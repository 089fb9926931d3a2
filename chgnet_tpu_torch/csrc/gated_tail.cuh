// The gated-MLP tail shared by the fused tail kernels (gated_message.cu)
// and the one-kernel conv pass (fused_pass.cu): tile sizes, the staged
// block-diagonal product, the per-row layer norms and gate with their
// backward, and the launch plumbing (wave size per instantiation, the
// in-order sum of the per-block parameter gradients). Both sources include
// it, so the two cannot drift apart; chgnet_tpu_torch/ops/build.py digests
// every header of this directory into each library's name, so both rebuild
// when it changes.
#pragma once

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                      // rows per tile
constexpr int kRowsPerWarp = kTile / kWarps;   // 4
constexpr int kMaxD = 64;                      // 2D <= 128
constexpr int kPerLane = kMaxD / 32;           // a half's elements per lane
// floats of one half tile; the 4 extra floats move the gate half off the
// core half's banks
constexpr int kHalf = kTile * kMaxD + 4;
constexpr int kWeights = 2 * kMaxD * kMaxD;    // W2c and W2g
constexpr int kVecs = 6;                       // per-row gradient vectors
constexpr float kEps = 1e-5f;
// Blocks of the backwards with parameter gradients, whatever the card, so
// that the wrapper can size their [blocks, n_part] scratch and the sums
// repeat bit for bit on any card: about one wave on an H100 (132 SMs) of a
// kernel that holds two blocks an SM, two of the tails' tensor-core form
// (gated_message.cu), which holds one.
constexpr int kParamBlocks = 256;
constexpr int kMaxDevices = 16;

// A tail's parameters in their storage type T (float, or bf16 under
// compute_dtype="bfloat16"); every kernel widens them to f32 as it loads
// them.
template <typename T>
struct TailT {
  const T* w2c;  // [D, D], null without a second layer
  const T* w2g;  // [D, D]
  const T* b2;   // [2D]
  const T* ncs;  // [D] layer-norm scales and biases
  const T* ncb;
  const T* ngs;
  const T* ngb;
};
using Tail = TailT<float>;

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }
__device__ __forceinline__ float silu_grad(float x) {
  const float s = sigm(x);
  return s * (1.f + x * (1.f - s));
}

// the same sum in every lane (a + b == b + a at each step)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float* half_tile(float* buf, int half) {
  return buf + half * kHalf;
}
__device__ __forceinline__ const float* half_tile(const float* buf, int half) {
  return buf + half * kHalf;
}

// A half row's elements e = lane + 32 i (zero past D).
template <typename T>
__device__ __forceinline__ void load_lane(const T* src, int d, int lane,
                                          float v[kPerLane]) {
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int e = lane + 32 * i;
    v[i] = e < d ? chgnet::to_f(src[e]) : 0.f;
  }
}

// ... and stored, rounded once to T (float, or bf16)
template <typename T>
__device__ __forceinline__ void store_lane(T* dst, int d, int lane,
                                           const float v[kPerLane]) {
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int e = lane + 32 * i;
    if (e < d) chgnet::store_v(dst + e, v[i]);
  }
}

// w_s[half][k][c] = W_half[k][c], or W_half[c][k] with transpose
template <typename T>
__device__ void stage_weights(float* w_s, const TailT<T>& t, int d, bool transpose) {
  const int dd = d * d;
  for (int i = threadIdx.x; i < 2 * dd; i += kThreads) {
    const int half = i >= dd;
    const int j = i - half * dd;
    const int k = j / d;
    const int c = j - k * d;
    w_s[half * dd + (transpose ? c * d + k : j)] = chgnet::to_f((half ? t.w2g : t.w2c)[j]);
  }
}

// h_s = silu(acc) of the tile's rows, zero rows past n_rows
template <typename T>
__device__ void load_silu(const T* __restrict__ acc, float* h_s, long row0,
                          int n_rows, int d) {
  const int d4 = d / 4;
  for (int i = threadIdx.x; i < kTile * 2 * d4; i += kThreads) {
    const int r = i / (2 * d4);
    const int c4 = i - r * 2 * d4;
    const long l = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (l < n_rows) {
      chgnet::load_v(v, acc + l * 2 * d + 4 * c4);
      v = make_float4(silu(v.x), silu(v.y), silu(v.z), silu(v.w));
    }
    const int half = c4 >= d4;
    reinterpret_cast<float4*>(half_tile(h_s, half) + r * d)[c4 - half * d4] = v;
  }
}

// out[r][j] = sum_k in[half][row r of the warp][k] * w[half][k][c + j] for
// the lane's columns col = 4 lane = half D + c (nothing past 2D)
__device__ __forceinline__ void tile_product(const float* in_s, const float* w_s,
                                             int d, int warp, int lane,
                                             float out[kRowsPerWarp][4]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
    out[r][0] = out[r][1] = out[r][2] = out[r][3] = 0.f;
  const int col = 4 * lane;
  if (col >= 2 * d) return;
  const int half = col >= d;
  const float* in = half_tile(in_s, half) + warp * kRowsPerWarp * d;
  const float* w = w_s + half * d * d + (col - half * d);
  for (int k = 0; k < d; k += 4) {
    const float4 w0 = *reinterpret_cast<const float4*>(w + (k + 0) * d);
    const float4 w1 = *reinterpret_cast<const float4*>(w + (k + 1) * d);
    const float4 w2 = *reinterpret_cast<const float4*>(w + (k + 2) * d);
    const float4 w3 = *reinterpret_cast<const float4*>(w + (k + 3) * d);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(in + r * d + k);
      float* o = out[r];
      o[0] = fmaf(x.x, w0.x, o[0]);
      o[1] = fmaf(x.x, w0.y, o[1]);
      o[2] = fmaf(x.x, w0.z, o[2]);
      o[3] = fmaf(x.x, w0.w, o[3]);
      o[0] = fmaf(x.y, w1.x, o[0]);
      o[1] = fmaf(x.y, w1.y, o[1]);
      o[2] = fmaf(x.y, w1.z, o[2]);
      o[3] = fmaf(x.y, w1.w, o[3]);
      o[0] = fmaf(x.z, w2.x, o[0]);
      o[1] = fmaf(x.z, w2.y, o[1]);
      o[2] = fmaf(x.z, w2.z, o[2]);
      o[3] = fmaf(x.z, w2.w, o[3]);
      o[0] = fmaf(x.w, w3.x, o[0]);
      o[1] = fmaf(x.w, w3.y, o[1]);
      o[2] = fmaf(x.w, w3.z, o[2]);
      o[3] = fmaf(x.w, w3.w, o[3]);
    }
  }
}

// y_s rows of the warp = y + b2
__device__ __forceinline__ void store_y(float* y_s, const float y[kRowsPerWarp][4],
                                        const float b[4], int d, int warp,
                                        int lane) {
  const int col = 4 * lane;
  if (col >= 2 * d) return;
  const int half = col >= d;
  float* dst = half_tile(y_s, half) + warp * kRowsPerWarp * d + (col - half * d);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
    *reinterpret_cast<float4*>(dst + r * d) =
        make_float4(y[r][0] + b[0], y[r][1] + b[1], y[r][2] + b[2], y[r][3] + b[3]);
}

// The sum over an aligned group of `width` lanes (a power of two, at most
// 32), the same in every lane of the group (a + b == b + a at each step);
// width 32 is warp_sum
__device__ __forceinline__ float group_sum(float v, int width) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < width) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Two-pass layer norm of one half row held by a group of `width` lanes,
// kN elements a lane (in[i]: element i lies inside D): z = (v - mean) * inv,
// zero outside D.
template <int kN>
__device__ __forceinline__ void ln_norm(const float v[kN], const bool in[kN], int d,
                                        int width, float z[kN], float& inv) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i)
    if (in[i]) s += v[i];
  const float mean = group_sum(s, width) / d;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i)
    if (in[i]) {
      const float c = v[i] - mean;
      q = fmaf(c, c, q);
    }
  inv = rsqrtf(group_sum(q, width) / d + kEps);
#pragma unroll
  for (int i = 0; i < kN; ++i) z[i] = in[i] ? (v[i] - mean) * inv : 0.f;
}

// ... of a half row held by the whole warp, elements e = lane + 32 i
__device__ __forceinline__ void ln_parts(const float v[kPerLane], int d, int lane,
                                         float z[kPerLane], float& inv) {
  bool in[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) in[i] = lane + 32 * i < d;
  ln_norm<kPerLane>(v, in, d, 32, z, inv);
}

// the gate of one element from its normalised halves and the layer norms'
// scales and biases. kFast: the exponentials and quotients by the fast
// intrinsics (__expf, __fdividef: a few ulp of f32, some 1e-6 relative),
// for outputs rounded to bf16 (2^-9 relative at most), where the accurate
// forms' instructions, not the bytes, bound the update forward.
template <bool kFast = false>
__device__ __forceinline__ float gate_value(float zc, float zg, float ncs, float ncb,
                                            float ngs, float ngb) {
  const float c = fmaf(zc, ncs, ncb);
  const float g = fmaf(zg, ngs, ngb);
  if constexpr (kFast)
    return __fdividef(c, 1.f + __expf(-c)) * __fdividef(1.f, 1.f + __expf(-g));
  return silu(c) * sigm(g);
}

// d x of out = z * scale + bias for the cotangent gout (_ln_bwd :141), kN
// elements a lane of a half row held by the whole warp
template <int kN = kPerLane>
__device__ __forceinline__ void ln_bwd(const float gout[kN], const float z[kN],
                                       float inv, const float scale[kN], int d,
                                       int lane, float dx[kN]) {
  float gz[kN];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    gz[i] = gout[i] * scale[i];  // zero past D, as gout and scale are
    s1 += gz[i];
    s2 = fmaf(gz[i], z[i], s2);
  }
  const float m1 = warp_sum(s1) / d;
  const float m2 = warp_sum(s2) / d;
#pragma unroll
  for (int i = 0; i < kN; ++i) dx[i] = (gz[i] - m1 - z[i] * m2) * inv;
}

struct LaneParams {  // the lane's layer-norm parameters, zero past D
  float ncs[kPerLane], ncb[kPerLane], ngs[kPerLane], ngb[kPerLane];
  template <typename T>
  __device__ void load(const TailT<T>& t, int d, int lane) {
    load_lane(t.ncs, d, lane, ncs);
    load_lane(t.ncb, d, lane, ncb);
    load_lane(t.ngs, d, lane, ngs);
    load_lane(t.ngb, d, lane, ngb);
  }
};

template <typename T>
__device__ __forceinline__ void load_bias(const TailT<T>& t, int d, int lane,
                                          float b[4]) {
  const int col = 4 * lane;
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = col < 2 * d ? chgnet::to_f(t.b2[col + j]) : 0.f;
}

// The gate of one row, silu(LN(y_c)) * sigmoid(LN(y_g)), for the lane's
// elements (unspecified past D); y_c and y_g are the row's two halves.
template <typename T>
__device__ __forceinline__ void gate_row(const T* y_c, const T* y_g,
                                         const LaneParams& lp, int d, int lane,
                                         float gate[kPerLane]) {
  float yc[kPerLane], yg[kPerLane], zc[kPerLane], zg[kPerLane];
  float invc, invg;
  load_lane(y_c, d, lane, yc);
  load_lane(y_g, d, lane, yg);
  ln_parts(yc, d, lane, zc, invc);
  ln_parts(yg, d, lane, zg, invg);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i)
    gate[i] = gate_value(zc[i], zg[i], lp.ncs[i], lp.ncb[i], lp.ngs[i], lp.ngb[i]);
}

// kN neighbouring elements of T in one load (16 bytes, or 8 for 4 bf16)
template <typename T, int kN>
using Pack = std::conditional_t<sizeof(T) * kN == 16, uint4, uint2>;

template <typename T, int kN>
__device__ __forceinline__ void widen(const Pack<T, kN>& p, float v[kN]) {
  const T* e = reinterpret_cast<const T*>(&p);
#pragma unroll
  for (int i = 0; i < kN; ++i) v[i] = chgnet::to_f(e[i]);
}

// v rounded once to T and packed
template <typename T, int kN>
__device__ __forceinline__ Pack<T, kN> narrow(const float v[kN]) {
  Pack<T, kN> p;
  if constexpr (chgnet::is_bf16<T>) {
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&p);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) e[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  } else {
    float* e = reinterpret_cast<float*>(&p);
#pragma unroll
    for (int i = 0; i < kN; ++i) e[i] = v[i];
  }
  return p;
}

// The backward of one row's gate for the cotangent row g (_bwd_math :150,
// _bwd_math_nw :690): the layer-norm parts of y, the cotangents of the two
// affine outputs, d_y, and for a message row d_weights and the row's part of
// d_mask. Everything is zero past D. y's halves are read as TY (shared
// memory, or the rows of acc without a second layer), g and weights as TG
// (float, or bf16 rows widened as they are read).
struct RowGrads {
  float zc[kPerLane], zg[kPerLane];      // normalised y halves
  float d_cn[kPerLane], d_gn[kPerLane];  // cotangents of the affine outputs
  float dyc[kPerLane], dyg[kPerLane];    // d_y halves
  float dw[kPerLane];                    // d_weights (message only)
  float mask_part;                       // this lane's part of d_mask
};

template <bool kMsg, typename TY, typename TG>
__device__ __forceinline__ void gate_row_bwd(const TY* y_c, const TY* y_g,
                                             const TG* g_row,
                                             const TG* w_row, float m,
                                             const LaneParams& lp, int d,
                                             int lane, RowGrads& o) {
  float yc[kPerLane], yg[kPerLane];
  float invc, invg;
  load_lane(y_c, d, lane, yc);
  load_lane(y_g, d, lane, yg);
  ln_parts(yc, d, lane, o.zc, invc);
  ln_parts(yg, d, lane, o.zg, invg);
  float gv[kPerLane];
  load_lane(g_row, d, lane, gv);  // zero past D, and so is all below
  if (kMsg) load_lane(w_row, d, lane, o.dw);
  o.mask_part = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const float cn = fmaf(o.zc[i], lp.ncs[i], lp.ncb[i]);
    const float gn = fmaf(o.zg[i], lp.ngs[i], lp.ngb[i]);
    const float silu_cn = silu(cn);
    const float sig_gn = sigm(gn);
    float up = gv[i];
    if (kMsg) {
      o.mask_part = fmaf(gv[i], silu_cn * sig_gn * o.dw[i], o.mask_part);
      up = gv[i] * o.dw[i] * m;
      o.dw[i] = gv[i] * silu_cn * sig_gn * m;  // d_weights
    }
    o.d_cn[i] = up * sig_gn * silu_grad(cn);
    o.d_gn[i] = up * silu_cn * sig_gn * (1.f - sig_gn);
  }
  ln_bwd(o.d_cn, o.zc, invc, lp.ncs, d, lane, o.dyc);
  ln_bwd(o.d_gn, o.zg, invg, lp.ngs, d, lane, o.dyg);
}

// A block's parameter-gradient sums: per-lane vectors (ncs, ncb, ngs, ngb,
// and the two halves of d_y: b2's gradient where there is a second layer)
// and this thread's 8 x 4 entries of dW2 (half threadIdx / 128, rows k0..,
// columns c0..).
struct ParamSums {
  float pv[kVecs][kPerLane];
  float pw[8][4];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int q = 0; q < kVecs; ++q)
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) pv[q][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) pw[i][0] = pw[i][1] = pw[i][2] = pw[i][3] = 0.f;
  }

  // one row's terms of the vectors
  __device__ __forceinline__ void add_row(const RowGrads& o) {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      pv[0][i] = fmaf(o.d_cn[i], o.zc[i], pv[0][i]);
      pv[1][i] += o.d_cn[i];
      pv[2][i] = fmaf(o.d_gn[i], o.zg[i], pv[2][i]);
      pv[3][i] += o.d_gn[i];
      pv[4][i] += o.dyc[i];
      pv[5][i] += o.dyg[i];
    }
  }

  // dW2 += h^T @ d_y over the tile's 32 rows, in order
  __device__ __forceinline__ void add_tile(const float* h_s, const float* y_s,
                                           int d) {
    const int w_half = threadIdx.x >> 7;
    const int k0 = ((threadIdx.x & 127) >> 4) * 8;
    const int c0 = (threadIdx.x & 15) * 4;
    if (k0 >= d || c0 >= d) return;
    const float* hh = half_tile(h_s, w_half);
    const float* dy = half_tile(y_s, w_half);
    for (int r = 0; r < kTile; ++r) {
      const float4 y4 = *reinterpret_cast<const float4*>(dy + r * d + c0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float hv = k0 + i < d ? hh[r * d + k0 + i] : 0.f;
        pw[i][0] = fmaf(hv, y4.x, pw[i][0]);
        pw[i][1] = fmaf(hv, y4.y, pw[i][1]);
        pw[i][2] = fmaf(hv, y4.z, pw[i][2]);
        pw[i][3] = fmaf(hv, y4.w, pw[i][3]);
      }
    }
  }

  // This block's row out of the partial buffer, by every thread of the
  // block: dW2c and dW2g (D x D each) at its front with kW2, the four
  // layer-norm vectors from ln_at, d_y's two sums from dy_at (negative: not
  // stored). The warps' vectors pass through red [kWarps][kVecs][kMaxD] in
  // shared memory, which nothing else may use meanwhile, and add in warp
  // order; a barrier lies between the writes to red and the reads.
  template <bool kW2>
  __device__ void store(float* red, float* out, int ln_at, int dy_at, int d,
                        int warp, int lane) const {
#pragma unroll
    for (int q = 0; q < kVecs; ++q)
      store_lane(red + (warp * kVecs + q) * kMaxD, d, lane, pv[q]);
    __syncthreads();
    const int w_half = threadIdx.x >> 7;
    const int k0 = ((threadIdx.x & 127) >> 4) * 8;
    const int c0 = (threadIdx.x & 15) * 4;
    if (kW2 && k0 < d && c0 < d) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (k0 + i >= d) break;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          out[w_half * d * d + (k0 + i) * d + c0 + j] = pw[i][j];
      }
    }
    for (int j = threadIdx.x; j < kVecs * d; j += kThreads) {
      const int q = j / d;
      const int e = j - q * d;
      if (q >= 4 && dy_at < 0) continue;
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[(w * kVecs + q) * kMaxD + e];
      out[(q >= 4 ? dy_at + (q - 4) * d : ln_at + q * d) + e] = s;
    }
  }
};

// out[j] = sum over blocks b, in order, of partial[b][j]: f32 partials
// summed in f32, rounded once to the parameters' type T (float, or bf16;
// chgnet_tpu casts each tile's f32 sums to the parameters' type and adds
// them there, ops/gated_message.py:222-228, ops/fused_pass.py:504-517)
template <typename T>
__global__ void sum_blocks_kernel(const float* __restrict__ partial,
                                  int n_blocks, int n_part,
                                  T* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_part) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(long)b * n_part + j];
  chgnet::store_v(out + j, s);
}

// One instantiation: its dynamic shared memory and, per device, the blocks
// of one full wave (0 until first found).
template <typename Fn>
struct Kernel {
  Fn fn;
  size_t smem;
  std::atomic<int>* waves;
};

// Blocks of one full wave of k, launched with `threads` a block, on the
// current device: its SMs times the blocks k's occupancy allows on each.
// Found once per instantiation and device, when k's shared memory limit is
// also set; negative: minus a cudaError_t.
template <typename Fn>
int wave_blocks(const Kernel<Fn>& k, int threads = kThreads) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev >= kMaxDevices) return -(int)cudaErrorInvalidDevice;
  int blocks = k.waves[dev].load(std::memory_order_relaxed);
  if (blocks != 0) return blocks;
  int per_sm = 0;
  err = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)k.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k.fn, threads,
                                                        k.smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  blocks = err == cudaSuccess ? chgnet::sm_count() * per_sm : -(int)err;
  k.waves[dev].store(blocks, std::memory_order_relaxed);
  return blocks;
}

int n_tiles(int n_rows) { return (n_rows + kTile - 1) / kTile; }

// The message-reduce's balance (gated_message.cu): input rows weigh
// kRowCost output rows. The first n in [0, n_out] with kRowCost * offsets[n]
// + n >= x (n_out if none).
constexpr int kRowCost = 8;
__device__ __forceinline__ int cost_lower_bound(const int* __restrict__ offsets,
                                                int n_out, long x) {
  int lo = 0, hi = n_out;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long)kRowCost * offsets[mid] + mid >= x) hi = mid; else lo = mid + 1;
  }
  return lo;
}

template <typename T = float>
TailT<T> make_tail(const void* const* p) {
  return TailT<T>{static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
                  static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
                  static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
                  static_cast<const T*>(p[6])};
}

}  // namespace
