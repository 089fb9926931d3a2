// The gated-MLP tails for D over gated_tail.cuh's kMaxD (64) and up to kD =
// 128, for every form the port runs: the message and update forwards
// (rows 6 and 8 with a second layer), the backwards with and without
// parameter gradients (rows 7 and 9, 7p and 9p), the message-reduce (row
// 10) and the one-kernel pass forward and backward (rows 13 and 14, 14p).
// gated_message.cu and fused_pass.cu launch these where d > kMaxD; below
// that their own kernels run as before. The same functions as theirs: y =
// silu(acc) @ blockdiag(W2c, W2g) + b2 (or y = acc without a second layer),
// per-half two-pass layer norms, silu * sigmoid, and the backward of it all
// (gated_message.cu's header, _bwd_math :150, _bwd_math_nw :690).
//
// Why not the D <= 64 tiles: at D = 128 the 3xTF32 kernels' pre-split W2
// fragments take 256 KB and their swizzled f32 W2 128 KB beside per-warp
// stages of twice the size, over the 227 KB a block may take, and their
// [2][8][4] accumulators a lane double; the CUDA-core tiles of
// gated_tail.cuh stage W2 and its transpose (256 KB) and give each thread 4
// consecutive columns of at most 128. These kernels are the simple design
// first: f32 FMAs on the CUDA cores, W2 staged once per block in f32 (bf16
// parameters widened exactly), 132 KB, and read in both orientations.
//
// Bound: at D = 128 a message row moves 2D + D + 1 values in and D out
// against 4 D^2 FLOPs of products (8 D^2 in the backward): 64 FLOPs a byte
// in f32, so by operations; these kernels' FMAs run at most at the CUDA
// cores' 67 TFLOP/s, under half the 165 TFLOP/s of 3xTF32 the bound charges.
// A speed redesign (tensor cores, W2's K slices through a ring) is later
// work (ROADMAP Queue 2).
//
// Design: 256 threads, 32-row tiles; warp w owns rows 4 w .. 4 w + 3 of a
// tile through every phase, lane l columns c = l + 32 i (i < 8) of a row
// [core D | gate D], so element e = l + 32 j (j < 4) of each half: every
// global load and store of a row is coalesced, and the layer norms and the
// gate run on the values a lane holds (warp shuffles for the sums). W2 lives
// in shared memory with rows kD + 1 floats apart, so that W[k][c] (the
// forward, c by lane) and W[c][k] (the backward's W^T) both fall on 32
// distinct banks. A product reads its A rows (silu(acc), then d_y) from the
// warp's own rows of a shared tile, 4 of them broadcast at a time, and each
// output is one fmaf chain over k in order. Serving needs no block barrier
// past the staging. With parameter gradients the block's rows meet once a
// tile: dW2 = h^T d_y over the tile's 32 rows, each entry of the block's
// [blocks, n_part] scratch row owned by one thread and added to there in
// tile order (global memory: 2 D^2 floats do not fit beside W2), the vectors
// in registers; the block's rows are then summed over the blocks by
// sum_blocks_kernel in block order. No float atomics: two runs give equal
// bits. The message-reduce gives each block a contiguous range of output
// rows, balanced by rows and segments as tail_reduce_tc_kernel's warps are,
// writes each tile's messages to shared memory and adds them in row order,
// one thread a column, into the open segment.
// bf16 (the _bf16 entries): rows and parameters widened as read, f32
// inside, each output rounded once at its store; the parameter gradients'
// scratch stays f32.
#pragma once

#include "gated_tail.cuh"

namespace {
namespace wide {

constexpr int kD = 128;               // widest D
constexpr int kP = kD / 32;           // a lane's elements of a half row
constexpr int kC = 2 * kP;            // a lane's columns of a row
constexpr int kRows = kRowsPerWarp;   // a warp's rows of a tile
constexpr int kStride = kD + 1;       // floats between W2's rows in shared memory
constexpr int kWFloats = 2 * kD * kStride;
constexpr int kRowF = 2 * kD;         // a tile row: core half, gate half at kD
constexpr int kTileF = kTile * kRowF;

// W2 (with a second layer), the h tile (silu(acc), with it) and the y tile
// (d_y with it; without, the parameter sums' room)
__host__ __device__ constexpr size_t smem_bytes(bool w2) {
  return (size_t)(w2 ? kWFloats + 2 * kTileF : kTileF) * sizeof(float);
}
static_assert(smem_bytes(true) <= 232448, "over the H100's shared memory a block");

// 32-row tiles of n rows, on either side
__host__ __device__ __forceinline__ int tiles_of(int n) { return (n + kTile - 1) / kTile; }

// column i of a lane: its half and its element of the half
__device__ __forceinline__ int half_of(int i) { return i / kP; }
__device__ __forceinline__ int elem_of(int i, int lane) { return lane + 32 * (i % kP); }

// The rows of an accumulator [n_rows, 2d]
template <typename T>
struct AccRows {
  const T* acc;
  // v[i] = column i of row l (zero past D)
  __device__ __forceinline__ void load(long l, int d, int lane, float v[kC]) const {
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int e = elem_of(i, lane);
      v[i] = e < d ? chgnet::to_f(acc[l * 2 * d + half_of(i) * d + e]) : 0.f;
    }
  }
};

// A lane's parameters: b2 by column, the layer norms' by element; zero past D
struct Prm {
  float b2[kC], ncs[kP], ncb[kP], ngs[kP], ngb[kP];
  template <typename T>
  __device__ void load(const TailT<T>& t, bool w2, int d, int lane) {
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int e = elem_of(i, lane);
      b2[i] = w2 && e < d ? chgnet::to_f(t.b2[half_of(i) * d + e]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      const int e = lane + 32 * j;
      const bool in = e < d;
      ncs[j] = in ? chgnet::to_f(t.ncs[e]) : 0.f;
      ncb[j] = in ? chgnet::to_f(t.ncb[e]) : 0.f;
      ngs[j] = in ? chgnet::to_f(t.ngs[e]) : 0.f;
      ngb[j] = in ? chgnet::to_f(t.ngb[e]) : 0.f;
    }
  }
};

// w_s[(h kD + k) kStride + c] = W_h[k][c], zero past D; by the whole block
template <typename T>
__device__ void stage_w(float* w_s, const TailT<T>& t, int d) {
  for (int i = threadIdx.x; i < 2 * kD * kD; i += kThreads) {
    const int h = i / (kD * kD);
    const int k = (i / kD) % kD;
    const int c = i % kD;
    w_s[(h * kD + k) * kStride + c] =
        k < d && c < d ? chgnet::to_f((h ? t.w2g : t.w2c)[k * d + c]) : 0.f;
  }
}

// out[r][i] += sum over k < d of A[r][half kD + k] W_half[k][e], or
// W_half[e][k] with kT (half, e: column i's), for the warp's rows r of the
// tile a_s (rows kRowF floats apart); one fmaf chain a value, k in order
template <bool kT>
__device__ __forceinline__ void product(const float* a_s, const float* w_s, int d,
                                        int warp, int lane, float out[kRows][kC]) {
  const float* a = a_s + warp * kRows * kRowF;
#pragma unroll 1
  for (int k = 0; k < d; k += 4) {
    float4 av[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        av[r][h] = *reinterpret_cast<const float4*>(a + r * kRowF + h * kD + k);
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int h = half_of(i);
      const int e = elem_of(i, lane);
      const float* w = w_s + h * kD * kStride;
      float wv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wv[kk] = kT ? w[e * kStride + k + kk] : w[(k + kk) * kStride + e];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        out[r][i] = fmaf(av[r][h].x, wv[0], out[r][i]);
        out[r][i] = fmaf(av[r][h].y, wv[1], out[r][i]);
        out[r][i] = fmaf(av[r][h].z, wv[2], out[r][i]);
        out[r][i] = fmaf(av[r][h].w, wv[3], out[r][i]);
      }
    }
  }
}

// The warp's rows row0 .. row0 + kRows - 1 (zero from row_end on): a = acc,
// y = b2 + silu(a) @ blockdiag(W2c, W2g) with a second layer (silu(a) into
// the warp's rows of h_s), else y = a
template <bool kW2, typename Src>
__device__ __forceinline__ void warp_rows(const Src& src, float* h_s, const float* w_s,
                                          const Prm& p, long row0, long row_end, int d,
                                          int warp, int lane, float a[kRows][kC],
                                          float y[kRows][kC]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row0 + r < row_end) {
      src.load(row0 + r, d, lane, a[r]);
    } else {
#pragma unroll
      for (int i = 0; i < kC; ++i) a[r][i] = 0.f;
    }
  }
  if constexpr (kW2) {
    float* hw = h_s + warp * kRows * kRowF;
    __syncwarp();  // the warp's last reads of its h rows done
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        hw[r * kRowF + lane + 32 * i] = silu(a[r][i]);
        y[r][i] = p.b2[i];
      }
    __syncwarp();
    product<false>(h_s, w_s, d, warp, lane, y);
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < kC; ++i) y[r][i] = a[r][i];
  }
}

__device__ __forceinline__ void in_d(int d, int lane, bool in[kP]) {
#pragma unroll
  for (int j = 0; j < kP; ++j) in[j] = lane + 32 * j < d;
}

// the gate silu(LN(y_c)) * sigmoid(LN(y_g)) of one row y (the lane's
// columns), by element
__device__ __forceinline__ void row_gate(const float y[kC], const Prm& p, int d,
                                         int lane, float gate[kP]) {
  bool in[kP];
  in_d(d, lane, in);
  float zc[kP], zg[kP], invc, invg;
  ln_norm<kP>(y, in, d, 32, zc, invc);
  ln_norm<kP>(y + kP, in, d, 32, zg, invg);
#pragma unroll
  for (int j = 0; j < kP; ++j)
    gate[j] = gate_value(zc[j], zg[j], p.ncs[j], p.ncb[j], p.ngs[j], p.ngb[j]);
}

// The backward of one row's gate (gate_row_bwd's arithmetic) for its
// cotangent row g_row and, for a message, its weights row and mask m: y
// (the lane's columns) is replaced by d_y (zero past D); dw: d_weights by
// element; mask_part: the lane's part of d_mask; with kParams the row's
// terms of the layer-norm vectors and of d_y's sums go into pv.
template <bool kMsg, bool kParams, typename T>
__device__ __forceinline__ void row_bwd(float y[kC], const T* g_row, const T* w_row,
                                        float m, const Prm& p, int d, int lane,
                                        float dw[kP], float& mask_part,
                                        float pv[kVecs][kP]) {
  bool in[kP];
  in_d(d, lane, in);
  float zc[kP], zg[kP], invc, invg;
  ln_norm<kP>(y, in, d, 32, zc, invc);
  ln_norm<kP>(y + kP, in, d, 32, zg, invg);
  float d_cn[kP], d_gn[kP];
  mask_part = 0.f;
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    const int e = lane + 32 * j;
    const float gv = in[j] ? chgnet::to_f(g_row[e]) : 0.f;
    const float cn = fmaf(zc[j], p.ncs[j], p.ncb[j]);
    const float gn = fmaf(zg[j], p.ngs[j], p.ngb[j]);
    const float silu_cn = silu(cn);
    const float sig_gn = sigm(gn);
    float up = gv;
    if (kMsg) {
      const float wv = in[j] ? chgnet::to_f(w_row[e]) : 0.f;
      mask_part = fmaf(gv, silu_cn * sig_gn * wv, mask_part);
      up = gv * wv * m;
      dw[j] = gv * silu_cn * sig_gn * m;
    }
    d_cn[j] = up * sig_gn * silu_grad(cn);
    d_gn[j] = up * silu_cn * sig_gn * (1.f - sig_gn);
  }
  float dyc[kP], dyg[kP];
  ln_bwd<kP>(d_cn, zc, invc, p.ncs, d, lane, dyc);
  ln_bwd<kP>(d_gn, zg, invg, p.ngs, d, lane, dyg);
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    y[j] = in[j] ? dyc[j] : 0.f;
    y[kP + j] = in[j] ? dyg[j] : 0.f;
    if (kParams) {
      pv[0][j] = fmaf(d_cn[j], zc[j], pv[0][j]);
      pv[1][j] += d_cn[j];
      pv[2][j] = fmaf(d_gn[j], zg[j], pv[2][j]);
      pv[3][j] += d_gn[j];
      pv[4][j] += y[j];
      pv[5][j] += y[kP + j];
    }
  }
}

// ------------------------------------------------------------- forward
// out = gate * weights * mask (kMsg) or gate + resnet, of y as warp_rows
// gives it; side: weights or resnet [n_rows, d]
template <typename T, typename Src, bool kMsg, bool kW2>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(TailT<T> t, Src src, const T* __restrict__ side,
               const T* __restrict__ mask, T* __restrict__ out, int n_rows, int d) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* h_s = w_s + (kW2 ? kWFloats : 0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Prm p;
  p.load(t, kW2, d, lane);
  if (kW2) {
    stage_w(w_s, t, d);
    __syncthreads();
  }
  const int tiles = tiles_of(n_rows);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * kTile + warp * kRows;
    float a[kRows][kC], y[kRows][kC];
    warp_rows<kW2>(src, h_s, w_s, p, row0, n_rows, d, warp, lane, a, y);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long l = row0 + r;
      if (l >= n_rows) break;  // warp-uniform
      float gate[kP];
      row_gate(y[r], p, d, lane, gate);
      const float m = kMsg ? chgnet::to_f(mask[l]) : 1.f;
#pragma unroll
      for (int j = 0; j < kP; ++j) {
        const int e = lane + 32 * j;
        if (e >= d) continue;
        const float s = chgnet::to_f(side[l * d + e]);
        chgnet::store_v(out + l * d + e, kMsg ? gate[j] * s * m : gate[j] + s);
      }
    }
  }
}

// ------------------------------------------------------------ backward
// d_acc = d_y (without a second layer) or (d_y @ W2^T) * silu'(acc), and
// for a message d_weights and, unless null, d_mask. kParams: the block's
// row of partial [gridDim.x, n_part], as gated_message.cu's
// tail_bwd_param_tc_kernel lays it out (kPass: fused_pass.cu's pass_bwd_kernel, with d_b1, the sum
// of d_acc, at its end).
template <typename T, typename Src, bool kMsg, bool kW2, bool kParams, bool kPass>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_kernel(TailT<T> t, Src src, const T* __restrict__ weights,
               const T* __restrict__ mask, const T* __restrict__ g,
               T* __restrict__ d_acc, T* __restrict__ d_weights, T* __restrict__ d_mask,
               float* __restrict__ partial, int n_rows, int d) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* h_s = w_s + (kW2 ? kWFloats : 0);
  float* y_s = h_s + (kW2 ? kTileF : 0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Prm p;
  p.load(t, kW2, d, lane);
  if (kW2) {
    stage_w(w_s, t, d);
    __syncthreads();
  }
  const int n_w = kW2 ? 2 * d * d : 0;
  const int n_part = (kW2 ? n_w + 2 * d : 0) + (kPass ? 6 : 4) * d;
  float* prow = kParams ? partial + (long)blockIdx.x * n_part : nullptr;
  float pv[kVecs][kP];  // the layer-norm vectors' and d_y's sums
  float pb[kC];         // d_b1's with a second layer (kPass)
  if (kParams) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q)
#pragma unroll
      for (int j = 0; j < kP; ++j) pv[q][j] = 0.f;
#pragma unroll
    for (int i = 0; i < kC; ++i) pb[i] = 0.f;
    for (int i = threadIdx.x; i < n_w; i += kThreads) prow[i] = 0.f;
  }
  const int tiles = tiles_of(n_rows);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * kTile + warp * kRows;
    float a[kRows][kC], y[kRows][kC];
    warp_rows<kW2>(src, h_s, w_s, p, row0, n_rows, d, warp, lane, a, y);
    float* yw = y_s + warp * kRows * kRowF;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long l = row0 + r;
      if (l < n_rows) {  // warp-uniform
        float dw[kP], mask_part;
        const float m = kMsg ? chgnet::to_f(mask[l]) : 1.f;
        row_bwd<kMsg, kParams>(y[r], g + l * d, kMsg ? weights + l * d : nullptr, m, p,
                               d, lane, dw, mask_part, pv);
        if (kMsg) {
#pragma unroll
          for (int j = 0; j < kP; ++j) {
            const int e = lane + 32 * j;
            if (e < d) chgnet::store_v(d_weights + l * d + e, dw[j]);
          }
          if (d_mask != nullptr) {
            const float dm = warp_sum(mask_part);
            if (lane == 0) chgnet::store_v(d_mask + l, dm);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kC; ++i) y[r][i] = 0.f;  // adds nothing to dW2
      }
      if (kW2) {
#pragma unroll
        for (int i = 0; i < kC; ++i) yw[r * kRowF + lane + 32 * i] = y[r][i];
      } else if (l < n_rows) {
#pragma unroll
        for (int i = 0; i < kC; ++i) {
          const int e = elem_of(i, lane);
          if (e < d) chgnet::store_v(d_acc + l * 2 * d + half_of(i) * d + e, y[r][i]);
        }
      }
    }
    if (kW2) {
      __syncwarp();  // the warp's d_y rows in y_s
      float dh[kRows][kC];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int i = 0; i < kC; ++i) dh[r][i] = 0.f;
      product<true>(y_s, w_s, d, warp, lane, dh);  // d_h = d_y @ W2^T
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const long l = row0 + r;
        if (l >= n_rows) break;
#pragma unroll
        for (int i = 0; i < kC; ++i) {
          const int e = elem_of(i, lane);
          if (e >= d) continue;
          const float v = dh[r][i] * silu_grad(a[r][i]);
          chgnet::store_v(d_acc + l * 2 * d + half_of(i) * d + e, v);
          if (kParams && kPass) pb[i] += v;  // in f32, before the store rounds
        }
      }
      if (kParams) {
        // dW2 += h^T @ d_y over the tile's rows, in order: each entry of the
        // block's row by one thread, added to there once a tile
        __syncthreads();  // every warp's h and d_y rows
        const int dd = d * d;
        for (int i = threadIdx.x; i < n_w; i += kThreads) {
          const int h = i >= dd;
          const int k = (i - h * dd) / d;
          const int c = i - h * dd - k * d;
          const float* hk = h_s + h * kD + k;
          const float* yc = y_s + h * kD + c;
          float s = 0.f;
#pragma unroll 8
          for (int r = 0; r < kTile; ++r) s = fmaf(hk[r * kRowF], yc[r * kRowF], s);
          prow[i] += s;
        }
        __syncthreads();  // before the next tile's rows overwrite h_s and y_s
      }
    }
  }
  if (!kParams) return;
  // the vectors: [db2 (2D) with w2 at n_w] [ncs, ncb, ngs, ngb] and with
  // kPass d_b1 (2D) last: with w2 the warps' sums of d_acc, without it d_y's
  // (the vectors 4 and 5). The warps' sums pass through red [kWarps][kVecs]
  // [kD] and redb [kWarps][2 kD] and add in warp order.
  __syncthreads();  // the last tile consumed: the tiles are free
  float* red = kW2 ? h_s : y_s;
  float* redb = red + kWarps * kVecs * kD;
#pragma unroll
  for (int q = 0; q < kVecs; ++q)
#pragma unroll
    for (int j = 0; j < kP; ++j) red[(warp * kVecs + q) * kD + lane + 32 * j] = pv[q][j];
  if (kW2 && kPass) {
#pragma unroll
    for (int i = 0; i < kC; ++i) redb[warp * 2 * kD + lane + 32 * i] = pb[i];
  }
  __syncthreads();
  const int ln_at = n_part - (kPass ? 6 : 4) * d;
  const int dy_at = kW2 ? n_w : kPass ? n_part - 2 * d : -1;
  for (int j = threadIdx.x; j < kVecs * d; j += kThreads) {
    const int q = j / d;
    const int e = j - q * d;
    if (q >= 4 && dy_at < 0) continue;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[(w * kVecs + q) * kD + e];
    prow[(q >= 4 ? dy_at + (q - 4) * d : ln_at + q * d) + e] = s;
  }
  if (kW2 && kPass) {
    for (int j = threadIdx.x; j < 2 * d; j += kThreads) {
      const int h = j >= d;
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += redb[w * 2 * kD + h * kD + j - h * d];
      prow[n_part - 2 * d + j] = s;
    }
  }
}

// ------------------------------------------------------ message-reduce
// out[n] = sum of the messages of rows offsets[n] .. offsets[n + 1]; block
// b owns the output rows [n0, n1) of its part of the rows' and segments'
// cost and walks their input rows in tiles
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    reduce_kernel(TailT<T> t, AccRows<T> src, const T* __restrict__ weights,
                  const T* __restrict__ mask, const int* __restrict__ offsets,
                  T* __restrict__ out, int n_out, int d) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* h_s = w_s + kWFloats;
  float* m_s = h_s + kTileF;  // the tile's messages, rows kD floats apart
  __shared__ int s_range[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Prm p;
  p.load(t, true, d, lane);
  stage_w(w_s, t, d);
  if (threadIdx.x < 2) {
    const long parts = gridDim.x;
    const long chunk = ((long)kRowCost * offsets[n_out] + n_out + parts - 1) / parts;
    const long end = blockIdx.x + threadIdx.x;
    s_range[threadIdx.x] = end == parts ? n_out : cost_lower_bound(offsets, n_out, chunk * end);
  }
  __syncthreads();
  const int n0 = s_range[0], n1 = s_range[1];
  if (n0 >= n1) return;  // block-uniform
  const long row_begin = offsets[n0];
  const long row_end = offsets[n1];
  const int c = threadIdx.x;  // the column this thread sums (c < d)
  int n = n0;
  long seg_end = offsets[n0 + 1];
  float sum = 0.f;
  for (long base = row_begin; base < row_end; base += kTile) {
    const long row0 = base + warp * kRows;
    float a[kRows][kC], y[kRows][kC];
    warp_rows<true>(src, h_s, w_s, p, row0, row_end, d, warp, lane, a, y);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long l = row0 + r;
      if (l >= row_end) break;  // warp-uniform
      float gate[kP];
      row_gate(y[r], p, d, lane, gate);
      const float m = chgnet::to_f(mask[l]);
#pragma unroll
      for (int j = 0; j < kP; ++j) {
        const int e = lane + 32 * j;
        if (e < d)
          m_s[(warp * kRows + r) * kD + e] = gate[j] * chgnet::to_f(weights[l * d + e]) * m;
      }
    }
    __syncthreads();  // the tile's messages
    const int rows = row_end - base < kTile ? (int)(row_end - base) : kTile;
    if (c < d) {
      for (int r = 0; r < rows; ++r) {
        while (base + r >= seg_end) {  // close segments, empty ones too
          chgnet::store_v(out + (long)n * d + c, sum);
          sum = 0.f;
          ++n;
          seg_end = offsets[n + 1];
        }
        sum += m_s[r * kD + c];
      }
    }
    __syncthreads();  // the messages summed: the tile is free
  }
  if (c < d) {
    for (; n < n1; ++n) {
      chgnet::store_v(out + (long)n * d + c, sum);
      sum = 0.f;
    }
  }
}

// ------------------------------------------------------------- launches
template <typename T, typename Src>
using FwdFn = void (*)(TailT<T>, Src, const T*, const T*, T*, int, int);
template <typename T, typename Src>
using BwdFn = void (*)(TailT<T>, Src, const T*, const T*, const T*, T*, T*, T*, float*,
                       int, int);

template <typename T, typename Src, bool kMsg, bool kW2>
Kernel<FwdFn<T, Src>> fwd_instance() {
  static std::atomic<int> waves[kMaxDevices];
  return {fwd_kernel<T, Src, kMsg, kW2>, smem_bytes(kW2), waves};
}

template <typename T, typename Src, bool kMsg, bool kW2, bool kParams, bool kPass>
Kernel<BwdFn<T, Src>> bwd_instance() {
  static std::atomic<int> waves[kMaxDevices];
  return {bwd_kernel<T, Src, kMsg, kW2, kParams, kPass>, smem_bytes(kW2), waves};
}

// the message forward (msg, with w2) or the update forward, at most one
// wave of persistent blocks
template <typename T, typename Src>
int launch_fwd(bool msg, bool w2, const TailT<T>& t, const Src& src, const T* side,
               const T* mask, T* out, int n_rows, int d, cudaStream_t stream) {
  const Kernel<FwdFn<T, Src>> k = msg  ? fwd_instance<T, Src, true, true>()
                                  : w2 ? fwd_instance<T, Src, false, true>()
                                       : fwd_instance<T, Src, false, false>();
  const int wave = wave_blocks(k);
  if (wave < 0) return -wave;
  const int tiles = tiles_of(n_rows);
  k.fn<<<tiles < wave ? tiles : wave, kThreads, k.smem, stream>>>(t, src, side, mask,
                                                                    out, n_rows, d);
  return (int)cudaSuccess;
}

template <typename T, typename Src, bool kPass, bool kParams>
Kernel<BwdFn<T, Src>> bwd_kernel_of(bool msg, bool w2) {
  if (msg) return bwd_instance<T, Src, true, true, kParams, kPass>();
  return w2 ? bwd_instance<T, Src, false, true, kParams, kPass>()
            : bwd_instance<T, Src, false, false, kParams, kPass>();
}

// the backward: with partial non-null in exactly n_blocks blocks (one row
// of partial each), else at most one wave of persistent blocks
template <typename T, typename Src, bool kPass>
int launch_bwd(bool msg, bool w2, const TailT<T>& t, const Src& src, const T* weights,
               const T* mask, const T* g, T* d_acc, T* d_weights, T* d_mask,
               float* partial, int n_rows, int d, int n_blocks, cudaStream_t stream) {
  const Kernel<BwdFn<T, Src>> k = partial != nullptr
                                      ? bwd_kernel_of<T, Src, kPass, true>(msg, w2)
                                      : bwd_kernel_of<T, Src, kPass, false>(msg, w2);
  const int wave = wave_blocks(k);
  if (wave < 0) return -wave;
  const int tiles = tiles_of(n_rows);
  const int grid = partial != nullptr ? n_blocks : tiles < wave ? tiles : wave;
  k.fn<<<grid, kThreads, k.smem, stream>>>(t, src, weights, mask, g, d_acc, d_weights,
                                           d_mask, partial, n_rows, d);
  return (int)cudaSuccess;
}

// the message-reduce: a block per kRowCost * kTile * kWarps cost units, at
// most one wave
template <typename T>
int launch_reduce(const TailT<T>& t, const T* acc, const T* weights, const T* mask,
                  const int* offsets, T* out, int n_rows, int n_out, int d,
                  cudaStream_t stream) {
  using Fn = void (*)(TailT<T>, AccRows<T>, const T*, const T*, const int*, T*, int, int);
  static std::atomic<int> waves[kMaxDevices];
  const Kernel<Fn> k{reduce_kernel<T>, smem_bytes(true), waves};
  const int wave = wave_blocks(k);
  if (wave < 0) return -wave;
  const long cost = (long)kRowCost * n_rows + n_out;
  const long per_block = (long)kRowCost * kTile * kWarps;
  const long want = (cost + per_block - 1) / per_block;
  k.fn<<<want < wave ? (int)want : wave, kThreads, k.smem, stream>>>(
      t, AccRows<T>{acc}, weights, mask, offsets, out, n_out, d);
  return (int)cudaSuccess;
}

}  // namespace wide

// a tail the kernels do not take: D over wide::kD, not a multiple of 4, a
// message without a second layer
bool bad_width(bool msg, bool w2, int d) {
  return d < 4 || d > wide::kD || d % 4 || (msg && !w2);
}

}  // namespace
