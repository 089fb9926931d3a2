// Fused gated-MLP tails of the conv layers, forward and backward:
//
//     y   = silu(acc) @ blockdiag(W2c, W2g) + b2        acc [L, 2D] f32
//     msg = silu(LN(y[:, :D])) * sigmoid(LN(y[:, D:])) * weights * mask
//     upd = silu(LN(y[:, :D])) * sigmoid(LN(y[:, D:])) + resnet
//
// with y = acc for an update tail without a second layer (w2c == null).
//
// Replaces the four Pallas kernels of chgnet_tpu/ops/gated_message.py:
// _kernel (:55, message forward), _bwd_kernel (:190, its backward),
// _kernel_nw (:620, update forward) and _bwd_kernel_nw (:734, its
// backward). One template of each direction serves both tails, and the
// per-row layer norms, gating and their backward are shared device
// functions, so the four cannot drift apart. A fifth kernel,
// tail_reduce_kernel, replaces _reduce_kernel (:378, _reduce_pallas :426):
// the message tail and the sorted segment sum of its rows in one sweep (see
// the note above it).
//
// Bound: a message row moves 2D + D + 1 floats in and D out (the backward
// 2D + 2D + 1 in, 2D + D out) against 4 D^2 FLOPs of the block-diagonal
// product (8 D^2 in the backward) plus the elementwise work of the norms and
// gates. At D = 64 the forward tails and the update backward are bound by
// bytes; the message backward, with the elementwise work counted, is bound
// by operations, as are the message-reduce's calls whose output is short
// (edges into atoms), which write almost nothing.
// Design: f32 throughout with FMAs, no TF32. A block stages W2c and W2g
// (and their transposes in the backward, 16 KB each at D = 64) in dynamic
// shared memory once, then walks 32-row tiles: it loads the tile's acc
// rows as float4, keeps h = silu(acc) in shared memory, and each of 256
// threads computes a 4-row x 4-column register tile of the two diagonal
// blocks only (half the FLOPs of the dense 2D x 2D product). The row
// phase gives each row to one warp: two-pass layer norms (mean, then the
// centred variance) by warp shuffles, the gating, and in the backward the
// layer-norm backward; the ragged last tile is masked, nothing is padded.
// Parameter gradients (the backward's optional mode) are summed per block
// in a fixed order into a [blocks, n_part] scratch buffer (a fixed number
// of blocks, kParamBlocks), which a second kernel reduces over the blocks in
// order: no float atomics, and the result repeats bit for bit.
#include <atomic>

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
// Blocks of the backward with parameter gradients, whatever the card, so
// that the wrapper can size their [blocks, n_part] scratch and the sums
// repeat bit for bit on any card: about one wave on an H100 (132 SMs, two
// blocks each at 128 registers).
constexpr int kParamBlocks = 256;
constexpr int kMaxDevices = 16;

struct Tail {
  const float* w2c;  // [D, D], null without a second layer
  const float* w2g;  // [D, D]
  const float* b2;   // [2D]
  const float* ncs;  // [D] layer-norm scales and biases
  const float* ncb;
  const float* ngs;
  const float* ngb;
};

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
__device__ __forceinline__ void load_lane(const float* src, int d, int lane,
                                          float v[kPerLane]) {
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int e = lane + 32 * i;
    v[i] = e < d ? src[e] : 0.f;
  }
}

__device__ __forceinline__ void store_lane(float* dst, int d, int lane,
                                           const float v[kPerLane]) {
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int e = lane + 32 * i;
    if (e < d) dst[e] = v[i];
  }
}

// w_s[half][k][c] = W_half[k][c], or W_half[c][k] with transpose
__device__ void stage_weights(float* w_s, const Tail& t, int d, bool transpose) {
  const int dd = d * d;
  for (int i = threadIdx.x; i < 2 * dd; i += kThreads) {
    const int half = i >= dd;
    const int j = i - half * dd;
    const int k = j / d;
    const int c = j - k * d;
    w_s[half * dd + (transpose ? c * d + k : j)] = (half ? t.w2g : t.w2c)[j];
  }
}

// h_s = silu(acc) of the tile's rows, zero rows past n_rows
__device__ void load_silu(const float* __restrict__ acc, float* h_s, long row0,
                          int n_rows, int d) {
  const int d4 = d / 4;
  for (int i = threadIdx.x; i < kTile * 2 * d4; i += kThreads) {
    const int r = i / (2 * d4);
    const int c4 = i - r * 2 * d4;
    const long l = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (l < n_rows) {
      v = reinterpret_cast<const float4*>(acc + l * 2 * d)[c4];
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

// Two-pass layer norm of one half row: z = (v - mean) * inv.
__device__ __forceinline__ void ln_parts(const float v[kPerLane], int d, int lane,
                                         float z[kPerLane], float& inv) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i)
    if (lane + 32 * i < d) s += v[i];
  const float mean = warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i)
    if (lane + 32 * i < d) {
      const float c = v[i] - mean;
      q = fmaf(c, c, q);
    }
  inv = rsqrtf(warp_sum(q) / d + kEps);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i)
    z[i] = lane + 32 * i < d ? (v[i] - mean) * inv : 0.f;
}

// d x of out = z * scale + bias for the cotangent gout (_ln_bwd :141)
__device__ __forceinline__ void ln_bwd(const float gout[kPerLane],
                                       const float z[kPerLane], float inv,
                                       const float scale[kPerLane], int d,
                                       int lane, float dx[kPerLane]) {
  float gz[kPerLane];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    gz[i] = gout[i] * scale[i];  // zero past D, as gout and scale are
    s1 += gz[i];
    s2 = fmaf(gz[i], z[i], s2);
  }
  const float m1 = warp_sum(s1) / d;
  const float m2 = warp_sum(s2) / d;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) dx[i] = (gz[i] - m1 - z[i] * m2) * inv;
}

struct LaneParams {  // the lane's layer-norm parameters, zero past D
  float ncs[kPerLane], ncb[kPerLane], ngs[kPerLane], ngb[kPerLane];
  __device__ void load(const Tail& t, int d, int lane) {
    load_lane(t.ncs, d, lane, ncs);
    load_lane(t.ncb, d, lane, ncb);
    load_lane(t.ngs, d, lane, ngs);
    load_lane(t.ngb, d, lane, ngb);
  }
};

__device__ __forceinline__ void load_bias(const Tail& t, int d, int lane,
                                          float b[4]) {
  const int col = 4 * lane;
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = col < 2 * d ? t.b2[col + j] : 0.f;
}

// The gate of one row, silu(LN(y_c)) * sigmoid(LN(y_g)), for the lane's
// elements (unspecified past D); y_c and y_g are the row's two halves.
__device__ __forceinline__ void gate_row(const float* y_c, const float* y_g,
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
    gate[i] = silu(fmaf(zc[i], lp.ncs[i], lp.ncb[i])) *
              sigm(fmaf(zg[i], lp.ngs[i], lp.ngb[i]));
}

// ------------------------------------------------------------- forward
template <bool kMsg, bool kW2>
__global__ void __launch_bounds__(kThreads)
    tail_fwd_kernel(Tail t, const float* __restrict__ acc,
                    const float* __restrict__ weights,
                    const float* __restrict__ mask,
                    const float* __restrict__ resnet, float* __restrict__ out,
                    int n_rows, int d) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [2][D][D]
  float* h_s = w_s + kWeights;                   // 2 half tiles
  float* y_s = h_s + 2 * kHalf;                  // 2 half tiles
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  LaneParams lp;
  lp.load(t, d, lane);
  float b[4];
  if (kW2) {
    load_bias(t, d, lane, b);
    stage_weights(w_s, t, d, false);
  }
  const int n_tiles = (n_rows + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long row0 = (long)tile * kTile;
    if (kW2) {
      __syncthreads();  // weights staged, the previous tile's y_s read
      load_silu(acc, h_s, row0, n_rows, d);
      __syncthreads();
      float y[kRowsPerWarp][4];
      tile_product(h_s, w_s, d, warp, lane, y);
      store_y(y_s, y, b, d, warp, lane);
      __syncthreads();
    }
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const long l = row0 + r;
      if (l >= n_rows) break;  // warp-uniform
      const float* src_c = kW2 ? half_tile(y_s, 0) + r * d : acc + l * 2 * d;
      const float* src_g = kW2 ? half_tile(y_s, 1) + r * d : acc + l * 2 * d + d;
      float gate[kPerLane];
      gate_row(src_c, src_g, lp, d, lane, gate);
      const float m = kMsg ? mask[l] : 0.f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int e = lane + 32 * i;
        if (e >= d) continue;
        out[l * d + e] = kMsg ? gate[i] * weights[l * d + e] * m
                              : gate[i] + resnet[l * d + e];
      }
    }
  }
}


// ------------------------------------------------- forward + segment sum
// out[n] = sum over rows l of segment n of message(acc, weights, mask)[l],
// the segments given as CSR offsets [n_out + 1] of the stream's sorted keys:
// rows offsets[n] .. offsets[n + 1] feed output row n, rows past
// offsets[n_out] (dropped keys) are never read. The mask multiplies inside
// the sum: a masked row whose key stays in range adds exactly zero.
//
// Bound: the forward tail's, less the [L, D] message stream, which never
// reaches device memory: by bytes where the output is long (angles into
// edges), by operations where it is short (edges into atoms). The sum phase
// below keeps d of the block's 256 threads busy behind a fourth barrier per
// tile: the first suspect for the distance to that bound.
// Design: no float atomics. The output rows are
// cut into one contiguous range per block, balanced by
// cost(n) = kRowCost * offsets[n] + n (input rows weigh kRowCost output
// rows, so the empty segments of the padding are shared out too); a block
// finds its range by two binary searches and owns the contiguous input rows
// offsets[n0] .. offsets[n1] that feed it. It walks them in 32-row tiles
// with the forward tail's phases, leaves the tile's messages in shared
// memory (over h_s, which the product has consumed) and lets one thread per
// column add them in row order into the open segment, writing each output
// row once when its segment closes. Two runs give equal bits. The add order
// differs from segment_sum_csr's lane-group tree, so the two agree only to
// rounding.
constexpr int kRowCost = 8;

// first n in [0, n_out] with kRowCost * offsets[n] + n >= x (n_out if none)
__device__ __forceinline__ int cost_lower_bound(const int* __restrict__ offsets,
                                                int n_out, long x) {
  int lo = 0, hi = n_out;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long)kRowCost * offsets[mid] + mid >= x) hi = mid; else lo = mid + 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    tail_reduce_kernel(Tail t, const float* __restrict__ acc,
                       const float* __restrict__ weights,
                       const float* __restrict__ mask,
                       const int* __restrict__ offsets, float* __restrict__ out,
                       int n_out, int d) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [2][D][D]
  float* h_s = w_s + kWeights;                   // 2 half tiles, then messages
  float* y_s = h_s + 2 * kHalf;                  // 2 half tiles
  const long total = (long)kRowCost * offsets[n_out] + n_out;
  const long chunk = (total + gridDim.x - 1) / gridDim.x;
  const int n0 = cost_lower_bound(offsets, n_out, chunk * blockIdx.x);
  const int n1 = blockIdx.x + 1 == gridDim.x
                     ? n_out
                     : cost_lower_bound(offsets, n_out, chunk * (blockIdx.x + 1));
  if (n0 >= n1) return;  // block-uniform
  const int row_end = offsets[n1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  LaneParams lp;
  lp.load(t, d, lane);
  float b[4];
  load_bias(t, d, lane, b);
  stage_weights(w_s, t, d, false);
  // the open segment of this thread's column (threads < d)
  int n = n0;
  int seg_end = offsets[n0 + 1];
  float sum = 0.f;
  for (int row0 = offsets[n0]; row0 < row_end; row0 += kTile) {
    __syncthreads();  // weights staged, the previous tile's messages summed
    load_silu(acc, h_s, row0, row_end, d);
    __syncthreads();
    float y[kRowsPerWarp][4];
    tile_product(h_s, w_s, d, warp, lane, y);
    store_y(y_s, y, b, d, warp, lane);
    __syncthreads();  // y_s written, h_s consumed
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const long l = (long)row0 + r;
      if (l >= row_end) break;  // warp-uniform
      float gate[kPerLane];
      gate_row(half_tile(y_s, 0) + r * d, half_tile(y_s, 1) + r * d, lp, d, lane,
               gate);
      const float m = mask[l];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int e = lane + 32 * i;
        if (e < d) h_s[r * d + e] = gate[i] * weights[l * d + e] * m;
      }
    }
    __syncthreads();  // the tile's messages in h_s
    if (threadIdx.x < d) {
      const int rows = row_end - row0 < kTile ? row_end - row0 : kTile;
      for (int r = 0; r < rows; ++r) {
        while (row0 + r >= seg_end) {  // close segments, empty ones too
          out[(long)n * d + threadIdx.x] = sum;
          sum = 0.f;
          ++n;
          seg_end = offsets[n + 1];
        }
        sum += h_s[r * d + threadIdx.x];
      }
    }
  }
  if (threadIdx.x < d)
    for (; n < n1; ++n) {
      out[(long)n * d + threadIdx.x] = sum;
      sum = 0.f;
    }
}


// ------------------------------------------------------------ backward
template <bool kMsg, bool kW2, bool kParams>
__global__ void __launch_bounds__(kThreads)
    tail_bwd_kernel(Tail t, const float* __restrict__ acc,
                    const float* __restrict__ weights,
                    const float* __restrict__ mask,
                    const float* __restrict__ g, float* __restrict__ d_acc,
                    float* __restrict__ d_weights, float* __restrict__ d_mask,
                    float* __restrict__ partial, int n_rows, int d) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [2][D][D]
  float* wt_s = w_s + (kW2 ? kWeights : 0);      // [2][D][D] transposed
  float* h_s = wt_s + (kW2 ? kWeights : 0);      // 2 half tiles
  float* y_s = h_s + 2 * kHalf;                  // y, then d_y in place
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  LaneParams lp;
  lp.load(t, d, lane);
  float b[4];
  if (kW2) {
    load_bias(t, d, lane, b);
    stage_weights(w_s, t, d, false);
    stage_weights(wt_s, t, d, true);
  }
  // this block's parameter gradients: per-lane vectors (ncs, ncb, ngs, ngb,
  // b2 core, b2 gate) and this thread's 8 x 4 entries of dW2 (half
  // threadIdx / 128, rows k0.., columns c0..)
  float pv[kVecs][kPerLane];
  float pw[8][4];
  const int w_half = threadIdx.x >> 7;
  const int k0 = ((threadIdx.x & 127) >> 4) * 8;
  const int c0 = (threadIdx.x & 15) * 4;
  if (kParams) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q)
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) pv[q][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) pw[i][0] = pw[i][1] = pw[i][2] = pw[i][3] = 0.f;
  }
  const int n_tiles = (n_rows + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long row0 = (long)tile * kTile;
    if (kW2) {
      __syncthreads();  // weights staged, the previous tile consumed
      load_silu(acc, h_s, row0, n_rows, d);
      __syncthreads();
      float y[kRowsPerWarp][4];
      tile_product(h_s, w_s, d, warp, lane, y);
      store_y(y_s, y, b, d, warp, lane);
      __syncthreads();
    }
    // row phase, one warp per row (_bwd_math :150, _bwd_math_nw :690)
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const long l = row0 + r;
      float* yc_s = half_tile(y_s, 0) + r * d;
      float* yg_s = half_tile(y_s, 1) + r * d;
      if (l >= n_rows) {  // warp-uniform; a zero d_y adds nothing to dW2
        if (kW2) {
          const float zero[kPerLane] = {};
          store_lane(yc_s, d, lane, zero);
          store_lane(yg_s, d, lane, zero);
        }
        continue;
      }
      float yc[kPerLane], yg[kPerLane], zc[kPerLane], zg[kPerLane];
      float invc, invg;
      load_lane(kW2 ? yc_s : acc + l * 2 * d, d, lane, yc);
      load_lane(kW2 ? yg_s : acc + l * 2 * d + d, d, lane, yg);
      ln_parts(yc, d, lane, zc, invc);
      ln_parts(yg, d, lane, zg, invg);
      float gv[kPerLane], wv[kPerLane], d_cn[kPerLane], d_gn[kPerLane];
      load_lane(g + l * d, d, lane, gv);  // zero past D, and so is all below
      if (kMsg) load_lane(weights + l * d, d, lane, wv);
      const float m = kMsg ? mask[l] : 1.f;
      float mask_part = 0.f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const float cn = fmaf(zc[i], lp.ncs[i], lp.ncb[i]);
        const float gn = fmaf(zg[i], lp.ngs[i], lp.ngb[i]);
        const float silu_cn = silu(cn);
        const float sig_gn = sigm(gn);
        float up = gv[i];
        if (kMsg) {
          mask_part = fmaf(gv[i], silu_cn * sig_gn * wv[i], mask_part);
          up = gv[i] * wv[i] * m;
          wv[i] = gv[i] * silu_cn * sig_gn * m;  // d_weights
        }
        d_cn[i] = up * sig_gn * silu_grad(cn);
        d_gn[i] = up * silu_cn * sig_gn * (1.f - sig_gn);
      }
      if (kMsg) {
        store_lane(d_weights + l * d, d, lane, wv);
        if (d_mask != nullptr) {
          const float dm = warp_sum(mask_part);
          if (lane == 0) d_mask[l] = dm;
        }
      }
      float dyc[kPerLane], dyg[kPerLane];
      ln_bwd(d_cn, zc, invc, lp.ncs, d, lane, dyc);
      ln_bwd(d_gn, zg, invg, lp.ngs, d, lane, dyg);
      if (kParams) {
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          pv[0][i] = fmaf(d_cn[i], zc[i], pv[0][i]);
          pv[1][i] += d_cn[i];
          pv[2][i] = fmaf(d_gn[i], zg[i], pv[2][i]);
          pv[3][i] += d_gn[i];
          pv[4][i] += dyc[i];
          pv[5][i] += dyg[i];
        }
      }
      if (kW2) {
        store_lane(yc_s, d, lane, dyc);
        store_lane(yg_s, d, lane, dyg);
      } else {
        store_lane(d_acc + l * 2 * d, d, lane, dyc);
        store_lane(d_acc + l * 2 * d + d, d, lane, dyg);
      }
    }
    if (kW2) {
      __syncthreads();  // d_y of every row in y_s
      float dh[kRowsPerWarp][4];
      tile_product(y_s, wt_s, d, warp, lane, dh);  // d_h = d_y @ W2^T
      const int col = 4 * lane;
      if (col < 2 * d) {
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const long l = row0 + warp * kRowsPerWarp + rr;
          if (l >= n_rows) break;
          const float4 a = *reinterpret_cast<const float4*>(acc + l * 2 * d + col);
          *reinterpret_cast<float4*>(d_acc + l * 2 * d + col) = make_float4(
              dh[rr][0] * silu_grad(a.x), dh[rr][1] * silu_grad(a.y),
              dh[rr][2] * silu_grad(a.z), dh[rr][3] * silu_grad(a.w));
        }
      }
      if (kParams && k0 < d && c0 < d) {  // dW2 += h^T @ d_y, rows in order
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
    }
  }
  if (!kParams) return;
  // this block's row of partial: [dW2c, dW2g (D x D each), db2 (2D)] with
  // w2, then ncs, ncb, ngs, ngb; the warps' vectors summed in warp order
  __syncthreads();
  float* red = h_s;  // [kWarps][kVecs][kMaxD]
#pragma unroll
  for (int q = 0; q < kVecs; ++q)
    store_lane(red + (warp * kVecs + q) * kMaxD, d, lane, pv[q]);
  __syncthreads();
  const int n_w = kW2 ? 2 * d * d : 0;
  const int n_part = (kW2 ? n_w + 2 * d : 0) + 4 * d;
  float* out = partial + (long)blockIdx.x * n_part;
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
    if (!kW2 && q >= 4) continue;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[(w * kVecs + q) * kMaxD + e];
    out[q >= 4 ? n_w + (q - 4) * d + e : n_part - 4 * d + q * d + e] = s;
  }
}

// out[j] = sum over blocks b, in order, of partial[b][j]
__global__ void sum_blocks_kernel(const float* __restrict__ partial,
                                  int n_blocks, int n_part,
                                  float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_part) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(long)b * n_part + j];
  out[j] = s;
}

using FwdFn = void (*)(Tail, const float*, const float*, const float*,
                       const float*, float*, int, int);
using BwdFn = void (*)(Tail, const float*, const float*, const float*,
                       const float*, float*, float*, float*, float*, int, int);
using ReduceFn = void (*)(Tail, const float*, const float*, const float*,
                          const int*, float*, int, int);

size_t fwd_smem(bool w2) { return w2 ? (kWeights + 4 * kHalf) * sizeof(float) : 0; }

size_t bwd_smem(bool w2, bool params) {
  if (w2) return (2 * kWeights + 4 * kHalf) * sizeof(float);
  return params ? kWarps * kVecs * kMaxD * sizeof(float) : 0;
}

// One instantiation: its dynamic shared memory and, per device, the blocks
// of one full wave (0 until first found).
template <typename Fn>
struct Kernel {
  Fn fn;
  size_t smem;
  std::atomic<int>* waves;
};

template <bool kMsg, bool kW2>
Kernel<FwdFn> fwd_instance() {
  static std::atomic<int> waves[kMaxDevices];
  return {tail_fwd_kernel<kMsg, kW2>, fwd_smem(kW2), waves};
}

template <bool kMsg, bool kW2, bool kParams>
Kernel<BwdFn> bwd_instance() {
  static std::atomic<int> waves[kMaxDevices];
  return {tail_bwd_kernel<kMsg, kW2, kParams>, bwd_smem(kW2, kParams), waves};
}

Kernel<FwdFn> fwd_kernel(bool msg, bool w2) {
  if (msg) return fwd_instance<true, true>();
  return w2 ? fwd_instance<false, true>() : fwd_instance<false, false>();
}

Kernel<BwdFn> bwd_kernel(bool msg, bool w2, bool params) {
  if (msg)
    return params ? bwd_instance<true, true, true>()
                  : bwd_instance<true, true, false>();
  if (w2)
    return params ? bwd_instance<false, true, true>()
                  : bwd_instance<false, true, false>();
  return params ? bwd_instance<false, false, true>()
                : bwd_instance<false, false, false>();
}

// Blocks of one full wave of k on the current device: its SMs times the
// blocks k's occupancy allows on each. Found once per instantiation and
// device, when k's shared memory limit is also set; negative: minus a
// cudaError_t.
template <typename Fn>
int wave_blocks(const Kernel<Fn>& k) {
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k.fn, kThreads,
                                                        k.smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  blocks = err == cudaSuccess ? chgnet::sm_count() * per_sm : -(int)err;
  k.waves[dev].store(blocks, std::memory_order_relaxed);
  return blocks;
}

int n_tiles(int n_rows) { return (n_rows + kTile - 1) / kTile; }

Tail make_tail(const void* const* p) {
  return Tail{static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
              static_cast<const float*>(p[2]), static_cast<const float*>(p[3]),
              static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
              static_cast<const float*>(p[6])};
}

bool bad_shape(bool msg, bool w2, int d) {
  return d < 4 || d > kMaxD || d % 4 || (msg && !w2);
}

}  // namespace

// tail: 7 pointers (w2c, w2g, b2, nc_scale, nc_bias, ng_scale, ng_bias),
// the first three null for an update without a second layer. msg = 1:
// out = message(acc, weights, mask); msg = 0: out = update(acc) + resnet.
// acc [n_rows, 2d] 16-byte aligned; every tensor contiguous f32. One block
// per 32-row tile, at most one wave.
extern "C" int gated_fwd_f32(int msg, const void* const* tail, const float* acc,
                             const float* weights, const float* mask,
                             const float* resnet, float* out, int n_rows,
                             int d, void* cuda_stream) {
  const Tail t = make_tail(tail);
  const bool w2 = t.w2c != nullptr;
  if (bad_shape(msg, w2, d)) return (int)cudaErrorInvalidValue;
  if (n_rows > 0) {
    const Kernel<FwdFn> k = fwd_kernel(msg, w2);
    const int wave = wave_blocks(k);
    if (wave < 0) return -wave;
    const int grid = n_tiles(n_rows) < wave ? n_tiles(n_rows) : wave;
    k.fn<<<grid, kThreads, k.smem, static_cast<cudaStream_t>(cuda_stream)>>>(
        t, acc, weights, mask, resnet, out, n_rows, d);
  }
  return (int)cudaGetLastError();
}

// d_acc [n_rows, 2d] (16-byte aligned, as acc), and for msg = 1 d_weights
// [n_rows, d] and, unless null, d_mask [n_rows]; grid as the forward's.
// With d_params non-null the parameter gradients too, by exactly n_blocks =
// min(tiles, kParamBlocks) blocks, one row each of partial [n_blocks,
// n_part]: d_params [n_part] = dW2c, dW2g, db2 (with w2), d nc_scale,
// d nc_bias, d ng_scale, d ng_bias.
extern "C" int gated_bwd_f32(int msg, const void* const* tail, const float* acc,
                             const float* weights, const float* mask,
                             const float* g, float* d_acc, float* d_weights,
                             float* d_mask, float* partial, float* d_params,
                             int n_rows, int d, int n_blocks,
                             void* cuda_stream) {
  const Tail t = make_tail(tail);
  const bool w2 = t.w2c != nullptr;
  const bool params = d_params != nullptr;
  const int tiles = n_rows > 0 ? n_tiles(n_rows) : 0;
  if (bad_shape(msg, w2, d) ||
      (params && n_blocks != (tiles < kParamBlocks ? tiles : kParamBlocks)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  if (n_rows > 0) {
    const Kernel<BwdFn> k = bwd_kernel(msg, w2, params);
    const int wave = wave_blocks(k);
    if (wave < 0) return -wave;
    const int grid = params ? n_blocks : (tiles < wave ? tiles : wave);
    k.fn<<<grid, kThreads, k.smem, stream>>>(t, acc, weights, mask, g, d_acc,
                                             d_weights, d_mask, partial, n_rows,
                                             d);
  }
  if (params) {
    const int n_part = (w2 ? 2 * d * d + 2 * d : 0) + 4 * d;
    sum_blocks_kernel<<<(n_part + 255) / 256, 256, 0, stream>>>(
        partial, n_blocks, n_part, d_params);
  }
  return (int)cudaGetLastError();
}

// out [n_out, d] = the message tail's rows summed per segment of the sorted
// stream: offsets [n_out + 1] int32, offsets[n_out] <= n_rows valid rows
// first. One block per kRowCost * n_rows + n_out cost units of a 32-row
// tile, at most one wave.
extern "C" int gated_reduce_f32(const void* const* tail, const float* acc,
                                const float* weights, const float* mask,
                                const int* offsets, float* out, int n_rows,
                                int n_out, int d, void* cuda_stream) {
  const Tail t = make_tail(tail);
  if (bad_shape(true, t.w2c != nullptr, d)) return (int)cudaErrorInvalidValue;
  if (n_out > 0) {
    static std::atomic<int> waves[kMaxDevices];
    const Kernel<ReduceFn> k{tail_reduce_kernel, fwd_smem(true), waves};
    const int wave = wave_blocks(k);
    if (wave < 0) return -wave;
    const long cost = (long)kRowCost * n_rows + n_out;
    const long want = (cost + kRowCost * kTile - 1) / (kRowCost * kTile);
    const int grid = want < wave ? (int)want : wave;
    k.fn<<<grid, kThreads, k.smem, static_cast<cudaStream_t>(cuda_stream)>>>(
        t, acc, weights, mask, offsets, out, n_out, d);
  }
  return (int)cudaGetLastError();
}
