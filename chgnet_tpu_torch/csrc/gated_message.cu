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
#include "gated_tail.cuh"

namespace {

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
  ParamSums ps;  // this block's parameter gradients
  if (kParams) ps.clear();
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
      RowGrads o;
      gate_row_bwd<kMsg>(kW2 ? yc_s : acc + l * 2 * d,
                         kW2 ? yg_s : acc + l * 2 * d + d, g + l * d,
                         kMsg ? weights + l * d : nullptr, kMsg ? mask[l] : 1.f,
                         lp, d, lane, o);
      if (kMsg) {
        store_lane(d_weights + l * d, d, lane, o.dw);
        if (d_mask != nullptr) {
          const float dm = warp_sum(o.mask_part);
          if (lane == 0) d_mask[l] = dm;
        }
      }
      if (kParams) ps.add_row(o);
      if (kW2) {
        store_lane(yc_s, d, lane, o.dyc);
        store_lane(yg_s, d, lane, o.dyg);
      } else {
        store_lane(d_acc + l * 2 * d, d, lane, o.dyc);
        store_lane(d_acc + l * 2 * d + d, d, lane, o.dyg);
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
      if (kParams) ps.add_tile(h_s, y_s, d);
    }
  }
  if (!kParams) return;
  // this block's row of partial: [dW2c, dW2g (D x D each), db2 (2D)] with
  // w2, then ncs, ncb, ngs, ngb
  __syncthreads();  // the last tile consumed: h_s is free
  const int n_w = kW2 ? 2 * d * d : 0;
  const int n_part = (kW2 ? n_w + 2 * d : 0) + 4 * d;
  ps.store<kW2>(h_s, partial + (long)blockIdx.x * n_part, n_part - 4 * d,
                kW2 ? n_w : -1, d, warp, lane);
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
