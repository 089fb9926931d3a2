// One-kernel conv-layer pass, forward and backward: the first-layer sum of
// K gathered, already projected tables, an aligned stream and the bias, and
// the gated-MLP tail on it, without the accumulator ever reaching device
// memory:
//
//     acc = sum_k T_k[idx_k[l]] + aligned[l] + b1          acc [L, 2D] f32
//     out = tail(acc)        (message: * weights * mask; update: + resnet)
//
// with the tail of gated_message.cu (y = silu(acc) @ blockdiag(W2c, W2g) +
// b2, or y = acc without a second layer; per-half layer norms; silu * sigmoid).
//
// Replaces chgnet_tpu/ops/fused_pass.py _kernel (:157, wrapper
// _fused_pass_pallas :219) -> pass_fwd_kernel, and _bwd_kernel (:393,
// wrapper _pass_bwd_pallas :526) -> pass_bwd_kernel. The TPU kernels DMA a
// source window per part and output block and reduce it with one-hot MXU
// matmuls; here a thread loads its 16-byte unit of each part's row.
//
// Bound: a message row reads K index entries, K table rows of 2D floats
// (short tables stay in L2 and come from device memory once), the aligned
// row, D weights and the mask, and writes D floats, against 4 D^2 FLOPs of
// the two diagonal blocks plus the tail's elementwise work: bytes, forward.
// The backward gathers the same rows again, reads the cotangent and writes
// d_total [L, 2D] and d_weights: with a second layer it is bound by
// operations, as the message backward is.
// Design: 256 threads walk 32-row tiles. Thread (warp, lane) owns rows
// 4 warp .. 4 warp + 3 and columns 4 lane .. 4 lane + 3 of the tile: it
// loads its K indices, then its K float4 units, and adds from zero in part
// order, then the aligned unit, then the bias (the order of the plain
// version). The 16 sums stay in registers; silu(acc) (or acc itself without
// a second layer) goes to shared memory in the tails' half-tile layout, and
// from there the phases are the tails' own (gated_tail.cuh): the 4 x 4
// register tile of the two diagonal blocks, one warp per row for the norms
// and the gate. Every phase of a tile reads only what the same warp wrote,
// so the serving kernels order their phases with __syncwarp; the
// parameter-gradient mode, whose dW2 sum reads all 32 rows, uses block
// barriers. The backward multiplies d_h by silu'(acc) from the registers, so
// acc is not gathered twice. Parameter gradients, d_b1 = sum of d_total
// among them, go through the fixed kParamBlocks scratch rows and
// sum_blocks_kernel: no float atomics, equal bits on every run.
#include "gated_tail.cuh"

namespace {

constexpr int kMaxParts = 3;  // gathered parts of one launch

struct Parts {
  const float* table[kMaxParts];  // [n_src, 2D]
  const int* idx[kMaxParts];      // [L]
  int n_src[kMaxParts];
  int n_parts;
  const float* aligned;  // [L, 2D] or null
  const float* b1;       // [2D]
};

template <bool kBlock>
__device__ __forceinline__ void tile_sync() {
  if (kBlock) __syncthreads(); else __syncwarp();
}

// acc[j] = columns 4 lane .. + 3 of row row0 + 4 warp + j of the first-layer
// sum; zero past n_rows and past 2D. A row whose index lies outside its
// table adds zero, as in gather_sum_rows.
__device__ __forceinline__ void build_acc(const Parts& p, long row0, int n_rows,
                                          int d, int warp, int lane,
                                          float4 acc[kRowsPerWarp]) {
  const int col = 4 * lane;
  const bool live = col < 2 * d;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 bias = live ? __ldg(reinterpret_cast<const float4*>(p.b1 + col)) : zero;
  int s[kRowsPerWarp][kMaxParts];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const long l = row0 + warp * kRowsPerWarp + j;
#pragma unroll
    for (int k = 0; k < kMaxParts; ++k)
      s[j][k] = (live && l < n_rows && k < p.n_parts) ? __ldg(p.idx[k] + l) : -1;
  }
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const long l = row0 + warp * kRowsPerWarp + j;
    float4 v[kMaxParts];
#pragma unroll
    for (int k = 0; k < kMaxParts; ++k)
      v[k] = (s[j][k] >= 0 && s[j][k] < p.n_src[k])
                 ? __ldg(reinterpret_cast<const float4*>(
                       p.table[k] + (long)s[j][k] * 2 * d + col))
                 : zero;
    float4 a = zero;
    if (live && l < n_rows) {
#pragma unroll
      for (int k = 0; k < kMaxParts; ++k)
        if (k < p.n_parts) chgnet::vadd(a, v[k]);
      if (p.aligned != nullptr)
        chgnet::vadd(a, __ldg(reinterpret_cast<const float4*>(
                            p.aligned + l * 2 * d + col)));
      chgnet::vadd(a, bias);
    }
    acc[j] = a;
  }
}

// the warp's rows of buf (two half tiles) = acc, or silu(acc) with act
__device__ __forceinline__ void store_acc(float* buf,
                                          const float4 acc[kRowsPerWarp], int d,
                                          int warp, int lane, bool act) {
  const int col = 4 * lane;
  if (col >= 2 * d) return;
  const int half = col >= d;
  float* dst = half_tile(buf, half) + warp * kRowsPerWarp * d + (col - half * d);
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    float4 v = acc[j];
    if (act) v = make_float4(silu(v.x), silu(v.y), silu(v.z), silu(v.w));
    *reinterpret_cast<float4*>(dst + j * d) = v;
  }
}

// ------------------------------------------------------------- forward
template <bool kMsg, bool kW2>
__global__ void __launch_bounds__(kThreads)
    pass_fwd_kernel(Tail t, Parts p, const float* __restrict__ weights,
                    const float* __restrict__ mask,
                    const float* __restrict__ resnet, float* __restrict__ out,
                    int n_rows, int d) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [2][D][D] with W2
  float* h_s = w_s + (kW2 ? kWeights : 0);       // 2 half tiles with W2
  float* y_s = h_s + (kW2 ? 2 * kHalf : 0);      // 2 half tiles
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  LaneParams lp;
  lp.load(t, d, lane);
  float b[4];
  if (kW2) {
    load_bias(t, d, lane, b);
    stage_weights(w_s, t, d, false);
    __syncthreads();
  }
  const int tiles = (n_rows + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * kTile;
    float4 acc[kRowsPerWarp];
    build_acc(p, row0, n_rows, d, warp, lane, acc);
    __syncwarp();  // the previous tile's y_s rows of this warp are read
    store_acc(kW2 ? h_s : y_s, acc, d, warp, lane, kW2);
    __syncwarp();
    if (kW2) {
      float y[kRowsPerWarp][4];
      tile_product(h_s, w_s, d, warp, lane, y);
      store_y(y_s, y, b, d, warp, lane);
      __syncwarp();
    }
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const long l = row0 + r;
      if (l >= n_rows) break;  // warp-uniform
      float gate[kPerLane];
      gate_row(half_tile(y_s, 0) + r * d, half_tile(y_s, 1) + r * d, lp, d, lane,
               gate);
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

// ------------------------------------------------------------ backward
template <bool kMsg, bool kW2, bool kParams>
__global__ void __launch_bounds__(kThreads)
    pass_bwd_kernel(Tail t, Parts p, const float* __restrict__ weights,
                    const float* __restrict__ mask, const float* __restrict__ g,
                    float* __restrict__ d_total, float* __restrict__ d_weights,
                    float* __restrict__ d_mask, float* __restrict__ partial,
                    int n_rows, int d) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [2][D][D] with W2
  float* wt_s = w_s + (kW2 ? kWeights : 0);      // [2][D][D] transposed
  float* h_s = wt_s + (kW2 ? kWeights : 0);      // 2 half tiles with W2
  float* y_s = h_s + (kW2 ? 2 * kHalf : 0);      // y, then d_y in place
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = 4 * lane;
  LaneParams lp;
  lp.load(t, d, lane);
  float b[4];
  if (kW2) {
    load_bias(t, d, lane, b);
    stage_weights(w_s, t, d, false);
    stage_weights(wt_s, t, d, true);
    __syncthreads();
  }
  // this block's parameter gradients: the tails' sums, and with W2 this
  // thread's 4 columns of d_b1 = sum of d_total (without W2 d_total is d_y,
  // whose sums are the tails' vectors 4 and 5)
  ParamSums ps;
  float pb[4] = {0.f, 0.f, 0.f, 0.f};
  if (kParams) ps.clear();
  const int tiles = (n_rows + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * kTile;
    float4 acc[kRowsPerWarp];
    build_acc(p, row0, n_rows, d, warp, lane, acc);
    tile_sync<kParams>();  // the previous tile consumed
    store_acc(kW2 ? h_s : y_s, acc, d, warp, lane, kW2);
    tile_sync<kParams>();
    if (kW2) {
      float y[kRowsPerWarp][4];
      tile_product(h_s, w_s, d, warp, lane, y);
      store_y(y_s, y, b, d, warp, lane);
      tile_sync<kParams>();
    }
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
      gate_row_bwd<kMsg>(yc_s, yg_s, g + l * d, kMsg ? weights + l * d : nullptr,
                         kMsg ? mask[l] : 1.f, lp, d, lane, o);
      if (kMsg) {
        store_lane(d_weights + l * d, d, lane, o.dw);
        if (d_mask != nullptr) {
          const float dm = warp_sum(o.mask_part);
          if (lane == 0) d_mask[l] = dm;
        }
      }
      if (kParams) ps.add_row(o);
      if (kW2) {  // over y: a lane reads, then writes, its own elements
        store_lane(yc_s, d, lane, o.dyc);
        store_lane(yg_s, d, lane, o.dyg);
      } else {
        store_lane(d_total + l * 2 * d, d, lane, o.dyc);
        store_lane(d_total + l * 2 * d + d, d, lane, o.dyg);
      }
    }
    if (kW2) {
      tile_sync<kParams>();  // d_y of every row in y_s
      float dh[kRowsPerWarp][4];
      tile_product(y_s, wt_s, d, warp, lane, dh);  // d_h = d_y @ W2^T
      if (col < 2 * d) {
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const long l = row0 + warp * kRowsPerWarp + rr;
          if (l >= n_rows) break;
          const float4 a = acc[rr];
          const float4 dt = make_float4(
              dh[rr][0] * silu_grad(a.x), dh[rr][1] * silu_grad(a.y),
              dh[rr][2] * silu_grad(a.z), dh[rr][3] * silu_grad(a.w));
          *reinterpret_cast<float4*>(d_total + l * 2 * d + col) = dt;
          if (kParams) {
            pb[0] += dt.x;
            pb[1] += dt.y;
            pb[2] += dt.z;
            pb[3] += dt.w;
          }
        }
      }
      if (kParams) ps.add_tile(h_s, y_s, d);
    }
  }
  if (!kParams) return;
  // this block's row of partial: [dW2c, dW2g (D x D each), db2 (2D)] with
  // W2, then ncs, ncb, ngs, ngb (D each), then d_b1 (2D): with W2 the
  // warps' column sums of d_total, added in warp order; without it d_total
  // is d_y, whose sums the vectors hold
  __syncthreads();  // the last tile consumed: the tiles are free
  float* red = kW2 ? h_s : y_s;                // [kWarps][kVecs][kMaxD]
  float* redb = red + kWarps * kVecs * kMaxD;  // [kWarps][2 kMaxD] with W2
  if (kW2 && col < 2 * d) {
#pragma unroll
    for (int j = 0; j < 4; ++j) redb[warp * 2 * kMaxD + col + j] = pb[j];
  }
  const int n_w = kW2 ? 2 * d * d : 0;
  const int n_part = (kW2 ? n_w + 2 * d : 0) + 6 * d;
  float* out = partial + (long)blockIdx.x * n_part;
  ps.store<kW2>(red, out, n_part - 6 * d, kW2 ? n_w : n_part - 2 * d, d, warp,
                lane);
  if (kW2)
    for (int j = threadIdx.x; j < 2 * d; j += kThreads) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += redb[w * 2 * kMaxD + j];
      out[n_part - 2 * d + j] = s;
    }
}

using FwdFn = void (*)(Tail, Parts, const float*, const float*, const float*,
                       float*, int, int);
using BwdFn = void (*)(Tail, Parts, const float*, const float*, const float*,
                       float*, float*, float*, float*, int, int);

size_t fwd_smem(bool w2) {
  return (w2 ? kWeights + 4 * kHalf : 2 * kHalf) * sizeof(float);
}

size_t bwd_smem(bool w2) {
  return (w2 ? 2 * kWeights + 4 * kHalf : 2 * kHalf) * sizeof(float);
}

template <bool kMsg, bool kW2>
Kernel<FwdFn> fwd_instance() {
  static std::atomic<int> waves[kMaxDevices];
  return {pass_fwd_kernel<kMsg, kW2>, fwd_smem(kW2), waves};
}

template <bool kMsg, bool kW2, bool kParams>
Kernel<BwdFn> bwd_instance() {
  static std::atomic<int> waves[kMaxDevices];
  return {pass_bwd_kernel<kMsg, kW2, kParams>, bwd_smem(kW2), waves};
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

// false when the parts are not what the kernels take
bool make_parts(int n_parts, const void* const* tables, const void* const* idxs,
                const int* n_srcs, const float* aligned, const float* b1, int d,
                Parts* p) {
  if (n_parts < 1 || n_parts > kMaxParts || !chgnet::vec4_ok(b1, 2 * d) ||
      (aligned != nullptr && !chgnet::vec4_ok(aligned, 2 * d)))
    return false;
  for (int k = 0; k < kMaxParts; ++k) {
    const int j = k < n_parts ? k : 0;
    if (!chgnet::vec4_ok(tables[j], 2 * d)) return false;
    p->table[k] = static_cast<const float*>(tables[j]);
    p->idx[k] = static_cast<const int*>(idxs[j]);
    p->n_src[k] = n_srcs[j];
  }
  p->n_parts = n_parts;
  p->aligned = aligned;
  p->b1 = b1;
  return true;
}

}  // namespace

// tail: 7 pointers as in gated_fwd_f32. tables[k] [n_srcs[k], 2d] and idxs[k]
// [n_rows] int32 for the 1..3 gathered parts, aligned [n_rows, 2d] or null,
// b1 [2d]; tables, aligned and b1 16-byte aligned, every tensor contiguous
// f32. msg = 1: out = message(acc, weights, mask); msg = 0: out =
// update(acc) + resnet. One block per 32-row tile, at most one wave.
extern "C" int fused_pass_fwd_f32(int msg, const void* const* tail, int n_parts,
                                  const void* const* tables,
                                  const void* const* idxs, const int* n_srcs,
                                  const float* aligned, const float* b1,
                                  const float* weights, const float* mask,
                                  const float* resnet, float* out, int n_rows,
                                  int d, void* cuda_stream) {
  const Tail t = make_tail(tail);
  const bool w2 = t.w2c != nullptr;
  Parts p;
  if (bad_shape(msg, w2, d) ||
      !make_parts(n_parts, tables, idxs, n_srcs, aligned, b1, d, &p))
    return (int)cudaErrorInvalidValue;
  if (n_rows > 0) {
    const Kernel<FwdFn> k = fwd_kernel(msg, w2);
    const int wave = wave_blocks(k);
    if (wave < 0) return -wave;
    const int grid = n_tiles(n_rows) < wave ? n_tiles(n_rows) : wave;
    k.fn<<<grid, kThreads, k.smem, static_cast<cudaStream_t>(cuda_stream)>>>(
        t, p, weights, mask, resnet, out, n_rows, d);
  }
  return (int)cudaGetLastError();
}

// d_total [n_rows, 2d] (16-byte aligned), and for msg = 1 d_weights
// [n_rows, d] and, unless null, d_mask [n_rows]. With d_params non-null the
// parameter gradients too, by exactly n_blocks = min(tiles, kParamBlocks)
// blocks, one row each of partial [n_blocks, n_part]: d_params [n_part] =
// dW2c, dW2g, db2 (with w2), d nc_scale, d nc_bias, d ng_scale, d ng_bias,
// d_b1.
extern "C" int fused_pass_bwd_f32(int msg, const void* const* tail, int n_parts,
                                  const void* const* tables,
                                  const void* const* idxs, const int* n_srcs,
                                  const float* aligned, const float* b1,
                                  const float* weights, const float* mask,
                                  const float* g, float* d_total,
                                  float* d_weights, float* d_mask,
                                  float* partial, float* d_params, int n_rows,
                                  int d, int n_blocks, void* cuda_stream) {
  const Tail t = make_tail(tail);
  const bool w2 = t.w2c != nullptr;
  const bool params = d_params != nullptr;
  const int tiles = n_rows > 0 ? n_tiles(n_rows) : 0;
  Parts p;
  if (bad_shape(msg, w2, d) ||
      !make_parts(n_parts, tables, idxs, n_srcs, aligned, b1, d, &p) ||
      !chgnet::vec4_ok(d_total, 2 * d) ||
      (params && n_blocks != (tiles < kParamBlocks ? tiles : kParamBlocks)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  if (n_rows > 0) {
    const Kernel<BwdFn> k = bwd_kernel(msg, w2, params);
    const int wave = wave_blocks(k);
    if (wave < 0) return -wave;
    const int grid = params ? n_blocks : (tiles < wave ? tiles : wave);
    k.fn<<<grid, kThreads, k.smem, stream>>>(t, p, weights, mask, g, d_total,
                                             d_weights, d_mask, partial, n_rows,
                                             d);
  }
  if (params) {
    const int n_part = (w2 ? 2 * d * d + 2 * d : 0) + 6 * d;
    sum_blocks_kernel<<<(n_part + 255) / 256, 256, 0, stream>>>(
        partial, n_blocks, n_part, d_params);
  }
  return (int)cudaGetLastError();
}
