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
// backward), and a fifth, _reduce_kernel (:378, _reduce_pallas :426): the
// message tail and the sorted segment sum of its rows in one sweep (see
// tail_reduce_tc_kernel). The per-row layer norms and gating are the same
// arithmetic in every kernel, so the five cannot drift apart.
//
// Bound: a message row moves 2D + D + 1 floats in and D out (the backward
// 2D + 2D + 1 in, 2D + D out) against 4 D^2 FLOPs of the block-diagonal
// product (8 D^2 in the backward) plus the elementwise work of the norms and
// gates. At D = 64, with the products at the tensor cores' f32-accurate
// rate (3xTF32), the tails are bound by bytes.
// Design of the message forward, the message-reduce and the serving
// backward: tail_fwd_tc_kernel, tail_reduce_tc_kernel and
// tail_bwd_tc_kernel (namespace tcb below), on tensor cores with
// asynchronous copies and warp-local tiles.
// Design of the update forward without a second layer: update_fwd_kernel,
// a row per group of lanes with 16-byte loads.
// Design of the update forward with a second layer and the backward with
// parameter gradients: f32 FMAs throughout, no TF32. A block stages W2c
// and W2g (and their transposes in the backward, 16 KB each at D = 64) in
// dynamic shared memory once, then walks 32-row tiles: it loads the tile's
// acc rows as float4, keeps h = silu(acc) in shared memory, and each of 256
// threads computes a 4-row x 4-column register tile of the two diagonal blocks
// only (half the FLOPs of the dense 2D x 2D product). The row phase gives
// each row to one warp: two-pass layer norms (mean, then the centred
// variance) by warp shuffles, the gating, and in the backward the
// layer-norm backward; the ragged last tile is masked, nothing is padded.
// Parameter gradients (the backward's optional mode) are summed per block
// in a fixed order into a [blocks, n_part] scratch buffer (a fixed number
// of blocks, kParamBlocks), which a second kernel reduces over the blocks in
// order: no float atomics, and the result repeats bit for bit.
// bf16 (compute_dtype="bfloat16", the _bf16 entry points): the forward
// kernels and the serving backward are instantiated for bf16 acc, weights,
// mask, cotangent and parameters (T = __nv_bfloat16). Rows are widened to
// f32 as they are fetched (tc::fetch4 / fetch1: a load now where the f32
// kernels copy with cp.async, so the next tile's rows no longer arrive in
// the background), everything inside runs in f32 as before, and each output
// is rounded once at its store, as chgnet_tpu's kernels do ("streams may be
// bf16 -- in-kernel math runs in f32", ops/gated_message.py:588-590). The
// products keep f32 accuracy: their A operands, silu(acc) and d_y, are f32
// values, but a bf16 W2 is exact in TF32, so of 3xTF32's three passes the
// two whose terms are not zero remain (lo_a hi_b, hi_a hi_b: tc::mma2_tiles,
// the same sums). Half the bytes of f32 move. The message-reduce
// (tail_reduce_tc_kernel<bf16>) also keeps each tile's messages in f32 and
// sums every segment in f32, rounding each output row once. The backward
// with parameter gradients (tail_bwd_kernel<bf16, ...>, training) widens
// its rows and parameters the same way; its per-block partials stay f32,
// sum_blocks_kernel adds them in block order in f32 (no atomics) and rounds
// each parameter gradient once to bf16 (chgnet_tpu casts each tile's f32
// sums to the parameters' type and adds them there, ops/gated_message.py:
// 222-228, so it rounds once a tile). The update forward without a second
// layer (update_fwd_kernel<bf16, ...>) takes the gate's exponentials and
// quotients by the fast intrinsics, some 1e-6 relative in f32 before the
// output's bf16 rounding.
#include "gated_tail.cuh"
#include "tf32x3.cuh"

namespace {

// ------------------------------------------------------- update forward
// With a second layer: y = silu(acc) @ blockdiag(W2c, W2g) + b2 by the
// staged tile product, then one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    tail_fwd_kernel(TailT<T> t, const T* __restrict__ acc,
                    const T* __restrict__ resnet, T* __restrict__ out,
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
  load_bias(t, d, lane, b);
  stage_weights(w_s, t, d, false);
  const int n_tiles = (n_rows + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long row0 = (long)tile * kTile;
    __syncthreads();  // weights staged, the previous tile's y_s read
    load_silu(acc, h_s, row0, n_rows, d);
    __syncthreads();
    float y[kRowsPerWarp][4];
    tile_product(h_s, w_s, d, warp, lane, y);
    store_y(y_s, y, b, d, warp, lane);
    __syncthreads();
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const long l = row0 + r;
      if (l >= n_rows) break;  // warp-uniform
      float gate[kPerLane];
      gate_row(half_tile(y_s, 0) + r * d, half_tile(y_s, 1) + r * d, lp, d, lane,
               gate);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int e = lane + 32 * i;
        if (e < d)
          chgnet::store_v(out + l * d + e, gate[i] + chgnet::to_f(resnet[l * d + e]));
      }
    }
  }
}

// Without a second layer (y = acc, the default AngleUpdate): replaces
// _kernel_nw (gated_message.py:620). Bound by bytes: a row reads 2D + D
// values and writes D against 23 operations an element. A row is held by a
// group of gl lanes, kN neighbouring elements of each half a lane, loaded 16
// bytes at a time (8 for bf16 rows whose D is not a multiple of 8), so a
// warp holds 32 / gl rows (at D = 64: 2 rows in f32, 4 in bf16) and its
// loads move whole rows; the layer norms sum over the group (ln_norm). The
// warps are persistent, and each loads its next rows before it reduces and
// stores these, so a row's loads are in flight while the previous row's
// shuffles run. resnet is read by elements where it is not aligned to a
// load. With half the bytes of f32, the bf16 rows leave the gate's accurate
// exponentials and divisions (about 50 instructions an element) as the
// limit, so the bf16 instantiation takes gate_value's fast form (on an H100
// at 700 W, bench.py's two calls: 0.42 -> 0.29 ms against a 0.25 ms bound).
template <typename T, int kN>
struct UpdateRows {  // a lane's part of one row, as loaded
  Pack<T, kN> c, g, res;
};

template <typename T, int kN>
__device__ __forceinline__ void load_update_rows(UpdateRows<T, kN>& r, const T* acc,
                                                 const T* resnet, long l, int d,
                                                 int e0, bool vec_res) {
  using P = Pack<T, kN>;
  r.c = *reinterpret_cast<const P*>(acc + l * 2 * d + e0);
  r.g = *reinterpret_cast<const P*>(acc + l * 2 * d + d + e0);
  if (vec_res) {
    r.res = *reinterpret_cast<const P*>(resnet + l * d + e0);
  } else {
    T* e = reinterpret_cast<T*>(&r.res);
#pragma unroll
    for (int i = 0; i < kN; ++i) e[i] = resnet[l * d + e0 + i];
  }
}

template <typename T, int kN>
__global__ void __launch_bounds__(kThreads)
    update_fwd_kernel(TailT<T> t, const T* __restrict__ acc,
                      const T* __restrict__ resnet, T* __restrict__ out,
                      int n_rows, int d, int vec_res) {
  const int lane = threadIdx.x & 31;
  const int vecs = d / kN;  // lanes a half row fills
  int gl = 1;               // lanes per row (power of two)
  while (gl < vecs) gl <<= 1;
  const int rows_per_warp = 32 / gl;
  const int u = lane % gl;
  const int e0 = u * kN;  // the lane's first element of each half
  const bool lane_in = u < vecs;
  bool in[kN];
  float ncs[kN], ncb[kN], ngs[kN], ngb[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    in[i] = lane_in;
    ncs[i] = lane_in ? chgnet::to_f(t.ncs[e0 + i]) : 0.f;
    ncb[i] = lane_in ? chgnet::to_f(t.ncb[e0 + i]) : 0.f;
    ngs[i] = lane_in ? chgnet::to_f(t.ngs[e0 + i]) : 0.f;
    ngb[i] = lane_in ? chgnet::to_f(t.ngb[e0 + i]) : 0.f;
  }
  const long warp0 = ((long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * rows_per_warp;
  const long stride = (long)gridDim.x * kWarps * rows_per_warp;
  const long sub = lane / gl;  // the lane's row of the warp's rows
  UpdateRows<T, kN> cur;
  long l = warp0 + sub;
  if (lane_in && l < n_rows) load_update_rows(cur, acc, resnet, l, d, e0, vec_res);
  for (long w0 = warp0; w0 < n_rows; w0 += stride) {
    UpdateRows<T, kN> next;
    const long ln = l + stride;
    if (lane_in && ln < n_rows) load_update_rows(next, acc, resnet, ln, d, e0, vec_res);
    float yc[kN], yg[kN], res[kN], zc[kN], zg[kN];
    float invc, invg;
    widen<T, kN>(cur.c, yc);
    widen<T, kN>(cur.g, yg);
    widen<T, kN>(cur.res, res);
    ln_norm<kN>(yc, in, d, gl, zc, invc);
    ln_norm<kN>(yg, in, d, gl, zg, invg);
    float o[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i)
      o[i] = gate_value<chgnet::is_bf16<T>>(zc[i], zg[i], ncs[i], ncb[i], ngs[i],
                                            ngb[i]) + res[i];
    if (lane_in && l < n_rows)
      *reinterpret_cast<Pack<T, kN>*>(out + l * d + e0) = narrow<T, kN>(o);
    cur = next;
    l = ln;
  }
}

// ------------------------------------------------------------ backward
template <typename T, bool kMsg, bool kW2, bool kParams>
__global__ void __launch_bounds__(kThreads)
    tail_bwd_kernel(TailT<T> t, const T* __restrict__ acc,
                    const T* __restrict__ weights,
                    const T* __restrict__ mask,
                    const T* __restrict__ g, T* __restrict__ d_acc,
                    T* __restrict__ d_weights, T* __restrict__ d_mask,
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
      const T* w_row = kMsg ? weights + l * d : nullptr;
      const float m = kMsg ? chgnet::to_f(mask[l]) : 1.f;
      if constexpr (kW2)
        gate_row_bwd<kMsg>(yc_s, yg_s, g + l * d, w_row, m, lp, d, lane, o);
      else
        gate_row_bwd<kMsg>(acc + l * 2 * d, acc + l * 2 * d + d, g + l * d, w_row, m,
                           lp, d, lane, o);
      if (kMsg) {
        store_lane(d_weights + l * d, d, lane, o.dw);
        if (d_mask != nullptr) {
          const float dm = warp_sum(o.mask_part);
          if (lane == 0) chgnet::store_v(d_mask + l, dm);
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
          float4 a;
          chgnet::load_v(a, acc + l * 2 * d + col);
          chgnet::store_v(d_acc + l * 2 * d + col,
                          make_float4(dh[rr][0] * silu_grad(a.x), dh[rr][1] * silu_grad(a.y),
                                      dh[rr][2] * silu_grad(a.z), dh[rr][3] * silu_grad(a.w)));
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


// -------------------------------------- backward on tensor cores (serving)
// The backward without parameter gradients, which serving runs: the
// function of tail_bwd_kernel, redesigned for Hopper.
//
// Bound: at D = 64 a message row moves 1,796 bytes against 2 x 4 D^2 FLOPs
// of products (1.0 ms for the default pass's 7 calls at 3xTF32) and 70
// elementwise operations per row element (0.34 ms): bytes (2.7 ms).
// Design: every warp is its own pipeline and owns 16 rows through every
// phase, so nothing in the tile loop waits on the block. Its next tile's
// acc rows are in flight (cp.async into the second of two stages) while it
// computes this one; g, weights and mask follow into their one slot as
// soon as this tile's d_y has left it. The two products run on the tensor
// cores at f32 accuracy (3xTF32, tf32x3.cuh), with silu(acc), then d_y, as
// the A operand and the block's one staged copy of W2c and W2g as B, read
// in both orientations; k and n are padded with zeros to multiples of 8.
// The accumulators' layout puts each row on one quad of lanes, so every
// layer-norm sum of the row phase is two shuffles. The row phase reads the
// accumulators back from a per-lane slot in shared memory in loops over
// the 8-column tiles: fully unrolled over its 64 values a lane, the kernel
// outgrew the instruction cache and ran 2.5x slower. gz, then d_y, take the
// g and weights slots a lane has just read, and d_y is the A operand of
// d_y @ W2^T from there.
namespace tcb {

constexpr int kRows = 16;                      // rows of a warp's tile
constexpr int kAccFloats = kRows * 2 * kMaxD;  // one acc stage
constexpr int kRowFloats = kRows * kMaxD;      // g or weights, then d_y's halves
constexpr int kFragFloats = 64 * 32;           // a [2][8][4] fragment per lane
constexpr int kWFloats = 2 * kMaxD * kMaxD;          // W2c, W2g, swizzled
constexpr int kParamFloats = 2 * kMaxD + 4 * kMaxD;  // b2, ncs, ncb, ngs, ngb
// A block's warps, as many as shared memory allows: with a second layer
// the weights and the parked fragments take room.
__host__ __device__ constexpr int warps(bool w2) { return w2 ? 6 : 9; }
__host__ __device__ constexpr int warp_floats(bool w2) {
  return 2 * kAccFloats + 2 * kRowFloats + (w2 ? kFragFloats : 0) + kRows;
}
__host__ __device__ constexpr size_t smem_bytes(bool w2) {
  return (size_t)((w2 ? kWFloats : 0) + kParamFloats + warps(w2) * warp_floats(w2)) *
         sizeof(float);
}

// W_half[k][n] lives at k * kMaxD + (n ^ swz(k)): the B fragments of both
// W (k = 8 s + q, n = 8 t + gid) and W^T (row n, column k) then hit 32
// distinct banks.
__device__ __forceinline__ int swz(int k) {
  return 4 * (((k & 3) << 1) | ((k >> 2) & 1));
}

// sigmoid with the fast exponential and division (a few ulp, against the
// backward's tolerance of 1e-4): the row phase's cost is its instructions
__device__ __forceinline__ float sigm_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float silu_grad_of(float x, float s) {  // s = sigm(x)
  return s * (1.f + x * (1.f - s));
}

// A tile row r's column c lives at r * width + (c ^ rswz(r)) (width 2 kMaxD
// for acc, kMaxD for g and weights): conflict-free A fragments, and 16-byte
// chunks stay whole for the copies; c ^ rswz(r) keeps c in its half.
__device__ __forceinline__ int rswz(int r) { return 4 * (r & 7); }
__device__ __forceinline__ int at_acc(int r, int c) {
  return r * 2 * kMaxD + (c ^ rswz(r));
}
__device__ __forceinline__ int at_row(int r, int c) {
  return r * kMaxD + (c ^ rswz(r));
}

// Copies of the 16 acc rows from row0 into acc_s (zeros from row_end on;
// the gate half at column kMaxD); the caller commits them.
template <typename T>
__device__ __forceinline__ void fetch_acc(float* acc_s, const T* acc, long row0,
                                          long row_end, int d, int lane) {
  const int d4 = d / 4;
  for (int i = lane; i < kRows * 2 * d4; i += 32) {
    const int r = i / (2 * d4);
    const int c = i - r * 2 * d4;
    const long l = row0 + r;
    const bool ok = l < row_end;
    const int half = c >= d4;
    tc::fetch4(acc_s + at_acc(r, half * kMaxD + 4 * (c - half * d4)),
               acc + (ok ? l : 0) * 2 * d + 4 * c, ok);
  }
}

// A lane's units of a tile's bf16 acc rows (fetch_acc's units, 4 values
// each), held in registers between hold_acc and land_acc.
constexpr int kHeldUnits = kRows * 2 * kMaxD / 4 / 32;
struct HeldAcc {
  uint2 v[kHeldUnits];
};
__device__ __forceinline__ void hold_acc(HeldAcc& h, const chgnet::bf16* acc,
                                         long row0, long row_end, int d, int lane) {
  const int d4 = d / 4;
#pragma unroll
  for (int j = 0; j < kHeldUnits; ++j) {
    const int i = lane + 32 * j;
    const int r = i / (2 * d4);
    const long l = row0 + r;
    h.v[j] = make_uint2(0u, 0u);
    if (i < kRows * 2 * d4 && l < row_end)
      h.v[j] = *reinterpret_cast<const uint2*>(acc + l * 2 * d + 4 * (i - r * 2 * d4));
  }
}
__device__ __forceinline__ void land_acc(float* acc_s, const HeldAcc& h, int d,
                                         int lane) {
  const int d4 = d / 4;
#pragma unroll
  for (int j = 0; j < kHeldUnits; ++j) {
    const int i = lane + 32 * j;
    if (i >= kRows * 2 * d4) continue;
    const int r = i / (2 * d4);
    const int c = i - r * 2 * d4;
    const int half = c >= d4;
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h.v[j].x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h.v[j].y));
    *reinterpret_cast<float4*>(acc_s + at_acc(r, half * kMaxD + 4 * (c - half * d4))) =
        make_float4(a.x, a.y, b.x, b.y);
  }
}

// Copies of tile t's g, weights and mask rows; vec: g and weights are
// 16-byte aligned. The caller commits them.
template <bool kMsg, typename T>
__device__ __forceinline__ void fetch_rows(float* g_s, float* w_s, float* m_s,
                                           const T* g, const T* weights,
                                           const T* mask, int t, int n_rows,
                                           int d, bool vec, int lane) {
  const long row0 = (long)t * kRows;
  const int unit = vec ? 4 : 1;  // floats a copy
  const int per_row = d / unit;
  for (int i = lane; i < kRows * per_row; i += 32) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * unit;
    const long l = row0 + r;
    const bool ok = l < n_rows;
    const long src = (ok ? l : 0) * d + c;
    if (vec) {
      tc::fetch4(g_s + at_row(r, c), g + src, ok);
      if (kMsg) tc::fetch4(w_s + at_row(r, c), weights + src, ok);
    } else {
      tc::fetch1(g_s + at_row(r, c), g + src, ok);
      if (kMsg) tc::fetch1(w_s + at_row(r, c), weights + src, ok);
    }
  }
  if (kMsg && lane < kRows) {
    const long l = row0 + lane;
    tc::fetch1(m_s + lane, mask + (l < n_rows ? l : 0), l < n_rows);
  }
}

// out[h][nt] += the warp's 16 rows of A_h @ W_h, or @ W_h^T with kT, over
// all kMaxD columns (W is zero-padded); A_h's row r, column c at
// a_h[r * width + (c ^ rswz(r))]; act: silu of A first. The step loop
// stays rolled: a fully unrolled kernel outgrows the instruction cache.
// kExactW: W holds bf16 values (exact in TF32), so of 3xTF32's three terms
// the two that are not zero suffice (tc::mma2_tiles, equal sums).
template <bool kT, bool kAct, bool kExactW>
__device__ __forceinline__ void product(const float* a0, const float* a1,
                                        int width, const float* w_s, int d8,
                                        int lane, float out[2][8][4]) {
  const int gid = lane >> 2;
  const int q = lane & 3;
  const int s = rswz(gid);  // rows gid and gid + 8 alike
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* a = (h ? a1 : a0) + gid * width;
    const float* w = w_s + h * kMaxD * kMaxD;
#pragma unroll 1
    for (int ks = 0; ks < d8; ++ks) {
      const int k0 = ks * 8 + q;
      const int k1 = k0 + 4;
      float av[4] = {a[k0 ^ s], a[8 * width + (k0 ^ s)], a[k1 ^ s],
                     a[8 * width + (k1 ^ s)]};
      if (kAct) {
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] *= sigm_fast(av[i]);
      }
      uint32_t hi[4], lo[4];
      tc::split_a(av, hi, lo);
      float b[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = nt * 8 + gid;
        if (kT) {
          b[nt][0] = w[n * kMaxD + (k0 ^ swz(n))];
          b[nt][1] = w[n * kMaxD + (k1 ^ swz(n))];
        } else {
          b[nt][0] = w[k0 * kMaxD + (n ^ swz(k0))];
          b[nt][1] = w[k1 * kMaxD + (n ^ swz(k1))];
        }
      }
      if constexpr (kExactW)
        tc::mma2_tiles<8>(out[h], hi, lo, b);
      else
        tc::mma3_tiles<8>(out[h], hi, lo, b);
    }
  }
}

// A [2][8][4] accumulator set: zeroed, and parked in shared memory per
// lane (f_s[((h * 8 + nt) * 4 + j) * 32 + lane]), so that the row phase
// runs as rolled loops over nt
__device__ __forceinline__ void zero(float v[2][8][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[h][nt][j] = 0.f;
}
__device__ __forceinline__ void park(float* f_s, const float v[2][8][4], int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) f_s[((h * 8 + nt) * 4 + j) * 32 + lane] = v[h][nt][j];
}

template <typename T, bool kMsg, bool kW2>
__global__ void __launch_bounds__(32 * warps(kW2), 1)
    tail_bwd_tc_kernel(TailT<T> t, const T* __restrict__ acc,
                       const T* __restrict__ weights,
                       const T* __restrict__ mask,
                       const T* __restrict__ g, T* __restrict__ d_acc,
                       T* __restrict__ d_weights, T* __restrict__ d_mask,
                       int n_rows, int d, int vec) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [2][kMaxD][kMaxD] with W2
  float* b2_s = w_s + (kW2 ? kWFloats : 0);      // [2 kMaxD], gate at kMaxD
  float* ncs_s = b2_s + 2 * kMaxD;
  float* ncb_s = ncs_s + kMaxD;
  float* ngs_s = ncb_s + kMaxD;
  float* ngb_s = ngs_s + kMaxD;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this warp's buffers: two acc stages; g and weights, whose slots take
  // gz and then d_y's core and gate halves once read; the parked
  // fragments (y, then d_h); the mask
  float* mine = ngb_s + kMaxD + warp * warp_floats(kW2);
  float* g_s = mine + 2 * kAccFloats;
  float* wt_s = g_s + kRowFloats;
  float* f_s = wt_s + kRowFloats;  // with W2
  float* m_s = f_s + (kW2 ? kFragFloats : 0);

  // weights and parameters zero-padded to kMaxD; this warp's buffers zeroed
  // (the copies never write the pad columns)
  for (int i = threadIdx.x; kW2 && i < kWFloats; i += blockDim.x) {
    const int h = i / (kMaxD * kMaxD);
    const int k = (i / kMaxD) % kMaxD;
    const int n = i % kMaxD;
    float v = 0.f;
    if (kW2 && k < d && n < d) v = chgnet::to_f((h ? t.w2g : t.w2c)[k * d + n]);
    w_s[h * kMaxD * kMaxD + k * kMaxD + (n ^ swz(k))] = v;
  }
  for (int i = threadIdx.x; i < 2 * kMaxD; i += blockDim.x) {
    const int h = i / kMaxD;
    const int e = i % kMaxD;
    b2_s[i] = kW2 && e < d ? chgnet::to_f(t.b2[h * d + e]) : 0.f;
    if (h == 0) {
      ncs_s[e] = e < d ? chgnet::to_f(t.ncs[e]) : 0.f;
      ncb_s[e] = e < d ? chgnet::to_f(t.ncb[e]) : 0.f;
      ngs_s[e] = e < d ? chgnet::to_f(t.ngs[e]) : 0.f;
      ngb_s[e] = e < d ? chgnet::to_f(t.ngb[e]) : 0.f;
    }
  }
  for (int i = lane; i < warp_floats(kW2); i += 32) mine[i] = 0.f;
  __syncthreads();  // the only block barrier

  const int gid = lane >> 2;
  const int q = lane & 3;
  const int d8 = (d + 7) / 8;
  const float inv_d = 1.f / d;
  const int n_tiles = (n_rows + kRows - 1) / kRows;
  const int step = gridDim.x * warps(kW2);
  int tile = blockIdx.x * warps(kW2) + warp;
  // acc runs one tile ahead through the two stages; g, weights and mask
  // for the next tile are copied as soon as this tile's d_y has left
  // their slots
  if (tile < n_tiles) fetch_acc(mine, acc, (long)tile * kRows, n_rows, d, lane);
  tc::commit();
  if (tile < n_tiles)
    fetch_rows<kMsg>(g_s, wt_s, m_s, g, weights, mask, tile, n_rows, d, vec, lane);
  tc::commit();
  // bf16 acc rows have no asynchronous copy into the f32 stage: the next
  // tile's are loaded into registers here and widened into their stage at
  // the end of this tile, so the loads are in flight while it is computed
  constexpr bool kHeld = chgnet::is_bf16<T>;
  HeldAcc held;
  for (int it = 0; tile < n_tiles; ++it, tile += step) {
    const float* acc_s = mine + (it & 1) * kAccFloats;
    float* acc_next = mine + ((it + 1) & 1) * kAccFloats;
    const bool ahead = tile + step < n_tiles;
    if constexpr (kHeld) {
      if (ahead) hold_acc(held, acc, (long)(tile + step) * kRows, n_rows, d, lane);
    } else if (ahead) {
      fetch_acc(acc_next, acc, (long)(tile + step) * kRows, n_rows, d, lane);
    }
    tc::commit();
    tc::wait_pending<1>();  // all but the next tile's acc have landed
    __syncwarp();
    const long row0 = (long)tile * kRows;

    // y = silu(acc) @ blockdiag(W2c, W2g) + b2, or acc. Element (h, nt, j):
    // row gid + 8 (j >> 1), column 8 nt + 2 q + (j & 1) of half h.
    if (kW2) {
      float y[2][8][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            y[h][nt][j] = b2_s[h * kMaxD + nt * 8 + 2 * q + (j & 1)];
      product<false, true, chgnet::is_bf16<T>>(acc_s, acc_s + kMaxD, 2 * kMaxD, w_s,
                                               d8, lane, y);
      park(f_s, y, lane);
    }
    auto y_at = [&](int h, int nt, int j) {
      return kW2 ? f_s[((h * 8 + nt) * 4 + j) * 32 + lane]
                 : acc_s[at_acc(gid + 8 * (j >> 1), h * kMaxD + nt * 8 + 2 * q + (j & 1))];
    };

    // two-pass layer-norm statistics of each half row
    float mean[2][2] = {}, inv[2][2] = {};
#pragma unroll 1
    for (int nt = 0; nt < d8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nt * 8 + 2 * q + (j & 1) < d) mean[h][j >> 1] += y_at(h, nt, j);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) mean[h][rr] = tc::quad_sum(mean[h][rr]) * inv_d;
#pragma unroll 1
    for (int nt = 0; nt < d8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nt * 8 + 2 * q + (j & 1) < d) {
            const float c = y_at(h, nt, j) - mean[h][j >> 1];
            inv[h][j >> 1] = fmaf(c, c, inv[h][j >> 1]);
          }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        inv[h][rr] = rsqrtf(tc::quad_sum(inv[h][rr]) * inv_d + kEps);
    // z of element (h, nt, j), zero past D
    auto z_at = [&](int h, int nt, int j) {
      return nt * 8 + 2 * q + (j & 1) < d
                 ? (y_at(h, nt, j) - mean[h][j >> 1]) * inv[h][j >> 1]
                 : 0.f;
    };

    // the gate's backward (gate_row_bwd's arithmetic): d_weights, d_mask,
    // and the layer norms' gz = d_out * scale with their sums; a lane
    // writes gz over the g and weights slots it has just read
    float s1[2][2] = {}, s2[2][2] = {}, mask_part[2] = {};
#pragma unroll 1
    for (int nt = 0; nt < d8; ++nt) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = gid + 8 * rr;
        const float m = kMsg ? m_s[r] : 1.f;
        float dw[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int e = nt * 8 + 2 * q + jj;
          const int at = at_row(r, e);
          const float zc = z_at(0, nt, 2 * rr + jj);
          const float zg = z_at(1, nt, 2 * rr + jj);
          const float cn = fmaf(zc, ncs_s[e], ncb_s[e]);
          const float gn = fmaf(zg, ngs_s[e], ngb_s[e]);
          const float sig_cn = sigm_fast(cn);
          const float silu_cn = cn * sig_cn;
          const float sig_gn = sigm_fast(gn);
          const float gv = g_s[at];  // zero past D
          float up = gv;
          if (kMsg) {
            const float wv = wt_s[at];
            mask_part[rr] = fmaf(gv, silu_cn * sig_gn * wv, mask_part[rr]);
            up = gv * wv * m;
            dw[jj] = gv * silu_cn * sig_gn * m;
          }
          const float gzc = up * sig_gn * silu_grad_of(cn, sig_cn) * ncs_s[e];
          const float gzg = up * silu_cn * sig_gn * (1.f - sig_gn) * ngs_s[e];
          s1[0][rr] += gzc;
          s2[0][rr] = fmaf(gzc, zc, s2[0][rr]);
          s1[1][rr] += gzg;
          s2[1][rr] = fmaf(gzg, zg, s2[1][rr]);
          g_s[at] = gzc;
          wt_s[at] = gzg;
        }
        const long l = row0 + r;
        const int e0 = nt * 8 + 2 * q;
        if (kMsg && e0 < d && l < n_rows)
          chgnet::store2(d_weights + l * d + e0, dw[0], dw[1]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const long l = row0 + gid + 8 * rr;
      if (kMsg && d_mask != nullptr) {
        const float dm = tc::quad_sum(mask_part[rr]);
        if (q == 0 && l < n_rows) chgnet::store_v(d_mask + l, dm);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        s1[h][rr] = tc::quad_sum(s1[h][rr]) * inv_d;
        s2[h][rr] = tc::quad_sum(s2[h][rr]) * inv_d;
      }
    // d_y = (gz - mean(gz) - z mean(gz z)) * inv, zero past D: in place
    // with W2, else straight to d_acc
#pragma unroll 1
    for (int nt = 0; nt < d8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = gid + 8 * rr;
          const long l = row0 + r;
          const int e0 = nt * 8 + 2 * q;
          float* half = h ? wt_s : g_s;
          float dy[2];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            float* p = half + at_row(r, e0 + jj);
            dy[jj] = e0 + jj < d ? (*p - s1[h][rr] - z_at(h, nt, 2 * rr + jj) *
                                                         s2[h][rr]) *
                                       inv[h][rr]
                                 : 0.f;
            if (kW2) *p = dy[jj];
          }
          if (!kW2 && e0 < d && l < n_rows)
            chgnet::store2(d_acc + l * 2 * d + h * d + e0, dy[0], dy[1]);
        }

    if (kW2) {
      __syncwarp();  // the warp's d_y rows in g_s and wt_s
      // d_acc = (d_y @ W2^T) * silu'(acc)
      float dh[2][8][4];
      zero(dh);
      product<true, false, chgnet::is_bf16<T>>(g_s, wt_s, kMaxD, w_s, d8, lane, dh);
      park(f_s, dh, lane);
#pragma unroll 1
      for (int nt = 0; nt < d8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int r = gid + 8 * rr;
            const long l = row0 + r;
            const int e0 = nt * 8 + 2 * q;
            if (e0 >= d || l >= n_rows) continue;
            const float a0 = acc_s[at_acc(r, h * kMaxD + e0)];
            const float a1 = acc_s[at_acc(r, h * kMaxD + e0 + 1)];
            chgnet::store2(d_acc + l * 2 * d + h * d + e0,
                           y_at(h, nt, 2 * rr) * silu_grad_of(a0, sigm_fast(a0)),
                           y_at(h, nt, 2 * rr + 1) * silu_grad_of(a1, sigm_fast(a1)));
          }
    }
    if constexpr (kHeld) {
      if (ahead) land_acc(acc_next, held, d, lane);
    }
    __syncwarp();  // this acc stage and the row slots free
    if (ahead)
      fetch_rows<kMsg>(g_s, wt_s, m_s, g, weights, mask, tile + step, n_rows, d,
                       vec, lane);
    tc::commit();
  }
}


// ------------------------------------ message forward on tensor cores
// The message tail's forward, and the message tail fused with the sorted
// segment sum of its rows, on the serving backward's tile.
//
// Bound: at D = 64 a message row moves 1,028 bytes (acc, weights, mask in,
// the message out) against 4 D^2 FLOPs of products (0.5 ms for the default
// pass's 7 calls at 3xTF32) and 34 elementwise operations per row element
// (0.16 ms): bytes (1.5 ms). The reduce moves the same less the message
// stream, plus its output rows.
// Design: every warp owns 16 rows at a time through every phase, with no
// block barrier in its loop. The product silu(acc) @ blockdiag(W2c, W2g)
// runs on the tensor cores at f32 accuracy (3xTF32) with y starting at b2.
// The block stages W2c and W2g once as B fragments split ahead into hi and
// lo (64 KB, tf32x3.cuh split_pair), so a k-step loads each 8-column
// tile's fragment as one 16-byte word and splits only A; k and n are padded
// with zeros to kMaxD, so no branch lies between the tiles' loads. The
// layer-norm statistics (mean, then the centred variance) come from the
// accumulators in registers; y is then parked over the acc rows it came
// from, and the gate reads it back in a loop over the 8-column tiles
// unrolled twice only (the instruction cache). silu(acc) and the gate take
// the fast exponential and division (the forward's error against its plain
// version stays under 2e-6 of its largest value).
// What holds the tile is latency, so the design buys warps: a warp has one
// acc stage (8 KB), one weights slot (4 KB) and its mask, so 12 warps fit
// beside the weights (215,296 bytes, one block an SM), and 12 warps (3 a
// scheduler) leave each thread up to 170 registers. A warp copies its next
// tile's acc rows and weights (cp.async) once the gate has read this tile's;
// the acc rows are waited for before the product, the weights only before
// the gate. Measured side by side (PERF.md §6), this beat two acc stages
// at 8 warps an SM; fetching the next tile into L2 ahead of its copy did
// not help.
constexpr int kFwdWarps = 12;
constexpr int kSplitW = 2 * 8 * 8 * 32;  // uint4 B fragments of W2c and W2g
constexpr int kPrmFloats = 2 * kMaxD + 4 * kMaxD;  // b2, ncs, ncb, ngs, ngb
// a warp's acc stage, its weights slot and its mask
constexpr int kFwdWarpFloats = kAccFloats + kRowFloats + kRows;
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  return kSplitW * sizeof(uint4) +
         (kPrmFloats + kFwdWarps * kFwdWarpFloats) * sizeof(float);
}
static_assert(fwd_smem_bytes() <= 232448, "over the H100's shared memory a block");

// The block's set-up, ended by its only barrier: W2c and W2g as split B
// fragments, wf[((h * 8 + ks) * 8 + nt) * 32 + lane] for the 8-deep step ks
// and the 8-column tile nt of half h (zero past D); b2 (gate half at
// kMaxD) and the layer-norm vectors, zero past D; the warp's buffers zeroed
// (the copies never write the columns past D).
template <typename T>
__device__ void stage_fwd(uint4* wf, float* prm, float* mine, const TailT<T>& t,
                          int d, int lane) {
  for (int i = threadIdx.x; i < kSplitW; i += blockDim.x) {
    const int n = ((i >> 5) & 7) * 8 + ((i & 31) >> 2);
    const int k0 = ((i >> 8) & 7) * 8 + (i & 3);
    const int k1 = k0 + 4;
    const T* w = (i >> 11) ? t.w2g : t.w2c;
    wf[i] = tc::split_pair(k0 < d && n < d ? chgnet::to_f(w[k0 * d + n]) : 0.f,
                           k1 < d && n < d ? chgnet::to_f(w[k1 * d + n]) : 0.f);
  }
  for (int i = threadIdx.x; i < 2 * kMaxD; i += blockDim.x) {
    const int h = i / kMaxD;
    const int e = i % kMaxD;
    prm[i] = e < d ? chgnet::to_f(t.b2[h * d + e]) : 0.f;
    if (h == 0) {
      prm[2 * kMaxD + e] = e < d ? chgnet::to_f(t.ncs[e]) : 0.f;
      prm[3 * kMaxD + e] = e < d ? chgnet::to_f(t.ncb[e]) : 0.f;
      prm[4 * kMaxD + e] = e < d ? chgnet::to_f(t.ngs[e]) : 0.f;
      prm[5 * kMaxD + e] = e < d ? chgnet::to_f(t.ngb[e]) : 0.f;
    }
  }
  for (int i = lane; i < kFwdWarpFloats; i += 32) mine[i] = 0.f;
  __syncthreads();
}

// Copies of the weights rows and mask entries of the 16 rows from row0
// (zeros from row_end on); vec: weights 16-byte aligned. The caller commits
// them.
template <typename T>
__device__ __forceinline__ void fetch_weights(float* w_s, float* m_s,
                                              const T* weights,
                                              const T* mask, long row0,
                                              long row_end, int d, bool vec,
                                              int lane) {
  const int unit = vec ? 4 : 1;  // floats a copy
  const int per_row = d / unit;
  for (int i = lane; i < kRows * per_row; i += 32) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * unit;
    const long l = row0 + r;
    const bool ok = l < row_end;
    const T* src = weights + (ok ? l : 0) * d + c;
    if (vec)
      tc::fetch4(w_s + at_row(r, c), src, ok);
    else
      tc::fetch1(w_s + at_row(r, c), src, ok);
  }
  if (lane < kRows) {
    const long l = row0 + lane;
    tc::fetch1(m_s + lane, mask + (l < row_end ? l : 0), l < row_end);
  }
}

// y[h] += the warp's 16 rows of silu(A_h) @ W_h over all kMaxD columns,
// A_h the acc stage's half h (row r, column c at at_acc(r, h kMaxD + c)),
// W_h from the split fragments. The step loop is unrolled twice only, so
// that one step's loads overlap the other's products. kExactW: bf16 W,
// whose lo parts are zero: two of 3xTF32's terms (tc::mma2_tiles_split).
template <bool kExactW>
__device__ __forceinline__ void product_split(const float* acc_s, const uint4* wf,
                                              int d8, int lane, float y[2][8][4]) {
  const int gid = lane >> 2;
  const int q = lane & 3;
  const int s = rswz(gid);  // rows gid and gid + 8 alike
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* a = acc_s + gid * 2 * kMaxD + h * kMaxD;
#pragma unroll 2
    for (int ks = 0; ks < d8; ++ks) {
      const int k0 = ks * 8 + q;
      const int k1 = k0 + 4;
      float av[4] = {a[k0 ^ s], a[16 * kMaxD + (k0 ^ s)], a[k1 ^ s],
                     a[16 * kMaxD + (k1 ^ s)]};
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] *= sigm_fast(av[i]);
      uint32_t hi[4], lo[4];
      tc::split_a(av, hi, lo);
      const uint4* b = wf + (h * 8 + ks) * 8 * 32 + lane;
      uint4 bf[8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) bf[nt] = b[nt * 32];
      if constexpr (kExactW)
        tc::mma2_tiles_split<8>(y[h], hi, lo, bf);
      else
        tc::mma3_tiles_split<8>(y[h], hi, lo, bf);
    }
  }
}

// The messages of the warp's 16 rows in the acc stage acc_s, with their
// weights and mask in w_s and m_s: emit(r, e0, v0, v1) for row r and the
// lane's columns e0, e0 + 1 < D, tile by tile. y is left parked in acc_s.
// The caller has committed the copies of acc_s, then of w_s and m_s: the
// acc rows are waited for before the product, the weights only before the
// gate, so their copy overlaps the product.
template <bool kExactW, typename Emit>
__device__ __forceinline__ void message_tile(float* acc_s, const float* w_s,
                                             const float* m_s, const uint4* wf,
                                             const float* prm, int d, int lane,
                                             Emit emit) {
  tc::wait_pending<1>();  // the acc rows; the weights may still be in flight
  __syncwarp();
  const int gid = lane >> 2;
  const int q = lane & 3;
  const int d8 = (d + 7) / 8;
  const float inv_d = 1.f / d;
  const float* ncs_s = prm + 2 * kMaxD;
  const float* ncb_s = ncs_s + kMaxD;
  const float* ngs_s = ncb_s + kMaxD;
  const float* ngb_s = ngs_s + kMaxD;
  // y = b2 + silu(acc) @ blockdiag(W2c, W2g). Element (h, nt, j): row
  // gid + 8 (j >> 1), column 8 nt + 2 q + (j & 1) of half h; exactly 0
  // past D (zero weights and b2)
  float y[2][8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) y[h][nt][j] = prm[h * kMaxD + nt * 8 + 2 * q + (j & 1)];
  product_split<kExactW>(acc_s, wf, d8, lane, y);

  // two-pass layer-norm statistics of each half row
  float mean[2][2] = {}, inv[2][2] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) mean[h][j >> 1] += y[h][nt][j];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) mean[h][rr] = tc::quad_sum(mean[h][rr]) * inv_d;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (nt * 8 + 2 * q + (j & 1) < d) {
          const float c = y[h][nt][j] - mean[h][j >> 1];
          inv[h][j >> 1] = fmaf(c, c, inv[h][j >> 1]);
        }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      inv[h][rr] = rsqrtf(tc::quad_sum(inv[h][rr]) * inv_d + kEps);
  tc::wait_pending<0>();  // the weights and mask too
  __syncwarp();  // every lane's A fragments read: y parks over them
  park(acc_s, y, lane);

  // the gate times weights and mask; a lane reads back only its own parked
  // values. Two tiles an iteration, for independent work.
#pragma unroll 2
  for (int nt = 0; nt < d8; ++nt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = gid + 8 * rr;
      const int e0 = nt * 8 + 2 * q;
      float v[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * rr + jj;
        const int e = e0 + jj;
        const float zc = (acc_s[(nt * 4 + j) * 32 + lane] - mean[0][rr]) * inv[0][rr];
        const float zg = (acc_s[((8 + nt) * 4 + j) * 32 + lane] - mean[1][rr]) * inv[1][rr];
        const float cn = fmaf(zc, ncs_s[e], ncb_s[e]);
        v[jj] = cn * sigm_fast(cn) * sigm_fast(fmaf(zg, ngs_s[e], ngb_s[e])) *
                w_s[at_row(r, e)] * m_s[r];
      }
      if (e0 < d) emit(r, e0, v[0], v[1]);
    }
}

// Zero the acc stage's columns between D and the next multiple of 8, which
// the product reads and the copies never write, once parked y has used
// them (else a non-finite y would reach the next tile's rows); nothing at
// D = 64.
__device__ __forceinline__ void clear_pad(float* acc_s, int d, int lane) {
  const int pad = ((d + 7) & ~7) - d;
  for (int i = lane; i < kRows * 2 * pad; i += 32) {
    const int r = i / (2 * pad);
    const int c = i - r * 2 * pad;
    const int h = c >= pad;
    acc_s[at_acc(r, h * kMaxD + d + c - h * pad)] = 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kFwdWarps, 1)
    tail_fwd_tc_kernel(TailT<T> t, const T* __restrict__ acc,
                       const T* __restrict__ weights,
                       const T* __restrict__ mask, T* __restrict__ out,
                       int n_rows, int d, int vec) {
  extern __shared__ float4 smem4[];
  uint4* wf = reinterpret_cast<uint4*>(smem4);
  float* prm = reinterpret_cast<float*>(wf + kSplitW);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this warp's buffers: its acc stage (y parks over it), the weights
  // slot, the mask
  float* mine = prm + kPrmFloats + warp * kFwdWarpFloats;
  float* w_s = mine + kAccFloats;
  float* m_s = w_s + kRowFloats;
  stage_fwd(wf, prm, mine, t, d, lane);

  const int n_tiles = (n_rows + kRows - 1) / kRows;
  const int step = gridDim.x * kFwdWarps;
  int tile = blockIdx.x * kFwdWarps + warp;
  if (tile < n_tiles) fetch_acc(mine, acc, (long)tile * kRows, n_rows, d, lane);
  tc::commit();
  if (tile < n_tiles)
    fetch_weights(w_s, m_s, weights, mask, (long)tile * kRows, n_rows, d, vec, lane);
  tc::commit();
  for (; tile < n_tiles; tile += step) {
    const long row0 = (long)tile * kRows;
    message_tile<chgnet::is_bf16<T>>(mine, w_s, m_s, wf, prm, d, lane,
                 [&](int r, int e0, float v0, float v1) {
                   const long l = row0 + r;
                   if (l < n_rows) chgnet::store2(out + l * d + e0, v0, v1);
                 });
    __syncwarp();  // parked y and the weights slot read
    clear_pad(mine, d, lane);
    const long next0 = row0 + (long)step * kRows;
    if (tile + step < n_tiles) fetch_acc(mine, acc, next0, n_rows, d, lane);
    tc::commit();
    if (tile + step < n_tiles)
      fetch_weights(w_s, m_s, weights, mask, next0, n_rows, d, vec, lane);
    tc::commit();
  }
}

// ---------------------------------------- message tail + segment sum
// out[n] = sum over rows l of segment n of message(acc, weights, mask)[l],
// the segments given as CSR offsets [n_out + 1] of the stream's sorted keys:
// rows offsets[n] .. offsets[n + 1] feed output row n, rows past
// offsets[n_out] (dropped keys) are never read. The mask multiplies inside
// the sum: a masked row whose key stays in range adds exactly zero.
// Design: no float atomics, no carries. The output rows are cut into one
// contiguous range per warp, balanced by cost(n) = kRowCost * offsets[n] + n
// (input rows weigh kRowCost output rows, so the empty segments of the
// padding are shared out too): warp w of block b owns chunk b * kFwdWarps + w
// and finds its range [n0, n1) by two binary searches, one in each of two
// lanes. It walks the rows offsets[n0] .. offsets[n1] that feed its range
// in 16-row tiles with the forward's phases, writes each tile's messages
// over the weights they were made from, and then every lane adds two
// columns of the tile's rows, in row order, into the open segment, kept in
// registers; it writes each output row once, when its segment closes, empty
// segments as zeros. No segment crosses a warp, so two runs give equal
// bits. The add order differs from segment_sum_csr's lane-group tree, so
// the two agree only to rounding.
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

template <typename T>
__global__ void __launch_bounds__(32 * kFwdWarps, 1)
    tail_reduce_tc_kernel(TailT<T> t, const T* __restrict__ acc,
                          const T* __restrict__ weights,
                          const T* __restrict__ mask,
                          const int* __restrict__ offsets, T* __restrict__ out,
                          int n_out, int d, int vec) {
  extern __shared__ float4 smem4[];
  uint4* wf = reinterpret_cast<uint4*>(smem4);
  float* prm = reinterpret_cast<float*>(wf + kSplitW);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* mine = prm + kPrmFloats + warp * kFwdWarpFloats;
  float* w_s = mine + kAccFloats;  // weights, then the tile's messages
  float* m_s = w_s + kRowFloats;
  stage_fwd(wf, prm, mine, t, d, lane);

  // this warp's output rows [n0, n1): lane 0 searches n0, lane 1 n1
  const long n_chunks = (long)gridDim.x * kFwdWarps;
  const long chunk = ((long)kRowCost * offsets[n_out] + n_out + n_chunks - 1) / n_chunks;
  const long c = (long)blockIdx.x * kFwdWarps + warp;
  const long end = c + (lane & 1);
  const int found = end == n_chunks ? n_out : cost_lower_bound(offsets, n_out, chunk * end);
  const int n0 = __shfl_sync(0xffffffffu, found, 0);
  const int n1 = __shfl_sync(0xffffffffu, found, 1);
  if (n0 >= n1) return;  // warp-uniform, after the block's only barrier
  const long row_begin = offsets[n0];
  const long row_end = offsets[n1];
  const int n_tiles = (int)((row_end - row_begin + kRows - 1) / kRows);
  // the open segment of the lane's columns 2 lane, 2 lane + 1
  const bool own = 2 * lane < d;
  T* out_col = out + 2 * lane;
  int n = n0;
  long seg_end = offsets[n0 + 1];
  float2 sum = make_float2(0.f, 0.f);
  if (n_tiles > 0) fetch_acc(mine, acc, row_begin, row_end, d, lane);
  tc::commit();
  if (n_tiles > 0)
    fetch_weights(w_s, m_s, weights, mask, row_begin, row_end, d, vec, lane);
  tc::commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    const long row0 = row_begin + (long)tile * kRows;
    const bool more = tile + 1 < n_tiles;
    message_tile<chgnet::is_bf16<T>>(mine, w_s, m_s, wf, prm, d, lane,
                 [&](int r, int e0, float v0, float v1) {
                   *reinterpret_cast<float2*>(w_s + at_row(r, e0)) = make_float2(v0, v1);
                 });
    __syncwarp();  // the tile's messages in w_s, parked y read
    clear_pad(mine, d, lane);
    if (more) fetch_acc(mine, acc, row0 + kRows, row_end, d, lane);
    tc::commit();
    const int rows = row_end - row0 < kRows ? (int)(row_end - row0) : kRows;
    for (int r = 0; r < rows; ++r) {
      while (row0 + r >= seg_end) {  // close segments, empty ones too
        if (own) chgnet::store2(out_col + (long)n * d, sum.x, sum.y);
        sum = make_float2(0.f, 0.f);
        ++n;
        seg_end = offsets[n + 1];
      }
      if (own) {
        const float2 v = *reinterpret_cast<const float2*>(w_s + at_row(r, 2 * lane));
        sum.x += v.x;
        sum.y += v.y;
      }
    }
    __syncwarp();  // the messages summed: the slot is free
    if (more) fetch_weights(w_s, m_s, weights, mask, row0 + kRows, row_end, d, vec, lane);
    tc::commit();
  }
  for (; n < n1; ++n) {
    if (own) chgnet::store2(out_col + (long)n * d, sum.x, sum.y);
    sum = make_float2(0.f, 0.f);
  }
}

}  // namespace tcb


template <typename T>
using FwdFn = void (*)(TailT<T>, const T*, const T*, T*, int, int);
template <typename T>
using BwdFn = void (*)(TailT<T>, const T*, const T*, const T*, const T*, T*, T*, T*,
                       float*, int, int);
// the tensor-core kernels
template <typename T>
using TcFwdFn = void (*)(TailT<T>, const T*, const T*, const T*, T*, int, int, int);
template <typename T>
using TcReduceFn = void (*)(TailT<T>, const T*, const T*, const T*, const int*, T*,
                            int, int, int);
template <typename T>
using TcBwdFn = void (*)(TailT<T>, const T*, const T*, const T*, const T*, T*, T*,
                         T*, int, int, int);

template <typename T>
using UpdateFn = void (*)(TailT<T>, const T*, const T*, T*, int, int, int);

size_t fwd_smem() { return (kWeights + 4 * kHalf) * sizeof(float); }

size_t bwd_smem(bool w2, bool params) {
  if (w2) return (2 * kWeights + 4 * kHalf) * sizeof(float);
  return params ? kWarps * kVecs * kMaxD * sizeof(float) : 0;
}

// the update forward with a second layer
template <typename T>
Kernel<FwdFn<T>> fwd_kernel() {
  static std::atomic<int> waves[kMaxDevices];
  return {tail_fwd_kernel<T>, fwd_smem(), waves};
}

template <typename T, int kN>
Kernel<UpdateFn<T>> update_instance() {
  static std::atomic<int> waves[kMaxDevices];
  return {update_fwd_kernel<T, kN>, 0, waves};
}

template <typename T, bool kMsg, bool kW2, bool kParams>
Kernel<BwdFn<T>> bwd_instance() {
  static std::atomic<int> waves[kMaxDevices];
  return {tail_bwd_kernel<T, kMsg, kW2, kParams>, bwd_smem(kW2, kParams), waves};
}

// the update forward without a second layer: 16-byte loads, or 8-byte ones
// for bf16 rows whose D is not a multiple of 8
template <typename T>
int launch_update(const TailT<T>& t, const T* acc, const T* resnet, T* out,
                  int n_rows, int d, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
  const bool wide = d % kWide == 0;
  const int n = wide ? kWide : 4;
  const Kernel<UpdateFn<T>> k = wide ? update_instance<T, kWide>()
                                     : update_instance<T, 4>();
  const int wave = wave_blocks(k);
  if (wave < 0) return -wave;
  int gl = 1;
  while (gl < d / n) gl <<= 1;
  const long rows = (long)kWarps * (32 / gl);  // a block's rows at a time
  const long want = (n_rows + rows - 1) / rows;
  if ((uintptr_t)acc % (n * sizeof(T)) || (uintptr_t)out % (n * sizeof(T)))
    return (int)cudaErrorInvalidValue;
  const int vec_res = (uintptr_t)resnet % (n * sizeof(T)) == 0;
  k.fn<<<want < wave ? (int)want : wave, kThreads, k.smem, stream>>>(
      t, acc, resnet, out, n_rows, d, vec_res);
  return (int)cudaSuccess;
}

// the backward with parameter gradients
template <typename T>
Kernel<BwdFn<T>> bwd_kernel(bool msg, bool w2) {
  if (msg) return bwd_instance<T, true, true, true>();
  return w2 ? bwd_instance<T, false, true, true>() : bwd_instance<T, false, false, true>();
}

template <typename T>
Kernel<TcFwdFn<T>> tc_fwd_kernel() {
  static std::atomic<int> waves[kMaxDevices];
  return {tcb::tail_fwd_tc_kernel<T>, tcb::fwd_smem_bytes(), waves};
}

template <typename T>
Kernel<TcReduceFn<T>> tc_reduce_kernel() {
  static std::atomic<int> waves[kMaxDevices];
  return {tcb::tail_reduce_tc_kernel<T>, tcb::fwd_smem_bytes(), waves};
}

// the serving backward
template <typename T, bool kMsg, bool kW2>
Kernel<TcBwdFn<T>> tc_bwd_instance() {
  static std::atomic<int> waves[kMaxDevices];
  return {tcb::tail_bwd_tc_kernel<T, kMsg, kW2>, tcb::smem_bytes(kW2), waves};
}

template <typename T>
Kernel<TcBwdFn<T>> tc_bwd_kernel(bool msg, bool w2) {
  if (msg) return tc_bwd_instance<T, true, true>();
  return w2 ? tc_bwd_instance<T, false, true>() : tc_bwd_instance<T, false, false>();
}

}  // namespace

// tail: 7 pointers (w2c, w2g, b2, nc_scale, nc_bias, ng_scale, ng_bias),
// the first three null for an update without a second layer. msg = 1:
// out = message(acc, weights, mask) by the tensor-core kernel, 16 rows a
// warp; msg = 0: out = update(acc) + resnet, with a second layer one block
// per 32-row tile, without one a row per group of lanes
// (update_fwd_kernel).
// acc [n_rows, 2d] 16-byte aligned; every tensor contiguous f32 (the
// _bf16 entry: bf16, computed in f32 and rounded once at each store). At
// most one wave of blocks.
namespace {

template <typename T>
int gated_fwd(int msg, const void* const* tail, const T* acc, const T* weights,
              const T* mask, const T* resnet, T* out, int n_rows, int d,
              void* cuda_stream) {
  const TailT<T> t = make_tail<T>(tail);
  const bool w2 = t.w2c != nullptr;
  if (bad_shape(msg, w2, d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  if (n_rows > 0 && msg) {
    const Kernel<TcFwdFn<T>> k = tc_fwd_kernel<T>();
    const int wave = wave_blocks(k, 32 * tcb::kFwdWarps);
    if (wave < 0) return -wave;
    const int rows = tcb::kRows * tcb::kFwdWarps;  // of a block's first tiles
    const int want = (n_rows + rows - 1) / rows;
    // weights rows in units of 4 values: 16 bytes of f32, 8 of bf16
    const int vec = (uintptr_t)weights % (4 * sizeof(T)) == 0;
    k.fn<<<want < wave ? want : wave, 32 * tcb::kFwdWarps, k.smem, stream>>>(
        t, acc, weights, mask, out, n_rows, d, vec);
  } else if (n_rows > 0 && w2) {
    const Kernel<FwdFn<T>> k = fwd_kernel<T>();
    const int wave = wave_blocks(k);
    if (wave < 0) return -wave;
    const int grid = n_tiles(n_rows) < wave ? n_tiles(n_rows) : wave;
    k.fn<<<grid, kThreads, k.smem, stream>>>(t, acc, resnet, out, n_rows, d);
  } else if (n_rows > 0) {
    const int err = launch_update(t, acc, resnet, out, n_rows, d, stream);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}

// the serving backward, by the tensor-core kernel
template <typename T>
int gated_bwd_serving(int msg, const TailT<T>& t, const T* acc, const T* weights,
                      const T* mask, const T* g, T* d_acc, T* d_weights,
                      T* d_mask, int n_rows, int d, cudaStream_t stream) {
  const bool w2 = t.w2c != nullptr;
  const Kernel<TcBwdFn<T>> k = tc_bwd_kernel<T>(msg, w2);
  const int wave = wave_blocks(k, 32 * tcb::warps(w2));
  if (wave < 0) return -wave;
  const int rows = tcb::kRows * tcb::warps(w2);  // of a block's first tiles
  const int want = (n_rows + rows - 1) / rows;
  const int vec = ((uintptr_t)g | (uintptr_t)(msg ? weights : g)) % (4 * sizeof(T)) == 0;
  k.fn<<<want < wave ? want : wave, 32 * tcb::warps(w2), k.smem, stream>>>(
      t, acc, weights, mask, g, d_acc, d_weights, d_mask, n_rows, d, vec);
  return (int)cudaSuccess;
}

// d_acc [n_rows, 2d] (16-byte aligned, as acc), and for msg = 1 d_weights
// [n_rows, d] and, unless null, d_mask [n_rows]. Without d_params: the
// tensor-core kernel, 16 rows a warp, at most one wave of persistent
// blocks. With d_params non-null the parameter gradients too, by
// tail_bwd_kernel in exactly n_blocks = min(tiles, kParamBlocks) blocks,
// one f32 row each of partial [n_blocks, n_part], summed in f32 in block
// order and rounded once to T: d_params [n_part] = dW2c, dW2g, db2 (with
// w2), d nc_scale, d nc_bias, d ng_scale, d ng_bias.
template <typename T>
int gated_bwd(int msg, const void* const* tail, const T* acc, const T* weights,
              const T* mask, const T* g, T* d_acc, T* d_weights, T* d_mask,
              float* partial, T* d_params, int n_rows, int d, int n_blocks,
              void* cuda_stream) {
  const TailT<T> t = make_tail<T>(tail);
  const bool w2 = t.w2c != nullptr;
  const bool params = d_params != nullptr;
  const int tiles = n_rows > 0 ? n_tiles(n_rows) : 0;
  if (bad_shape(msg, w2, d) ||
      (params && n_blocks != (tiles < kParamBlocks ? tiles : kParamBlocks)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  if (n_rows > 0 && params) {
    const Kernel<BwdFn<T>> k = bwd_kernel<T>(msg, w2);
    const int wave = wave_blocks(k);
    if (wave < 0) return -wave;
    k.fn<<<n_blocks, kThreads, k.smem, stream>>>(t, acc, weights, mask, g, d_acc,
                                                 d_weights, d_mask, partial,
                                                 n_rows, d);
  } else if (n_rows > 0) {
    const int err = gated_bwd_serving(msg, t, acc, weights, mask, g, d_acc,
                                      d_weights, d_mask, n_rows, d, stream);
    if (err) return err;
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
// first. One warp per kRowCost * n_rows + n_out cost units of a 16-row
// tile, at most one wave of blocks. bf16: each segment summed in f32 and
// rounded once.
template <typename T>
int gated_reduce(const void* const* tail, const T* acc, const T* weights,
                 const T* mask, const int* offsets, T* out, int n_rows, int n_out,
                 int d, void* cuda_stream) {
  const TailT<T> t = make_tail<T>(tail);
  if (bad_shape(true, t.w2c != nullptr, d)) return (int)cudaErrorInvalidValue;
  if (n_out > 0) {
    const Kernel<TcReduceFn<T>> k = tc_reduce_kernel<T>();
    const int wave = wave_blocks(k, 32 * tcb::kFwdWarps);
    if (wave < 0) return -wave;
    const long cost = (long)tcb::kRowCost * n_rows + n_out;
    const long per_block = (long)tcb::kRowCost * tcb::kRows * tcb::kFwdWarps;
    const long want = (cost + per_block - 1) / per_block;
    // weights rows in units of 4 values: 16 bytes of f32, 8 of bf16
    const int vec = (uintptr_t)weights % (4 * sizeof(T)) == 0;
    k.fn<<<want < wave ? (int)want : wave, 32 * tcb::kFwdWarps, k.smem,
           static_cast<cudaStream_t>(cuda_stream)>>>(t, acc, weights, mask,
                                                     offsets, out, n_out, d, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gated_fwd_f32(int msg, const void* const* tail, const float* acc,
                             const float* weights, const float* mask,
                             const float* resnet, float* out, int n_rows,
                             int d, void* cuda_stream) {
  return gated_fwd(msg, tail, acc, weights, mask, resnet, out, n_rows, d,
                   cuda_stream);
}

extern "C" int gated_fwd_bf16(int msg, const void* const* tail,
                              const chgnet::bf16* acc, const chgnet::bf16* weights,
                              const chgnet::bf16* mask, const chgnet::bf16* resnet,
                              chgnet::bf16* out, int n_rows, int d,
                              void* cuda_stream) {
  return gated_fwd(msg, tail, acc, weights, mask, resnet, out, n_rows, d,
                   cuda_stream);
}

// The backward (gated_bwd above); the _bf16 entry takes bf16 rows,
// parameters and outputs, the partial buffer stays f32.
extern "C" int gated_bwd_f32(int msg, const void* const* tail, const float* acc,
                             const float* weights, const float* mask,
                             const float* g, float* d_acc, float* d_weights,
                             float* d_mask, float* partial, float* d_params,
                             int n_rows, int d, int n_blocks,
                             void* cuda_stream) {
  return gated_bwd(msg, tail, acc, weights, mask, g, d_acc, d_weights, d_mask,
                   partial, d_params, n_rows, d, n_blocks, cuda_stream);
}

extern "C" int gated_bwd_bf16(int msg, const void* const* tail,
                              const chgnet::bf16* acc, const chgnet::bf16* weights,
                              const chgnet::bf16* mask, const chgnet::bf16* g,
                              chgnet::bf16* d_acc, chgnet::bf16* d_weights,
                              chgnet::bf16* d_mask, float* partial,
                              chgnet::bf16* d_params, int n_rows, int d,
                              int n_blocks, void* cuda_stream) {
  return gated_bwd(msg, tail, acc, weights, mask, g, d_acc, d_weights, d_mask,
                   partial, d_params, n_rows, d, n_blocks, cuda_stream);
}

// The message-reduce (gated_reduce above), f32 or bf16.
extern "C" int gated_reduce_f32(const void* const* tail, const float* acc,
                                const float* weights, const float* mask,
                                const int* offsets, float* out, int n_rows,
                                int n_out, int d, void* cuda_stream) {
  return gated_reduce(tail, acc, weights, mask, offsets, out, n_rows, n_out, d,
                      cuda_stream);
}

extern "C" int gated_reduce_bf16(const void* const* tail, const chgnet::bf16* acc,
                                 const chgnet::bf16* weights,
                                 const chgnet::bf16* mask, const int* offsets,
                                 chgnet::bf16* out, int n_rows, int n_out, int d,
                                 void* cuda_stream) {
  return gated_reduce(tail, acc, weights, mask, offsets, out, n_rows, n_out, d,
                      cuda_stream);
}

// The dynamic shared memory, warps a block and blocks of one wave on the
// current device of the tensor-core kernels, info[3 * i ..] for the message
// forward (i = 0), the message-reduce (1) and the message backward (2);
// nothing is launched. For the build report.
extern "C" int gated_tc_occupancy(int* info) {
  const int waves[3] = {wave_blocks(tc_fwd_kernel<float>(), 32 * tcb::kFwdWarps),
                        wave_blocks(tc_reduce_kernel<float>(), 32 * tcb::kFwdWarps),
                        wave_blocks(tc_bwd_kernel<float>(true, true),
                                    32 * tcb::warps(true))};
  const size_t smem[3] = {tcb::fwd_smem_bytes(), tcb::fwd_smem_bytes(),
                          tcb::smem_bytes(true)};
  const int warps[3] = {tcb::kFwdWarps, tcb::kFwdWarps, tcb::warps(true)};
  for (int i = 0; i < 3; ++i) {
    if (waves[i] < 0) return -waves[i];
    info[3 * i] = (int)smem[i];
    info[3 * i + 1] = warps[i];
    info[3 * i + 2] = waves[i];
  }
  return (int)cudaSuccess;
}
