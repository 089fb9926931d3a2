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
// asynchronous copies and warp-local tiles; in bf16 the message forward
// and the serving backward are tail_fwd_bf16_kernel and
// tail_bwd_bf16_kernel (namespace tcb16), the same warp-local tiles on
// bf16 stages and the bf16 tensor cores.
// Design of the update forward without a second layer: update_fwd_kernel,
// a row per group of lanes with 16-byte loads.
// Design of the update forward with a second layer: f32 FMAs throughout,
// no TF32. A block stages W2c and W2g (16 KB each at D = 64) in dynamic
// shared memory once, then walks 32-row tiles: it loads the tile's acc rows
// as float4, keeps h = silu(acc) in shared memory, and each of 256 threads
// computes a 4-row x 4-column register tile of the two diagonal blocks only
// (half the FLOPs of the dense 2D x 2D product). The row phase gives each
// row to one warp: two-pass layer norms (mean, then the centred variance)
// by warp shuffles and the gating; the ragged last tile is masked, nothing
// is padded.
// Design of the backward with parameter gradients (training):
// tail_bwd_param_tc_kernel and tail_bwd_param_bf16_kernel (below tcb16),
// the serving tiles with dW2 on the tensor cores, each of a block's 8
// warps the owner of an eighth of it. Parameter gradients are summed per
// block in a fixed order into a [blocks, n_part] scratch buffer (a fixed
// number of blocks, kParamBlocks), which a second kernel reduces over the
// blocks in order: no float atomics, and the result repeats bit for bit.
// bf16 (compute_dtype="bfloat16", the _bf16 entry points): every kernel
// takes bf16 acc, weights, mask, cotangent and parameters, computes in f32
// and rounds each output once at its store, as chgnet_tpu's kernels do
// ("streams may be bf16 -- in-kernel math runs in f32",
// ops/gated_message.py:588-590). The message forward and the serving
// backward have kernels of their own, tcb16::tail_fwd_bf16_kernel and
// tcb16::tail_bwd_bf16_kernel (below tcb): their rows stay bf16 in shared
// memory, copied by cp.async, W2 is staged once in bf16 and read by
// ldmatrix (transposed for y = silu(acc) @ W2, as it is for d_h = d_y @
// W2^T), and every product runs on the bf16 tensor cores
// (mma.sync.m16n8k16) in two passes, the f32 A operand (silu(acc), d_y)
// split into a bf16 hi and lo (bf16_tile.cuh), so they keep f32 accuracy;
// y stays in registers, the row phase is tcb's f32 arithmetic, and each
// output is rounded once. The backward with parameter gradients has its
// own bf16 kernel, tcb16::tail_bwd_param_bf16_kernel, on the same bf16
// stages; its per-block partials stay f32, sum_blocks_kernel adds them in
// block order in f32 (no atomics) and rounds each parameter gradient once
// to bf16 (chgnet_tpu casts each tile's f32 sums to the parameters' type
// and adds them there, ops/gated_message.py:222-228, so it rounds once a
// tile). The other forms are the f32 kernels instantiated for bf16: their
// rows are widened to f32 as they are fetched (tc::fetch4 / fetch1: a load
// now where the f32 kernels copy with cp.async) and their products keep
// f32 accuracy as two of 3xTF32's passes, those whose terms are not zero
// for a bf16 W2 (lo_a hi_b, hi_a hi_b: tc::mma2_tiles_split, the same
// sums). The message-reduce (tail_reduce_tc_kernel<bf16>) keeps each
// tile's messages in f32 and sums every segment in f32, rounding each
// output row once. The update
// forward without a second layer (update_fwd_kernel<bf16, ...>) takes the
// gate's exponentials and quotients by the fast intrinsics, some 1e-6
// relative in f32 before the output's bf16 rounding.
// D over 64 (up to 128): every form but the update forward without a second
// layer (update_fwd_kernel, which takes rows up to 128 wide as they are)
// runs on wide_tail.cuh's kernels, launched by the same entry points.
#include "bf16_tail.cuh"
#include "bf16_tile.cuh"
#include "gated_tail.cuh"
#include "tf32x3.cuh"
#include "wide_tail.cuh"

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

// A lane's place in its warp's 16-row tiles and the width's constants, the
// same for every tile a kernel takes: made once, before the tile loop
struct Geom {
  int d, lane, gid, q, d8, d16;
  float inv_d;
  __device__ __forceinline__ Geom(int d_, int lane_)
      : d(d_), lane(lane_), gid(lane_ >> 2), q(lane_ & 3), d8((d_ + 7) / 8),
        d16((d_ + 15) / 16), inv_d(1.f / d_) {}
};

// Helpers of the backwards below: the tile's row phase sums the
// layer-norm vectors' gradients with these when it takes parameter
// gradients (see tail_bwd_param_tc_kernel's notes, below tcb16).
namespace prm {

// The warps of a block, met at barrier 1 (the block's own barrier stays free)
__device__ __forceinline__ void group_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// The block's 16-row tiles [first, last): the n_tiles split evenly over the
// grid, in order
struct Share {
  int first, last;
};
__device__ __forceinline__ Share block_share(int n_tiles) {
  return {(int)((long)n_tiles * blockIdx.x / gridDim.x),
          (int)((long)n_tiles * (blockIdx.x + 1) / gridDim.x)};
}

// The sum of v[gid] over the 8 lanes of one quad position q (lanes q, q + 4,
// ..., q + 28), returned to the lane whose gid = lane / 4: halves, quarters
// and pairs exchanged in a fixed tree of 7 shuffles
__device__ __forceinline__ float scatter8(const float v[8], int lane) {
  const bool b = lane & 16, c = lane & 8, e = lane & 4;
  float w[4], x[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = b ? v[i] : v[i + 4];
    w[i] = (b ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = c ? w[i] : w[i + 2];
    x[i] = (c ? w[i + 2] : w[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float send = e ? x[0] : x[1];
  return (e ? x[1] : x[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
}

// A lane's sums of the 8-column tiles nt of a rolled loop: add_next(x) adds
// x to the current tile's sum and moves on to the next; after 8 moves the
// sums stand in place again, s[nt]
struct Rot8 {
  float s[8];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
  }
  __device__ __forceinline__ void add_next(float x) {
    const float t = s[0] + x;
#pragma unroll
    for (int i = 0; i < 7; ++i) s[i] = s[i + 1];
    s[7] = t;
  }
};

// The gate's loop, a lane's terms of one 8-column tile: the four vectors'
// terms of its column 8 nt + 2 q + jj over its two rows, at 2 vector + jj
__device__ __forceinline__ void vec_terms(float lv[8], int jj, float dcn, float zc,
                                          float dgn, float zg) {
  lv[jj] = fmaf(dcn, zc, lv[jj]);
  lv[2 + jj] += dcn;
  lv[4 + jj] = fmaf(dgn, zg, lv[4 + jj]);
  lv[6 + jj] += dgn;
}

// A warp's vector sums into red (vector v, column e at v kMaxD + e): lane
// (gid, q) holds vector gid / 2, column 8 nt + 2 q + gid % 2 in s[nt]
__device__ __forceinline__ void park_vectors(float* red, const Rot8& ln, int lane) {
  const int gid = lane >> 2;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    red[(gid >> 1) * kMaxD + 8 * nt + 2 * (lane & 3) + (gid & 1)] = ln.s[nt];
}

// The block's four vectors, [nc_scale, nc_bias, ng_scale, ng_bias] x D, into
// out: the warps' parked sums (warp w's at red + w * stride) added in warp
// order, by every thread of the block
__device__ __forceinline__ void store_vectors(const float* red, int stride, int n_warps,
                                              float* out, int d) {
  for (int j = threadIdx.x; j < 4 * d; j += blockDim.x) {
    const int v = j / d;
    const int e = j - v * d;
    float s = 0.f;
    for (int w = 0; w < n_warps; ++w) s += red[w * stride + v * kMaxD + e];
    out[j] = s;
  }
}

// The owner's part of the block's dW2 (2 m-tiles from mt0, 4 n-tiles from
// nt0 of half oh; element e of tile (i, j): W row 16 (mt0 + i) + gid + 8 (e
// / 2), column 8 (nt0 + j) + 2 q + e % 2) into out (dW2c, then dW2g)
__device__ __forceinline__ void store_dw(float* out, const float c[2][4][4], int oh,
                                         int mt0, int nt0, int d, int lane) {
  const int gid = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 16 * (mt0 + i) + gid + 8 * (e >> 1);
        const int n = 8 * (nt0 + j) + 2 * q + (e & 1);
        if (m < d && n < d) out[oh * d * d + m * d + n] = c[i][j][e];
      }
}

}  // namespace prm

// -------------------------------------- backward on tensor cores (serving)
// The backward without parameter gradients, which serving runs: the
// function of _bwd_kernel (:190) and _bwd_kernel_nw (:734) without their
// parameter sums, redesigned for Hopper.
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
// d_y @ W2^T from there. The tile's row phase (row_phase) is shared with
// the backward with parameter gradients (tail_bwd_param_tc_kernel).
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
template <bool kT, bool kAct>
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

// A warp's buffers for one 16-row tile of the backward kernels below: the
// acc stage; the g and weights slots (gz, then d_y's core and gate halves);
// with W2 the fragment slots (y, then d_h); the mask
struct TileBufs {
  const float* acc_s;
  float* g_s;
  float* wt_s;
  float* f_s;
  const float* m_s;
};

// One warp's tile of the backward from acc to d_acc (_bwd_math :150,
// _bwd_math_nw :690), the serving kernel's and the one with parameter
// gradients' alike: y = silu(acc) @ blockdiag(W2c, W2g) + b2 (or acc), the
// two-pass layer-norm statistics, the gate's backward, d_y, and with W2
// d_acc = (d_y @ W2^T) * silu'(acc), d_y left in the g and weights slots.
// w_s: the staged W2; p_s: b2 (2 kMaxD), then ncs, ncb, ngs, ngb (kMaxD
// each). kParams: the four layer-norm vectors' terms of each 8-column tile
// summed into ln, and with W2 h = silu(acc) over d_h in the fragment slots
// (zero past D and n_rows, as acc is).
template <typename T, bool kMsg, bool kW2, bool kParams>
__device__ __forceinline__ void row_phase(const float* w_s, const float* p_s,
                                          const TileBufs& b, long row0, int n_rows,
                                          const Geom& geo, T* d_acc, T* d_weights,
                                          T* d_mask, prm::Rot8& ln) {
  const float* b2_s = p_s;
  const float* ncs_s = p_s + 2 * kMaxD;
  const float* ncb_s = ncs_s + kMaxD;
  const float* ngs_s = ncb_s + kMaxD;
  const float* ngb_s = ngs_s + kMaxD;
  const float* acc_s = b.acc_s;
  float* g_s = b.g_s;
  float* wt_s = b.wt_s;
  float* f_s = b.f_s;
  const float* m_s = b.m_s;
  const int d = geo.d;
  const int lane = geo.lane;
  const int gid = geo.gid;
  const int q = geo.q;
  const int d8 = geo.d8;
  const float inv_d = geo.inv_d;

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
    product<false, true>(acc_s, acc_s + kMaxD, 2 * kMaxD, w_s, d8, lane, y);
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
  // and the layer norms' gz = d_out * scale with their sums, where d_out is
  // d_cn or d_gn, the cotangent of an affine output; a lane writes gz over
  // the g and weights slots it has just read
  float s1[2][2] = {}, s2[2][2] = {}, mask_part[2] = {};
#pragma unroll 1
  for (int nt = 0; nt < d8; ++nt) {
    float lv[8] = {};  // kParams: this tile's vector terms
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
        const float dcn = up * sig_gn * silu_grad_of(cn, sig_cn);
        const float dgn = up * silu_cn * sig_gn * (1.f - sig_gn);
        const float gzc = dcn * ncs_s[e];
        const float gzg = dgn * ngs_s[e];
        s1[0][rr] += gzc;
        s2[0][rr] = fmaf(gzc, zc, s2[0][rr]);
        s1[1][rr] += gzg;
        s2[1][rr] = fmaf(gzg, zg, s2[1][rr]);
        if constexpr (kParams) prm::vec_terms(lv, jj, dcn, zc, dgn, zg);
        g_s[at] = gzc;
        wt_s[at] = gzg;
      }
      const long l = row0 + r;
      const int e0 = nt * 8 + 2 * q;
      if (kMsg && e0 < d && l < n_rows)
        chgnet::store2(d_weights + l * d + e0, dw[0], dw[1]);
    }
    if constexpr (kParams) ln.add_next(prm::scatter8(lv, lane));
  }
  if constexpr (kParams)
    for (int nt = d8; nt < 8; ++nt) ln.add_next(0.f);  // the sums back in place
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
    // d_acc = (d_y @ W2^T) * silu'(acc); kParams: h = silu(acc) over d_h
    float dh[2][8][4];
    zero(dh);
    product<true, false>(g_s, wt_s, kMaxD, w_s, d8, lane, dh);
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
          const bool in = e0 < d && l < n_rows;
          if (!kParams && !in) continue;
          const float a0 = acc_s[at_acc(r, h * kMaxD + e0)];
          const float a1 = acc_s[at_acc(r, h * kMaxD + e0 + 1)];
          const float sg0 = sigm_fast(a0);
          const float sg1 = sigm_fast(a1);
          float* f0 = f_s + ((h * 8 + nt) * 4 + 2 * rr) * 32 + lane;
          float* f1 = f0 + 32;
          if (in)
            chgnet::store2(d_acc + l * 2 * d + h * d + e0, *f0 * silu_grad_of(a0, sg0),
                           *f1 * silu_grad_of(a1, sg1));
          if constexpr (kParams) {
            *f0 = a0 * sg0;
            *f1 = a1 * sg1;
          }
        }
  }
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
  prm::Rot8 no_sums;  // serving takes no parameter gradients
  const Geom geo(d, lane);
  for (int it = 0; tile < n_tiles; ++it, tile += step) {
    const float* acc_s = mine + (it & 1) * kAccFloats;
    float* acc_next = mine + ((it + 1) & 1) * kAccFloats;
    const bool ahead = tile + step < n_tiles;
    if (ahead) fetch_acc(acc_next, acc, (long)(tile + step) * kRows, n_rows, d, lane);
    tc::commit();
    tc::wait_pending<1>();  // all but the next tile's acc have landed
    __syncwarp();
    const long row0 = (long)tile * kRows;
    row_phase<T, kMsg, kW2, false>(w_s, b2_s, {acc_s, g_s, wt_s, f_s, m_s}, row0, n_rows,
                                   geo, d_acc, d_weights, d_mask, no_sums);
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


// ------------------------------- serving backward on bf16 tensor cores
// The serving backward in bf16 (rows 7 and 9 without parameter gradients,
// D <= 64): the function of tcb::tail_bwd_tc_kernel, redesigned for bf16
// rows and Hopper's bf16 tensor cores.
//
// Bound: at D = 64 a bf16 message row moves 898 bytes (acc, g, weights,
// mask in, d_acc and d_weights out) against 8 D^2 FLOPs of products; the
// default bf16 pass's 7 calls: 1.345 ms by bytes. What holds the tile is
// its instructions and their latency, so the design cuts instructions and
// buys warps.
// Design: every warp owns 16 rows through every phase, with no block
// barrier in its loop (as tcb's). Its rows stay bf16 in shared memory:
// acc in two stages (cp.async, 16-byte units, 8-byte ones where D % 8 != 0),
// g, weights and mask in one slot, refilled as soon as the gate has read
// it; the stages take the bt::at swizzle, so ldmatrix and the C-fragment
// reads are free of bank conflicts. The block stages W2c and W2g once in
// bf16 (exact): ldmatrix.trans reads W for y = silu(acc) @ W2, ldmatrix W^T
// for d_h = d_y @ W2^T. Both products run as mma.sync.m16n8k16 in two bf16
// passes (bf16_tile.cuh: A = hi + lo of the f32 silu(acc) or d_y), so
// they keep f32 accuracy, and a 16-deep step costs 4 MMAs a tile pair and
// one ldmatrix for each of A and B. silu(acc) is taken on the A fragment
// as it leaves ldmatrix. y stays in registers: the layer-norm statistics
// (two passes) and z come from there, z is parked (a float4 a lane and
// 8-column tile) for the gate's loop, which stays rolled (the instruction
// cache: see tcb) and writes gz over it, d_weights over the weights it has
// read. d_y is computed in registers from gz and z and passes to d_y @ W2^T
// as its A fragments with no parking (bf16_tile.cuh). d_h is parked, and
// d_acc = d_h * silu'(acc) is written over the acc stage it came from;
// d_acc and d_weights leave by whole-row 16-byte stores. f32 throughout
// the row phase: bf16 values are widened as they are read, each output is
// rounded once as it is written to its stage. A warp takes 20 KB of shared
// memory for a message tile (18 KB for an update), so a block holds 10 warps
// for the message, 11 for an update with W2, 12 without (one block an SM).
// The copy loops walk their units without a division (Walk). Each choice
// won a same-call A/B on an H100 (tools/time_tail_bwd.py; PERF.md §6):
// d_y parked for a rolled d_y @ W2^T, the product's 16-deep steps unrolled
// (spills), and g, weights and mask double-buffered at 8 warps were slower.
// The tile's row phase (row_phase) is shared with the backward with
// parameter gradients (tail_bwd_param_bf16_kernel).
namespace tcb16 {

__host__ __device__ constexpr int warp_bytes(bool msg) {
  return 2 * kAccBytes + (msg ? 2 : 1) * kRowBytes + kParkBytes + (msg ? kMaskBytes : 0);
}
__host__ __device__ constexpr int fixed_bytes(bool w2) {
  return (w2 ? kWBytes : 0) + kParamBytes;
}
// A block's warps: as many as shared memory holds
__host__ __device__ constexpr int warps(bool msg, bool w2) {
  return (kSmemPerBlock - fixed_bytes(w2)) / warp_bytes(msg);
}
__host__ __device__ constexpr size_t smem_bytes(bool msg, bool w2) {
  return (size_t)fixed_bytes(w2) + (size_t)warps(msg, w2) * warp_bytes(msg);
}

// vec, as the launch passes it: bits 0-1 the unit of the g and weights
// copies (2: 16 bytes, 1: 8 bytes, 0: one value, loaded now), bit 2 the
// mask 16-byte aligned
inline int vec_of(const bf16* g, const bf16* weights, const bf16* mask, int d) {
  const uintptr_t a = (uintptr_t)g | (uintptr_t)weights;
  const int unit = d % 8 == 0 && a % 16 == 0 ? 2 : a % 8 == 0 ? 1 : 0;
  return unit | (mask != nullptr && (uintptr_t)mask % 16 == 0 ? 4 : 0);
}

// Copies of the g, weights and mask rows from row0 (vec: vec_of; w: units
// of the copies, one value each for a unit 0, which are loaded now); kG:
// g too (the message forward has none). The caller commits them.
template <bool kMsg, bool kG = true>
__device__ __forceinline__ void fetch_rows(char* g_s, char* w_s, bf16* m_s,
                                           const bf16* g, const bf16* weights,
                                           const bf16* mask, long row0, int n_rows,
                                           int d, int vec, Walk w, int lane) {
  const int unit = vec & 3;
  if (unit) {
    const int n = unit == 2 ? 8 : 4;
    for (; w.r < kRows; w.next()) {
      const int r = w.r;
      const int c = w.c * n;
      const long l = row0 + r;
      const bool ok = l < n_rows;
      const long src = (ok ? l : 0) * d + c;
      const int at = bt::at<8>(r, c);
      if (unit == 2) {
        if (kG) tc::copy16(g_s + at, g + src, ok);
        if (kMsg) tc::copy16(w_s + at, weights + src, ok);
      } else {
        if (kG) bt::copy8(g_s + at, g + src, ok);
        if (kMsg) bt::copy8(w_s + at, weights + src, ok);
      }
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (; w.r < kRows; w.next()) {
      const int r = w.r;
      const int c = w.c;
      const long l = row0 + r;
      const int at = bt::at<8>(r, c);
      if (kG) *reinterpret_cast<bf16*>(g_s + at) = l < n_rows ? g[l * d + c] : zero;
      if (kMsg) *reinterpret_cast<bf16*>(w_s + at) = l < n_rows ? weights[l * d + c] : zero;
    }
  }
  if (!kMsg) return;
  if (vec & 4) {
    if (lane < 2) {  // 8 rows a lane
      const long first = row0 + 8 * lane;
      const long left = n_rows - first;
      const int bytes = left <= 0 ? 0 : left >= 8 ? 16 : 2 * (int)left;
      bt::copy16_n(m_s + 8 * lane, mask + (bytes ? first : 0), bytes);
    }
  } else if (lane < kRows) {
    const long l = row0 + lane;
    m_s[lane] = l < n_rows ? mask[l] : __float2bfloat16(0.f);
  }
}

// Copies of the 16 acc rows from row0 into the stage st (zeros from n_rows
// on; the gate half at column kMaxD), n values a copy (w: units of n, 2D / n
// a row); the caller commits them.
__device__ __forceinline__ void fetch_acc(char* st, const bf16* acc, long row0,
                                          int n_rows, int d, int n, Walk w) {
  const int u = n == 8 ? d >> 3 : d >> 2;  // copies a half row
  for (; w.r < kRows; w.next()) {
    const int r = w.r;
    const int c = w.c;
    const int half = c >= u;
    const long l = row0 + r;
    const bool ok = l < n_rows;
    const bf16* src = acc + (ok ? l : 0) * 2 * d + n * c;
    char* dst = st + bt::at<16>(r, half * kMaxD + n * (c - half * u));
    if (n == 8)
      tc::copy16(dst, src, ok);
    else
      bt::copy8(dst, src, ok);
  }
}

// y[h] += silu(acc_h) @ W_h over the 16-deep steps below D and the tile
// pairs that hold a column below D (everything past D is zero-padded)
__device__ __forceinline__ void product_y(const char* acc_s, const char* w_s, int d8,
                                          int d16, int lane, float y[2][8][4]) {
  const int lr = lane & 7;
  const int lm = lane >> 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const char* w = w_s + h * kMaxD * kMaxD * 2;
#pragma unroll 1
    for (int ks = 0; ks < d16; ++ks) {
      uint32_t a[4], hi[4], lo[4];
      bt::ldsm4(a, acc_s + bt::at<16>(lr + 8 * (lm & 1), h * kMaxD + 16 * ks + 8 * (lm >> 1)));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x0 = bt::lo_f(a[i]);
        const float x1 = bt::hi_f(a[i]);
        bt::split(x0 * tcb::sigm_fast(x0), x1 * tcb::sigm_fast(x1), hi[i], lo[i]);
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (2 * jp >= d8) break;
        uint32_t b[4];
        bt::ldsm4_t(b, w + bt::at<8>(16 * ks + lr + 8 * (lm & 1), 16 * jp + 8 * (lm >> 1)));
        bt::mma2_pair(y[h][2 * jp], y[h][2 * jp + 1], hi, lo, b);
      }
    }
  }
}

constexpr int kPlane = kAccBytes;  // [kRows][2 kMaxD] bf16: h's or d_y's hi or lo

// A warp's buffers for one 16-row tile of the bf16 backward kernels: the acc
// stage (d_acc once written); g and weights (d_weights once read); the
// parked f32 fragments (z, then gz, then d_h; with parameter gradients and
// W2 then d_y's hi and lo planes); with parameter gradients and W2 h's hi
// and lo planes; the mask
struct TileBufs {
  char* acc_s;
  char* g_s;
  char* wt_s;
  float4* f_s;
  char* h_s;
  const bf16* m_s;
};

// One warp's tile of the bf16 backward from acc to d_acc, the serving
// kernel's and the one with parameter gradients' alike: v = y, then z, then
// d_y in registers; the gate's backward, d_weights over the weights it has
// read and stored; refill() once g, weights and mask have been read (the
// caller's copies into their slots, committed); with W2 d_h = d_y @ W2^T
// parked and d_acc = d_h * silu'(acc) over the acc stage; d_acc stored. w_s:
// the staged W2; p_s: b2 (2 kMaxD), then ncs, ncb, ngs, ngb (kMaxD each).
// kParams: the four layer-norm vectors' terms of each 8-column tile summed
// into ln, and with W2 h = silu(acc) and d_y parked as bf16 hi and lo planes
// (zero past D and n_rows, as acc is).
template <bool kMsg, bool kW2, bool kParams, typename Refill>
__device__ __forceinline__ void row_phase(const char* w_s, const float* p_s,
                                          const TileBufs& b, long row0, int n_rows,
                                          const Geom& geo, int n, Walk acc_walk,
                                          Walk out_walk, bf16* d_acc, bf16* d_weights,
                                          bf16* d_mask, prm::Rot8& ln, Refill&& refill) {
  const float* b2_s = p_s;
  const float* ncs_s = p_s + 2 * kMaxD;
  const float* ncb_s = ncs_s + kMaxD;
  const float* ngs_s = ncb_s + kMaxD;
  const float* ngb_s = ngs_s + kMaxD;
  char* acc_s = b.acc_s;
  char* g_s = b.g_s;
  char* wt_s = b.wt_s;
  float4* f_s = b.f_s;
  const bf16* m_s = b.m_s;
  const int d = geo.d;
  const int lane = geo.lane;
  const int gid = geo.gid;
  const int q = geo.q;
  const int d8 = geo.d8;
  const int d16 = geo.d16;
  const float inv_d = geo.inv_d;

  // v: y = silu(acc) @ blockdiag(W2c, W2g) + b2, or acc; then z; then d_y.
  // Element (h, nt, j): row gid + 8 (j >> 1), column 8 nt + 2 q + (j & 1)
  // of half h; every element past D is zero.
  float v[2][8][4];
  if constexpr (kW2) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[h][nt][j] = b2_s[h * kMaxD + nt * 8 + 2 * q + (j & 1)];
    product_y(acc_s, w_s, d8, d16, lane, v);
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const uint32_t p =
              nt < d8 ? *reinterpret_cast<const uint32_t*>(
                            acc_s + bt::at<16>(gid + 8 * rr, h * kMaxD + nt * 8 + 2 * q))
                      : 0u;
          v[h][nt][2 * rr] = bt::lo_f(p);
          v[h][nt][2 * rr + 1] = bt::hi_f(p);
        }
  }

  // two-pass layer-norm statistics of each half row, then z (zero past D),
  // parked for the gate's loop
  float mean[2][2] = {}, inv[2][2] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) mean[h][j >> 1] += v[h][nt][j];
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
          const float c = v[h][nt][j] - mean[h][j >> 1];
          inv[h][j >> 1] = fmaf(c, c, inv[h][j >> 1]);
        }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      inv[h][rr] = rsqrtf(tc::quad_sum(inv[h][rr]) * inv_d + kEps);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[h][nt][j] = nt * 8 + 2 * q + (j & 1) < d
                          ? (v[h][nt][j] - mean[h][j >> 1]) * inv[h][j >> 1]
                          : 0.f;
      if (nt < d8)
        f_s[(h * 8 + nt) * 32 + lane] =
            make_float4(v[h][nt][0], v[h][nt][1], v[h][nt][2], v[h][nt][3]);
    }

  // the gate's backward (gate_row_bwd's arithmetic): d_weights, d_mask,
  // and the layer norms' gz = d_out * scale with their sums, where d_out is
  // d_cn or d_gn, the cotangent of an affine output; gz goes over the z it
  // came from, d_weights over the weights just read
  float s1[2][2] = {}, s2[2][2] = {}, mask_part[2] = {};
  float m[2] = {1.f, 1.f};
  if (kMsg) {
    m[0] = __bfloat162float(m_s[gid]);
    m[1] = __bfloat162float(m_s[gid + 8]);
  }
#pragma unroll 1
  for (int nt = 0; nt < d8; ++nt) {
    const float4 zc4 = f_s[nt * 32 + lane];
    const float4 zg4 = f_s[(8 + nt) * 32 + lane];
    const float zc[4] = {zc4.x, zc4.y, zc4.z, zc4.w};
    const float zg[4] = {zg4.x, zg4.y, zg4.z, zg4.w};
    const int e = nt * 8 + 2 * q;
    const float2 ncs = *reinterpret_cast<const float2*>(ncs_s + e);
    const float2 ncb = *reinterpret_cast<const float2*>(ncb_s + e);
    const float2 ngs = *reinterpret_cast<const float2*>(ngs_s + e);
    const float2 ngb = *reinterpret_cast<const float2*>(ngb_s + e);
    float gzc[4], gzg[4], lv[8] = {};  // lv: kParams, this tile's vector terms
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int at = bt::at<8>(gid + 8 * rr, e);
      const uint32_t gp = *reinterpret_cast<const uint32_t*>(g_s + at);
      const uint32_t wp = kMsg ? *reinterpret_cast<const uint32_t*>(wt_s + at) : 0u;
      float dw[2] = {};
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * rr + jj;
        const float sc = jj ? ncs.y : ncs.x;
        const float sg = jj ? ngs.y : ngs.x;
        const float cn = fmaf(zc[j], sc, jj ? ncb.y : ncb.x);
        const float gn = fmaf(zg[j], sg, jj ? ngb.y : ngb.x);
        const float sig_cn = sigm_fast(cn);
        const float silu_cn = cn * sig_cn;
        const float sig_gn = sigm_fast(gn);
        const float gv = jj ? bt::hi_f(gp) : bt::lo_f(gp);  // zero past D
        float up = gv;
        if (kMsg) {
          const float wv = jj ? bt::hi_f(wp) : bt::lo_f(wp);
          mask_part[rr] = fmaf(gv, silu_cn * sig_gn * wv, mask_part[rr]);
          up = gv * wv * m[rr];
          dw[jj] = gv * silu_cn * sig_gn * m[rr];
        }
        const float dcn = up * sig_gn * silu_grad_of(cn, sig_cn);
        const float dgn = up * silu_cn * sig_gn * (1.f - sig_gn);
        gzc[j] = dcn * sc;
        gzg[j] = dgn * sg;
        s1[0][rr] += gzc[j];
        s2[0][rr] = fmaf(gzc[j], zc[j], s2[0][rr]);
        s1[1][rr] += gzg[j];
        s2[1][rr] = fmaf(gzg[j], zg[j], s2[1][rr]);
        if constexpr (kParams) prm::vec_terms(lv, jj, dcn, zc[j], dgn, zg[j]);
      }
      if (kMsg) *reinterpret_cast<uint32_t*>(wt_s + at) = bt::pack(dw[0], dw[1]);
    }
    f_s[nt * 32 + lane] = make_float4(gzc[0], gzc[1], gzc[2], gzc[3]);
    f_s[(8 + nt) * 32 + lane] = make_float4(gzg[0], gzg[1], gzg[2], gzg[3]);
    if constexpr (kParams) ln.add_next(prm::scatter8(lv, lane));
  }
  if constexpr (kParams)
    for (int nt = d8; nt < 8; ++nt) ln.add_next(0.f);  // the sums back in place
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long l = row0 + gid + 8 * rr;
    if (kMsg && d_mask != nullptr) {
      const float dm = tc::quad_sum(mask_part[rr]);
      if (q == 0 && l < n_rows) chgnet::store_v(d_mask + l, dm);
    }
  }
  __syncwarp();  // d_weights in its slot; g, weights and mask read
  if (kMsg) store_rows<8>(wt_s, d_weights, row0, n_rows, d, n, out_walk);
  __syncwarp();  // the slots free
  refill();

  // d_y = (gz - mean(gz) - z mean(gz z)) * inv, zero past D, over z
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      s1[h][rr] = tc::quad_sum(s1[h][rr]) * inv_d;
      s2[h][rr] = tc::quad_sum(s2[h][rr]) * inv_d;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float4 gz4 = nt < d8 ? f_s[(h * 8 + nt) * 32 + lane]
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      const float gz[4] = {gz4.x, gz4.y, gz4.z, gz4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = j >> 1;
        v[h][nt][j] = nt * 8 + 2 * q + (j & 1) < d
                          ? (gz[j] - s1[h][rr] - v[h][nt][j] * s2[h][rr]) * inv[h][rr]
                          : 0.f;
      }
    }

  if constexpr (kW2) {
    // d_h = d_y @ W2^T, parked; d_acc = d_h * silu'(acc) over the acc stage;
    // kParams: h = silu(acc) into its planes
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float dh[8][4];
      product_dh(v[h], w_s + h * kMaxD * kMaxD * 2, d8, d16, lane, dh);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        if (nt < d8)
          f_s[(h * 8 + nt) * 32 + lane] =
              make_float4(dh[nt][0], dh[nt][1], dh[nt][2], dh[nt][3]);
    }
#pragma unroll 1
    for (int nt = 0; nt < d8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 dh = f_s[(h * 8 + nt) * 32 + lane];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int at = bt::at<16>(gid + 8 * rr, h * kMaxD + nt * 8 + 2 * q);
          uint32_t* p = reinterpret_cast<uint32_t*>(acc_s + at);
          const float a0 = bt::lo_f(*p);
          const float a1 = bt::hi_f(*p);
          const float sg0 = sigm_fast(a0);
          const float sg1 = sigm_fast(a1);
          *p = bt::pack((rr ? dh.z : dh.x) * silu_grad_of(a0, sg0),
                        (rr ? dh.w : dh.y) * silu_grad_of(a1, sg1));
          if constexpr (kParams) {
            uint32_t hi, lo;
            bt::split(a0 * sg0, a1 * sg1, hi, lo);
            *reinterpret_cast<uint32_t*>(b.h_s + at) = hi;
            *reinterpret_cast<uint32_t*>(b.h_s + kPlane + at) = lo;
          }
        }
      }
    if constexpr (kParams) {
      __syncwarp();  // d_h read: its slots take d_y's planes
      char* dy_s = reinterpret_cast<char*>(f_s);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int at = bt::at<16>(gid + 8 * rr, h * kMaxD + nt * 8 + 2 * q);
            uint32_t hi, lo;
            bt::split(v[h][nt][2 * rr], v[h][nt][2 * rr + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(dy_s + at) = hi;
            *reinterpret_cast<uint32_t*>(dy_s + kPlane + at) = lo;
          }
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          if (nt < d8)
            *reinterpret_cast<uint32_t*>(
                acc_s + bt::at<16>(gid + 8 * rr, h * kMaxD + nt * 8 + 2 * q)) =
                bt::pack(v[h][nt][2 * rr], v[h][nt][2 * rr + 1]);
  }
  __syncwarp();  // d_acc in the stage
  store_rows<16>(acc_s, d_acc, row0, n_rows, d, n, acc_walk);
  __syncwarp();  // the stage free
}

template <bool kMsg, bool kW2>
__global__ void __launch_bounds__(32 * warps(kMsg, kW2), 1)
    tail_bwd_bf16_kernel(TailT<bf16> t, const bf16* __restrict__ acc,
                         const bf16* __restrict__ weights,
                         const bf16* __restrict__ mask, const bf16* __restrict__ g,
                         bf16* __restrict__ d_acc, bf16* __restrict__ d_weights,
                         bf16* __restrict__ d_mask, int n_rows, int d, int vec) {
  constexpr int kWarps = warps(kMsg, kW2);
  extern __shared__ float4 smem4[];
  char* w_s = reinterpret_cast<char*>(smem4);  // [2][kMaxD][kMaxD] bf16 with W2
  // b2 (gate at kMaxD), then ncs, ncb, ngs, ngb
  float* b2_s = reinterpret_cast<float*>(w_s + (kW2 ? kWBytes : 0));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this warp's buffers: two acc stages; g and weights (d_weights once
  // read); the parked f32 fragments (z, then gz, then d_h); the mask
  char* mine = w_s + fixed_bytes(kW2) + warp * warp_bytes(kMsg);
  char* g_s = mine + 2 * kAccBytes;
  char* wt_s = g_s + kRowBytes;  // with kMsg
  float4* f_s = reinterpret_cast<float4*>(g_s + (kMsg ? 2 : 1) * kRowBytes);
  bf16* m_s = reinterpret_cast<bf16*>(f_s + kParkBytes / 16);  // with kMsg

  // weights and parameters zero-padded to kMaxD; this warp's buffers zeroed
  // (the copies never write the pad columns)
  stage_tail<kW2>(w_s, b2_s, t, d);
  for (int i = lane; i < warp_bytes(kMsg) / 16; i += 32)
    reinterpret_cast<float4*>(mine)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();  // the only block barrier

  const int n_tiles = (n_rows + kRows - 1) / kRows;
  const int step = gridDim.x * kWarps;
  int tile = blockIdx.x * kWarps + warp;
  // the copies' units: acc and d_acc by n values (16 bytes, or 8), g and
  // weights by vec's unit, d_weights by n
  const int n = d % 8 == 0 ? 8 : 4;
  const Walk acc_walk(lane, 2 * d / n);
  const Walk row_walk(lane, d / ((vec & 3) == 2 ? 8 : (vec & 3) == 1 ? 4 : 1));
  const Walk out_walk(lane, d / n);
  // acc runs one tile ahead through the two stages; g, weights and mask
  // for the next tile are copied as soon as the gate has read this tile's
  if (tile < n_tiles) fetch_acc(mine, acc, (long)tile * kRows, n_rows, d, n, acc_walk);
  tc::commit();
  if (tile < n_tiles)
    fetch_rows<kMsg>(g_s, wt_s, m_s, g, weights, mask, (long)tile * kRows, n_rows, d,
                     vec, row_walk, lane);
  tc::commit();
  prm::Rot8 no_sums;  // serving takes no parameter gradients
  const Geom geo(d, lane);
  for (int it = 0; tile < n_tiles; ++it, tile += step) {
    char* acc_s = mine + (it & 1) * kAccBytes;
    const bool ahead = tile + step < n_tiles;
    if (ahead)
      fetch_acc(mine + ((it + 1) & 1) * kAccBytes, acc, (long)(tile + step) * kRows,
                n_rows, d, n, acc_walk);
    tc::commit();
    tc::wait_pending<1>();  // all but the next tile's acc have landed
    __syncwarp();
    const long row0 = (long)tile * kRows;
    row_phase<kMsg, kW2, false>(
        w_s, b2_s, {acc_s, g_s, wt_s, f_s, nullptr, m_s}, row0, n_rows, geo, n, acc_walk,
        out_walk, d_acc, d_weights, d_mask, no_sums, [&] {
          if (ahead)
            fetch_rows<kMsg>(g_s, wt_s, m_s, g, weights, mask, (long)(tile + step) * kRows,
                             n_rows, d, vec, row_walk, lane);
          tc::commit();
        });
  }
}

// ------------------------------------------- message forward on bf16 tiles
// The message forward in bf16 (row 6, D <= 64): tcb::tail_fwd_tc_kernel's
// function and schedule (a warp owns 16 rows through every phase, no block
// barrier in its loop) on bf16 stages and the bf16 tensor cores. acc runs
// one tile ahead through two bf16 stages (cp.async, 16-byte units, 8-byte
// ones where D % 8 != 0); the weights rows and mask entries take their own
// slot, copied once the previous tile's messages have left it and waited
// for only before the gate. y = b2 + silu(acc) @ blockdiag(W2c, W2g) is
// product_y's: W2c and W2g staged once a block in bf16 (16 KB, exact) and
// read by ldmatrix.trans, each A fragment by ldmatrix, silu in f32, split
// into a bf16 hi and lo, two mma.sync.m16n8k16 passes (f32 accuracy). y
// stays in its C fragments: the layer-norm statistics (two passes, quad
// shuffles) and the gate (message_tile's arithmetic: sigm_fast, the same
// order of products) read it from registers. The messages, rounded once to
// bf16, go over the weights they were made from and leave by whole-row
// 16-byte stores (8-byte where D % 8 != 0). Nothing is parked in an acc
// stage, so its columns past D, which the copies never write, stay zero.
// A warp takes 10 KB of shared memory; registers set the warps a block:
// 16 at up to 128 registers, which beat 12 side by side (PERF.md §6).
constexpr int kFwdWarps = 16;
constexpr int kFwdWarpBytes = 2 * kAccBytes + kRowBytes + kMaskBytes;
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  return (size_t)fixed_bytes(true) + (size_t)kFwdWarps * kFwdWarpBytes;
}
static_assert(fwd_smem_bytes() <= kSmemPerBlock, "over the H100's shared memory a block");

__global__ void __launch_bounds__(32 * kFwdWarps, 1)
    tail_fwd_bf16_kernel(TailT<bf16> t, const bf16* __restrict__ acc,
                         const bf16* __restrict__ weights, const bf16* __restrict__ mask,
                         bf16* __restrict__ out, int n_rows, int d, int vec) {
  extern __shared__ float4 smem4[];
  char* w_s = reinterpret_cast<char*>(smem4);  // [2][kMaxD][kMaxD] bf16
  float* b2_s = reinterpret_cast<float*>(w_s + kWBytes);  // gate at kMaxD
  const float* ncs_s = b2_s + 2 * kMaxD;
  const float* ncb_s = ncs_s + kMaxD;
  const float* ngs_s = ncb_s + kMaxD;
  const float* ngb_s = ngs_s + kMaxD;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this warp's buffers: two acc stages; weights (the messages once read);
  // the mask
  char* mine = w_s + fixed_bytes(true) + warp * kFwdWarpBytes;
  char* wt_s = mine + 2 * kAccBytes;
  bf16* m_s = reinterpret_cast<bf16*>(wt_s + kRowBytes);
  stage_tail<true>(w_s, b2_s, t, d);
  for (int i = lane; i < kFwdWarpBytes / 16; i += 32)
    reinterpret_cast<float4*>(mine)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();  // the only block barrier

  const int gid = lane >> 2;
  const int q = lane & 3;
  const int d8 = (d + 7) / 8;
  const int d16 = (d + 15) / 16;
  const float inv_d = 1.f / d;
  const int n_tiles = (n_rows + kRows - 1) / kRows;
  const int step = gridDim.x * kFwdWarps;
  int tile = blockIdx.x * kFwdWarps + warp;
  // the copies' units: acc and out by n values (16 bytes, or 8), weights
  // by vec's unit
  const int n = d % 8 == 0 ? 8 : 4;
  const Walk acc_walk(lane, 2 * d / n);
  const Walk row_walk(lane, d / ((vec & 3) == 2 ? 8 : (vec & 3) == 1 ? 4 : 1));
  const Walk out_walk(lane, d / n);
  if (tile < n_tiles) fetch_acc(mine, acc, (long)tile * kRows, n_rows, d, n, acc_walk);
  tc::commit();
  if (tile < n_tiles)
    fetch_rows<true, false>(nullptr, wt_s, m_s, nullptr, weights, mask,
                            (long)tile * kRows, n_rows, d, vec, row_walk, lane);
  tc::commit();
  for (int it = 0; tile < n_tiles; ++it, tile += step) {
    const char* acc_s = mine + (it & 1) * kAccBytes;
    const bool ahead = tile + step < n_tiles;
    if (ahead)
      fetch_acc(mine + ((it + 1) & 1) * kAccBytes, acc, (long)(tile + step) * kRows,
                n_rows, d, n, acc_walk);
    tc::commit();
    tc::wait_pending<2>();  // this tile's acc; its weights may still be in flight
    __syncwarp();
    const long row0 = (long)tile * kRows;

    // y = b2 + silu(acc) @ blockdiag(W2c, W2g). Element (h, nt, j): row
    // gid + 8 (j >> 1), column 8 nt + 2 q + (j & 1) of half h; exactly 0
    // past D (zero weights and b2)
    float y[2][8][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) y[h][nt][j] = b2_s[h * kMaxD + nt * 8 + 2 * q + (j & 1)];
    product_y(acc_s, w_s, d8, d16, lane, y);

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
    tc::wait_pending<1>();  // the weights and mask too
    __syncwarp();

    // the gate times weights and mask (message_tile's arithmetic), over
    // the weights a lane has just read
    const float m[2] = {__bfloat162float(m_s[gid]), __bfloat162float(m_s[gid + 8])};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int e0 = nt * 8 + 2 * q;
      if (e0 >= d) break;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        uint32_t* wp = reinterpret_cast<uint32_t*>(wt_s + bt::at<8>(gid + 8 * rr, e0));
        const uint32_t wv = *wp;
        float v[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * rr + jj;
          const int e = e0 + jj;
          const float zc = (y[0][nt][j] - mean[0][rr]) * inv[0][rr];
          const float zg = (y[1][nt][j] - mean[1][rr]) * inv[1][rr];
          const float cn = fmaf(zc, ncs_s[e], ncb_s[e]);
          v[jj] = cn * tcb::sigm_fast(cn) * tcb::sigm_fast(fmaf(zg, ngs_s[e], ngb_s[e])) *
                  (jj ? bt::hi_f(wv) : bt::lo_f(wv)) * m[rr];
        }
        *wp = bt::pack(v[0], v[1]);
      }
    }
    __syncwarp();  // the messages in their slot
    store_rows<8>(wt_s, out, row0, n_rows, d, n, out_walk);
    __syncwarp();  // the slot free
    if (ahead)
      fetch_rows<true, false>(nullptr, wt_s, m_s, nullptr, weights, mask,
                              (long)(tile + step) * kRows, n_rows, d, vec, row_walk, lane);
    tc::commit();
  }
}

}  // namespace tcb16


// -------------------- backward with parameter gradients on tensor cores
// The backward with parameter gradients, which every train step runs (rows
// 7 and 9 with d_params at D <= 64: "7p" and "9p" in PERF.md): the serving
// tiles' function plus the parameter gradients of _bwd_kernel (:190) and
// _bwd_kernel_nw (:734), per-tile sums :213-228: dW2c = silu(acc_c)^T d_y_c
// and dW2g alike, db2 = the sum of d_y over the rows (with W2), and the
// four layer-norm vectors' gradients, sum(d_cn z_c), sum(d_cn),
// sum(d_gn z_g), sum(d_gn), where d_cn and d_gn are the cotangents of the
// two affine outputs.
//
// Bound: at D = 64 the serving backward's bytes (a train step's 14 message
// calls: 1.276 ms in f32 and 0.638 ms in bf16, bytes) plus a third product
// the size of the other two, dW2 = h^T d_y. On the CUDA cores (the
// f32 FMAs of the kernel this replaces) that product alone takes longer than
// the f32 bound, so it runs on the tensor cores at f32 accuracy like the
// other two.
// Design: the serving tiles' row phase (tcb::row_phase, tcb16::row_phase
// above, with kParams), one 16-row tile a warp through every phase, and a
// block of kParamGroup warps that meets twice a round of tiles at a named
// barrier. The warps of a block take its tiles in
// rounds, one tile each; after its tile's row phase a warp parks the tile's
// h = silu(acc) and d_y in shared memory (h from the d_acc loop, which
// takes sigmoid(acc) anyway), and at the barrier each warp becomes the owner
// of one eighth of dW2 (2 m16 tiles of W's rows by 4 n8 tiles of its
// columns in one half: 32 accumulators a lane) and adds every parked tile
// of the round into it, h^T as the A operand and d_y as B, in the order of
// the tiles; a second barrier frees the parked tiles. f32: 3xTF32
// (tf32x3.cuh), h over d_h in the fragment slots, d_y where the serving
// tile leaves it; bf16: h and d_y parked as bf16 hi and lo planes, read by
// ldmatrix.trans, three m16n8k16 passes (lo hi, hi lo, hi hi). db2 goes to
// the owners of W's first rows: the sum of d_y's fragments (f32), a product
// with a ones A fragment (bf16). The layer-norm vectors are summed in the
// gate's loop: each 8-column tile's terms over the lane's two rows, then
// over the 8 lanes of its columns by a fixed tree of shuffles that leaves a
// lane one (vector, column) sum, kept in 8 registers rotated through the
// loop (a rolled loop cannot index registers). Without W2 (the update tail
// of the default model) there is no product: the row phase and the vector
// sums only, 12 warps a block. One acc stage a warp buys the warps a round
// needs (8 with W2, one block an SM); the next tile's rows are copied while
// the owners work, where their slots are free. Each block writes one f32
// row of partial in a fixed order (the owners' tiles, then the warps'
// vector sums added in warp order), so two runs give equal bits.
namespace tcb {

// The block's warps: with W2 the group that shares dW2, 8 owners of 8
// tiles each; without, as many as keep the row phase busy
constexpr int kParamGroup = 8;
__host__ __device__ constexpr int param_warps(bool w2) { return w2 ? kParamGroup : 12; }
// a warp's buffers: one acc stage; the g and weights slots (gz, then d_y's
// halves); with W2 the fragment slots (y, then d_h, then h); the mask
__host__ __device__ constexpr int param_warp_floats(bool w2) {
  return kAccFloats + 2 * kRowFloats + (w2 ? kFragFloats : 0) + kRows;
}
__host__ __device__ constexpr size_t param_smem_bytes(bool w2) {
  return (size_t)((w2 ? kWFloats : 0) + kParamFloats +
                  param_warps(w2) * param_warp_floats(w2)) *
         sizeof(float);
}
static_assert(param_smem_bytes(true) <= 232448 && param_smem_bytes(false) <= 232448,
              "over the H100's shared memory a block");

// Element (r, c) of half hh of a tile in the fragment slots of park(): h
// there once the d_acc loop has read d_h
__device__ __forceinline__ int at_frag(int hh, int r, int c) {
  return ((hh * 8 + (c >> 3)) * 4 + 2 * (r >> 3) + (c & 1)) * 32 + 4 * (r & 7) +
         ((c & 7) >> 1);
}

// c += h^T d_y over one parked 16-row tile, the owner's 2 x 4 tiles of half
// oh at 3xTF32 (lo hi, hi lo, hi hi), in two 8-row k steps; h from the
// tile's fragment slots, d_y from its g (core half) or weights (gate half)
// slot. With db: the lane's sums of d_y's fragments, column 8 (nt0 + j) +
// gid, rows q and q + 4 of each step.
__device__ __forceinline__ void owner_product(const float* h_s, const float* dy_s, int oh,
                                              int mt0, int nt0, bool with_db, int lane,
                                              float c[2][4][4], float db[4]) {
  const int gid = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int r = 8 * s + q;
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = 16 * (mt0 + i) + gid;
      const float av[4] = {h_s[at_frag(oh, r, m)], h_s[at_frag(oh, r, m + 8)],
                           h_s[at_frag(oh, r + 4, m)], h_s[at_frag(oh, r + 4, m + 8)]};
      tc::split_a(av, ahi[i], alo[i]);
    }
    uint32_t bhi[4][2], blo[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 8 * (nt0 + j) + gid;
      const float b0 = dy_s[at_row(r, n)];
      const float b1 = dy_s[at_row(r + 4, n)];
      if (with_db) {
        db[j] += b0;
        db[j] += b1;
      }
      tc::split(b0, bhi[j][0], blo[j][0]);
      tc::split(b1, bhi[j][1], blo[j][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) tc::mma(c[i][j], alo[i], bhi[j][0], bhi[j][1]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) tc::mma(c[i][j], ahi[i], blo[j][0], blo[j][1]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) tc::mma(c[i][j], ahi[i], bhi[j][0], bhi[j][1]);
  }
}

template <bool kMsg, bool kW2>
__global__ void __launch_bounds__(32 * param_warps(kW2), 1)
    tail_bwd_param_tc_kernel(Tail t, const float* __restrict__ acc,
                             const float* __restrict__ weights,
                             const float* __restrict__ mask, const float* __restrict__ g,
                             float* __restrict__ d_acc, float* __restrict__ d_weights,
                             float* __restrict__ d_mask, float* __restrict__ partial,
                             int n_rows, int d, int vec) {
  constexpr int kWarps = param_warps(kW2);
  constexpr int kWarpFloats = param_warp_floats(kW2);
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [2][kMaxD][kMaxD] with W2
  float* b2_s = w_s + (kW2 ? kWFloats : 0);      // [2 kMaxD], gate at kMaxD
  float* ncs_s = b2_s + 2 * kMaxD;
  float* ncb_s = ncs_s + kMaxD;
  float* ngs_s = ncb_s + kMaxD;
  float* ngb_s = ngs_s + kMaxD;
  float* warps_s = ngb_s + kMaxD;  // the warps' buffers, kWarpFloats each
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* acc_s = warps_s + warp * kWarpFloats;
  float* g_s = acc_s + kAccFloats;
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
    if (kW2 && k < d && n < d) v = (h ? t.w2g : t.w2c)[k * d + n];
    w_s[h * kMaxD * kMaxD + k * kMaxD + (n ^ swz(k))] = v;
  }
  for (int i = threadIdx.x; i < 2 * kMaxD; i += blockDim.x) {
    const int h = i / kMaxD;
    const int e = i % kMaxD;
    b2_s[i] = kW2 && e < d ? t.b2[h * d + e] : 0.f;
    if (h == 0) {
      ncs_s[e] = e < d ? t.ncs[e] : 0.f;
      ncb_s[e] = e < d ? t.ncb[e] : 0.f;
      ngs_s[e] = e < d ? t.ngs[e] : 0.f;
      ngb_s[e] = e < d ? t.ngb[e] : 0.f;
    }
  }
  for (int i = lane; i < kWarpFloats; i += 32) acc_s[i] = 0.f;
  __syncthreads();

  const int gid = lane >> 2;
  const int q = lane & 3;
  const prm::Share share = prm::block_share((n_rows + kRows - 1) / kRows);
  const int rounds = (share.last - share.first + kWarps - 1) / kWarps;
  // the owner's tiles of dW2: half oh, m-tiles mt0 and mt0 + 1, n-tiles
  // nt0 .. nt0 + 3 (none that lies wholly past D); the owners of m-tile 0
  // sum db2
  const int oh = warp >> 2;
  const int mt0 = 2 * ((warp >> 1) & 1);
  const int nt0 = 4 * (warp & 1);
  const bool owner = kW2 && 16 * mt0 < d && 8 * nt0 < d;
  float cw[2][4][4] = {}, db[4] = {};
  prm::Rot8 ln;
  ln.clear();
  const Geom geo(d, lane);

  int tile = share.first + warp;
  if (tile < share.last) {
    fetch_acc(acc_s, acc, (long)tile * kRows, n_rows, d, lane);
    fetch_rows<kMsg>(g_s, wt_s, m_s, g, weights, mask, tile, n_rows, d, vec, lane);
  }
  tc::commit();
  for (int k = 0; k < rounds; ++k, tile += kWarps) {
    const int next = tile + kWarps;
    if (tile < share.last) {
      tc::wait_pending<0>();
      __syncwarp();
      const long row0 = (long)tile * kRows;
      row_phase<float, kMsg, kW2, true>(w_s, b2_s, {acc_s, g_s, wt_s, f_s, m_s}, row0,
                                        n_rows, geo, d_acc, d_weights, d_mask, ln);
      __syncwarp();  // this tile's acc read
      if (next < share.last) {
        fetch_acc(acc_s, acc, (long)next * kRows, n_rows, d, lane);
        // with W2 the owners read d_y from the g and weights slots first
        if (!kW2) fetch_rows<kMsg>(g_s, wt_s, m_s, g, weights, mask, next, n_rows, d, vec, lane);
      }
      tc::commit();
    }
    if constexpr (kW2) {
      prm::group_sync(32 * kWarps);  // every tile of the round parked
      if (owner) {
        const int parked = min(kWarps, share.last - (share.first + k * kWarps));
        for (int p = 0; p < parked; ++p) {
          const float* pw = warps_s + p * kWarpFloats;
          owner_product(pw + kAccFloats + 2 * kRowFloats, pw + kAccFloats + oh * kRowFloats,
                        oh, mt0, nt0, mt0 == 0, lane, cw, db);
        }
      }
      prm::group_sync(32 * kWarps);  // read: the slots take the next tiles
      if (tile < share.last && next < share.last)
        fetch_rows<kMsg>(g_s, wt_s, m_s, g, weights, mask, next, n_rows, d, vec, lane);
      tc::commit();
    }
  }

  // this block's row of partial: [dW2c, dW2g (D x D each), db2 (2D)] with
  // W2, then ncs, ncb, ngs, ngb
  tc::wait_pending<0>();
  float* out = partial + (long)blockIdx.x * ((kW2 ? 2 * d * d + 2 * d : 0) + 4 * d);
  if (owner) {
    prm::store_dw(out, cw, oh, mt0, nt0, d, lane);
    if (mt0 == 0)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s = tc::quad_sum(db[j]);
        const int n = 8 * (nt0 + j) + gid;
        if (q == 0 && n < d) out[2 * d * d + oh * d + n] = s;
      }
  }
  prm::park_vectors(acc_s, ln, lane);
  __syncthreads();
  prm::store_vectors(warps_s, kWarpFloats, kWarps, out + (kW2 ? 2 * d * d + 2 * d : 0), d);
}

}  // namespace tcb

namespace tcb16 {

// The block's warps, as tcb::param_warps
__host__ __device__ constexpr int param_warps(bool w2) { return w2 ? tcb::kParamGroup : 12; }
// a warp's buffers: one acc stage; g and weights (d_weights once read); the
// parked f32 fragments (z, gz, d_h; then d_y's hi and lo planes); with W2
// h's hi and lo planes; the mask
__host__ __device__ constexpr int param_warp_bytes(bool msg, bool w2) {
  return kAccBytes + (msg ? 2 : 1) * kRowBytes + kParkBytes + (w2 ? 2 * kPlane : 0) +
         (msg ? kMaskBytes : 0);
}
__host__ __device__ constexpr size_t param_smem_bytes(bool msg, bool w2) {
  return (size_t)fixed_bytes(w2) + (size_t)param_warps(w2) * param_warp_bytes(msg, w2);
}
static_assert(param_smem_bytes(true, true) <= kSmemPerBlock &&
                  param_smem_bytes(false, true) <= kSmemPerBlock &&
                  param_smem_bytes(false, false) <= kSmemPerBlock,
              "over the H100's shared memory a block");

// c += h^T d_y over one parked 16-row tile (one 16-deep k step), the
// owner's 2 x 4 tiles of half oh in three bf16 passes (lo hi, hi lo, hi
// hi): A from h's planes and B from d_y's by ldmatrix.trans. With db: db2's
// sums, a ones A fragment times d_y's lo, then hi (every row of db[j] the
// column sums of n-tile nt0 + j).
__device__ __forceinline__ void owner_product(const char* h_s, const char* dy_s, int oh,
                                              int mt0, int nt0, bool with_db, int lane,
                                              float c[2][4][4], float db[4][4]) {
  const int lr = lane & 7;
  const int lm = lane >> 3;
  uint32_t ahi[2][4], alo[2][4], bhi[2][4], blo[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int at = bt::at<16>(lr + 8 * (lm >> 1), oh * kMaxD + 16 * (mt0 + i) + 8 * (lm & 1));
    bt::ldsm4_t(ahi[i], h_s + at);
    bt::ldsm4_t(alo[i], h_s + kPlane + at);
  }
#pragma unroll
  for (int jp = 0; jp < 2; ++jp) {
    const int at = bt::at<16>(lr + 8 * (lm & 1), oh * kMaxD + 8 * (nt0 + 2 * jp) + 8 * (lm >> 1));
    bt::ldsm4_t(bhi[jp], dy_s + at);
    bt::ldsm4_t(blo[jp], dy_s + kPlane + at);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) bt::mma_pair(c[i][2 * jp], c[i][2 * jp + 1], alo[i], bhi[jp]);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) bt::mma_pair(c[i][2 * jp], c[i][2 * jp + 1], ahi[i], blo[jp]);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) bt::mma_pair(c[i][2 * jp], c[i][2 * jp + 1], ahi[i], bhi[jp]);
  if (with_db) {
    const uint32_t one[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u};
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) bt::mma_pair(db[2 * jp], db[2 * jp + 1], one, blo[jp]);
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) bt::mma_pair(db[2 * jp], db[2 * jp + 1], one, bhi[jp]);
  }
}

template <bool kMsg, bool kW2>
__global__ void __launch_bounds__(32 * param_warps(kW2), 1)
    tail_bwd_param_bf16_kernel(TailT<bf16> t, const bf16* __restrict__ acc,
                               const bf16* __restrict__ weights,
                               const bf16* __restrict__ mask, const bf16* __restrict__ g,
                               bf16* __restrict__ d_acc, bf16* __restrict__ d_weights,
                               bf16* __restrict__ d_mask, float* __restrict__ partial,
                               int n_rows, int d, int vec) {
  constexpr int kWarps = param_warps(kW2);
  constexpr int kWarpBytes = param_warp_bytes(kMsg, kW2);
  extern __shared__ float4 smem4[];
  char* w_s = reinterpret_cast<char*>(smem4);  // [2][kMaxD][kMaxD] bf16 with W2
  // b2 (gate at kMaxD), then ncs, ncb, ngs, ngb
  float* b2_s = reinterpret_cast<float*>(w_s + (kW2 ? kWBytes : 0));
  char* warps_s = w_s + fixed_bytes(kW2);  // the warps' buffers, kWarpBytes each
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  char* acc_s = warps_s + warp * kWarpBytes;
  char* g_s = acc_s + kAccBytes;
  char* wt_s = g_s + kRowBytes;  // with kMsg
  float4* f_s = reinterpret_cast<float4*>(g_s + (kMsg ? 2 : 1) * kRowBytes);
  char* h_s = reinterpret_cast<char*>(f_s) + kParkBytes;       // with W2
  bf16* m_s = reinterpret_cast<bf16*>(h_s + (kW2 ? 2 * kPlane : 0));  // with kMsg

  stage_tail<kW2>(w_s, b2_s, t, d);
  for (int i = lane; i < kWarpBytes / 16; i += 32)
    reinterpret_cast<float4*>(acc_s)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int gid = lane >> 2;
  const int q = lane & 3;
  const prm::Share share = prm::block_share((n_rows + kRows - 1) / kRows);
  const int rounds = (share.last - share.first + kWarps - 1) / kWarps;
  const int oh = warp >> 2;  // the owner's tiles, as tcb's
  const int mt0 = 2 * ((warp >> 1) & 1);
  const int nt0 = 4 * (warp & 1);
  const bool owner = kW2 && 16 * mt0 < d && 8 * nt0 < d;
  float cw[2][4][4] = {}, db[4][4] = {};
  prm::Rot8 ln;
  ln.clear();
  const Geom geo(d, lane);
  // the copies' units, as the serving tile's
  const int n = d % 8 == 0 ? 8 : 4;
  const Walk acc_walk(lane, 2 * d / n);
  const Walk row_walk(lane, d / ((vec & 3) == 2 ? 8 : (vec & 3) == 1 ? 4 : 1));
  const Walk out_walk(lane, d / n);

  int tile = share.first + warp;
  if (tile < share.last) {
    fetch_acc(acc_s, acc, (long)tile * kRows, n_rows, d, n, acc_walk);
    fetch_rows<kMsg>(g_s, wt_s, m_s, g, weights, mask, (long)tile * kRows, n_rows, d, vec,
                     row_walk, lane);
  }
  tc::commit();
  for (int k = 0; k < rounds; ++k, tile += kWarps) {
    const int next = tile + kWarps;
    const bool ahead = next < share.last;
    if (tile < share.last) {
      tc::wait_pending<0>();
      __syncwarp();
      const long row0 = (long)tile * kRows;
      row_phase<kMsg, kW2, true>(
          w_s, b2_s, {acc_s, g_s, wt_s, f_s, h_s, m_s}, row0, n_rows, geo, n, acc_walk,
          out_walk, d_acc, d_weights, d_mask, ln, [&] {
            if (ahead)
              fetch_rows<kMsg>(g_s, wt_s, m_s, g, weights, mask, (long)next * kRows, n_rows,
                               d, vec, row_walk, lane);
            tc::commit();
          });
      if (ahead) fetch_acc(acc_s, acc, (long)next * kRows, n_rows, d, n, acc_walk);
      tc::commit();
    }
    if constexpr (kW2) {
      prm::group_sync(32 * kWarps);  // every tile of the round parked
      if (owner) {
        const int parked = min(kWarps, share.last - (share.first + k * kWarps));
        for (int p = 0; p < parked; ++p) {
          const char* pw = warps_s + p * kWarpBytes;
          const char* pf = pw + kAccBytes + (kMsg ? 2 : 1) * kRowBytes;
          owner_product(pf + kParkBytes, pf, oh, mt0, nt0, mt0 == 0, lane, cw, db);
        }
      }
      prm::group_sync(32 * kWarps);  // read: the planes take the next tiles
    }
  }

  // this block's row of partial, as tcb's
  tc::wait_pending<0>();
  float* out = partial + (long)blockIdx.x * ((kW2 ? 2 * d * d + 2 * d : 0) + 4 * d);
  if (owner) {
    prm::store_dw(out, cw, oh, mt0, nt0, d, lane);
    if (mt0 == 0 && gid == 0)  // every row of db[j] alike: row 0, columns 2 q, 2 q + 1
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * (nt0 + j) + 2 * q + e;
          if (n < d) out[2 * d * d + oh * d + n] = db[j][e];
        }
  }
  prm::park_vectors(reinterpret_cast<float*>(acc_s), ln, lane);
  __syncthreads();
  prm::store_vectors(reinterpret_cast<const float*>(warps_s), kWarpBytes / 4, kWarps,
                     out + (kW2 ? 2 * d * d + 2 * d : 0), d);
}

}  // namespace tcb16


template <typename T>
using FwdFn = void (*)(TailT<T>, const T*, const T*, T*, int, int);
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
using ParamFn = void (*)(TailT<T>, const T*, const T*, const T*, const T*, T*, T*, T*,
                         float*, int, int, int);

template <typename T>
using UpdateFn = void (*)(TailT<T>, const T*, const T*, T*, int, int, int);

size_t fwd_smem() { return (kWeights + 4 * kHalf) * sizeof(float); }

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

// the backward with parameter gradients: tcb's kernel in f32, tcb16's in bf16
template <typename T, bool kMsg, bool kW2>
Kernel<ParamFn<T>> param_instance() {
  static std::atomic<int> waves[kMaxDevices];
  if constexpr (chgnet::is_bf16<T>)
    return {tcb16::tail_bwd_param_bf16_kernel<kMsg, kW2>, tcb16::param_smem_bytes(kMsg, kW2),
            waves};
  else
    return {tcb::tail_bwd_param_tc_kernel<kMsg, kW2>, tcb::param_smem_bytes(kW2), waves};
}

template <typename T>
Kernel<ParamFn<T>> param_kernel(bool msg, bool w2) {
  if (msg) return param_instance<T, true, true>();
  return w2 ? param_instance<T, false, true>() : param_instance<T, false, false>();
}

template <typename T>
int param_warps(bool w2) {
  return chgnet::is_bf16<T> ? tcb16::param_warps(w2) : tcb::param_warps(w2);
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

// the serving backward in bf16
template <bool kMsg, bool kW2>
Kernel<TcBwdFn<chgnet::bf16>> bf16_bwd_instance() {
  static std::atomic<int> waves[kMaxDevices];
  return {tcb16::tail_bwd_bf16_kernel<kMsg, kW2>, tcb16::smem_bytes(kMsg, kW2), waves};
}

Kernel<TcBwdFn<chgnet::bf16>> bf16_bwd_kernel(bool msg, bool w2) {
  if (msg) return bf16_bwd_instance<true, true>();
  return w2 ? bf16_bwd_instance<false, true>() : bf16_bwd_instance<false, false>();
}

// the message forward in bf16
Kernel<TcFwdFn<chgnet::bf16>> bf16_fwd_kernel() {
  static std::atomic<int> waves[kMaxDevices];
  return {tcb16::tail_fwd_bf16_kernel, tcb16::fwd_smem_bytes(), waves};
}

}  // namespace

// tail: 7 pointers (w2c, w2g, b2, nc_scale, nc_bias, ng_scale, ng_bias),
// the first three null for an update without a second layer. msg = 1:
// out = message(acc, weights, mask) by the tensor-core kernel, 16 rows a
// warp; msg = 0: out = update(acc) + resnet, with a second layer one block
// per 32-row tile, without one a row per group of lanes
// (update_fwd_kernel). d <= 128, a multiple of 4; over 64 with a second
// layer wide_tail.cuh's forward, 4 rows a warp.
// acc [n_rows, 2d] 16-byte aligned; every tensor contiguous f32 (the
// _bf16 entry: bf16, computed in f32 and rounded once at each store). At
// most one wave of blocks.
namespace {

// the message forward, by the tensor-core kernel
template <typename T>
int launch_msg_fwd(const TailT<T>& t, const T* acc, const T* weights, const T* mask,
                   T* out, int n_rows, int d, cudaStream_t stream) {
  const Kernel<TcFwdFn<T>> k = tc_fwd_kernel<T>();
  const int wave = wave_blocks(k, 32 * tcb::kFwdWarps);
  if (wave < 0) return -wave;
  const int rows = tcb::kRows * tcb::kFwdWarps;  // of a block's first tiles
  const int want = (n_rows + rows - 1) / rows;
  // weights rows in units of 4 values: 16 bytes of f32, 8 of bf16
  const int vec = (uintptr_t)weights % (4 * sizeof(T)) == 0;
  k.fn<<<want < wave ? want : wave, 32 * tcb::kFwdWarps, k.smem, stream>>>(
      t, acc, weights, mask, out, n_rows, d, vec);
  return (int)cudaSuccess;
}

// ... and in bf16, by tcb16's kernel; out is stored by whole 16-byte units
// (8-byte where D % 8 != 0), so it must be aligned
int launch_msg_fwd(const TailT<chgnet::bf16>& t, const chgnet::bf16* acc,
                   const chgnet::bf16* weights, const chgnet::bf16* mask,
                   chgnet::bf16* out, int n_rows, int d, cudaStream_t stream) {
  if ((uintptr_t)acc % 16 || (uintptr_t)out % (d % 8 == 0 ? 16 : 8))
    return (int)cudaErrorInvalidValue;
  const Kernel<TcFwdFn<chgnet::bf16>> k = bf16_fwd_kernel();
  const int wave = wave_blocks(k, 32 * tcb16::kFwdWarps);
  if (wave < 0) return -wave;
  const int rows = tcb16::kRows * tcb16::kFwdWarps;  // of a block's first tiles
  const int want = (n_rows + rows - 1) / rows;
  const int vec = tcb16::vec_of(weights, weights, mask, d);
  k.fn<<<want < wave ? want : wave, 32 * tcb16::kFwdWarps, k.smem, stream>>>(
      t, acc, weights, mask, out, n_rows, d, vec);
  return (int)cudaSuccess;
}

template <typename T>
int gated_fwd(int msg, const void* const* tail, const T* acc, const T* weights,
              const T* mask, const T* resnet, T* out, int n_rows, int d,
              void* cuda_stream) {
  const TailT<T> t = make_tail<T>(tail);
  const bool w2 = t.w2c != nullptr;
  if (bad_width(msg, w2, d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  if (n_rows > 0 && d > kMaxD && w2) {
    const int err = wide::launch_fwd(msg, w2, t, wide::AccRows<T>{acc},
                                     msg ? weights : resnet, mask, out, n_rows, d, stream);
    if (err) return err;
  } else if (n_rows > 0 && msg) {
    const int err = launch_msg_fwd(t, acc, weights, mask, out, n_rows, d, stream);
    if (err) return err;
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

// ... and in bf16, by tcb16's kernel; d_acc and d_weights are stored by
// whole 16-byte units (8-byte where D % 8 != 0), so they must be aligned
int gated_bwd_serving(int msg, const TailT<chgnet::bf16>& t, const chgnet::bf16* acc,
                      const chgnet::bf16* weights, const chgnet::bf16* mask,
                      const chgnet::bf16* g, chgnet::bf16* d_acc,
                      chgnet::bf16* d_weights, chgnet::bf16* d_mask, int n_rows, int d,
                      cudaStream_t stream) {
  const bool w2 = t.w2c != nullptr;
  const uintptr_t unit = d % 8 == 0 ? 16 : 8;
  if ((uintptr_t)acc % 16 || (uintptr_t)d_acc % unit ||
      (msg && (uintptr_t)d_weights % unit))
    return (int)cudaErrorInvalidValue;
  const Kernel<TcBwdFn<chgnet::bf16>> k = bf16_bwd_kernel(msg, w2);
  const int warps = tcb16::warps(msg, w2);
  const int wave = wave_blocks(k, 32 * warps);
  if (wave < 0) return -wave;
  const int rows = tcb16::kRows * warps;  // of a block's first tiles
  const int want = (n_rows + rows - 1) / rows;
  const int vec = tcb16::vec_of(g, msg ? weights : g, msg ? mask : nullptr, d);
  k.fn<<<want < wave ? want : wave, 32 * warps, k.smem, stream>>>(
      t, acc, weights, mask, g, d_acc, d_weights, d_mask, n_rows, d, vec);
  return (int)cudaSuccess;
}

// the backward with parameter gradients, by the tensor-core kernel of T
// (tail_bwd_param_tc_kernel, tail_bwd_param_bf16_kernel) in exactly
// n_blocks blocks; in bf16 d_acc and d_weights are stored by whole 16-byte
// units (8-byte where D % 8 != 0), so they must be aligned
template <typename T>
int gated_bwd_params(int msg, const TailT<T>& t, const T* acc, const T* weights,
                     const T* mask, const T* g, T* d_acc, T* d_weights, T* d_mask,
                     float* partial, int n_rows, int d, int n_blocks, cudaStream_t stream) {
  const bool w2 = t.w2c != nullptr;
  int vec;
  if constexpr (chgnet::is_bf16<T>) {
    const uintptr_t unit = d % 8 == 0 ? 16 : 8;
    if ((uintptr_t)acc % 16 || (uintptr_t)d_acc % unit ||
        (msg && (uintptr_t)d_weights % unit))
      return (int)cudaErrorInvalidValue;
    vec = tcb16::vec_of(g, msg ? weights : g, msg ? mask : nullptr, d);
  } else {
    vec = ((uintptr_t)g | (uintptr_t)(msg ? weights : g)) % 16 == 0;
  }
  const Kernel<ParamFn<T>> k = param_kernel<T>(msg, w2);
  const int threads = 32 * param_warps<T>(w2);
  const int wave = wave_blocks(k, threads);
  if (wave < 0) return -wave;
  k.fn<<<n_blocks, threads, k.smem, stream>>>(t, acc, weights, mask, g, d_acc, d_weights,
                                              d_mask, partial, n_rows, d, vec);
  return (int)cudaSuccess;
}

// d_acc [n_rows, 2d] (16-byte aligned, as acc), and for msg = 1 d_weights
// [n_rows, d] and, unless null, d_mask [n_rows]. Without d_params: the
// tensor-core kernel, 16 rows a warp, at most one wave of persistent
// blocks (d over 64: wide_tail.cuh's backward, in both modes). With
// d_params non-null the parameter gradients too, by gated_bwd_params in
// exactly n_blocks = min(tiles, kParamBlocks) blocks (tiles of 32 rows),
// each taking an even share of the 16-row tiles in order and writing one
// f32 row of partial [n_blocks, n_part], summed in f32 in block order and
// rounded once to T: d_params [n_part] = dW2c, dW2g, db2 (with w2),
// d nc_scale, d nc_bias, d ng_scale, d ng_bias.
template <typename T>
int gated_bwd(int msg, const void* const* tail, const T* acc, const T* weights,
              const T* mask, const T* g, T* d_acc, T* d_weights, T* d_mask,
              float* partial, T* d_params, int n_rows, int d, int n_blocks,
              void* cuda_stream) {
  const TailT<T> t = make_tail<T>(tail);
  const bool w2 = t.w2c != nullptr;
  const bool params = d_params != nullptr;
  const int tiles = n_rows > 0 ? n_tiles(n_rows) : 0;
  if (bad_width(msg, w2, d) ||
      (params && n_blocks != (tiles < kParamBlocks ? tiles : kParamBlocks)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  if (n_rows > 0 && d > kMaxD) {
    const int err = wide::launch_bwd<T, wide::AccRows<T>, false>(
        msg, w2, t, wide::AccRows<T>{acc}, weights, mask, g, d_acc, d_weights, d_mask,
        params ? partial : nullptr, n_rows, d, n_blocks, stream);
    if (err) return err;
  } else if (n_rows > 0 && params) {
    const int err = gated_bwd_params(msg, t, acc, weights, mask, g, d_acc, d_weights,
                                     d_mask, partial, n_rows, d, n_blocks, stream);
    if (err) return err;
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
  if (bad_width(true, t.w2c != nullptr, d)) return (int)cudaErrorInvalidValue;
  if (n_out > 0 && d > kMaxD) {
    const int err = wide::launch_reduce(t, acc, weights, mask, offsets, out, n_rows,
                                        n_out, d, static_cast<cudaStream_t>(cuda_stream));
    if (err) return err;
  } else if (n_out > 0) {
    const Kernel<TcReduceFn<T>> k = tc_reduce_kernel<T>();
    const int wave = wave_blocks(k, 32 * tcb::kFwdWarps);
    if (wave < 0) return -wave;
    const long cost = (long)kRowCost * n_rows + n_out;
    const long per_block = (long)kRowCost * tcb::kRows * tcb::kFwdWarps;
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
// forward (i = 0), the message-reduce (1), the message backward (2), the
// bf16 serving backwards: message (3), update with W2 (4), without (5),
// the bf16 message forward (6), and the backwards with parameter
// gradients: f32 message (7), f32 update without W2 (8), bf16 message (9),
// bf16 update without W2 (10); nothing is launched. For the build report.
extern "C" int gated_tc_occupancy(int* info) {
  constexpr int kN = 11;
  const int waves[kN] = {
      wave_blocks(tc_fwd_kernel<float>(), 32 * tcb::kFwdWarps),
      wave_blocks(tc_reduce_kernel<float>(), 32 * tcb::kFwdWarps),
      wave_blocks(tc_bwd_kernel<float>(true, true), 32 * tcb::warps(true)),
      wave_blocks(bf16_bwd_kernel(true, true), 32 * tcb16::warps(true, true)),
      wave_blocks(bf16_bwd_kernel(false, true), 32 * tcb16::warps(false, true)),
      wave_blocks(bf16_bwd_kernel(false, false), 32 * tcb16::warps(false, false)),
      wave_blocks(bf16_fwd_kernel(), 32 * tcb16::kFwdWarps),
      wave_blocks(param_kernel<float>(true, true), 32 * tcb::param_warps(true)),
      wave_blocks(param_kernel<float>(false, false), 32 * tcb::param_warps(false)),
      wave_blocks(param_kernel<chgnet::bf16>(true, true), 32 * tcb16::param_warps(true)),
      wave_blocks(param_kernel<chgnet::bf16>(false, false), 32 * tcb16::param_warps(false))};
  const size_t smem[kN] = {tcb::fwd_smem_bytes(), tcb::fwd_smem_bytes(),
                           tcb::smem_bytes(true), tcb16::smem_bytes(true, true),
                           tcb16::smem_bytes(false, true),
                           tcb16::smem_bytes(false, false), tcb16::fwd_smem_bytes(),
                           tcb::param_smem_bytes(true), tcb::param_smem_bytes(false),
                           tcb16::param_smem_bytes(true, true),
                           tcb16::param_smem_bytes(false, false)};
  const int warps[kN] = {tcb::kFwdWarps, tcb::kFwdWarps, tcb::warps(true),
                         tcb16::warps(true, true), tcb16::warps(false, true),
                         tcb16::warps(false, false), tcb16::kFwdWarps,
                         tcb::param_warps(true), tcb::param_warps(false),
                         tcb16::param_warps(true), tcb16::param_warps(false)};
  for (int i = 0; i < kN; ++i) {
    if (waves[i] < 0) return -waves[i];
    info[3 * i] = (int)smem[i];
    info[3 * i + 1] = warps[i];
    info[3 * i + 2] = waves[i];
  }
  return (int)cudaSuccess;
}
