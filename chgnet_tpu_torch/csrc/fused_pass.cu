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
// _fused_pass_pallas :219) -> pass_fwd_tc_kernel, and _bwd_kernel (:393,
// wrapper _pass_bwd_pallas :526) -> pass_bwd_tc_kernel (serving) and
// pass_bwd_kernel (with parameter gradients); in bf16 the serving forms
// are pass_fwd_bf16_kernel and pass_bwd_bf16_kernel. The TPU kernels DMA a source
// window per part and output block and reduce it with one-hot MXU matmuls;
// here each gathered row is read whole, 16 bytes a lane.
//
// Bound: a message row reads K index entries, K table rows of 2D floats
// (short tables stay in L2 and come from device memory once), the aligned
// row, D weights and the mask, and writes D floats, against 4 D^2 FLOPs of
// the two diagonal blocks plus the tail's elementwise work: at D = 64, with
// the products at the tensor cores' f32-accurate rate (3xTF32), bytes. The
// backward gathers the same rows again, reads the cotangent and writes
// d_total [L, 2D] and d_weights: bytes too.
//
// Design of the f32 serving kernels (pass_fwd_tc_kernel, pass_bwd_tc_kernel;
// namespace tcp below, instantiated for f32 only): warp-specialised.
// Producer warps gather: each builds
// 16-row acc tiles in part order (from zero, each gathered part, the aligned
// part, then the bias: the plain version's order) in a ring of acc slots in
// shared memory: the aligned rows copied into the slot (cp.async) while the
// gathered units load into registers 8 rows at a time, the next tile's
// indices already loaded.
// Consumer warps run the tensor-core tails of gated_message.cu on the slots:
// each owns 16 rows through every phase, with no block barrier in its loop
// (the forward: row 6's tile, W2 staged pre-split, the statistics from the
// accumulators, y parked over the slot; the backward: row 7's tile, W2 staged
// once, swizzled and read in both orientations, silu'(acc) parked over y so
// that the slot is released before the second product). A slot passes
// between its producer and its consumer through two mbarriers (full,
// empty), so the gathers' latency overlaps the consumers' products. A consumer copies its
// tile's aligned rows (weights and mask, resnet, the cotangent) with cp.async
// and waits for them only before the row phase. The step loops stay rolled
// or unrolled twice: a fully unrolled tail outgrows the instruction cache.
//
// Design of the backward with parameter gradients (pass_bwd_kernel, not on
// the serving path): f32 FMAs. 256 threads walk 32-row tiles; thread (warp,
// lane) owns rows 4 warp .. 4 warp + 3 and columns 4 lane .. 4 lane + 3 of
// the tile: it loads its K indices, then its K float4 units, and adds them
// in the same order. The 16 sums stay in registers; silu(acc) (or acc itself
// without a second layer) goes to shared memory in the tails' half-tile
// layout, and from there the phases are the tails' own (gated_tail.cuh): the
// 4 x 4 register tile of the two diagonal blocks, one warp per row for the
// norms and the gate, block barriers between the phases (the dW2 sum reads
// all 32 rows). d_h is multiplied by silu'(acc) from the registers.
// Parameter gradients, d_b1 = sum of d_total among them, go through the
// fixed kParamBlocks scratch rows and sum_blocks_kernel: no float atomics,
// equal bits on every run.
//
// bf16 (compute_dtype="bfloat16", the _bf16 entry points): the serving
// forms are kernels of their own, tcp16::pass_fwd_bf16_kernel and
// tcp16::pass_bwd_bf16_kernel (below tcp): warp-local tiles that copy the
// gathered and aligned rows raw, as bf16, and run both products on the
// bf16 tensor cores. The backward with parameter gradients is instantiated
// for bf16 tables, aligned rows, b1, side rows, cotangent and parameters:
// rows are widened to f32 as they are read. Every bf16 form sums, takes
// the layer norms and gates in f32 and rounds each output once at its
// store, as chgnet_tpu's kernels widen their bf16 streams and compute in
// f32 (ops/fused_pass.py:197-207, :452-489). The parameter gradients'
// per-block partials stay f32 and are summed in f32 in block order, then
// rounded once to bf16 (ops/fused_pass.py:504-517 cast each tile's f32
// sums to the parameters' type and add them there, so the TPU kernel
// rounds once a tile). Half the bytes of f32 move.
//
// D over 64 (up to 128): every form runs on wide_tail.cuh's kernels, which
// build each row's first-layer sum in registers (PassSrc, the lane's
// columns in the same part order) and run the tail on it in the same
// kernel, so the accumulator still never reaches device memory.
#include "bf16_tail.cuh"
#include "gated_tail.cuh"
#include "tf32x3.cuh"
#include "wide_tail.cuh"

namespace {

constexpr int kMaxParts = 3;  // gathered parts of one launch

// The parts of a pass in their storage type T (float, or bf16 under
// compute_dtype="bfloat16"; every kernel widens them to f32 as it reads them)
template <typename T>
struct PartsT {
  const T* table[kMaxParts];  // [n_src, 2D]
  const int* idx[kMaxParts];  // [L]
  int n_src[kMaxParts];
  int n_parts;
  const T* aligned;  // [L, 2D] or null
  const T* b1;       // [2D]
};

// acc[j] = columns 4 lane .. + 3 of row row0 + 4 warp + j of the first-layer
// sum; zero past n_rows and past 2D. A row whose index lies outside its
// table adds zero, as in gather_sum_rows.
template <typename T>
__device__ __forceinline__ void build_acc(const PartsT<T>& p, long row0, int n_rows,
                                          int d, int warp, int lane,
                                          float4 acc[kRowsPerWarp]) {
  const int col = 4 * lane;
  const bool live = col < 2 * d;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 bias = zero;
  if (live) chgnet::ldg_v(bias, p.b1 + col);
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
    for (int k = 0; k < kMaxParts; ++k) {
      v[k] = zero;
      if (s[j][k] >= 0 && s[j][k] < p.n_src[k])
        chgnet::ldg_v(v[k], p.table[k] + (long)s[j][k] * 2 * d + col);
    }
    float4 a = zero;
    if (live && l < n_rows) {
#pragma unroll
      for (int k = 0; k < kMaxParts; ++k)
        if (k < p.n_parts) chgnet::vadd(a, v[k]);
      if (p.aligned != nullptr) {
        float4 al;
        chgnet::ldg_v(al, p.aligned + l * 2 * d + col);
        chgnet::vadd(a, al);
      }
      chgnet::vadd(a, bias);
    }
    acc[j] = a;
  }
}

// The first-layer sum of a row as wide_tail.cuh's kernels read their
// accumulator: the lane's columns (element lane + 32 j of each half), from
// zero, each gathered part in order, the aligned part, then the bias, as
// build_acc adds them.
template <typename T>
struct PassSrc {
  PartsT<T> p;
  __device__ __forceinline__ void load(long l, int d, int lane,
                                       float v[wide::kC]) const {
    int s[kMaxParts];
#pragma unroll
    for (int k = 0; k < kMaxParts; ++k) s[k] = k < p.n_parts ? __ldg(p.idx[k] + l) : -1;
#pragma unroll
    for (int i = 0; i < wide::kC; ++i) {
      const int e = wide::elem_of(i, lane);
      const int col = wide::half_of(i) * d + e;
      float a = 0.f;
      if (e < d) {
#pragma unroll
        for (int k = 0; k < kMaxParts; ++k)
          if (s[k] >= 0 && s[k] < p.n_src[k])
            a += chgnet::to_f(p.table[k][(long)s[k] * 2 * d + col]);
        if (p.aligned != nullptr) a += chgnet::to_f(p.aligned[l * 2 * d + col]);
        a += chgnet::to_f(p.b1[col]);
      }
      v[i] = a;
    }
  }
};

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

// ------------------------------------ backward with parameter gradients
template <typename T, bool kMsg, bool kW2>
__global__ void __launch_bounds__(kThreads)
    pass_bwd_kernel(TailT<T> t, PartsT<T> p, const T* __restrict__ weights,
                    const T* __restrict__ mask, const T* __restrict__ g,
                    T* __restrict__ d_total, T* __restrict__ d_weights,
                    T* __restrict__ d_mask, float* __restrict__ partial,
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
  ps.clear();
  const int tiles = (n_rows + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * kTile;
    float4 acc[kRowsPerWarp];
    build_acc(p, row0, n_rows, d, warp, lane, acc);
    __syncthreads();  // the previous tile consumed
    store_acc(kW2 ? h_s : y_s, acc, d, warp, lane, kW2);
    __syncthreads();
    if (kW2) {
      float y[kRowsPerWarp][4];
      tile_product(h_s, w_s, d, warp, lane, y);
      store_y(y_s, y, b, d, warp, lane);
      __syncthreads();
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
      const T* w_row = kMsg ? weights + l * d : nullptr;
      gate_row_bwd<kMsg>(yc_s, yg_s, g + l * d, w_row,
                         kMsg ? chgnet::to_f(mask[l]) : 1.f, lp, d, lane, o);
      if (kMsg) {
        store_lane(d_weights + l * d, d, lane, o.dw);
        if (d_mask != nullptr) {
          const float dm = warp_sum(o.mask_part);
          if (lane == 0) chgnet::store_v(d_mask + l, dm);
        }
      }
      ps.add_row(o);
      if (kW2) {  // over y: a lane reads, then writes, its own elements
        store_lane(yc_s, d, lane, o.dyc);
        store_lane(yg_s, d, lane, o.dyg);
      } else {
        store_lane(d_total + l * 2 * d, d, lane, o.dyc);
        store_lane(d_total + l * 2 * d + d, d, lane, o.dyg);
      }
    }
    if (kW2) {
      __syncthreads();  // d_y of every row in y_s
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
          chgnet::store_v(d_total + l * 2 * d + col, dt);
          pb[0] += dt.x;  // in f32, before the store rounds
          pb[1] += dt.y;
          pb[2] += dt.z;
          pb[3] += dt.w;
        }
      }
      ps.add_tile(h_s, y_s, d);
    }
  }
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

// --------------------------------------------- serving kernels (tensor cores)
namespace tcp {

constexpr int kRows = 16;                       // rows of a tile
constexpr int kSlotFloats = kRows * 2 * kMaxD;  // one acc slot
constexpr int kRowFloats = kRows * kMaxD;       // weights, resnet or g of a tile
constexpr int kFragFloats = 64 * 32;            // a [2][8][4] fragment set per lane
constexpr int kSplitW = 2 * 8 * 8 * 32;         // uint4 B fragments of W2c, W2g
constexpr int kSwzW = 2 * kMaxD * kMaxD;        // floats of W2c, W2g swizzled
constexpr int kPrmFloats = 6 * kMaxD;  // b2 (gate half at kMaxD), ncs, ncb, ngs, ngb

// A block's warps: kCons consumers and kProd producers, each producer with a
// ring of ring() acc slots for its kPer consumers (c % kProd == producer).
// Measured side by side (PERF.md section 6): fewer producers starve
// the forward's consumers (8 + 4 warps beat 9 + 3 and 10 + 2); the
// backward's consumers bind it, so with W2 it keeps one slot per consumer
// for 8 of them (W2 swizzled, 32 KB) over 6 with two slots or with W2
// stored pre-split; 12 consumers slowed the forms without W2.
constexpr int kCons = 8;
constexpr int kProd = 4;
constexpr int kBlockWarps = kCons + kProd;
constexpr int kPer = kCons / kProd;
__host__ __device__ constexpr int ring(bool bwd, bool w2) { return bwd && w2 ? 2 : 4; }

// floats of a consumer's own buffers: the forward's side rows (weights or
// resnet) and mask; the backward's g and weights, its parked fragments (with
// W2) and mask
__host__ __device__ constexpr int cons_floats(bool bwd, bool w2) {
  return bwd ? 2 * kRowFloats + (w2 ? kFragFloats : 0) + kRows : kRowFloats + kRows;
}
__host__ __device__ constexpr int w_bytes(bool bwd, bool w2) {
  return !w2 ? 0 : bwd ? kSwzW * 4 : kSplitW * 16;
}
// W2, the parameters, the full and empty barriers of every slot, the slots,
// the consumers' buffers
template <bool kBwd, bool kW2>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr int kSlots = kProd * ring(kBwd, kW2);
  return (size_t)w_bytes(kBwd, kW2) + kPrmFloats * 4 + 2 * kSlots * 8 +
         (size_t)kSlots * kSlotFloats * 4 + (size_t)kCons * cons_floats(kBwd, kW2) * 4;
}
static_assert(smem_bytes<false, true>() <= 232448, "over the H100's shared memory a block");
static_assert(smem_bytes<false, false>() <= 232448, "over the H100's shared memory a block");
static_assert(smem_bytes<true, true>() <= 232448, "over the H100's shared memory a block");
static_assert(smem_bytes<true, false>() <= 232448, "over the H100's shared memory a block");

// W_half[k][n] lives at k * kMaxD + (n ^ swz(k)): the B fragments of both
// W (k = 8 s + q, n = 8 t + gid) and W^T (row n, column k) then hit 32
// distinct banks.
__device__ __forceinline__ int swz(int k) {
  return 4 * (((k & 3) << 1) | ((k >> 2) & 1));
}

// sigmoid with the fast exponential and division (a few ulp)
__device__ __forceinline__ float sigm_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float silu_grad_of(float x, float s) {  // s = sigm(x)
  return s * (1.f + x * (1.f - s));
}

// A tile row r's column c lives at r * width + (c ^ rswz(r)) (width 2 kMaxD
// for acc, kMaxD for the side rows): conflict-free A fragments, and 16-byte
// chunks stay whole; c ^ rswz(r) keeps c in its half.
__device__ __forceinline__ int rswz(int r) { return 4 * (r & 7); }
__device__ __forceinline__ int at_acc(int r, int c) {
  return r * 2 * kMaxD + (c ^ rswz(r));
}
__device__ __forceinline__ int at_row(int r, int c) {
  return r * kMaxD + (c ^ rswz(r));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tc::smem_addr(b)),
               "r"(count)
               : "memory");
}

// this thread's arrival, releasing its shared-memory reads and writes
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}\n" ::"r"(tc::smem_addr(b))
      : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n\t}\n" ::"r"(tc::smem_addr(b)),
      "r"(parity)
      : "memory");
}

// ------------------------------------------------------------- set-up
// The block's set-up, ended by its only barrier: W2 (the forward: split B
// fragments, wf[((h * 8 + ks) * 8 + nt) * 32 + lane] for the 8-deep step ks
// and the 8-column tile nt of half h; the backward: swizzled), zero past D;
// b2 and the layer-norm vectors, zero past D; the consumers' buffers zeroed
// (the copies never write the columns past D); every slot's two barriers,
// one arrival of each lane of a warp a phase.
template <bool kBwd, bool kW2, typename T>
__device__ void stage(void* w, float* prm, uint64_t* bars, float* cons,
                      const TailT<T>& t, int d) {
  using chgnet::to_f;
  if (kW2 && !kBwd) {
    uint4* wf = static_cast<uint4*>(w);
    for (int i = threadIdx.x; i < kSplitW; i += blockDim.x) {
      const int n = ((i >> 5) & 7) * 8 + ((i & 31) >> 2);
      const int k0 = ((i >> 8) & 7) * 8 + (i & 3);
      const int k1 = k0 + 4;
      const T* src = (i >> 11) ? t.w2g : t.w2c;
      wf[i] = tc::split_pair(k0 < d && n < d ? to_f(src[k0 * d + n]) : 0.f,
                             k1 < d && n < d ? to_f(src[k1 * d + n]) : 0.f);
    }
  }
  if (kW2 && kBwd) {
    float* ws = static_cast<float*>(w);
    for (int i = threadIdx.x; i < kSwzW; i += blockDim.x) {
      const int h = i / (kMaxD * kMaxD);
      const int k = (i / kMaxD) % kMaxD;
      const int n = i % kMaxD;
      const float v = k < d && n < d ? to_f((h ? t.w2g : t.w2c)[k * d + n]) : 0.f;
      ws[h * kMaxD * kMaxD + k * kMaxD + (n ^ swz(k))] = v;
    }
  }
  for (int i = threadIdx.x; i < 2 * kMaxD; i += blockDim.x) {
    const int h = i / kMaxD;
    const int e = i % kMaxD;
    prm[i] = kW2 && e < d ? to_f(t.b2[h * d + e]) : 0.f;
    if (h == 0) {
      prm[2 * kMaxD + e] = e < d ? to_f(t.ncs[e]) : 0.f;
      prm[3 * kMaxD + e] = e < d ? to_f(t.ncb[e]) : 0.f;
      prm[4 * kMaxD + e] = e < d ? to_f(t.ngs[e]) : 0.f;
      prm[5 * kMaxD + e] = e < d ? to_f(t.ngb[e]) : 0.f;
    }
  }
  for (int i = threadIdx.x; i < kCons * cons_floats(kBwd, kW2); i += blockDim.x)
    cons[i] = 0.f;
  if (threadIdx.x < 2 * kProd * ring(kBwd, kW2)) bar_init(bars + threadIdx.x, 32);
  __syncthreads();
}

// --------------------------------------------------------- producers
// Job j of producer pw: iteration j / kPer of its consumer (j % kPer) kProd
// + pw, whose tiles are blockIdx.x kCons + c + i step. Tiles grow with j.
__device__ __forceinline__ long job_tile(int j, int pw, int step) {
  return (long)blockIdx.x * kCons + (j % kPer) * kProd + pw + (long)(j / kPer) * step;
}

// lane r < 16: the indices of row r of the tile (-1 past n_rows)
template <typename T>
__device__ __forceinline__ void load_idx(const PartsT<T>& p, long tile, int n_rows,
                                         int lane, int s[kMaxParts]) {
  const long l = tile * kRows + lane;
#pragma unroll
  for (int k = 0; k < kMaxParts; ++k)
    s[k] = lane < kRows && l < n_rows && k < p.n_parts ? __ldg(p.idx[k] + l) : -1;
}

// The acc tile of the 16 rows from row0 into slot: lane u owns half u / 16,
// columns 4 (u % 16) .. + 3 of it, and writes zeros past D and past n_rows,
// so every column the tails read is rewritten. The aligned rows are copied
// into the slot (cp.async) while the kParts gathered parts' 16-byte loads,
// 8 rows of them, are in flight in registers; then each unit is summed
// from zero in part order, plus the aligned unit, plus the bias. s: the
// tile's indices, row r's in lane r.
template <int kParts, typename T>
__device__ __forceinline__ void build_tile(float* slot, const PartsT<T>& p,
                                           const int s[kMaxParts], long row0,
                                           int n_rows, int d, int lane,
                                           float4 bias) {
  constexpr int kGroup = 8;  // 16 rows of 2 parts spill at 168 registers
  const int h = lane >> 4;
  const int cu = 4 * (lane & 15);
  const bool live = cu < d;
  const int col = h * d + cu;
  const bool aligned = p.aligned != nullptr;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (aligned) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long l = row0 + r;
      const bool ok = live && l < n_rows;
      const T* src = p.aligned + (ok ? l : 0) * 2 * d + col;
      tc::fetch4(slot + at_acc(r, h * kMaxD + cu), src, ok);
    }
  }
  tc::commit();
#pragma unroll 1
  for (int r0 = 0; r0 < kRows; r0 += kGroup) {
    float4 v[kGroup][kParts];
#pragma unroll
    for (int gr = 0; gr < kGroup; ++gr) {
#pragma unroll
      for (int k = 0; k < kParts; ++k) {
        const int sk = __shfl_sync(0xffffffffu, s[k], r0 + gr);
        const T* src = p.table[k] + (long)sk * 2 * d + col;
        v[gr][k] = zero;
        if (live && sk >= 0 && sk < p.n_src[k]) chgnet::ldg_v(v[gr][k], src);
      }
    }
    tc::wait_pending<0>();  // this lane's aligned units
#pragma unroll
    for (int gr = 0; gr < kGroup; ++gr) {
      const int r = r0 + gr;
      float4* unit = reinterpret_cast<float4*>(slot + at_acc(r, h * kMaxD + cu));
      float4 a = zero;
      if (live && row0 + r < n_rows) {
#pragma unroll
        for (int k = 0; k < kParts; ++k) chgnet::vadd(a, v[gr][k]);
        if (aligned) chgnet::vadd(a, *unit);
        chgnet::vadd(a, bias);
      }
      *unit = a;
    }
  }
}

// A producer warp: its jobs in order, each into the next slot of its ring
// once the consumer has released that slot's previous tile; the next job's
// indices load while this one builds.
template <int kRing, typename T>
__device__ void produce(const PartsT<T>& p, float* slots, uint64_t* full,
                        uint64_t* empty, int n_rows, int d, int pw, int lane) {
  const int n_tiles = (n_rows + kRows - 1) / kRows;
  const int step = gridDim.x * kCons;
  const int cu = 4 * (lane & 15);
  float4 bias = make_float4(0.f, 0.f, 0.f, 0.f);
  if (cu < d) chgnet::ldg_v(bias, p.b1 + (lane >> 4) * d + cu);
  int s[kMaxParts];
  long tile = job_tile(0, pw, step);
  if (tile < n_tiles) load_idx(p, tile, n_rows, lane, s);
  for (int j = 0; tile < n_tiles; ++j) {
    const long next = job_tile(j + 1, pw, step);
    int sn[kMaxParts] = {-1, -1, -1};
    if (next < n_tiles) load_idx(p, next, n_rows, lane, sn);
    const int k = pw * kRing + j % kRing;
    bar_wait(empty + k, ((j / kRing) & 1) ^ 1);
    float* slot = slots + k * kSlotFloats;
    const long row0 = tile * kRows;
    switch (p.n_parts) {
      case 1: build_tile<1>(slot, p, s, row0, n_rows, d, lane, bias); break;
      case 2: build_tile<2>(slot, p, s, row0, n_rows, d, lane, bias); break;
      default: build_tile<3>(slot, p, s, row0, n_rows, d, lane, bias); break;
    }
    bar_arrive(full + k);
#pragma unroll
    for (int kk = 0; kk < kMaxParts; ++kk) s[kk] = sn[kk];
    tile = next;
  }
}

// ---------------------------------------------------- consumer helpers
// Copies of the side rows (weights or resnet, [L, D]) of the 16 rows from
// row0, and with kMsg their mask entries (zeros from n_rows on); vec: side
// rows in aligned units of 4 values. The caller commits them.
template <bool kMsg, typename T>
__device__ __forceinline__ void fetch_side(float* w_s, float* m_s, const T* side,
                                           const T* mask, long row0, int n_rows,
                                           int d, bool vec, int lane) {
  const int unit = vec ? 4 : 1;  // floats a copy
  const int per_row = d / unit;
  for (int i = lane; i < kRows * per_row; i += 32) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * unit;
    const long l = row0 + r;
    const bool ok = l < n_rows;
    const T* src = side + (ok ? l : 0) * d + c;
    if (vec)
      tc::fetch4(w_s + at_row(r, c), src, ok);
    else
      tc::fetch1(w_s + at_row(r, c), src, ok);
  }
  if (kMsg && lane < kRows) {
    const long l = row0 + lane;
    tc::fetch1(m_s + lane, mask + (l < n_rows ? l : 0), l < n_rows);
  }
}

// Copies of the g, weights and mask rows of the 16 rows from row0; vec: g
// and weights 16-byte aligned. The caller commits them.
template <bool kMsg, typename T>
__device__ __forceinline__ void fetch_rows(float* g_s, float* wv_s, float* m_s,
                                           const T* g, const T* weights,
                                           const T* mask, long row0, int n_rows,
                                           int d, bool vec, int lane) {
  fetch_side<false, T>(g_s, nullptr, g, nullptr, row0, n_rows, d, vec, lane);
  if (kMsg) fetch_side<true, T>(wv_s, m_s, weights, mask, row0, n_rows, d, vec, lane);
}

// y[h] += the warp's 16 rows of silu(A_h) @ W_h over all kMaxD columns,
// A_h the slot's half h, W_h from the split fragments. The step loop is
// unrolled twice only, so that one step's loads overlap the other's products.
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
      tc::mma3_tiles_split<8>(y[h], hi, lo, bf);
    }
  }
}

// out[h][nt] += the warp's 16 rows of A_h @ W_h, or @ W_h^T with kT, over
// all kMaxD columns (W swizzled, zero-padded); A_h's row r, column c at
// a_h[r * width + (c ^ rswz(r))]; kAct: silu of A first. The step loop is
// unrolled twice only (2% faster than rolled, PERF.md section 6).
template <bool kT, bool kAct>
__device__ __forceinline__ void product(const float* a0, const float* a1, int width,
                                        const float* w_s, int d8, int lane,
                                        float out[2][8][4]) {
  const int gid = lane >> 2;
  const int q = lane & 3;
  const int s = rswz(gid);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* a = (h ? a1 : a0) + gid * width;
    const float* w = w_s + h * kMaxD * kMaxD;
#pragma unroll 2
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

// A [2][8][4] accumulator set: zeroed, and parked in shared memory per lane
// (f_s[((h * 8 + nt) * 4 + j) * 32 + lane])
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

// The two-pass layer-norm statistics (mean, then inverse deviation) of the
// half rows gid, gid + 8 of a tile whose element (h, nt, j) - row gid + 8
// (j >> 1), column 8 nt + 2 q + (j & 1) of half h - y_at gives, in rolled
// loops; every lane of a quad ends with its rows' values.
template <typename YAt>
__device__ __forceinline__ void row_stats(YAt y_at, int d, int q, float mean[2][2],
                                          float inv[2][2]) {
  const int d8 = (d + 7) / 8;
  const float inv_d = 1.f / d;
#pragma unroll
  for (int h = 0; h < 2; ++h) mean[h][0] = mean[h][1] = inv[h][0] = inv[h][1] = 0.f;
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
}

// row_stats of y held in registers, fully unrolled (a rolled loop would
// send y to local memory); y is exactly 0 past D, so the means sum it all
__device__ __forceinline__ void reg_stats(const float y[2][8][4], int d, int q,
                                          float mean[2][2], float inv[2][2]) {
  const float inv_d = 1.f / d;
#pragma unroll
  for (int h = 0; h < 2; ++h) mean[h][0] = mean[h][1] = inv[h][0] = inv[h][1] = 0.f;
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
}

// The block's shared memory: W2, the parameters, the slots' full and empty
// barriers, the slots, the consumers' buffers
template <bool kBwd, bool kW2>
struct Layout {
  static constexpr int kSlots = kProd * ring(kBwd, kW2);
  void* w;
  float* prm;
  uint64_t* full;
  uint64_t* empty;
  float* slots;
  float* cons;
  __device__ explicit Layout(float4* base) {
    char* at = reinterpret_cast<char*>(base);
    w = at;
    prm = reinterpret_cast<float*>(at + w_bytes(kBwd, kW2));
    full = reinterpret_cast<uint64_t*>(prm + kPrmFloats);
    empty = full + kSlots;
    slots = reinterpret_cast<float*>(empty + kSlots);
    cons = slots + kSlots * kSlotFloats;
  }
};

// ------------------------------------------------------------ forward
// The consumer of an acc tile: with W2, y = b2 + silu(acc) @ blockdiag(W2c,
// W2g) on the tensor cores (3xTF32), the statistics from the accumulators,
// y parked over the slot; without, y = acc read from the slot. Then the gate
// times weights and mask, or plus resnet.
template <typename T, bool kMsg, bool kW2>
__global__ void __launch_bounds__(32 * kBlockWarps, 1)
    pass_fwd_tc_kernel(TailT<T> t, PartsT<T> p, const T* __restrict__ side,
                       const T* __restrict__ mask, T* __restrict__ out,
                       int n_rows, int d, int vec) {
  constexpr int kRing = ring(false, kW2);
  extern __shared__ float4 smem4[];
  const Layout<false, kW2> s(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  stage<false, kW2>(s.w, s.prm, s.full, s.cons, t, d);
  if (warp >= kCons) {
    produce<kRing>(p, s.slots, s.full, s.empty, n_rows, d, warp - kCons, lane);
    return;
  }
  const uint4* wf = static_cast<const uint4*>(s.w);
  float* w_s = s.cons + warp * cons_floats(false, kW2);  // weights or resnet
  float* m_s = w_s + kRowFloats;
  const float* ncs_s = s.prm + 2 * kMaxD;
  const float* ncb_s = ncs_s + kMaxD;
  const float* ngs_s = ncb_s + kMaxD;
  const float* ngb_s = ngs_s + kMaxD;
  const int gid = lane >> 2;
  const int q = lane & 3;
  const int d8 = (d + 7) / 8;
  const int first = (warp % kProd) * kRing;  // this warp's producer's slots
  const int member = warp / kProd;
  const int n_tiles = (n_rows + kRows - 1) / kRows;
  const int step = gridDim.x * kCons;
  int tile = blockIdx.x * kCons + warp;
  if (tile < n_tiles)
    fetch_side<kMsg, T>(w_s, m_s, side, mask, (long)tile * kRows, n_rows, d, vec, lane);
  tc::commit();
  for (int i = 0; tile < n_tiles; ++i, tile += step) {
    const long row0 = (long)tile * kRows;
    const int j = i * kPer + member;
    const int k = first + j % kRing;
    float* acc_s = s.slots + k * kSlotFloats;
    bar_wait(s.full + k, (j / kRing) & 1);
    float mean[2][2], inv[2][2];
    if (kW2) {
      // y = b2 + silu(acc) @ blockdiag(W2c, W2g); exactly 0 past D
      float y[2][8][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            y[h][nt][jj] = s.prm[h * kMaxD + nt * 8 + 2 * q + (jj & 1)];
      product_split(acc_s, wf, d8, lane, y);
      reg_stats(y, d, q, mean, inv);
      tc::wait_pending<0>();  // the side rows
      __syncwarp();           // every lane's A fragments read: y parks over them
      park(acc_s, y, lane);
    } else {
      row_stats([&](int h, int nt, int jj) {
        return acc_s[at_acc(gid + 8 * (jj >> 1), h * kMaxD + nt * 8 + 2 * q + (jj & 1))];
      }, d, q, mean, inv);
      tc::wait_pending<0>();
      __syncwarp();
    }
    // the gate, times weights and mask or plus resnet; with W2 a lane reads
    // back only its own parked values
#pragma unroll 2
    for (int nt = 0; nt < d8; ++nt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = gid + 8 * rr;
        const int e0 = nt * 8 + 2 * q;
        float v[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int jx = 2 * rr + jj;
          const int e = e0 + jj;
          const float yc = kW2 ? acc_s[(nt * 4 + jx) * 32 + lane] : acc_s[at_acc(r, e)];
          const float yg = kW2 ? acc_s[((8 + nt) * 4 + jx) * 32 + lane]
                               : acc_s[at_acc(r, kMaxD + e)];
          const float zc = (yc - mean[0][rr]) * inv[0][rr];
          const float zg = (yg - mean[1][rr]) * inv[1][rr];
          const float cn = fmaf(zc, ncs_s[e], ncb_s[e]);
          const float gate =
              cn * sigm_fast(cn) * sigm_fast(fmaf(zg, ngs_s[e], ngb_s[e]));
          const float sv = w_s[at_row(r, e)];
          v[jj] = kMsg ? gate * sv * m_s[r] : gate + sv;
        }
        const long l = row0 + r;
        if (e0 < d && l < n_rows) chgnet::store2(out + l * d + e0, v[0], v[1]);
      }
    __syncwarp();  // the slot and the side rows read
    bar_arrive(s.empty + k);
    if (tile + step < n_tiles)
      fetch_side<kMsg, T>(w_s, m_s, side, mask, row0 + (long)step * kRows, n_rows, d,
                          vec, lane);
    tc::commit();
  }
}

// ----------------------------------------------------------- backward
// The consumer of an acc tile, serving (no parameter gradients): with W2,
// y = b2 + silu(acc) @ W2 parked per lane; the statistics; then, once g,
// weights and mask have landed, the gate's backward (d_weights, d_mask),
// d_y in place over g and weights (or straight to d_total without W2);
// silu'(acc) parked over y and the slot released; d_total = (d_y @ W2^T) *
// silu'(acc), both products on the tensor cores.
template <typename T, bool kMsg, bool kW2>
__global__ void __launch_bounds__(32 * kBlockWarps, 1)
    pass_bwd_tc_kernel(TailT<T> t, PartsT<T> p, const T* __restrict__ weights,
                       const T* __restrict__ mask, const T* __restrict__ g,
                       T* __restrict__ d_total, T* __restrict__ d_weights,
                       T* __restrict__ d_mask, int n_rows, int d, int vec) {
  constexpr int kRing = ring(true, kW2);
  extern __shared__ float4 smem4[];
  const Layout<true, kW2> s(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  stage<true, kW2>(s.w, s.prm, s.full, s.cons, t, d);
  if (warp >= kCons) {
    produce<kRing>(p, s.slots, s.full, s.empty, n_rows, d, warp - kCons, lane);
    return;
  }
  const float* w_s = static_cast<const float*>(s.w);
  const float* b2_s = s.prm;
  const float* ncs_s = s.prm + 2 * kMaxD;
  const float* ncb_s = ncs_s + kMaxD;
  const float* ngs_s = ncb_s + kMaxD;
  const float* ngb_s = ngs_s + kMaxD;
  // this warp's buffers: g and weights, whose slots take gz and then d_y's
  // core and gate halves once read; the parked fragments (y, then d_h); the
  // mask
  float* g_s = s.cons + warp * cons_floats(true, kW2);
  float* wv_s = g_s + kRowFloats;
  float* f_s = wv_s + kRowFloats;  // with W2
  float* m_s = f_s + (kW2 ? kFragFloats : 0);
  const int gid = lane >> 2;
  const int q = lane & 3;
  const int d8 = (d + 7) / 8;
  const float inv_d = 1.f / d;
  const int first = (warp % kProd) * kRing;  // this warp's producer's slots
  const int member = warp / kProd;
  const int n_tiles = (n_rows + kRows - 1) / kRows;
  const int step = gridDim.x * kCons;
  int tile = blockIdx.x * kCons + warp;
  if (tile < n_tiles)
    fetch_rows<kMsg, T>(g_s, wv_s, m_s, g, weights, mask, (long)tile * kRows, n_rows,
                        d, vec, lane);
  tc::commit();
  for (int i = 0; tile < n_tiles; ++i, tile += step) {
    const long row0 = (long)tile * kRows;
    const int j = i * kPer + member;
    const int k = first + j % kRing;
    const float* acc_s = s.slots + k * kSlotFloats;
    bar_wait(s.full + k, (j / kRing) & 1);

    // y = silu(acc) @ blockdiag(W2c, W2g) + b2, or acc. Element (h, nt, j):
    // row gid + 8 (j >> 1), column 8 nt + 2 q + (j & 1) of half h.
    if (kW2) {
      float y[2][8][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            y[h][nt][jj] = b2_s[h * kMaxD + nt * 8 + 2 * q + (jj & 1)];
      product<false, true>(acc_s, acc_s + kMaxD, 2 * kMaxD, w_s, d8, lane, y);
      park(f_s, y, lane);
    }
    auto y_at = [&](int h, int nt, int jj) {
      return kW2 ? f_s[((h * 8 + nt) * 4 + jj) * 32 + lane]
                 : acc_s[at_acc(gid + 8 * (jj >> 1), h * kMaxD + nt * 8 + 2 * q + (jj & 1))];
    };
    float mean[2][2], inv[2][2];
    row_stats(y_at, d, q, mean, inv);
    // z of element (h, nt, j), zero past D
    auto z_at = [&](int h, int nt, int jj) {
      return nt * 8 + 2 * q + (jj & 1) < d
                 ? (y_at(h, nt, jj) - mean[h][jj >> 1]) * inv[h][jj >> 1]
                 : 0.f;
    };
    tc::wait_pending<0>();  // g, weights and mask
    __syncwarp();

    // the gate's backward (gate_row_bwd's arithmetic): d_weights, d_mask,
    // and the layer norms' gz = d_out * scale with their sums; a lane writes
    // gz over the g and weights slots it has just read
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
            const float wv = wv_s[at];
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
          wv_s[at] = gzg;
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
    // d_y = (gz - mean(gz) - z mean(gz z)) * inv, zero past D: in place with
    // W2, else straight to d_total
#pragma unroll 1
    for (int nt = 0; nt < d8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = gid + 8 * rr;
          const long l = row0 + r;
          const int e0 = nt * 8 + 2 * q;
          float* half = h ? wv_s : g_s;
          float dy[2];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            float* pv = half + at_row(r, e0 + jj);
            dy[jj] = e0 + jj < d
                         ? (*pv - s1[h][rr] - z_at(h, nt, 2 * rr + jj) * s2[h][rr]) *
                               inv[h][rr]
                         : 0.f;
            if (kW2) *pv = dy[jj];
          }
          if (!kW2 && e0 < d && l < n_rows)
            chgnet::store2(d_total + l * 2 * d + h * d + e0, dy[0], dy[1]);
        }

    if (kW2) {
      // silu'(acc) of the lane's elements over its parked y, which the d_y
      // loop has read: the slot is then free for the producer while d_h is
      // computed
#pragma unroll 1
      for (int nt = 0; nt < d8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float a =
                acc_s[at_acc(gid + 8 * (jj >> 1), h * kMaxD + nt * 8 + 2 * q + (jj & 1))];
            f_s[((h * 8 + nt) * 4 + jj) * 32 + lane] = silu_grad_of(a, sigm_fast(a));
          }
    }
    __syncwarp();  // the slot read; with W2 the warp's d_y rows in g_s and wv_s
    bar_arrive(s.empty + k);
    if (kW2) {
      // d_total = (d_y @ W2^T) * silu'(acc), from the accumulators
      float dh[2][8][4];
      zero(dh);
      product<true, false>(g_s, wv_s, kMaxD, w_s, d8, lane, dh);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const long l = row0 + gid + 8 * rr;
            const int e0 = nt * 8 + 2 * q;
            if (e0 >= d || l >= n_rows) continue;
            const float* sg = f_s + ((h * 8 + nt) * 4 + 2 * rr) * 32 + lane;
            chgnet::store2(d_total + l * 2 * d + h * d + e0, dh[h][nt][2 * rr] * sg[0],
                           dh[h][nt][2 * rr + 1] * sg[32]);
          }
      __syncwarp();  // d_y read
    }
    if (tile + step < n_tiles)
      fetch_rows<kMsg, T>(g_s, wv_s, m_s, g, weights, mask, row0 + (long)step * kRows,
                          n_rows, d, vec, lane);
    tc::commit();
  }
}

}  // namespace tcp

// ---------------------------------- serving kernels on bf16 tensor cores
// The one-kernel pass in bf16 (rows 13 and 14 without parameter gradients,
// D <= 64): the function of tcp::pass_fwd_tc_kernel and
// tcp::pass_bwd_tc_kernel, redesigned for bf16 rows and Hopper's bf16
// tensor cores on the tiles of rows 6 and 7's bf16 kernels (bf16_tail.cuh).
//
// Bound: at D = 64 a message row reads K index entries, K gathered rows and
// the aligned row of 2D bf16 values, D weights and the mask, and writes D
// values, against 4 D^2 FLOPs of products: bytes (P bf16's 9 forward calls
// 1.091 ms, its 9 backward calls 1.727). What holds the tile is its
// instructions and their latency, as in rows 6 and 7.
// Design: every warp owns 16 rows through every phase, with no block
// barrier in its loop and no warp feeding another. It copies its tile's
// parts raw, as bf16, by cp.async: each gathered part's 16 rows (the row's
// index passed by a warp shuffle, so every lane runs the same number of
// copy steps) and the aligned rows, one bf16 tile each (the bt::at swizzle,
// the gate half at column kMaxD), into a stage of up to 4 tiles. acc is
// never stored: each A fragment of y = silu(acc) @ blockdiag(W2c, W2g) is
// summed in f32 from the tiles' ldmatrix fragments in the plain version's
// order (from zero, each gathered part, the aligned part, then b1), so acc
// is never rounded to bf16; silu is taken on it, it is split into a bf16 hi
// and lo, and both products run as two passes of mma.sync.m16n8k16
// (bf16_tile.cuh) on W2 staged once a block in bf16 (16 KB). Without a
// second layer y = acc, summed the same way in the C layout. From y on,
// the phases are rows 6 and 7's bf16 tiles: y in registers, the layer-norm
// statistics by quad shuffles, the gate; in the backward z and gz parked,
// d_y in registers as the A fragments of d_y @ W2^T, d_h parked, and
// d_total = d_h * silu'(acc), acc summed again from the stage, written over
// the first part's tile and stored by whole rows. f32 throughout; every
// output is rounded once to bf16. A warp has one stage: the forward's takes
// the next tile's parts as soon as the product has read it, the
// backward's once d_total has left it. The side rows (weights or resnet,
// g), the mask and the outputs other than d_total go between registers
// and device memory by pairs of values, with no shared memory of their
// own; g and weights one 8-column tile ahead of the gate's loop. Shared
// memory sets the warps a block: a warp's is its stage and, in the
// backward, 8 KB of parked fragments, so it depends on the launch's parts
// (one block an SM). Each choice won a same-call A/B on an H100 (PERF.md
// section 6): two stages a warp (8 and 5 warps at 3 parts) and side rows
// staged by cp.async lost to more warps.
namespace tcp16 {

using chgnet::bf16;
using bt::Walk;
using tcb16::kRows;
constexpr int kPartBytes = tcb16::kAccBytes;  // a part's 16 rows of 2 kMaxD
// the most warps a block: 16 at 128 registers a thread (the backward's
// tile spills 68-88 bytes there; with its side rows staged in shared
// memory, 8 warps at up to 184 registers ran no faster: PERF.md section 6)
constexpr int kMaxFwdWarps = 16;
constexpr int kMaxBwdWarps = 16;
constexpr int kPrmBytes = 8 * kMaxD * 4;  // b2, ncs, ncb, ngs, ngb, then b1

__host__ __device__ constexpr int max_warps(bool bwd) { return bwd ? kMaxBwdWarps : kMaxFwdWarps; }
__host__ __device__ constexpr int fixed_bytes(bool w2) {
  return (w2 ? tcb16::kWBytes : 0) + kPrmBytes;
}
// A warp's stage of n_set part tiles, and the backward's parked fragments
__host__ __device__ constexpr int warp_bytes(bool bwd, int n_set) {
  return n_set * kPartBytes + (bwd ? tcb16::kParkBytes : 0);
}
__host__ __device__ constexpr int warps(bool bwd, bool w2, int n_set) {
  const int w = (tcb16::kSmemPerBlock - fixed_bytes(w2)) / warp_bytes(bwd, n_set);
  return w < max_warps(bwd) ? w : max_warps(bwd);
}
__host__ __device__ constexpr size_t smem_bytes(bool bwd, bool w2, int n_set) {
  return (size_t)fixed_bytes(w2) + (size_t)warps(bwd, w2, n_set) * warp_bytes(bwd, n_set);
}
static_assert(warps(true, true, kMaxParts + 1) >= 1, "a warp over the shared memory");

// the parts' copy unit: 8 values (16 bytes) where every table and the
// aligned part allow it, else 4 (make_parts holds rows to 8 bytes)
inline int unit_of(const PartsT<bf16>& p, int d) {
  uintptr_t a = p.aligned != nullptr ? (uintptr_t)p.aligned : 0;
  for (int k = 0; k < p.n_parts; ++k) a |= (uintptr_t)p.table[k];
  return d % 8 == 0 && a % 16 == 0 ? 8 : 4;
}

// Copies of one part's 16 rows into a tile (bt::at<16>, the gate half at
// column kMaxD): with kIndexed row r is row s_r of tab [n_src, 2D], s_r in
// lane r's ix (a shuffle of the whole warp, so every lane runs n_it
// steps), else row row0 + r; zeros for a row outside [0, n_src). n values
// a copy (w: units of n, 2D / n a row). The caller commits them.
template <bool kIndexed>
__device__ __forceinline__ void copy_part(char* st, const bf16* tab, int ix, long n_src,
                                          long row0, int d, int n, int n_it, Walk w) {
  const int u = d / n;  // copies a half row
  for (int it = 0; it < n_it; ++it, w.next()) {
    long s = row0 + w.r;
    if (kIndexed) s = __shfl_sync(0xffffffffu, ix, w.r & 31);
    if (w.r < kRows) {
      const int half = w.c >= u;
      const bool ok = s >= 0 && s < n_src;
      bt::copy_unit(st + bt::at<16>(w.r, half * kMaxD + n * (w.c - half * u)),
                    tab + (ok ? s * 2 * d + n * w.c : 0), ok, n);
    }
  }
}

// Copies of a tile's parts into a stage: gathered part k into tile k (lane
// r < 16 holds row r's index of each part in ix), the aligned rows into
// tile n_parts. The caller commits them.
__device__ __forceinline__ void fetch_parts(char* st, const PartsT<bf16>& p,
                                            const int ix[kMaxParts], long row0, int n_rows,
                                            int d, int n, int n_it, Walk w) {
#pragma unroll
  for (int k = 0; k < kMaxParts; ++k)
    if (k < p.n_parts)
      copy_part<true>(st + k * kPartBytes, p.table[k], ix[k], p.n_src[k], row0, d, n, n_it,
                      w);
  if (p.aligned != nullptr)
    copy_part<false>(st + p.n_parts * kPartBytes, p.aligned, 0, n_rows, row0, d, n, n_it, w);
}

// y[h] += silu(acc_h) @ W_h over the 16-deep steps below D and the tile
// pairs that hold a column below D; each A fragment of acc summed in f32
// from the stage's n_set tiles in order, plus b1 (b1_s, zero past D)
__device__ __forceinline__ void product_y(const char* st, int n_set, const float* b1_s,
                                          const char* w_s, int d8, int d16, int lane,
                                          float y[2][8][4]) {
  const int lr = lane & 7;
  const int lm = lane >> 3;
  const int q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const char* w = w_s + h * kMaxD * kMaxD * 2;
#pragma unroll 1
    for (int ks = 0; ks < d16; ++ks) {
      const int col = h * kMaxD + 16 * ks;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k <= kMaxParts; ++k) {
        if (k >= n_set) break;
        uint32_t a[4];
        bt::ldsm4(a, st + k * kPartBytes + bt::at<16>(lr + 8 * (lm & 1), col + 8 * (lm >> 1)));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[2 * i] += bt::lo_f(a[i]);
          x[2 * i + 1] += bt::hi_f(a[i]);
        }
      }
      // register i: row gid + 8 (i & 1), columns col + 8 (i >> 1) + 2q, + 1
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 b = *reinterpret_cast<const float2*>(b1_s + col + 8 * (i >> 1) + 2 * q);
        const float x0 = x[2 * i] + b.x;
        const float x1 = x[2 * i + 1] + b.y;
        bt::split(x0 * tcb16::sigm_fast(x0), x1 * tcb16::sigm_fast(x1), hi[i], lo[i]);
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

// acc at row r, columns c and c + 1 (c = h kMaxD + e, e even): summed in
// f32 from the stage's n_set tiles in order, plus b1 (zero past D)
__device__ __forceinline__ float2 acc_at(const char* st, int n_set, const float* b1_s, int r,
                                         int c) {
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int k = 0; k <= kMaxParts; ++k) {
    if (k >= n_set) break;
    const uint32_t v = *reinterpret_cast<const uint32_t*>(st + k * kPartBytes + bt::at<16>(r, c));
    a0 += bt::lo_f(v);
    a1 += bt::hi_f(v);
  }
  const float2 b = *reinterpret_cast<const float2*>(b1_s + c);
  return make_float2(a0 + b.x, a1 + b.y);
}

// y = acc (no second layer) in the C layout: element (h, nt, j) is row
// gid + 8 (j >> 1), column 8 nt + 2 q + (j & 1) of half h; zero past D
__device__ __forceinline__ void acc_tile(const char* st, int n_set, const float* b1_s, int d8,
                                         int lane, float y[2][8][4]) {
  const int gid = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float2 a = nt < d8 ? acc_at(st, n_set, b1_s, gid + 8 * rr, h * kMaxD + nt * 8 + 2 * q)
                                 : make_float2(0.f, 0.f);
        y[h][nt][2 * rr] = a.x;
        y[h][nt][2 * rr + 1] = a.y;
      }
}

// The two-pass layer-norm statistics of each half row of y (exactly 0 past
// D): every lane of a quad ends with its rows' values
__device__ __forceinline__ void row_stats(const float y[2][8][4], int d, int q,
                                          float mean[2][2], float inv[2][2]) {
  const float inv_d = 1.f / d;
#pragma unroll
  for (int h = 0; h < 2; ++h) mean[h][0] = mean[h][1] = inv[h][0] = inv[h][1] = 0.f;
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
}

// The block's W2 (with kW2), b2, the layer-norm vectors and b1 (f32, zero
// past D) staged, this warp's buffers zeroed (the copies never write the
// pad columns), then the only block barrier
template <bool kW2>
__device__ __forceinline__ void set_up(char* w_s, float* prm, char* mine, int bytes,
                                       const TailT<bf16>& t, const bf16* b1, int d) {
  tcb16::stage_tail<kW2>(w_s, prm, t, d);
  float* b1_s = prm + 6 * kMaxD;
  for (int i = threadIdx.x; i < 2 * kMaxD; i += blockDim.x) {
    const int e = i % kMaxD;
    b1_s[i] = e < d ? chgnet::to_f(b1[(i / kMaxD) * d + e]) : 0.f;
  }
  for (int i = threadIdx.x & 31; i < bytes / 16; i += 32)
    reinterpret_cast<float4*>(mine)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
}

// The side rows' pair at row l, columns e and e + 1 of a [n_rows, d] bf16
// array, as the gate reads it (zeros from n_rows on and past d): a4, the
// array 4-byte aligned: one 4-byte load, else two 2-byte ones
__device__ __forceinline__ uint32_t load_pair(const bf16* x, long l, int n_rows, int d,
                                              int e, bool a4) {
  if (l >= n_rows || e >= d) return 0u;
  const bf16* p = x + l * d + e;
  if (a4) return __ldg(reinterpret_cast<const unsigned int*>(p));
  return (uint32_t)__bfloat16_as_ushort(p[0]) | ((uint32_t)__bfloat16_as_ushort(p[1]) << 16);
}

// a pair rounded once to bf16 at row l, columns e and e + 1 (none from
// n_rows on and past d)
__device__ __forceinline__ void store_pair(bf16* x, long l, int n_rows, int d, int e,
                                           float v0, float v1) {
  if (l < n_rows && e < d) *reinterpret_cast<uint32_t*>(x + l * d + e) = bt::pack(v0, v1);
}

// the mask entries of rows gid and gid + 8 of the tile from row0
__device__ __forceinline__ void load_mask(const bf16* mask, long row0, int n_rows, int gid,
                                          float m[2]) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long l = row0 + gid + 8 * rr;
    m[rr] = l < n_rows ? __bfloat162float(mask[l]) : 0.f;
  }
}

// ------------------------------------------------------------ forward
template <bool kMsg, bool kW2>
__global__ void __launch_bounds__(32 * kMaxFwdWarps, 1)
    pass_fwd_bf16_kernel(TailT<bf16> t, PartsT<bf16> p, const bf16* __restrict__ side,
                         const bf16* __restrict__ mask, bf16* __restrict__ out, int n_rows,
                         int d, int unit, int a4) {
  extern __shared__ float4 smem4[];
  char* w_s = reinterpret_cast<char*>(smem4);  // [2][kMaxD][kMaxD] bf16 with W2
  float* prm = reinterpret_cast<float*>(w_s + (kW2 ? tcb16::kWBytes : 0));
  const float* ncs_s = prm + 2 * kMaxD;
  const float* ncb_s = ncs_s + kMaxD;
  const float* ngs_s = ncb_s + kMaxD;
  const float* ngb_s = ngs_s + kMaxD;
  const float* b1_s = ngb_s + kMaxD;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_set = p.n_parts + (p.aligned != nullptr);
  char* st = w_s + fixed_bytes(kW2) + warp * warp_bytes(false, n_set);  // the stage
  set_up<kW2>(w_s, prm, st, warp_bytes(false, n_set), t, p.b1, d);

  const int gid = lane >> 2;
  const int q = lane & 3;
  const int d8 = (d + 7) / 8;
  const int d16 = (d + 15) / 16;
  const int n_tiles = (n_rows + kRows - 1) / kRows;
  const int step = gridDim.x * n_warps;
  int tile = blockIdx.x * n_warps + warp;
  const Walk part_walk(lane, 2 * d / unit);
  const int part_it = (kRows * (2 * d / unit) + 31) / 32;
  // the indices of this warp's next tile to fetch, one tile ahead
  int ix[kMaxParts], nx[kMaxParts];
  tcp::load_idx(p, tile, n_rows, lane, ix);
  tcp::load_idx(p, tile + step, n_rows, lane, nx);
  if (tile < n_tiles)
    fetch_parts(st, p, ix, (long)tile * kRows, n_rows, d, unit, part_it, part_walk);
  tc::commit();
  for (; tile < n_tiles; tile += step) {
    const bool ahead = tile + step < n_tiles;
    const long row0 = (long)tile * kRows;
    tc::wait_pending<0>();  // this tile's parts
    __syncwarp();

    // y = b2 + silu(acc) @ blockdiag(W2c, W2g), or acc. Element (h, nt, j):
    // row gid + 8 (j >> 1), column 8 nt + 2 q + (j & 1) of half h; exactly
    // 0 past D (zero weights, b2 and b1)
    float y[2][8][4];
    if constexpr (kW2) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) y[h][nt][j] = prm[h * kMaxD + nt * 8 + 2 * q + (j & 1)];
      product_y(st, n_set, b1_s, w_s, d8, d16, lane, y);
    } else {
      acc_tile(st, n_set, b1_s, d8, lane, y);
    }
    __syncwarp();  // the stage read: it takes the next tile's parts
    if (ahead)
      fetch_parts(st, p, nx, row0 + (long)step * kRows, n_rows, d, unit, part_it, part_walk);
    tc::commit();
    if (ahead) tcp::load_idx(p, tile + 2 * step, n_rows, lane, nx);

    // the side rows (weights or resnet) and the mask as the gate reads
    // them, loaded while the statistics are taken
    uint32_t sv[8][2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        sv[nt][rr] = load_pair(side, row0 + gid + 8 * rr, n_rows, d, nt * 8 + 2 * q, a4);
    float m[2] = {1.f, 1.f};
    if (kMsg) load_mask(mask, row0, n_rows, gid, m);
    float mean[2][2], inv[2][2];
    row_stats(y, d, q, mean, inv);

    // the gate, times weights and mask or plus resnet
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int e0 = nt * 8 + 2 * q;
      if (e0 >= d) break;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float v[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * rr + jj;
          const int e = e0 + jj;
          const float zc = (y[0][nt][j] - mean[0][rr]) * inv[0][rr];
          const float zg = (y[1][nt][j] - mean[1][rr]) * inv[1][rr];
          const float cn = fmaf(zc, ncs_s[e], ncb_s[e]);
          const float gate =
              cn * tcb16::sigm_fast(cn) * tcb16::sigm_fast(fmaf(zg, ngs_s[e], ngb_s[e]));
          const float s = jj ? bt::hi_f(sv[nt][rr]) : bt::lo_f(sv[nt][rr]);
          v[jj] = kMsg ? gate * s * m[rr] : gate + s;
        }
        store_pair(out, row0 + gid + 8 * rr, n_rows, d, e0, v[0], v[1]);
      }
    }
  }
}

// ----------------------------------------------------------- backward
template <bool kMsg, bool kW2>
__global__ void __launch_bounds__(32 * kMaxBwdWarps, 1)
    pass_bwd_bf16_kernel(TailT<bf16> t, PartsT<bf16> p, const bf16* __restrict__ weights,
                         const bf16* __restrict__ mask, const bf16* __restrict__ g,
                         bf16* __restrict__ d_total, bf16* __restrict__ d_weights,
                         bf16* __restrict__ d_mask, int n_rows, int d, int unit, int a4) {
  extern __shared__ float4 smem4[];
  char* w_s = reinterpret_cast<char*>(smem4);  // [2][kMaxD][kMaxD] bf16 with W2
  float* prm = reinterpret_cast<float*>(w_s + (kW2 ? tcb16::kWBytes : 0));
  const float* ncs_s = prm + 2 * kMaxD;
  const float* ncb_s = ncs_s + kMaxD;
  const float* ngs_s = ncb_s + kMaxD;
  const float* ngb_s = ngs_s + kMaxD;
  const float* b1_s = ngb_s + kMaxD;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_set = p.n_parts + (p.aligned != nullptr);
  // this warp's buffers: the stage (d_total over its first tile); the
  // parked f32 fragments (z, then gz, then d_h)
  char* st = w_s + fixed_bytes(kW2) + warp * warp_bytes(true, n_set);
  float4* f_s = reinterpret_cast<float4*>(st + n_set * kPartBytes);
  set_up<kW2>(w_s, prm, st, warp_bytes(true, n_set), t, p.b1, d);

  const int gid = lane >> 2;
  const int q = lane & 3;
  const int d8 = (d + 7) / 8;
  const int d16 = (d + 15) / 16;
  const float inv_d = 1.f / d;
  const int n_tiles = (n_rows + kRows - 1) / kRows;
  const int step = gridDim.x * n_warps;
  int tile = blockIdx.x * n_warps + warp;
  // the copies' units: the parts by unit values, d_total by n (16 bytes,
  // or 8 where D % 8 != 0)
  const int n = d % 8 == 0 ? 8 : 4;
  const Walk part_walk(lane, 2 * d / unit);
  const int part_it = (kRows * (2 * d / unit) + 31) / 32;
  const Walk total_walk(lane, 2 * d / n);
  int ix[kMaxParts], nx[kMaxParts];
  tcp::load_idx(p, tile, n_rows, lane, ix);
  tcp::load_idx(p, tile + step, n_rows, lane, nx);
  if (tile < n_tiles)
    fetch_parts(st, p, ix, (long)tile * kRows, n_rows, d, unit, part_it, part_walk);
  tc::commit();
  for (; tile < n_tiles; tile += step) {
    const bool ahead = tile + step < n_tiles;
    const long row0 = (long)tile * kRows;
    tc::wait_pending<0>();  // this tile's parts
    __syncwarp();

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
          for (int j = 0; j < 4; ++j) v[h][nt][j] = prm[h * kMaxD + nt * 8 + 2 * q + (j & 1)];
      product_y(st, n_set, b1_s, w_s, d8, d16, lane, v);
    } else {
      acc_tile(st, n_set, b1_s, d8, lane, v);
    }

    // the statistics, then z (zero past D), parked for the gate's loop
    float mean[2][2], inv[2][2];
    row_stats(v, d, q, mean, inv);
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
    // and the layer norms' gz = d_out * scale with their sums; gz goes over
    // the z it came from. g and weights are loaded one 8-column tile ahead.
    float s1[2][2] = {}, s2[2][2] = {}, mask_part[2] = {};
    float m[2] = {1.f, 1.f};
    if (kMsg) load_mask(mask, row0, n_rows, gid, m);
    uint32_t gp[2], wp[2] = {0u, 0u};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      gp[rr] = load_pair(g, row0 + gid + 8 * rr, n_rows, d, 2 * q, a4);
      if (kMsg) wp[rr] = load_pair(weights, row0 + gid + 8 * rr, n_rows, d, 2 * q, a4);
    }
#pragma unroll 1
    for (int nt = 0; nt < d8; ++nt) {
      const int e = nt * 8 + 2 * q;
      uint32_t gn[2], wn[2] = {0u, 0u};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        gn[rr] = load_pair(g, row0 + gid + 8 * rr, n_rows, d, e + 8, a4);
        if (kMsg) wn[rr] = load_pair(weights, row0 + gid + 8 * rr, n_rows, d, e + 8, a4);
      }
      const float4 zc4 = f_s[nt * 32 + lane];
      const float4 zg4 = f_s[(8 + nt) * 32 + lane];
      const float zc[4] = {zc4.x, zc4.y, zc4.z, zc4.w};
      const float zg[4] = {zg4.x, zg4.y, zg4.z, zg4.w};
      const float2 ncs = *reinterpret_cast<const float2*>(ncs_s + e);
      const float2 ncb = *reinterpret_cast<const float2*>(ncb_s + e);
      const float2 ngs = *reinterpret_cast<const float2*>(ngs_s + e);
      const float2 ngb = *reinterpret_cast<const float2*>(ngb_s + e);
      float gzc[4], gzg[4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float dw[2] = {};
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * rr + jj;
          const float sc = jj ? ncs.y : ncs.x;
          const float sg = jj ? ngs.y : ngs.x;
          const float cn = fmaf(zc[j], sc, jj ? ncb.y : ncb.x);
          const float gn_ = fmaf(zg[j], sg, jj ? ngb.y : ngb.x);
          const float sig_cn = tcb16::sigm_fast(cn);
          const float silu_cn = cn * sig_cn;
          const float sig_gn = tcb16::sigm_fast(gn_);
          const float gv = jj ? bt::hi_f(gp[rr]) : bt::lo_f(gp[rr]);  // zero past D
          float up = gv;
          if (kMsg) {
            const float wv = jj ? bt::hi_f(wp[rr]) : bt::lo_f(wp[rr]);
            mask_part[rr] = fmaf(gv, silu_cn * sig_gn * wv, mask_part[rr]);
            up = gv * wv * m[rr];
            dw[jj] = gv * silu_cn * sig_gn * m[rr];
          }
          gzc[j] = up * sig_gn * tcb16::silu_grad_of(cn, sig_cn) * sc;
          gzg[j] = up * silu_cn * sig_gn * (1.f - sig_gn) * sg;
          s1[0][rr] += gzc[j];
          s2[0][rr] = fmaf(gzc[j], zc[j], s2[0][rr]);
          s1[1][rr] += gzg[j];
          s2[1][rr] = fmaf(gzg[j], zg[j], s2[1][rr]);
        }
        if (kMsg) store_pair(d_weights, row0 + gid + 8 * rr, n_rows, d, e, dw[0], dw[1]);
        gp[rr] = gn[rr];
        wp[rr] = wn[rr];
      }
      f_s[nt * 32 + lane] = make_float4(gzc[0], gzc[1], gzc[2], gzc[3]);
      f_s[(8 + nt) * 32 + lane] = make_float4(gzg[0], gzg[1], gzg[2], gzg[3]);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const long l = row0 + gid + 8 * rr;
      if (kMsg && d_mask != nullptr) {
        const float dm = tc::quad_sum(mask_part[rr]);
        if (q == 0 && l < n_rows) chgnet::store_v(d_mask + l, dm);
      }
    }

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

    // d_total over the first part's tile, each lane over the elements whose
    // acc it has just summed: with W2 d_h = d_y @ W2^T, parked, times
    // silu'(acc); without, d_y
    if constexpr (kW2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float dh[8][4];
        tcb16::product_dh(v[h], w_s + h * kMaxD * kMaxD * 2, d8, d16, lane, dh);
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
            const int r = gid + 8 * rr;
            const int c = h * kMaxD + nt * 8 + 2 * q;
            const float2 a = acc_at(st, n_set, b1_s, r, c);
            *reinterpret_cast<uint32_t*>(st + bt::at<16>(r, c)) = bt::pack(
                (rr ? dh.z : dh.x) * tcb16::silu_grad_of(a.x, tcb16::sigm_fast(a.x)),
                (rr ? dh.w : dh.y) * tcb16::silu_grad_of(a.y, tcb16::sigm_fast(a.y)));
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
                  st + bt::at<16>(gid + 8 * rr, h * kMaxD + nt * 8 + 2 * q)) =
                  bt::pack(v[h][nt][2 * rr], v[h][nt][2 * rr + 1]);
    }
    __syncwarp();  // d_total in the first tile
    tcb16::store_rows<16>(st, d_total, row0, n_rows, d, n, total_walk);
    __syncwarp();  // the stage free
    if (ahead)
      fetch_parts(st, p, nx, row0 + (long)step * kRows, n_rows, d, unit, part_it, part_walk);
    tc::commit();
    if (ahead) tcp::load_idx(p, tile + 2 * step, n_rows, lane, nx);
  }
}

}  // namespace tcp16

template <typename T>
using TcFwdFn = void (*)(TailT<T>, PartsT<T>, const T*, const T*, T*, int, int, int);
template <typename T>
using TcBwdFn = void (*)(TailT<T>, PartsT<T>, const T*, const T*, const T*, T*, T*, T*,
                         int, int, int);
template <typename T>
using BwdFn = void (*)(TailT<T>, PartsT<T>, const T*, const T*, const T*, T*, T*, T*,
                       float*, int, int);

size_t bwd_smem(bool w2) {
  return (w2 ? 2 * kWeights + 4 * kHalf : 2 * kHalf) * sizeof(float);
}

template <typename T, bool kMsg, bool kW2>
Kernel<TcFwdFn<T>> fwd_instance() {
  static std::atomic<int> waves[kMaxDevices];
  return {tcp::pass_fwd_tc_kernel<T, kMsg, kW2>, tcp::smem_bytes<false, kW2>(), waves};
}

template <typename T, bool kMsg, bool kW2>
Kernel<TcBwdFn<T>> tc_bwd_instance() {
  static std::atomic<int> waves[kMaxDevices];
  return {tcp::pass_bwd_tc_kernel<T, kMsg, kW2>, tcp::smem_bytes<true, kW2>(), waves};
}

template <typename T, bool kMsg, bool kW2>
Kernel<BwdFn<T>> bwd_instance() {
  static std::atomic<int> waves[kMaxDevices];
  return {pass_bwd_kernel<T, kMsg, kW2>, bwd_smem(kW2), waves};
}

template <typename T>
Kernel<TcFwdFn<T>> fwd_kernel(bool msg, bool w2) {
  if (msg) return fwd_instance<T, true, true>();
  return w2 ? fwd_instance<T, false, true>() : fwd_instance<T, false, false>();
}

// the serving backward
template <typename T>
Kernel<TcBwdFn<T>> tc_bwd_kernel(bool msg, bool w2) {
  if (msg) return tc_bwd_instance<T, true, true>();
  return w2 ? tc_bwd_instance<T, false, true>() : tc_bwd_instance<T, false, false>();
}

// the backward with parameter gradients
template <typename T>
Kernel<BwdFn<T>> bwd_kernel(bool msg, bool w2) {
  if (msg) return bwd_instance<T, true, true>();
  return w2 ? bwd_instance<T, false, true>() : bwd_instance<T, false, false>();
}

// blocks of a tensor-core launch: enough for every consumer's first tile,
// at most one wave (negative: minus a cudaError_t)
template <typename Fn>
int tc_grid(const Kernel<Fn>& k, int n_rows) {
  const int wave = wave_blocks(k, 32 * tcp::kBlockWarps);
  if (wave < 0) return wave;
  const int rows = tcp::kRows * tcp::kCons;
  const int want = (n_rows + rows - 1) / rows;
  return want < wave ? want : wave;
}

// the serving kernels in bf16 (tcp16): one block an SM at most (the wave
// is found at the largest shared memory), each with the warps its parts'
// stages leave room for
template <typename Fn>
int bf16_launch_shape(const Kernel<Fn>& k, bool bwd, bool w2,
                      const PartsT<chgnet::bf16>& p, int n_rows, int* warps, size_t* smem) {
  const int wave = wave_blocks(k, 32 * tcp16::max_warps(bwd));
  if (wave < 0) return wave;
  const int n_set = p.n_parts + (p.aligned != nullptr);
  *warps = tcp16::warps(bwd, w2, n_set);
  *smem = tcp16::smem_bytes(bwd, w2, n_set);
  const int rows = tcp16::kRows * *warps;  // of a block's first tiles
  const int want = (n_rows + rows - 1) / rows;
  return want < wave ? want : wave;
}

template <typename T>
using Bf16FwdFn = void (*)(TailT<T>, PartsT<T>, const T*, const T*, T*, int, int, int, int);
template <typename T>
using Bf16BwdFn = void (*)(TailT<T>, PartsT<T>, const T*, const T*, const T*, T*, T*, T*,
                           int, int, int, int);

template <bool kMsg, bool kW2>
Kernel<Bf16FwdFn<chgnet::bf16>> bf16_fwd_instance() {
  static std::atomic<int> waves[kMaxDevices];
  return {tcp16::pass_fwd_bf16_kernel<kMsg, kW2>, (size_t)tcb16::kSmemPerBlock, waves};
}

template <bool kMsg, bool kW2>
Kernel<Bf16BwdFn<chgnet::bf16>> bf16_bwd_instance() {
  static std::atomic<int> waves[kMaxDevices];
  return {tcp16::pass_bwd_bf16_kernel<kMsg, kW2>, (size_t)tcb16::kSmemPerBlock, waves};
}

Kernel<Bf16FwdFn<chgnet::bf16>> bf16_fwd_kernel(bool msg, bool w2) {
  if (msg) return bf16_fwd_instance<true, true>();
  return w2 ? bf16_fwd_instance<false, true>() : bf16_fwd_instance<false, false>();
}

Kernel<Bf16BwdFn<chgnet::bf16>> bf16_bwd_kernel(bool msg, bool w2) {
  if (msg) return bf16_bwd_instance<true, true>();
  return w2 ? bf16_bwd_instance<false, true>() : bf16_bwd_instance<false, false>();
}

// the forward in bf16; out is stored by pairs of values, so it must be
// 4-byte aligned
int launch_bf16_fwd(bool msg, const TailT<chgnet::bf16>& t, const PartsT<chgnet::bf16>& p,
                    const chgnet::bf16* side, const chgnet::bf16* mask, chgnet::bf16* out,
                    int n_rows, int d, cudaStream_t stream) {
  if ((uintptr_t)out % 4) return (int)cudaErrorInvalidValue;
  const bool w2 = t.w2c != nullptr;
  const Kernel<Bf16FwdFn<chgnet::bf16>> k = bf16_fwd_kernel(msg, w2);
  int warps = 0;
  size_t smem = 0;
  const int grid = bf16_launch_shape(k, false, w2, p, n_rows, &warps, &smem);
  if (grid < 0) return -grid;
  k.fn<<<grid, 32 * warps, smem, stream>>>(t, p, side, mask, out, n_rows, d,
                                           tcp16::unit_of(p, d), (uintptr_t)side % 4 == 0);
  return (int)cudaSuccess;
}

// the serving backward in bf16; d_total is stored by whole 16-byte units
// (8-byte where D % 8 != 0) and d_weights by pairs, so they must be aligned
int launch_bf16_bwd(bool msg, const TailT<chgnet::bf16>& t, const PartsT<chgnet::bf16>& p,
                    const chgnet::bf16* weights, const chgnet::bf16* mask,
                    const chgnet::bf16* g, chgnet::bf16* d_total, chgnet::bf16* d_weights,
                    chgnet::bf16* d_mask, int n_rows, int d, cudaStream_t stream) {
  const uintptr_t unit = d % 8 == 0 ? 16 : 8;
  if ((uintptr_t)d_total % unit || (msg && (uintptr_t)d_weights % 4))
    return (int)cudaErrorInvalidValue;
  const bool w2 = t.w2c != nullptr;
  const Kernel<Bf16BwdFn<chgnet::bf16>> k = bf16_bwd_kernel(msg, w2);
  int warps = 0;
  size_t smem = 0;
  const int grid = bf16_launch_shape(k, true, w2, p, n_rows, &warps, &smem);
  if (grid < 0) return -grid;
  k.fn<<<grid, 32 * warps, smem, stream>>>(
      t, p, weights, mask, g, d_total, d_weights, d_mask, n_rows, d, tcp16::unit_of(p, d),
      ((uintptr_t)g | (uintptr_t)(msg ? weights : g)) % 4 == 0);
  return (int)cudaSuccess;
}

// false when the parts are not what the kernels take: rows of 2d values in
// aligned units of 4 (16 bytes of f32, 8 of bf16)
template <typename T>
bool make_parts(int n_parts, const void* const* tables, const void* const* idxs,
                const int* n_srcs, const T* aligned, const T* b1, int d,
                PartsT<T>* p) {
  if (n_parts < 1 || n_parts > kMaxParts || !chgnet::vec4_ok(b1, 2 * d) ||
      (aligned != nullptr && !chgnet::vec4_ok(aligned, 2 * d)))
    return false;
  for (int k = 0; k < kMaxParts; ++k) {
    const int j = k < n_parts ? k : 0;
    const T* table = static_cast<const T*>(tables[j]);
    if (!chgnet::vec4_ok(table, 2 * d)) return false;
    p->table[k] = table;
    p->idx[k] = static_cast<const int*>(idxs[j]);
    p->n_src[k] = n_srcs[j];
  }
  p->n_parts = n_parts;
  p->aligned = aligned;
  p->b1 = b1;
  return true;
}

// tail: 7 pointers as in gated_fwd_f32. tables[k] [n_srcs[k], 2d] and idxs[k]
// [n_rows] int32 for the 1..3 gathered parts, aligned [n_rows, 2d] or null,
// b1 [2d]; tables, aligned and b1 16-byte aligned, every tensor contiguous
// T (f32, or bf16: widened as read, rounded once at each store). msg = 1:
// out = message(acc, weights, mask); msg = 0: out = update(acc) + resnet.
// The tensor-core kernel, 16 rows a consumer warp, at most one wave of
// blocks; d over 64 (up to 128): wide_tail.cuh's forward.
template <typename T>
int fused_pass_fwd(int msg, const void* const* tail, int n_parts,
                   const void* const* tables, const void* const* idxs,
                   const int* n_srcs, const T* aligned, const T* b1, const T* weights,
                   const T* mask, const T* resnet, T* out, int n_rows, int d,
                   void* cuda_stream) {
  const TailT<T> t = make_tail<T>(tail);
  const bool w2 = t.w2c != nullptr;
  PartsT<T> p;
  if (bad_width(msg, w2, d) ||
      !make_parts(n_parts, tables, idxs, n_srcs, aligned, b1, d, &p))
    return (int)cudaErrorInvalidValue;
  if (n_rows > 0 && d > kMaxD) {
    const int err = wide::launch_fwd(msg, w2, t, PassSrc<T>{p}, msg ? weights : resnet,
                                     mask, out, n_rows, d,
                                     static_cast<cudaStream_t>(cuda_stream));
    if (err) return err;
  } else if (n_rows > 0) {
    const T* side = msg ? weights : resnet;
    if constexpr (chgnet::is_bf16<T>) {
      const int err = launch_bf16_fwd(msg, t, p, side, mask, out, n_rows, d,
                                      static_cast<cudaStream_t>(cuda_stream));
      if (err) return err;
    } else {
      const Kernel<TcFwdFn<T>> k = fwd_kernel<T>(msg, w2);
      const int grid = tc_grid(k, n_rows);
      if (grid < 0) return -grid;
      const int vec = (uintptr_t)side % (4 * sizeof(T)) == 0;
      k.fn<<<grid, 32 * tcp::kBlockWarps, k.smem,
             static_cast<cudaStream_t>(cuda_stream)>>>(t, p, side, mask, out, n_rows, d,
                                                       vec);
    }
  }
  return (int)cudaGetLastError();
}

// d_total [n_rows, 2d] (16-byte aligned), and for msg = 1 d_weights
// [n_rows, d] and, unless null, d_mask [n_rows]. Without d_params: the
// tensor-core kernel, at most one wave. With d_params non-null the
// parameter gradients too, by pass_bwd_kernel in exactly n_blocks =
// min(tiles, kParamBlocks) blocks, one f32 row each of partial [n_blocks,
// n_part], summed in f32 in block order and rounded once to T: d_params
// [n_part] = dW2c, dW2g, db2 (with w2), d nc_scale, d nc_bias, d ng_scale,
// d ng_bias, d_b1.
template <typename T>
int fused_pass_bwd(int msg, const void* const* tail, int n_parts,
                   const void* const* tables, const void* const* idxs,
                   const int* n_srcs, const T* aligned, const T* b1, const T* weights,
                   const T* mask, const T* g, T* d_total, T* d_weights, T* d_mask,
                   float* partial, T* d_params, int n_rows, int d, int n_blocks,
                   void* cuda_stream) {
  const TailT<T> t = make_tail<T>(tail);
  const bool w2 = t.w2c != nullptr;
  const bool params = d_params != nullptr;
  const int tiles = n_rows > 0 ? n_tiles(n_rows) : 0;
  PartsT<T> p;
  if (bad_width(msg, w2, d) ||
      !make_parts(n_parts, tables, idxs, n_srcs, aligned, b1, d, &p) ||
      !chgnet::vec4_ok(d_total, 2 * d) ||
      (params && n_blocks != (tiles < kParamBlocks ? tiles : kParamBlocks)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  if (n_rows > 0 && d > kMaxD) {
    const int err = wide::launch_bwd<T, PassSrc<T>, true>(
        msg, w2, t, PassSrc<T>{p}, weights, mask, g, d_total, d_weights, d_mask,
        params ? partial : nullptr, n_rows, d, n_blocks, stream);
    if (err) return err;
  } else if (n_rows > 0 && params) {
    const Kernel<BwdFn<T>> k = bwd_kernel<T>(msg, w2);
    const int wave = wave_blocks(k);
    if (wave < 0) return -wave;
    k.fn<<<n_blocks, kThreads, k.smem, stream>>>(t, p, weights, mask, g, d_total,
                                                 d_weights, d_mask, partial,
                                                 n_rows, d);
  } else if (n_rows > 0) {
    if constexpr (chgnet::is_bf16<T>) {
      const int err = launch_bf16_bwd(msg, t, p, weights, mask, g, d_total, d_weights, d_mask,
                                      n_rows, d, stream);
      if (err) return err;
    } else {
      const Kernel<TcBwdFn<T>> k = tc_bwd_kernel<T>(msg, w2);
      const int grid = tc_grid(k, n_rows);
      if (grid < 0) return -grid;
      const int vec = ((uintptr_t)g | (uintptr_t)(msg ? weights : g)) % (4 * sizeof(T)) == 0;
      k.fn<<<grid, 32 * tcp::kBlockWarps, k.smem, stream>>>(
          t, p, weights, mask, g, d_total, d_weights, d_mask, n_rows, d, vec);
    }
  }
  if (params) {
    const int n_part = (w2 ? 2 * d * d + 2 * d : 0) + 6 * d;
    sum_blocks_kernel<<<(n_part + 255) / 256, 256, 0, stream>>>(
        partial, n_blocks, n_part, d_params);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The one-kernel pass forward (fused_pass_fwd above), f32 or bf16.
extern "C" int fused_pass_fwd_f32(int msg, const void* const* tail, int n_parts,
                                  const void* const* tables,
                                  const void* const* idxs, const int* n_srcs,
                                  const float* aligned, const float* b1,
                                  const float* weights, const float* mask,
                                  const float* resnet, float* out, int n_rows,
                                  int d, void* cuda_stream) {
  return fused_pass_fwd(msg, tail, n_parts, tables, idxs, n_srcs, aligned, b1,
                        weights, mask, resnet, out, n_rows, d, cuda_stream);
}

extern "C" int fused_pass_fwd_bf16(int msg, const void* const* tail, int n_parts,
                                   const void* const* tables,
                                   const void* const* idxs, const int* n_srcs,
                                   const chgnet::bf16* aligned,
                                   const chgnet::bf16* b1,
                                   const chgnet::bf16* weights,
                                   const chgnet::bf16* mask,
                                   const chgnet::bf16* resnet, chgnet::bf16* out,
                                   int n_rows, int d, void* cuda_stream) {
  return fused_pass_fwd(msg, tail, n_parts, tables, idxs, n_srcs, aligned, b1,
                        weights, mask, resnet, out, n_rows, d, cuda_stream);
}

// The one-kernel pass backward (fused_pass_bwd above), f32 or bf16; the
// partial buffer stays f32.
extern "C" int fused_pass_bwd_f32(int msg, const void* const* tail, int n_parts,
                                  const void* const* tables,
                                  const void* const* idxs, const int* n_srcs,
                                  const float* aligned, const float* b1,
                                  const float* weights, const float* mask,
                                  const float* g, float* d_total,
                                  float* d_weights, float* d_mask,
                                  float* partial, float* d_params, int n_rows,
                                  int d, int n_blocks, void* cuda_stream) {
  return fused_pass_bwd(msg, tail, n_parts, tables, idxs, n_srcs, aligned, b1,
                        weights, mask, g, d_total, d_weights, d_mask, partial,
                        d_params, n_rows, d, n_blocks, cuda_stream);
}

extern "C" int fused_pass_bwd_bf16(int msg, const void* const* tail, int n_parts,
                                   const void* const* tables,
                                   const void* const* idxs, const int* n_srcs,
                                   const chgnet::bf16* aligned,
                                   const chgnet::bf16* b1,
                                   const chgnet::bf16* weights,
                                   const chgnet::bf16* mask, const chgnet::bf16* g,
                                   chgnet::bf16* d_total, chgnet::bf16* d_weights,
                                   chgnet::bf16* d_mask, float* partial,
                                   chgnet::bf16* d_params, int n_rows, int d,
                                   int n_blocks, void* cuda_stream) {
  return fused_pass_bwd(msg, tail, n_parts, tables, idxs, n_srcs, aligned, b1,
                        weights, mask, g, d_total, d_weights, d_mask, partial,
                        d_params, n_rows, d, n_blocks, cuda_stream);
}

// The dynamic shared memory, warps a block and blocks of one wave on the
// current device of the serving kernels, info[3 * i ..] for the message
// forward (i = 0), the update forward without a second layer (1), the
// message backward (2) and the update backward without a second layer (3);
// nothing is launched. For the build report.
extern "C" int fused_tc_occupancy(int* info) {
  const Kernel<TcFwdFn<float>> fwd[2] = {fwd_kernel<float>(true, true),
                                         fwd_kernel<float>(false, false)};
  const Kernel<TcBwdFn<float>> bwd[2] = {tc_bwd_kernel<float>(true, true),
                                         tc_bwd_kernel<float>(false, false)};
  for (int i = 0; i < 4; ++i) {
    const int wave = i < 2 ? wave_blocks(fwd[i], 32 * tcp::kBlockWarps)
                           : wave_blocks(bwd[i - 2], 32 * tcp::kBlockWarps);
    if (wave < 0) return -wave;
    info[3 * i] = (int)(i < 2 ? fwd[i].smem : bwd[i - 2].smem);
    info[3 * i + 1] = tcp::kBlockWarps;
    info[3 * i + 2] = wave;
  }
  return (int)cudaSuccess;
}

// The dynamic shared memory, warps a block and blocks of one wave on the
// current device of the bf16 serving kernels, info[3 * (4 i + n - 1) ..]
// for the message forward (i = 0), the update forward without a second
// layer (1), the message backward (2) and the update backward without a
// second layer (3), each at n = 1..4 part tiles a stage; nothing is
// launched. For the build report.
extern "C" int fused_bf16_occupancy(int* info) {
  const int wave[4] = {
      wave_blocks(bf16_fwd_kernel(true, true), 32 * tcp16::kMaxFwdWarps),
      wave_blocks(bf16_fwd_kernel(false, false), 32 * tcp16::kMaxFwdWarps),
      wave_blocks(bf16_bwd_kernel(true, true), 32 * tcp16::kMaxBwdWarps),
      wave_blocks(bf16_bwd_kernel(false, false), 32 * tcp16::kMaxBwdWarps)};
  for (int i = 0; i < 4; ++i) {
    if (wave[i] < 0) return -wave[i];
    const bool bwd = i >= 2;
    const bool msg = i % 2 == 0;
    for (int n = 1; n <= kMaxParts + 1; ++n) {
      int* out = info + 3 * (4 * i + n - 1);
      out[0] = (int)tcp16::smem_bytes(bwd, msg, n);
      out[1] = tcp16::warps(bwd, msg, n);
      out[2] = wave[i];
    }
  }
  return (int)cudaSuccess;
}
