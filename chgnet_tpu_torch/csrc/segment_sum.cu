// Segment sums over CSR plans: one output row per warp, fixed order, no
// float atomics.
//
// Replaces chgnet_tpu/ops/stream_ops.py
//   _segsum_kernel  (:135, wrapper _segsum_pallas :209)   -> segment_sum_csr
//   _segsum2_kernel (:257, wrapper _segsum2_pallas :345)  -> segment_sum_pair
// The TPU kernels stream sorted input chunks through one-hot MXU matmuls,
// block by block. Here the host plan already holds the CSR offsets of the
// sorted keys, so output row n is simply the sum of rows
// offsets[n] .. offsets[n+1] of x, read through the stable sort
// permutation when the stream is not sorted by construction. Rows whose
// key is >= n_out lie past offsets[n_out] and are never read.
//
// Bound: bytes. The function reads each valid row of x once (plus its
// 4-byte permutation entry) and writes n_out rows; it does 1 add per
// element read. Design: a warp owns one output row; its lanes split the
// row's d floats into float4 units (floats where a row is not 16-byte
// aligned), at most 32 of them (the wrapper checks), and several input rows
// are summed side by side by lane groups and folded with a fixed shuffle
// tree, so every sum is deterministic run to run.
// segment_sum_pair sweeps x once for both key streams, as the TPU kernel
// does (its two streams' rows of one output block "overlap almost
// completely", stream_ops.py:258-264): a warp owns output row n of both
// streams and adds the two segments side by side, each in segment_sum_csr's
// order and shuffle tree, so each output equals segment_sum_csr's over its
// stream bit for bit. The blocks go over the output rows in order, so the
// rows of x the second stream reads for the rows in flight are rows the
// first stream read moments before and come from L2 where that window fits
// in it: on bench.py's batch 8 output rows of the angle stream (by dir_i,
// dir_j into edges) read a window of at most 290 rows of x, and the rows in
// flight on the card at most 11,470 (5.9 MB in f32); 8 atoms of the edge
// stream (by center, nbr) read their whole crystal, 18,175 rows (9.3 MB),
// and the atoms in flight all 32 crystals, so there the second stream is
// read from device memory again. The launch (launch_pair) follows the mean
// segment length: unrolled persistent warps for long segments, many warps
// of few registers for short ones (the angle stream: one or two rows an
// output row, about half of them empty, so a row's offsets, permutation and
// x loads wait on each other and only more warps hide them).
// bf16 rows (compute_dtype="bfloat16"): the same sweep over units of 4
// bf16 (8 bytes), widened to f32 as they are read, summed in f32 in the same
// order and rounded once at the store; the TPU kernel also sums bf16
// streams in f32 (preferred_element_type, stream_ops.py:194,321). Half the
// bytes of f32, so half the bound.
#include <atomic>

#include "common.cuh"

namespace {

using chgnet::load_v;
using chgnet::shfl_down;
using chgnet::store_v;
using chgnet::vadd;
using chgnet::vzero;

// acc += row perm[k] of x (row k of a sorted stream: perm null), the lane's
// unit u of it
template <typename S, typename V>
__device__ __forceinline__ void add_row(V& acc, const S* __restrict__ x,
                                        const int* __restrict__ perm, int k,
                                        int units, int u) {
  constexpr int kW = sizeof(V) / sizeof(float);
  const long row = perm ? perm[k] : k;
  V v;
  load_v(v, x + (row * units + u) * kW);
  vadd(acc, v);
}

// S: the storage type of x and out (float or bf16); V: a lane's value of a
// row, float or float4 (4 elements: 16 bytes of f32, 8 of bf16). Sums are
// taken in f32 and rounded to S once, at the store.
template <typename S, typename V>
__device__ __forceinline__ void segsum_rows(const S* __restrict__ x,
                                            const int* __restrict__ perm,
                                            const int* __restrict__ offsets,
                                            S* __restrict__ out, int n_out,
                                            int units) {
  constexpr int kW = sizeof(V) / sizeof(float);  // elements of a unit
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long warp0 = (long)blockIdx.x * warps + (threadIdx.x >> 5);
  const long n_warps = (long)gridDim.x * warps;
  int lpr = 1;  // lanes per input row (power of two)
  while (lpr < units) lpr <<= 1;
  const int groups = 32 / lpr;
  const int g = lane / lpr;
  const int u = lane % lpr;
  for (long n = warp0; n < n_out; n += n_warps) {
    const int beg = offsets[n];
    const int end = offsets[n + 1];
    V acc = vzero<V>();
    if (u < units) {
#pragma unroll 4
      for (int k = beg + g; k < end; k += groups) add_row<S, V>(acc, x, perm, k, units, u);
    }
    for (int off = 16; off >= lpr; off >>= 1) vadd(acc, shfl_down(acc, off));
    if (g == 0 && u < units) store_v(out + (n * units + u) * kW, acc);
  }
}

template <typename S, typename V>
__global__ void __launch_bounds__(256)
    segment_sum_csr_kernel(const S* __restrict__ x, const int* __restrict__ perm,
                           const int* __restrict__ offsets, S* __restrict__ out,
                           int n_out, int units) {
  segsum_rows<S, V>(x, perm, offsets, out, n_out, units);
}

struct PairStreams {
  const int* perm[2];
  const int* offsets[2];
  void* out[2];
};

// acc_a += rows g, g + groups, ... of segment a, acc_b likewise, in order
// (segsum_rows' order), the two side by side while both last, then the
// longer one's rest; kUnroll of each loop's iterations at a time.
template <int kUnroll, typename S, typename V>
__device__ __forceinline__ void add_pair(V& acc_a, V& acc_b, const S* __restrict__ x,
                                         const int* __restrict__ perm_a, int beg_a,
                                         int len_a, const int* __restrict__ perm_b,
                                         int beg_b, int len_b, int g, int groups,
                                         int units, int u) {
  const int both = len_a < len_b ? len_a : len_b;
  int j = g;
#pragma unroll (kUnroll)
  for (; j < both; j += groups) {
    add_row<S, V>(acc_a, x, perm_a, beg_a + j, units, u);
    add_row<S, V>(acc_b, x, perm_b, beg_b + j, units, u);
  }
#pragma unroll (kUnroll)
  for (int k = j; k < len_a; k += groups) add_row<S, V>(acc_a, x, perm_a, beg_a + k, units, u);
#pragma unroll (kUnroll)
  for (int k = j; k < len_b; k += groups) add_row<S, V>(acc_b, x, perm_b, beg_b + k, units, u);
}

// Output row n of both streams by one warp (add_pair), folded by
// segsum_rows' shuffle tree; the warp loads the offsets of its next row
// before it sums this one. kUnroll 4 for long segments (the edge stream's
// some 80 rows: 8 rows of x in flight a warp), 1 for short ones (the angle
// stream's one or two: fewer registers, so more warps in flight).
template <typename S, typename V, int kUnroll>
__global__ void __launch_bounds__(256)
    segment_sum_pair_kernel(const S* __restrict__ x, PairStreams s, int n_out,
                            int units) {
  constexpr int kW = sizeof(V) / sizeof(float);
  const int* __restrict__ off_a = s.offsets[0];
  const int* __restrict__ off_b = s.offsets[1];
  S* __restrict__ out_a = static_cast<S*>(s.out[0]);
  S* __restrict__ out_b = static_cast<S*>(s.out[1]);
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long warp0 = (long)blockIdx.x * warps + (threadIdx.x >> 5);
  const long n_warps = (long)gridDim.x * warps;
  int lpr = 1;  // lanes per input row (power of two)
  while (lpr < units) lpr <<= 1;
  const int groups = 32 / lpr;
  const int g = lane / lpr;
  const int u = lane % lpr;
  int a0 = 0, a1 = 0, b0 = 0, b1 = 0;
  if (warp0 < n_out) {
    a0 = off_a[warp0];
    a1 = off_a[warp0 + 1];
    b0 = off_b[warp0];
    b1 = off_b[warp0 + 1];
  }
  for (long n = warp0; n < n_out; n += n_warps) {
    const int beg_a = a0, len_a = a1 - a0;
    const int beg_b = b0, len_b = b1 - b0;
    const long next = n + n_warps;
    if (next < n_out) {
      a0 = off_a[next];
      a1 = off_a[next + 1];
      b0 = off_b[next];
      b1 = off_b[next + 1];
    }
    V acc_a = vzero<V>();
    V acc_b = vzero<V>();
    if (u < units)
      add_pair<kUnroll, S, V>(acc_a, acc_b, x, s.perm[0], beg_a, len_a, s.perm[1],
                              beg_b, len_b, g, groups, units, u);
    for (int off = 16; off >= lpr; off >>= 1) {
      vadd(acc_a, shfl_down(acc_a, off));
      vadd(acc_b, shfl_down(acc_b, off));
    }
    if (g == 0 && u < units) {
      store_v(out_a + (n * units + u) * kW, acc_a);
      store_v(out_b + (n * units + u) * kW, acc_b);
    }
  }
}

// Blocks of segment_sum_pair_kernel<S, V, kUnroll> resident on the current
// device at once (256 threads each, no shared memory), found once per
// device.
template <typename S, typename V, int kUnroll>
int pair_wave() {
  static std::atomic<int> per_sm[16];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev >= 16) return -(int)cudaErrorInvalidDevice;
  int n = per_sm[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, segment_sum_pair_kernel<S, V, kUnroll>, 256, 0);
    if (err != cudaSuccess) return -(int)err;
    n = n > 0 ? n : 1;
    per_sm[dev].store(n, std::memory_order_relaxed);
  }
  return n * chgnet::sm_count();
}

constexpr int kThreads = 256;
constexpr int kMaxUnits = 32;  // one lane per unit of a row

int grid_for(int n_out) {
  const long want = ((long)n_out + kThreads / 32 - 1) / (kThreads / 32);
  const long cap = (long)chgnet::sm_count() * 16;
  return (int)(want < cap ? want : cap);
}

template <typename S>
int segment_sum_csr(const S* x, const int* perm, const int* offsets, S* out,
                    int n_out, int d, void* stream) {
  const bool vec4 = chgnet::vec4_ok(x, d) && chgnet::vec4_ok(out, d);
  if ((vec4 ? d / 4 : d) > kMaxUnits) return (int)cudaErrorInvalidValue;
  if (n_out > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int grid = grid_for(n_out);
    if (vec4) {
      segment_sum_csr_kernel<S, float4><<<grid, kThreads, 0, st>>>(
          x, perm, offsets, out, n_out, d / 4);
    } else {
      segment_sum_csr_kernel<S, float><<<grid, kThreads, 0, st>>>(
          x, perm, offsets, out, n_out, d);
    }
  }
  return (int)cudaGetLastError();
}

// segment_sum_pair's launch, by the mean rows of x an output row sums. At
// least kLongRows (the edge stream's ~80): kLongUnroll rows of each segment
// in flight a warp, one wave of persistent blocks. Fewer (the angle
// stream's ~1): no unrolling and so few registers, one block per 8 output
// rows for f32 rows (a finished block makes room for the next at once);
// for bf16 rows, half the bytes to wait on, kShortWavesBf16 waves of
// persistent blocks, whose warps load their next row's offsets before they
// sum this one (on an H100 at 700 W, bench.py's angle-stream calls: 13%
// faster in bf16 and 6% slower in f32 than one block per 8 rows).
constexpr int kLongRows = 16;
constexpr int kLongUnroll = 8;
constexpr int kShortWavesBf16 = 8;

// waves > 0: at most that many waves of persistent blocks; 0: a block per 8
// output rows
template <typename S, typename V, int kUnroll>
int launch_pair_kernel(const S* x, const PairStreams& s, int n_out, int units,
                       int waves, cudaStream_t st) {
  long blocks = ((long)n_out + kThreads / 32 - 1) / (kThreads / 32);
  if (waves > 0) {
    const int wave = pair_wave<S, V, kUnroll>();
    if (wave < 0) return -wave;
    blocks = blocks < (long)wave * waves ? blocks : (long)wave * waves;
  }
  segment_sum_pair_kernel<S, V, kUnroll><<<(int)blocks, kThreads, 0, st>>>(
      x, s, n_out, units);
  return (int)cudaSuccess;
}

template <typename S, typename V>
int launch_pair(const S* x, const PairStreams& s, int n_rows, int n_out, int units,
                cudaStream_t st) {
  if ((long)n_rows >= (long)kLongRows * n_out)
    return launch_pair_kernel<S, V, kLongUnroll>(x, s, n_out, units, 1, st);
  return launch_pair_kernel<S, V, 1>(x, s, n_out, units,
                                     chgnet::is_bf16<S> ? kShortWavesBf16 : 0, st);
}

template <typename S>
int segment_sum_pair(const S* x, const int* perm_a, const int* offsets_a,
                     S* out_a, const int* perm_b, const int* offsets_b, S* out_b,
                     int n_rows, int n_out, int d, void* stream) {
  const bool vec4 = chgnet::vec4_ok(x, d) && chgnet::vec4_ok(out_a, d) &&
                    chgnet::vec4_ok(out_b, d);
  if ((vec4 ? d / 4 : d) > kMaxUnits) return (int)cudaErrorInvalidValue;
  if (n_out > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    PairStreams s;
    s.perm[0] = perm_a;
    s.perm[1] = perm_b;
    s.offsets[0] = offsets_a;
    s.offsets[1] = offsets_b;
    s.out[0] = out_a;
    s.out[1] = out_b;
    const int err = vec4 ? launch_pair<S, float4>(x, s, n_rows, n_out, d / 4, st)
                         : launch_pair<S, float>(x, s, n_rows, n_out, d, st);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out [n_out, d] = the segment sums of x [., d] over CSR offsets
// [n_out + 1]; perm [offsets[n_out]] or null (a sorted stream). The _bf16
// entry takes bf16 x and out and sums in f32.
extern "C" int segment_sum_csr_f32(const float* x, const int* perm,
                                   const int* offsets, float* out, int n_out,
                                   int d, void* stream) {
  return segment_sum_csr(x, perm, offsets, out, n_out, d, stream);
}

extern "C" int segment_sum_csr_bf16(const chgnet::bf16* x, const int* perm,
                                    const int* offsets, chgnet::bf16* out,
                                    int n_out, int d, void* stream) {
  return segment_sum_csr(x, perm, offsets, out, n_out, d, stream);
}

// out_a, out_b as segment_sum_csr_f32's over the two streams (one n_out),
// in one sweep of x [n_rows, d].
extern "C" int segment_sum_pair_f32(const float* x, const int* perm_a,
                                    const int* offsets_a, float* out_a,
                                    const int* perm_b, const int* offsets_b,
                                    float* out_b, int n_rows, int n_out, int d,
                                    void* stream) {
  return segment_sum_pair(x, perm_a, offsets_a, out_a, perm_b, offsets_b, out_b,
                          n_rows, n_out, d, stream);
}

extern "C" int segment_sum_pair_bf16(const chgnet::bf16* x, const int* perm_a,
                                     const int* offsets_a, chgnet::bf16* out_a,
                                     const int* perm_b, const int* offsets_b,
                                     chgnet::bf16* out_b, int n_rows, int n_out,
                                     int d, void* stream) {
  return segment_sum_pair(x, perm_a, offsets_a, out_a, perm_b, offsets_b, out_b,
                          n_rows, n_out, d, stream);
}

// ------------------------------------------------ input-stationary sums
// segment_sum_tiles: the function of segment_sum_csr with the input owned,
// not the output. Replaces chgnet_tpu/ops/stream_ops.py _segsum_v2_kernel
// (:1003, wrapper _segsum_v2_pallas :1033), whose grid walks input chunks
// and flushes each output block once; the dispatch takes it for d < 128
// under CHGNET_TPU_STREAM_V2 (_segsum_impl :453).
//
// Bound: bytes, as segment_sum_csr. Design: the valid sorted rows are cut
// into tiles of kTileRows rows, one per group of lanes (a lane per float4
// unit of a row, so at d = 64 a warp holds two tiles and no lane idles, and
// the work per group is the same whatever the segment lengths). A group
// finds the segment of its first row by a binary search over the offsets,
// then walks its rows in order, adding runs of one segment: a segment that
// lies wholly inside the tile is written straight to out; the tile's first
// and last runs, when their segments reach past it, go to two carry slots
// of the tile (slot 0: the run that holds the tile's first row). A second
// kernel owns the output rows: it zeroes the empty segments and adds the
// carries of every segment that spans tiles, in tile order. No float
// atomics: two runs give equal bits. The add order (rows in order inside a
// tile, then tiles in order) differs from segment_sum_csr's lane-group tree,
// so the two agree to rounding only.
// bf16 rows (compute_dtype="bfloat16", the _bf16 entry): x and out bf16, in
// units of 4 values widened to f32 as they are read; the runs, the carries
// (f32 scratch) and their sums are f32, and each output row is rounded once,
// when it is stored, as the TPU kernel sums bf16 streams in f32
// (preferred_element_type, stream_ops.py:1021). Half the bytes of x and out.
namespace {

constexpr int kTileRows = 32;

// S: the storage type of x and out; V: a lane's value of a row and of the
// f32 carries, float or float4 (4 elements: 16 bytes of f32, 8 of bf16)
template <typename S, typename V>
__global__ void __launch_bounds__(kThreads)
    segment_sum_tiles_kernel(const S* __restrict__ x, const int* __restrict__ perm,
                             const int* __restrict__ offsets, S* __restrict__ out,
                             V* __restrict__ carry, int n_out, int units,
                             int lpr) {
  constexpr int kW = sizeof(V) / sizeof(float);  // elements of a unit
  const int groups = kThreads / lpr;
  const long t = (long)blockIdx.x * groups + threadIdx.x / lpr;  // the tile
  const int u = threadIdx.x % lpr;
  const int n_valid = offsets[n_out];
  const long b = t * kTileRows;
  if (b >= n_valid || u >= units) return;
  const int e = b + kTileRows < n_valid ? (int)b + kTileRows : n_valid;
  // the segment of row b: the first n with offsets[n + 1] > b
  int lo = 0, hi = n_out - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (offsets[mid + 1] > b) hi = mid; else lo = mid + 1;
  }
  int n = lo;
  int seg_beg = offsets[n];
  int seg_end = offsets[n + 1];
  V acc = vzero<V>();
  for (int k = (int)b; k <= e; ++k) {
    if (k == e || k >= seg_end) {  // the run of segment n ends before row k
      if (seg_beg >= b && seg_end <= e)
        store_v(out + ((long)n * units + u) * kW, acc);
      else
        carry[(t * 2 + (seg_beg > b)) * units + u] = acc;
      if (k == e) break;
      acc = vzero<V>();
      do {  // the next segment with a row, past the empty ones
        ++n;
        seg_end = offsets[n + 1];
      } while (k >= seg_end);
      seg_beg = offsets[n];
    }
    const long row = perm ? perm[k] : k;
    V v;
    load_v(v, x + (row * units + u) * kW);
    vadd(acc, v);
  }
}

template <typename S, typename V>
__global__ void __launch_bounds__(kThreads)
    segment_sum_carry_kernel(const int* __restrict__ offsets,
                             const V* __restrict__ carry, S* __restrict__ out,
                             int n_out, int units, int lpr) {
  constexpr int kW = sizeof(V) / sizeof(float);
  const int groups = kThreads / lpr;
  const int u = threadIdx.x % lpr;
  if (u >= units) return;
  for (long n = (long)blockIdx.x * groups + threadIdx.x / lpr; n < n_out;
       n += (long)gridDim.x * groups) {
    const int beg = offsets[n];
    const int end = offsets[n + 1];
    if (beg == end) {
      store_v(out + (n * units + u) * kW, vzero<V>());
      continue;
    }
    const int t0 = beg / kTileRows;
    const int t1 = (end - 1) / kTileRows;
    if (t0 == t1) continue;  // wholly inside a tile: the first kernel wrote it
    V acc = vzero<V>();
    for (long t = t0; t <= t1; ++t) {
      const int slot = t == t0 && beg > t * kTileRows;
      vadd(acc, carry[(t * 2 + slot) * units + u]);
    }
    store_v(out + (n * units + u) * kW, acc);
  }
}

template <typename S, typename V>
void launch_tiles(const S* x, const int* perm, const int* offsets, S* out,
                  V* carry, int n_rows, int n_out, int units, cudaStream_t st) {
  int lpr = 1;  // lanes per tile (power of two)
  while (lpr < units) lpr <<= 1;
  const int groups = kThreads / lpr;
  const long tiles = ((long)n_rows + kTileRows - 1) / kTileRows;
  if (tiles > 0)
    segment_sum_tiles_kernel<S, V><<<(int)((tiles + groups - 1) / groups), kThreads,
                                     0, st>>>(x, perm, offsets, out, carry, n_out,
                                              units, lpr);
  const long want = ((long)n_out + groups - 1) / groups;
  const long cap = (long)chgnet::sm_count() * 16;
  segment_sum_carry_kernel<S, V><<<(int)(want < cap ? want : cap), kThreads, 0, st>>>(
      offsets, carry, out, n_out, units, lpr);
}

template <typename S>
int segment_sum_tiles(const S* x, const int* perm, const int* offsets, S* out,
                      float* carry, int n_rows, int n_out, int d, void* stream) {
  const bool vec4 = chgnet::vec4_ok(x, d) && chgnet::vec4_ok(out, d) &&
                    chgnet::vec4_ok(carry, d);
  if ((vec4 ? d / 4 : d) > kMaxUnits) return (int)cudaErrorInvalidValue;
  if (n_out > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec4) {
      launch_tiles<S, float4>(x, perm, offsets, out, reinterpret_cast<float4*>(carry),
                              n_rows, n_out, d / 4, st);
    } else {
      launch_tiles<S, float>(x, perm, offsets, out, carry, n_rows, n_out, d, st);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out [n_out, d] as segment_sum_csr_f32; n_rows bounds the valid rows
// (offsets[n_out] <= n_rows); carry: f32 scratch of 2 d floats per tile of
// 32 rows, ceil(n_rows / 32) tiles, 16-byte aligned. The _bf16 entry takes
// bf16 x and out (the carry stays f32).
extern "C" int segment_sum_tiles_f32(const float* x, const int* perm,
                                     const int* offsets, float* out,
                                     float* carry, int n_rows, int n_out, int d,
                                     void* stream) {
  return segment_sum_tiles(x, perm, offsets, out, carry, n_rows, n_out, d, stream);
}

extern "C" int segment_sum_tiles_bf16(const chgnet::bf16* x, const int* perm,
                                      const int* offsets, chgnet::bf16* out,
                                      float* carry, int n_rows, int n_out, int d,
                                      void* stream) {
  return segment_sum_tiles(x, perm, offsets, out, carry, n_rows, n_out, d, stream);
}
