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
// aligned), and several input rows are summed side by side by lane groups
// and folded with a fixed shuffle tree, so every sum is deterministic run to
// run. A row of at most 32 units takes one lane a unit; a wider one (up to
// kMaxUnits: 256 aligned floats, the first layer's cotangent of a 128-wide
// model) is summed in chunks of 32 units, one after the other, each by the
// whole warp in the same way (the kChunked instantiations; the others are
// the code of rows up to 32 units as it was).
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
#include <climits>

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
// taken in f32 and rounded to S once, at the store. kChunked: rows of more
// than 32 units, in chunks of 32.
template <typename S, typename V, bool kChunked>
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
  if constexpr (kChunked) {
    for (long n = warp0; n < n_out; n += n_warps) {
      const int beg = offsets[n];
      const int end = offsets[n + 1];
      // units c0 .. c0 + cu - 1 of the row
      for (int c0 = 0; c0 < units; c0 += 32) {
        const int cu = units - c0 < 32 ? units - c0 : 32;
        int lpr = 1;  // lanes per input row (power of two)
        while (lpr < cu) lpr <<= 1;
        const int groups = 32 / lpr;
        const int g = lane / lpr;
        const int u = lane % lpr;
        V acc = vzero<V>();
        if (u < cu) {
#pragma unroll 4
          for (int k = beg + g; k < end; k += groups)
            add_row<S, V>(acc, x, perm, k, units, c0 + u);
        }
        for (int off = 16; off >= lpr; off >>= 1) vadd(acc, shfl_down(acc, off));
        if (g == 0 && u < cu) store_v(out + (n * units + c0 + u) * kW, acc);
      }
    }
    return;
  }
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

template <typename S, typename V, bool kChunked>
__global__ void __launch_bounds__(256)
    segment_sum_csr_kernel(const S* __restrict__ x, const int* __restrict__ perm,
                           const int* __restrict__ offsets, S* __restrict__ out,
                           int n_out, int units) {
  segsum_rows<S, V, kChunked>(x, perm, offsets, out, n_out, units);
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
// kChunked: rows of more than 32 units, in chunks of 32 as in segsum_rows.
template <typename S, typename V, int kUnroll, bool kChunked>
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
    if constexpr (kChunked) {
      for (int c0 = 0; c0 < units; c0 += 32) {
        const int cu = units - c0 < 32 ? units - c0 : 32;
        int lp = 1;  // lanes per input row of this chunk
        while (lp < cu) lp <<= 1;
        const int gs = 32 / lp;
        const int gc = lane / lp;
        const int uc = lane % lp;
        V acc_a = vzero<V>();
        V acc_b = vzero<V>();
        if (uc < cu)
          add_pair<kUnroll, S, V>(acc_a, acc_b, x, s.perm[0], beg_a, len_a, s.perm[1],
                                  beg_b, len_b, gc, gs, units, c0 + uc);
        for (int off = 16; off >= lp; off >>= 1) {
          vadd(acc_a, shfl_down(acc_a, off));
          vadd(acc_b, shfl_down(acc_b, off));
        }
        if (gc == 0 && uc < cu) {
          store_v(out_a + (n * units + c0 + uc) * kW, acc_a);
          store_v(out_b + (n * units + c0 + uc) * kW, acc_b);
        }
      }
      continue;
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

// Blocks of segment_sum_pair_kernel<S, V, kUnroll, kChunked> resident on
// the current device at once (256 threads each, no shared memory), found
// once per device.
template <typename S, typename V, int kUnroll, bool kChunked>
int pair_wave() {
  static std::atomic<int> per_sm[16];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev >= 16) return -(int)cudaErrorInvalidDevice;
  int n = per_sm[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, segment_sum_pair_kernel<S, V, kUnroll, kChunked>, 256, 0);
    if (err != cudaSuccess) return -(int)err;
    n = n > 0 ? n : 1;
    per_sm[dev].store(n, std::memory_order_relaxed);
  }
  return n * chgnet::sm_count();
}

constexpr int kThreads = 256;
// units of the widest row: a 128-wide model's first-layer cotangent, K =
// 256 floats, in float4 units (64 floats where the row is not aligned)
constexpr int kMaxUnits = 64;

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
    const bool chunked = (vec4 ? d / 4 : d) > 32;
    if (vec4 && chunked) {
      segment_sum_csr_kernel<S, float4, true><<<grid, kThreads, 0, st>>>(
          x, perm, offsets, out, n_out, d / 4);
    } else if (vec4) {
      segment_sum_csr_kernel<S, float4, false><<<grid, kThreads, 0, st>>>(
          x, perm, offsets, out, n_out, d / 4);
    } else if (chunked) {
      segment_sum_csr_kernel<S, float, true><<<grid, kThreads, 0, st>>>(
          x, perm, offsets, out, n_out, d);
    } else {
      segment_sum_csr_kernel<S, float, false><<<grid, kThreads, 0, st>>>(
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
template <typename S, typename V, int kUnroll, bool kChunked>
int launch_pair_kernel(const S* x, const PairStreams& s, int n_out, int units,
                       int waves, cudaStream_t st) {
  long blocks = ((long)n_out + kThreads / 32 - 1) / (kThreads / 32);
  if (waves > 0) {
    const int wave = pair_wave<S, V, kUnroll, kChunked>();
    if (wave < 0) return -wave;
    blocks = blocks < (long)wave * waves ? blocks : (long)wave * waves;
  }
  segment_sum_pair_kernel<S, V, kUnroll, kChunked><<<(int)blocks, kThreads, 0, st>>>(
      x, s, n_out, units);
  return (int)cudaSuccess;
}

template <typename S, typename V, bool kChunked>
int launch_pair(const S* x, const PairStreams& s, int n_rows, int n_out, int units,
                cudaStream_t st) {
  if ((long)n_rows >= (long)kLongRows * n_out)
    return launch_pair_kernel<S, V, kLongUnroll, kChunked>(x, s, n_out, units, 1, st);
  return launch_pair_kernel<S, V, 1, kChunked>(
      x, s, n_out, units, chgnet::is_bf16<S> ? kShortWavesBf16 : 0, st);
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
    const int units = vec4 ? d / 4 : d;
    int err;
    if (units > 32)
      err = vec4 ? launch_pair<S, float4, true>(x, s, n_rows, n_out, units, st)
                 : launch_pair<S, float, true>(x, s, n_rows, n_out, units, st);
    else
      err = vec4 ? launch_pair<S, float4, false>(x, s, n_rows, n_out, units, st)
                 : launch_pair<S, float, false>(x, s, n_rows, n_out, units, st);
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
// (:1003, wrapper _segsum_v2_pallas :1033), whose grid walks input chunks in
// order and flushes each output block once; the dispatch takes it for d <
// 128 under CHGNET_TPU_STREAM_V2 (_segsum_impl :453). On the card blocks
// run in no order, so a segment cut by a block boundary goes through a
// carry and a second, small kernel.
//
// Bound: bytes, as segment_sum_csr: the valid rows of x (and their 4-byte
// permutation entries) read once, the offsets read once, n_out rows
// written; one add per element read. Design, each point against what held
// the first design (a lane group per 32-row tile) back:
// - Blocks own long parts of the stream, found once. The wrapper launches
//   `blocks` (tiles_blocks in ops/segment.py: a block per 256 rows and
//   segments of capacity, at most four an SM). Block b takes an equal part
//   of the merge path of the valid sorted rows and the segment ends, so a
//   run of empty segments (bench.py's angle stream ends in ~62,700 padded
//   bonds without angles) is shared out like rows; split by rows alone, the
//   last block walked them all and held every call up. Each end of a part
//   is found by one warp probing 32 offsets a round (path_segment: 4 rounds
//   of loads over 647,168 segments, where the first design searched 20
//   deep per 32-row tile). The block walks its segments from slices of
//   kSlice offsets staged in shared memory by coalesced loads, slice after
//   slice through runs of empty segments.
// - Rows are loaded ahead of the adds. The block's rows are copied chunk by
//   chunk (kStageBytes of rows) into a ring of kStages chunks in shared
//   memory with cp.async (16-byte copies where the rows allow, else 8 or 4;
//   bf16 rows of an odd width by plain loads); the permutation entries of
//   a chunk's 16-byte copies are loaded a chunk before its copies are
//   issued. The warps then sum staged rows segment by segment: no load
//   waits on a segment boundary.
// - Segments go to lane groups by their index: short segments (mean under
//   kLongSegment rows) a group of lanes each (a lane per unit of a row),
//   long ones a warp each, whose lane groups take every `split`-th row of
//   the segment and fold with a fixed shuffle tree (the warp converged
//   first; an empty segment skips it). A row of more than 32 units (up to
//   kMaxUnits) takes a group of 64 lanes, two warps, and its segments are
//   summed row after row by that group (split 1, no shuffles).
// - Units of 16 bytes: 4 f32 values, or 8 bf16 values widened to f32 in
//   registers (a 64-wide bf16 row is 8 lanes); rows of 4k bf16 values on
//   8-byte aligned storage keep 4-value units, other widths and unaligned
//   rows single values.
// - Two carries per block, not per 32 rows. A segment that begins and ends
//   in the block's part (empty ones too) is written once, by the group that
//   sums it. The part's first segment, when it began in an earlier part,
//   goes to carry slot 0 (its index to head[b]); its last, when it has rows
//   here and ends later, to slot 1. segment_sum_fixup_kernel then sums each
//   such segment's carries in block order, one lane group a block boundary.
// No float atomics: the add order is fixed by the plan (the parts' bounds,
// the split) and two runs give equal bits; it differs from segment_sum_csr's,
// so the two agree to rounding only. The adds are f32; bf16 rows (the _bf16
// entry) are widened as they are read from shared memory, their carries are
// f32, and each output row is rounded once, at its store, as the TPU kernel
// sums bf16 streams in f32 (preferred_element_type, stream_ops.py:1021).
namespace {

using chgnet::bf16;

constexpr int kTileThreads = 256;
constexpr int kStages = 3;          // chunks of rows in flight a block
constexpr int kStageBytes = 16384;  // bytes of rows a chunk holds
constexpr int kSlice = 1024;        // segments whose offsets are staged at once
constexpr int kLongSegment = 16;    // mean rows a segment that takes a warp
constexpr int kTileSmem = kStages * kStageBytes + (kSlice + 1) * (int)sizeof(int);

// a lane's unit of a row: kW consecutive values, summed in f32
template <int kW>
struct Acc {
  float v[kW];
};

template <int kW>
__device__ __forceinline__ void zero(Acc<kW>& a) {
#pragma unroll
  for (int e = 0; e < kW; ++e) a.v[e] = 0.f;
}
template <int kW>
__device__ __forceinline__ void add(Acc<kW>& a, const Acc<kW>& b) {
#pragma unroll
  for (int e = 0; e < kW; ++e) a.v[e] += b.v[e];
}
template <int kW>
__device__ __forceinline__ Acc<kW> shfl_down(const Acc<kW>& a, int off) {
  Acc<kW> r;
#pragma unroll
  for (int e = 0; e < kW; ++e) r.v[e] = __shfl_down_sync(0xffffffffu, a.v[e], off);
  return r;
}

// two bf16 values of a 32-bit word, widened (the first in the low half)
__device__ __forceinline__ void widen2(float* f, unsigned w) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned narrow2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// a unit from p (shared memory, or the f32 carries), widened to f32
__device__ __forceinline__ void load_unit(Acc<1>& a, const float* p) { a.v[0] = *p; }
__device__ __forceinline__ void load_unit(Acc<4>& a, const float* p) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  a.v[0] = f.x, a.v[1] = f.y, a.v[2] = f.z, a.v[3] = f.w;
}
__device__ __forceinline__ void load_unit(Acc<8>& a, const float* p) {
  Acc<4> lo, hi;
  load_unit(lo, p);
  load_unit(hi, p + 4);
#pragma unroll
  for (int e = 0; e < 4; ++e) a.v[e] = lo.v[e], a.v[4 + e] = hi.v[e];
}
__device__ __forceinline__ void load_unit(Acc<1>& a, const bf16* p) {
  a.v[0] = __bfloat162float(*p);
}
__device__ __forceinline__ void load_unit(Acc<4>& a, const bf16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  widen2(a.v, w.x);
  widen2(a.v + 2, w.y);
}
__device__ __forceinline__ void load_unit(Acc<8>& a, const bf16* p) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  widen2(a.v, w.x);
  widen2(a.v + 2, w.y);
  widen2(a.v + 4, w.z);
  widen2(a.v + 6, w.w);
}

// a unit to p (out, or the f32 carries), rounded once to bf16 for bf16 rows
__device__ __forceinline__ void store_unit(float* p, const Acc<1>& a) { *p = a.v[0]; }
__device__ __forceinline__ void store_unit(float* p, const Acc<4>& a) {
  *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
}
__device__ __forceinline__ void store_unit(float* p, const Acc<8>& a) {
  *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(a.v[4], a.v[5], a.v[6], a.v[7]);
}
__device__ __forceinline__ void store_unit(bf16* p, const Acc<1>& a) {
  *p = __float2bfloat16_rn(a.v[0]);
}
__device__ __forceinline__ void store_unit(bf16* p, const Acc<4>& a) {
  *reinterpret_cast<uint2*>(p) = make_uint2(narrow2(a.v[0], a.v[1]), narrow2(a.v[2], a.v[3]));
}
__device__ __forceinline__ void store_unit(bf16* p, const Acc<8>& a) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(narrow2(a.v[0], a.v[1]), narrow2(a.v[2], a.v[3]),
                 narrow2(a.v[4], a.v[5]), narrow2(a.v[6], a.v[7]));
}

// kBytes from global src to shared dst: cp.async for 16, 8 and 4 bytes
// (16: through L2 only), a plain load and store for 2
template <int kBytes>
__device__ __forceinline__ void copy_bytes(unsigned char* dst, const unsigned char* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else if constexpr (kBytes == 2) {
    *reinterpret_cast<unsigned short*>(dst) = *reinterpret_cast<const unsigned short*>(src);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
                 "n"(kBytes));
  }
}

// the launch's shape, fixed by the rows and the plan's size
struct TilesShape {
  int n_out;
  int d;
  int units;       // units of a row
  int lpr;         // lanes per row: a power of two >= units
  int split;       // lane groups (of lpr lanes) that share a segment
  int row_bytes;   // bytes of a row of x
  int chunk_rows;  // rows of a chunk: kStageBytes / row_bytes
  int copy;        // bytes of a copy: 16, 8, 4 or 2
};

// rows [c0, c0 + rows) of the sorted stream (x's rows perm[k], or k) into
// dst, kBytes a copy; each thread loads the permutation entries of a batch
// of its copies before it issues them
template <int kBytes>
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const unsigned char* x,
                                           const int* __restrict__ perm, int c0,
                                           int rows, int row_bytes) {
  constexpr int kSteps = kStageBytes / (kBytes * kTileThreads);
  constexpr int kBatch = kSteps < 4 ? kSteps : 4;
  const int per_row = row_bytes / kBytes;
  const int n = rows * per_row;
#pragma unroll 1
  for (int m0 = 0; m0 < kSteps && (int)threadIdx.x + m0 * kTileThreads < n; m0 += kBatch) {
    long src[kBatch];
    int at[kBatch];
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      const int q = threadIdx.x + (m0 + m) * kTileThreads;
      const int i = q / per_row;
      const int p = (q - i * per_row) * kBytes;
      at[m] = i * row_bytes + p;
      src[m] = q < n ? (long)(perm ? perm[c0 + i] : c0 + i) * row_bytes + p : -1;
    }
#pragma unroll
    for (int m = 0; m < kBatch; ++m)
      if (src[m] >= 0) copy_bytes<kBytes>(dst + at[m], x + src[m]);
  }
}

// 16-byte copies, a thread's kSteps16 of a chunk; their sources (x's row
// perm[k], or k; -1 past the chunk) are loaded a chunk ahead of the copies
constexpr int kSteps16 = kStageBytes / (16 * kTileThreads);

__device__ __forceinline__ void chunk_sources16(int (&src)[kSteps16],
                                                const int* __restrict__ perm, int c0,
                                                int rows, int row_bytes) {
  const int per_row = row_bytes / 16;
#pragma unroll
  for (int m = 0; m < kSteps16; ++m) {
    const int i = (threadIdx.x + m * kTileThreads) / per_row;
    src[m] = i < rows ? (perm ? perm[c0 + i] : c0 + i) : -1;
  }
}

__device__ __forceinline__ void copy_chunk16(unsigned char* dst, const unsigned char* x,
                                             const int (&src)[kSteps16], int row_bytes) {
  const int per_row = row_bytes / 16;
#pragma unroll
  for (int m = 0; m < kSteps16; ++m) {
    const int q = threadIdx.x + m * kTileThreads;
    const int i = q / per_row;
    const int p = (q - i * per_row) * 16;
    if (src[m] >= 0) copy_bytes<16>(dst + i * row_bytes + p, x + (long)src[m] * row_bytes + p);
  }
}

// The merge path of the sorted rows and the segment ends: item p of the
// path is row k or the end of segment n, in order, the end of segment n at
// p = offsets[n + 1] + n. The point of the path at diagonal v is (n, v - n),
// n the first segment with offsets[n + 1] + n >= v (n_out when none): the
// segments before n have ended, rows before v - n are taken. One warp, 32
// probes a round.
__device__ __forceinline__ int path_segment(const int* __restrict__ offsets, int n_out,
                                            long v) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n_out;  // the answer lies in [lo, hi]
  auto ends_by = [&](int n) { return n == n_out || (long)offsets[n + 1] + n >= v; };
  while (hi - lo > 31) {
    const int step = (hi - lo + 31) >> 5;
    const unsigned ge = __ballot_sync(0xffffffffu, ends_by(min(lo + (lane + 1) * step, hi)));
    const int f = __ffs(ge) - 1;  // lane 31 probes hi, which holds
    const int top = min(lo + (f + 1) * step, hi);
    lo = f == 0 ? lo : lo + f * step + 1;
    hi = top;
  }
  const unsigned ge = __ballot_sync(0xffffffffu, lo + lane <= hi && ends_by(lo + lane));
  return lo + __ffs(ge) - 1;
}

// S: the storage type of x and out; kW: values of a lane's unit. carry:
// 2 rows of d floats a block; head[b]: the segment of carry slot 0 (-1:
// none).
template <typename S, int kW>
__global__ void __launch_bounds__(kTileThreads)
    segment_sum_tiles_kernel(const S* __restrict__ x, const int* __restrict__ perm,
                             const int* __restrict__ offsets, S* __restrict__ out,
                             float* __restrict__ carry, int* __restrict__ head,
                             TilesShape t) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* soff = reinterpret_cast<int*>(smem + kStages * kStageBytes);
  // the block's part of the path, items [b per, b per + per) of the n_valid
  // rows and n_out ends: s_path[3 w .. 3 w + 2] = (n, k, offsets[n] < k) of
  // its start (w = 0) and of its end (w = 1)
  __shared__ int s_path[6];
  const int b = blockIdx.x;
  if (threadIdx.x < 64) {  // warp 0 finds the start, warp 1 the end
    const int w = threadIdx.x >> 5;
    const long items = (long)offsets[t.n_out] + t.n_out;
    const long per = (items + gridDim.x - 1) / gridDim.x;
    const long at = (long)(b + w) * per;
    const long v = at < items ? at : items;
    const int n = path_segment(offsets, t.n_out, v);
    if ((threadIdx.x & 31) == 0) {
      s_path[3 * w] = n;
      s_path[3 * w + 1] = (int)(v - n);
      s_path[3 * w + 2] = offsets[n] < v - n;  // segment n has rows before k
    }
  }
  __syncthreads();
  // the segments n_first .. n_last - 1 end in this block, and rows r0 .. r1
  // - 1 are its; n_first began earlier when `cont`, n_last has rows here
  // (and runs on) when `runs_on`
  const int n_first = s_path[0], r0 = s_path[1];
  const bool cont = s_path[2];
  const int n_last = s_path[3], r1 = s_path[4];
  const bool runs_on = s_path[5];
  const int n_end = n_last + runs_on;  // the walk: segments [n_first, n_end)
  if (threadIdx.x == 0) head[b] = cont ? n_first : -1;
  const int C = t.chunk_rows;
  const int n_chunks = max((r1 - r0 + C - 1) / C, 1);
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  int src16[kSteps16];  // the sources of the next chunk's 16-byte copies
  auto fetch = [&](int j) {
    const int c0 = r0 + j * C;
    if (t.copy == 16 && j < n_chunks)
      chunk_sources16(src16, perm, c0, min(C, r1 - c0), t.row_bytes);
  };
  auto issue = [&](int j) {  // chunk j's rows into its stage; 16-byte ones from src16
    if (j < n_chunks) {
      const int c0 = r0 + j * C;
      unsigned char* dst = smem + (j % kStages) * kStageBytes;
      const int rows = min(C, r1 - c0);
      switch (t.copy) {
        case 16: copy_chunk16(dst, xb, src16, t.row_bytes); break;
        case 8: copy_chunk<8>(dst, xb, perm, c0, rows, t.row_bytes); break;
        case 4: copy_chunk<4>(dst, xb, perm, c0, rows, t.row_bytes); break;
        default: copy_chunk<2>(dst, xb, perm, c0, rows, t.row_bytes); break;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
#pragma unroll 1
  for (int j = 0; j < kStages - 1; ++j) {
    fetch(j);
    issue(j);
  }
  fetch(kStages - 1);
  int n_cur = n_first;  // the first segment not finished
  int s0 = n_cur;       // soff[i] = offsets[s0 + i]
  auto stage_offsets = [&]() {
    for (int i = threadIdx.x; i <= kSlice; i += kTileThreads)
      soff[i] = offsets[min(s0 + i, t.n_out)];
  };
  stage_offsets();

  const int gsize = t.split * t.lpr;  // lanes that sum one segment
  const int groups = kTileThreads / gsize;
  const int group = threadIdx.x / gsize;
  const int sub = (threadIdx.x % gsize) / t.lpr;
  const int u = threadIdx.x % t.lpr;
  const bool live = u < t.units;
  int open = -1;  // this group's segment that runs on past the last chunk
  Acc<kW> acc;
  zero(acc);
#pragma unroll 1
  for (int j = 0; j < n_chunks; ++j) {
    issue(j + kStages - 1);
    fetch(j + kStages);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
    __syncthreads();
    const unsigned char* rows = smem + (j % kStages) * kStageBytes;
    const int c0 = r0 + j * C;
    const int c1 = min(c0 + C, r1);
    // segments starting below limit take part in this chunk; in the last
    // chunk every walked segment (the empty ones at r1 too)
    const int limit = j == n_chunks - 1 ? INT_MAX : c1;
    int i_lim;
#pragma unroll 1
    while (true) {
      const int n_seg = min(kSlice, n_end - s0);
      int lo = 0, hi = n_seg;  // i_lim: the first slice segment at or past limit
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (soff[mid] < limit) lo = mid + 1; else hi = mid;
      }
      i_lim = lo;
      const int i0 = n_cur - s0;
#pragma unroll 1
      for (int i = i0 + ((group - (s0 + i0)) & (groups - 1)); i < i_lim; i += groups) {
        const int n = s0 + i;
        const int beg = soff[i];
        const int end = soff[i + 1];
        if (n != open) zero(acc);
        if (live) {  // lane group sub takes the rows k = sub mod split
          const int k0 = max(beg, c0);
          const int k1 = min(end, c1);
#pragma unroll 4
          for (int k = k0 + ((sub - k0) & (t.split - 1)); k < k1; k += t.split) {
            Acc<kW> v;
            load_unit(v, reinterpret_cast<const S*>(rows + (long)(k - c0) * t.row_bytes) +
                             u * kW);
            add(acc, v);
          }
        }
        if (min(end, r1) > c1) {  // its rows go on past this chunk
          open = n;
          continue;
        }
        open = -1;
        // a warp's lane groups fold their sums by a shuffle tree, the
        // warp converged first; an empty segment's sums are zero as they are
        if (gsize > t.lpr && beg < end) {
          __syncwarp();
          for (int off = gsize >> 1; off >= t.lpr; off >>= 1) add(acc, shfl_down(acc, off));
        }
        if (sub == 0 && live) {
          if (beg < r0)
            store_unit(carry + ((long)b * 2) * t.d + u * kW, acc);
          else if (n == n_last)
            store_unit(carry + ((long)b * 2 + 1) * t.d + u * kW, acc);
          else
            store_unit(out + (long)n * t.d + u * kW, acc);
        }
      }
      // every segment of the slice done and more start below limit: the next slice
      if (i_lim == n_seg && s0 + n_seg < n_end && soff[n_seg] < limit) {
        __syncthreads();
        s0 += n_seg;
        n_cur = s0;
        stage_offsets();
        __syncthreads();
        continue;
      }
      break;
    }
    // the next chunk starts at the segment left open, else at the first
    // one not yet walked
    n_cur = i_lim > 0 && soff[i_lim] > c1 ? s0 + i_lim - 1 : s0 + i_lim;
    __syncthreads();  // the chunk's stage and soff are read
  }
}

// Each segment that spans blocks, summed from its carries in block order:
// slot 1 of the block it began in, slot 0 of every later block it reaches.
// A lane group per block b >= 1 whose first segment began in block b - 1.
template <typename S, int kW>
__global__ void __launch_bounds__(kTileThreads)
    segment_sum_fixup_kernel(const float* __restrict__ carry,
                             const int* __restrict__ head, S* __restrict__ out,
                             int blocks, TilesShape t) {
  const int groups = kTileThreads / t.lpr;
  const int b = 1 + blockIdx.x * groups + threadIdx.x / t.lpr;
  const int u = threadIdx.x % t.lpr;
  if (b >= blocks || u >= t.units) return;
  const int n = head[b];
  if (n < 0 || head[b - 1] == n) return;
  Acc<kW> acc, v;
  load_unit(acc, carry + ((long)(b - 1) * 2 + 1) * t.d + u * kW);
  for (long c = b; c < blocks && head[c] == n; ++c) {
    load_unit(v, carry + (c * 2) * t.d + u * kW);
    add(acc, v);
  }
  store_unit(out + (long)n * t.d + u * kW, acc);
}

// allows kernel its dynamic shared memory, once per device
template <typename S, int kW>
cudaError_t allow_tiles_smem() {
  static std::atomic<unsigned> done{0};  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (done.load(std::memory_order_relaxed) & (1u << dev)) return cudaSuccess;
  err = cudaFuncSetAttribute(segment_sum_tiles_kernel<S, kW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
  if (err == cudaSuccess) done.fetch_or(1u << dev, std::memory_order_relaxed);
  return err;
}

template <typename S, int kW>
int launch_tiles(const S* x, const int* perm, const int* offsets, S* out, float* carry,
                 int n_rows, int n_out, int d, int blocks, cudaStream_t st) {
  TilesShape t;
  t.n_out = n_out;
  t.d = d;
  t.units = d / kW;
  t.lpr = 1;
  while (t.lpr < t.units) t.lpr <<= 1;
  t.row_bytes = d * (int)sizeof(S);
  t.chunk_rows = kStageBytes / t.row_bytes;
  t.split = t.lpr <= 32 && (long)n_rows >= (long)kLongSegment * n_out ? 32 / t.lpr : 1;
  const uintptr_t a = reinterpret_cast<uintptr_t>(x);
  t.copy = 2;
  for (int c = 16; c >= 4; c >>= 1) {
    if (t.row_bytes % c == 0 && a % c == 0) {
      t.copy = c;
      break;
    }
  }
  const cudaError_t err = allow_tiles_smem<S, kW>();
  if (err != cudaSuccess) return (int)err;
  int* head = reinterpret_cast<int*>(carry + (long)blocks * 2 * d);
  segment_sum_tiles_kernel<S, kW><<<blocks, kTileThreads, kTileSmem, st>>>(
      x, perm, offsets, out, carry, head, t);
  if (blocks > 1) {
    const int groups = kTileThreads / t.lpr;
    segment_sum_fixup_kernel<S, kW><<<(blocks - 1 + groups - 1) / groups, kTileThreads, 0,
                                      st>>>(carry, head, out, blocks, t);
  }
  return (int)cudaSuccess;
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename S>
int segment_sum_tiles(const S* x, const int* perm, const int* offsets, S* out,
                      float* carry, int n_rows, int n_out, int d, int blocks,
                      void* stream) {
  constexpr int es = (int)sizeof(S);
  // 8 bf16 values a unit where the rows allow, else 4 values, else 1
  const bool by8 = chgnet::is_bf16<S> && d % 8 == 0 && aligned(x, 16) && aligned(out, 16);
  const bool by4 = d % 4 == 0 && aligned(x, 4 * es) && aligned(out, 4 * es);
  const int kw = by8 ? 8 : by4 ? 4 : 1;
  if (d / kw > kMaxUnits || blocks < 1 || !aligned(carry, 16))
    return (int)cudaErrorInvalidValue;
  if (n_out > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int err = 0;
    if constexpr (chgnet::is_bf16<S>) {  // no 8-value units of f32
      if (kw == 8)
        err = launch_tiles<S, 8>(x, perm, offsets, out, carry, n_rows, n_out, d, blocks, st);
    }
    if (kw == 4)
      err = launch_tiles<S, 4>(x, perm, offsets, out, carry, n_rows, n_out, d, blocks, st);
    if (kw == 1)
      err = launch_tiles<S, 1>(x, perm, offsets, out, carry, n_rows, n_out, d, blocks, st);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out [n_out, d] as segment_sum_csr_f32; n_rows bounds the valid rows
// (offsets[n_out] <= n_rows, offsets[0] = 0); blocks: the blocks that share
// the rows (ops/segment.py tiles_blocks); carry: f32 scratch of blocks x
// (2 d + 1) floats, 16-byte aligned (two carry rows a block, then an int a
// block). The _bf16 entry takes bf16 x and out (the carries stay f32).
extern "C" int segment_sum_tiles_f32(const float* x, const int* perm,
                                     const int* offsets, float* out,
                                     float* carry, int n_rows, int n_out, int d,
                                     int blocks, void* stream) {
  return segment_sum_tiles(x, perm, offsets, out, carry, n_rows, n_out, d, blocks,
                           stream);
}

extern "C" int segment_sum_tiles_bf16(const chgnet::bf16* x, const int* perm,
                                      const int* offsets, chgnet::bf16* out,
                                      float* carry, int n_rows, int n_out, int d,
                                      int blocks, void* stream) {
  return segment_sum_tiles(x, perm, offsets, out, carry, n_rows, n_out, d, blocks,
                           stream);
}
