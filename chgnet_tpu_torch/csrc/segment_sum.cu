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
// tree, so every sum is deterministic run to run. segment_sum_pair reads x twice (once per key stream, on
// blockIdx.y); the TPU kernel's one-sweep saving is later work.
// bf16 rows (compute_dtype="bfloat16"): the same sweep over units of 4
// bf16 (8 bytes), widened to f32 as they are read, summed in f32 in the same
// order and rounded once at the store; the TPU kernel also sums bf16
// streams in f32 (preferred_element_type, stream_ops.py:194,321). Half the
// bytes of f32, so half the bound.
#include "common.cuh"

namespace {

using chgnet::load_v;
using chgnet::shfl_down;
using chgnet::store_v;
using chgnet::vadd;
using chgnet::vzero;

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
      for (int k = beg + g; k < end; k += groups) {
        const long row = perm ? perm[k] : k;
        V v;
        load_v(v, x + (row * units + u) * kW);
        vadd(acc, v);
      }
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

template <typename S, typename V>
__global__ void __launch_bounds__(256)
    segment_sum_pair_kernel(const S* __restrict__ x, PairStreams s, int n_out,
                            int units) {
  const int z = blockIdx.y;
  segsum_rows<S, V>(x, s.perm[z], s.offsets[z], static_cast<S*>(s.out[z]),
                    n_out, units);
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

template <typename S>
int segment_sum_pair(const S* x, const int* perm_a, const int* offsets_a,
                     S* out_a, const int* perm_b, const int* offsets_b, S* out_b,
                     int n_out, int d, void* stream) {
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
    const dim3 grid(grid_for(n_out), 2);
    if (vec4) {
      segment_sum_pair_kernel<S, float4><<<grid, kThreads, 0, st>>>(
          x, s, n_out, d / 4);
    } else {
      segment_sum_pair_kernel<S, float><<<grid, kThreads, 0, st>>>(x, s, n_out, d);
    }
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

extern "C" int segment_sum_pair_f32(const float* x, const int* perm_a,
                                    const int* offsets_a, float* out_a,
                                    const int* perm_b, const int* offsets_b,
                                    float* out_b, int n_out, int d,
                                    void* stream) {
  return segment_sum_pair(x, perm_a, offsets_a, out_a, perm_b, offsets_b, out_b,
                          n_out, d, stream);
}

extern "C" int segment_sum_pair_bf16(const chgnet::bf16* x, const int* perm_a,
                                     const int* offsets_a, chgnet::bf16* out_a,
                                     const int* perm_b, const int* offsets_b,
                                     chgnet::bf16* out_b, int n_out, int d,
                                     void* stream) {
  return segment_sum_pair(x, perm_a, offsets_a, out_a, perm_b, offsets_b, out_b,
                          n_out, d, stream);
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
