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
#include "common.cuh"

namespace {

using chgnet::shfl_down;
using chgnet::vadd;
using chgnet::vzero;

template <typename T>
__device__ __forceinline__ void segsum_rows(const T* __restrict__ x,
                                            const int* __restrict__ perm,
                                            const int* __restrict__ offsets,
                                            T* __restrict__ out, int n_out,
                                            int units) {
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
    T acc = vzero<T>();
    if (u < units) {
#pragma unroll 4
      for (int k = beg + g; k < end; k += groups) {
        const long row = perm ? perm[k] : k;
        vadd(acc, x[row * units + u]);
      }
    }
    for (int off = 16; off >= lpr; off >>= 1) vadd(acc, shfl_down(acc, off));
    if (g == 0 && u < units) out[n * units + u] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    segment_sum_csr_kernel(const T* __restrict__ x, const int* __restrict__ perm,
                           const int* __restrict__ offsets, T* __restrict__ out,
                           int n_out, int units) {
  segsum_rows<T>(x, perm, offsets, out, n_out, units);
}

struct PairStreams {
  const int* perm[2];
  const int* offsets[2];
  void* out[2];
};

template <typename T>
__global__ void __launch_bounds__(256)
    segment_sum_pair_kernel(const T* __restrict__ x, PairStreams s, int n_out,
                            int units) {
  const int z = blockIdx.y;
  segsum_rows<T>(x, s.perm[z], s.offsets[z], static_cast<T*>(s.out[z]), n_out,
                 units);
}

constexpr int kThreads = 256;
constexpr int kMaxUnits = 32;  // one lane per unit of a row

int grid_for(int n_out) {
  const long want = ((long)n_out + kThreads / 32 - 1) / (kThreads / 32);
  const long cap = (long)chgnet::sm_count() * 16;
  return (int)(want < cap ? want : cap);
}

}  // namespace

extern "C" int segment_sum_csr_f32(const float* x, const int* perm,
                                   const int* offsets, float* out, int n_out,
                                   int d, void* stream) {
  const bool vec4 = chgnet::vec4_ok(x, d) && chgnet::vec4_ok(out, d);
  if ((vec4 ? d / 4 : d) > kMaxUnits) return (int)cudaErrorInvalidValue;
  if (n_out > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int grid = grid_for(n_out);
    if (vec4) {
      segment_sum_csr_kernel<float4><<<grid, kThreads, 0, st>>>(
          reinterpret_cast<const float4*>(x), perm, offsets,
          reinterpret_cast<float4*>(out), n_out, d / 4);
    } else {
      segment_sum_csr_kernel<float><<<grid, kThreads, 0, st>>>(
          x, perm, offsets, out, n_out, d);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int segment_sum_pair_f32(const float* x, const int* perm_a,
                                    const int* offsets_a, float* out_a,
                                    const int* perm_b, const int* offsets_b,
                                    float* out_b, int n_out, int d,
                                    void* stream) {
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
      segment_sum_pair_kernel<float4><<<grid, kThreads, 0, st>>>(
          reinterpret_cast<const float4*>(x), s, n_out, d / 4);
    } else {
      segment_sum_pair_kernel<float><<<grid, kThreads, 0, st>>>(x, s, n_out, d);
    }
  }
  return (int)cudaGetLastError();
}
