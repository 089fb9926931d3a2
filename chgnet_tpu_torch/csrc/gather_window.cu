// Windowed row gather: out[l] = src[idx[l]] for an index inside the source
// window [lo, hi] of the row's block of kBlockRows output rows, a zero row
// otherwise (and for an index outside [0, n_src)). Replaces
// chgnet_tpu/ops/stream_ops.py _gather_v2_kernel (:1109, wrapper
// _gather_v2_pallas :1132), the paired-window gather behind
// CHGNET_TPU_STREAM_V2. The TPU kernel DMAs two 512-row source blocks per
// output block into VMEM and expands them with one-hot MXU matmuls; here the
// host plan (graph/batching.py build_window_plan) names each block's exact
// window over its valid rows.
//
// Bound: bytes. It reads the indices, the windows and the distinct rows named
// inside their windows, and writes L rows, with no arithmetic; the writes are
// most of it. Design: one thread per (row, 16-byte unit), grid-stride, so the
// threads of a warp read neighbouring units of the rows their indices name
// (from L2: a block of 128 rows names 2-19 distinct rows on the benchmark
// batch) and write contiguous output, with no shared memory and no barrier:
// every warp of the card keeps its loads and stores in flight. The output is
// written with streaming stores (st.global.cs): a later kernel reads it, and
// letting it leave L2 first keeps the named rows there.
//
// Designs that assembled 128-row output tiles in shared memory and wrote
// each with one bulk store (cp.async.bulk), with windows of up to 32 rows
// staged whole by bulk copies and the others loaded row by row (cp.async),
// per block or per warp, ran 1.19-1.47 ms on the stream-v2 path's 16 calls
// against 0.95 for this schedule (H100 80GB HBM3, 700 W; PERF.md): their bulk
// stores wrote at most about 2 TB/s, bounded by the bytes that shared memory
// holds in flight.
#include "common.cuh"

namespace {

constexpr int kBlockRows = 128;  // output rows a window covers
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    gather_window_kernel(const float4* __restrict__ src,
                         const int* __restrict__ idx,
                         const int* __restrict__ window,
                         float4* __restrict__ out, long n_rows, int n_src,
                         int units) {
  const long total = n_rows * units;
  for (long t = (long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (long)gridDim.x * blockDim.x) {
    const long l = t / units;
    const int u = (int)(t - l * units);
    const int s = idx[l];
    const long b = l / kBlockRows;
    const int lo = window[2 * b], hi = window[2 * b + 1];
    __stcs(out + t, (s >= lo && s <= hi && s >= 0 && s < n_src)
                        ? src[(long)s * units + u]
                        : chgnet::vzero<float4>());
  }
}

}  // namespace

// window [ceil(n_rows / 128), 2] int32: the first and last source row of
// each block of 128 output rows (lo > hi: no row); src and out 16-byte
// aligned, d % 4 == 0.
extern "C" int gather_rows_window_f32(const float* src, const int* idx,
                                      const int* window, float* out,
                                      long n_rows, int n_src, int d,
                                      void* stream) {
  if (!chgnet::vec4_ok(src, d) || !chgnet::vec4_ok(out, d) || d < 4)
    return (int)cudaErrorInvalidValue;
  if (n_rows > 0) {
    const long total = n_rows * (d / 4);
    const long want = (total + kThreads - 1) / kThreads;
    const long cap = (long)chgnet::sm_count() * 32;
    gather_window_kernel<<<(int)(want < cap ? want : cap), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(src), idx, window,
        reinterpret_cast<float4*>(out), n_rows, n_src, d / 4);
  }
  return (int)cudaGetLastError();
}
