// Row gather: out[l] = src[idx[l]], and a zero row where idx[l] lies
// outside [0, n_src).
//
// Replaces chgnet_tpu/ops/stream_ops.py _gather_kernel (:645, wrapper
// _gather_pallas :733), and with it expand_rows (:562): the transpose of a
// segment sum gathers the cotangent by the row-aligned keys, whose padded
// rows (key >= n_out) come out zero here. The TPU kernel DMAs a source
// window per output block and expands it with one-hot MXU matmuls; on
// Hopper each thread simply loads one 16-byte unit of its row.
//
// Bound: bytes. It reads L indices and L rows of src and writes L rows,
// with no arithmetic. Design: one thread per (row, float4 unit), so the
// threads of a warp read neighbouring 16-byte units of the same or the
// next source row and write contiguous output.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
    gather_rows_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                       T* __restrict__ out, long n_rows, int n_src, int units) {
  const long total = n_rows * units;
  for (long t = (long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (long)gridDim.x * blockDim.x) {
    const long l = t / units;
    const int u = (int)(t - l * units);
    const int s = idx[l];
    out[t] = (s >= 0 && s < n_src) ? src[(long)s * units + u]
                                   : chgnet::vzero<T>();
  }
}

constexpr int kThreads = 256;

int grid_for(long total) {
  const long want = (total + kThreads - 1) / kThreads;
  const long cap = (long)chgnet::sm_count() * 32;
  return (int)(want < cap ? want : cap);
}

}  // namespace

extern "C" int gather_rows_f32(const float* src, const int* idx, float* out,
                               long n_rows, int n_src, int d, void* stream) {
  if (n_rows > 0 && d > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (chgnet::vec4_ok(src, d) && chgnet::vec4_ok(out, d)) {
      gather_rows_kernel<float4><<<grid_for(n_rows * (d / 4)), kThreads, 0, st>>>(
          reinterpret_cast<const float4*>(src), idx,
          reinterpret_cast<float4*>(out), n_rows, n_src, d / 4);
    } else {
      gather_rows_kernel<float><<<grid_for(n_rows * d), kThreads, 0, st>>>(
          src, idx, out, n_rows, n_src, d);
    }
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ windowed gather
// gather_rows_window: out[l] = src[idx[l]] for an index inside the source
// window [lo, hi] of the row's block of kWindowBlock output rows, a zero row
// otherwise. Replaces chgnet_tpu/ops/stream_ops.py _gather_v2_kernel (:1109,
// wrapper _gather_v2_pallas :1132), the paired-window gather behind
// CHGNET_TPU_STREAM_V2, whose window is two 512-row source blocks; here the
// host plan (graph/batching.py build_window_plan) names each block's exact
// window over its valid rows, at most cap_rows rows, the largest that
// shared memory holds at d = 128.
//
// Bound: bytes, as gather_rows. Design: a block stages the rows lo .. hi of
// the source into dynamic shared memory with coalesced 16-byte loads, each
// source row read from device memory or L2 once per block instead of once
// per output row that names it, and then writes its output rows from
// there. The shared memory a block reserves is cap_rows rows whatever its
// window, so at d = 128 one block fits on an SM.
namespace {

constexpr int kWindowBlock = 128;       // output rows per block
constexpr int kSharedBytes = 232448;    // 227 KB, the most a block may use
constexpr int kMaxDevices = 16;

__global__ void __launch_bounds__(kThreads)
    gather_rows_window_kernel(const float4* __restrict__ src,
                              const int* __restrict__ idx,
                              const int* __restrict__ window,
                              float4* __restrict__ out, long n_rows, int n_src,
                              int units, int cap_rows) {
  extern __shared__ float4 win[];
  const long row0 = (long)blockIdx.x * kWindowBlock;
  int lo = window[2 * blockIdx.x];
  int hi = window[2 * blockIdx.x + 1];
  if (lo < 0) lo = 0;
  if (hi >= n_src) hi = n_src - 1;
  if (hi >= lo + cap_rows) hi = lo + cap_rows - 1;
  const int n_win = hi >= lo ? (hi - lo + 1) * units : 0;
  for (int i = threadIdx.x; i < n_win; i += kThreads)
    win[i] = src[(long)lo * units + i];
  __syncthreads();
  const long left = n_rows - row0;
  const int rows = left < kWindowBlock ? (int)left : kWindowBlock;
  for (int i = threadIdx.x; i < rows * units; i += kThreads) {
    const int r = i / units;
    const int u = i - r * units;
    const int s = idx[row0 + r];
    out[(row0 + r) * units + u] = (s >= lo && s <= hi)
                                      ? win[(s - lo) * units + u]
                                      : chgnet::vzero<float4>();
  }
}

}  // namespace

// window [ceil(n_rows / 128), 2] int32: the first and last source row of
// each block of 128 output rows (lo > hi: no row); src and out 16-byte
// aligned, d % 4 == 0, and cap_rows rows of d floats within 227 KB.
extern "C" int gather_rows_window_f32(const float* src, const int* idx,
                                      const int* window, float* out,
                                      long n_rows, int n_src, int d,
                                      int cap_rows, void* stream) {
  const long smem = (long)cap_rows * d * sizeof(float);
  if (!chgnet::vec4_ok(src, d) || !chgnet::vec4_ok(out, d) || cap_rows < 1 ||
      smem > kSharedBytes)
    return (int)cudaErrorInvalidValue;
  if (n_rows > 0) {
    static bool allowed[kMaxDevices];  // the opt-in above 48 KB, per device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!allowed[dev]) {
      err = cudaFuncSetAttribute(gather_rows_window_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSharedBytes);
      if (err != cudaSuccess) return (int)err;
      allowed[dev] = true;
    }
    const long blocks = (n_rows + kWindowBlock - 1) / kWindowBlock;
    gather_rows_window_kernel<<<(int)blocks, kThreads, (size_t)smem,
                                static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(src), idx, window,
        reinterpret_cast<float4*>(out), n_rows, n_src, d / 4, cap_rows);
  }
  return (int)cudaGetLastError();
}
