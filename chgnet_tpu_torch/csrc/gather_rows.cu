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
