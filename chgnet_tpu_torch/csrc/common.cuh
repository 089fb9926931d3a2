// Shared helpers of the port's CUDA kernels (chgnet_tpu_torch/csrc).
//
// Every kernel source is built on its own by chgnet_tpu_torch/ops/build.py
// (nvcc -> shared library with a plain C interface -> ctypes). Each C entry
// point launches on the caller's stream and returns cudaGetLastError(),
// which the Python wrapper turns into an exception when it is not 0.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace chgnet {

__device__ __forceinline__ void vadd(float& a, float b) { a += b; }
__device__ __forceinline__ void vadd(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

template <typename T>
__device__ __forceinline__ T vzero();
template <>
__device__ __forceinline__ float vzero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float shfl_down(float v, int off) {
  return __shfl_down_sync(0xffffffffu, v, off);
}
__device__ __forceinline__ float4 shfl_down(float4 v, int off) {
  v.x = __shfl_down_sync(0xffffffffu, v.x, off);
  v.y = __shfl_down_sync(0xffffffffu, v.y, off);
  v.z = __shfl_down_sync(0xffffffffu, v.z, off);
  v.w = __shfl_down_sync(0xffffffffu, v.w, off);
  return v;
}

// float4 loads need rows of 4k floats on 16-byte aligned storage
inline bool vec4_ok(const void* p, int d) {
  return d % 4 == 0 && (reinterpret_cast<uintptr_t>(p) % 16) == 0;
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

}  // namespace chgnet
