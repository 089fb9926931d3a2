// Shared helpers of the port's CUDA kernels (chgnet_tpu_torch/csrc).
//
// Every kernel source is built on its own by chgnet_tpu_torch/ops/build.py
// (nvcc -> shared library with a plain C interface -> ctypes). Each C entry
// point launches on the caller's stream and returns cudaGetLastError(),
// which the Python wrapper turns into an exception when it is not 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace chgnet {

// Storage types: every kernel takes float or bf16 rows and
// computes in f32; a bf16 value widens to f32 exactly, and a result is
// rounded to bf16 once, when it is stored (round to nearest even).
using bf16 = __nv_bfloat16;
// bf16 storage: a value widened from it is exact in TF32 (tf32x3.cuh)
template <typename T>
constexpr bool is_bf16 = sizeof(T) == 2;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// a value of a row: 1 element, or 4 elements of 16 bytes (f32) or 8 (bf16)
__device__ __forceinline__ void load_v(float& v, const float* p) { v = *p; }
__device__ __forceinline__ void load_v(float4& v, const float* p) {
  v = *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void load_v(float& v, const bf16* p) { v = to_f(*p); }
__device__ __forceinline__ void load_v(float4& v, const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v = make_float4(a.x, a.y, b.x, b.y);
}
// load_v through the read-only data cache
__device__ __forceinline__ void ldg_v(float4& v, const float* p) {
  v = __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void ldg_v(float4& v, const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v = make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store_v(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_v(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store_v(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_v(bf16* p, const float4& v) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = u;
}
// two neighbouring elements (8 bytes f32, 4 bf16)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldg2(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

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
// ... and 4-element loads of bf16 rows of 4k values on 8-byte aligned storage
inline bool vec4_ok(const bf16* p, int d) {
  return d % 4 == 0 && (reinterpret_cast<uintptr_t>(p) % 8) == 0;
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

}  // namespace chgnet
