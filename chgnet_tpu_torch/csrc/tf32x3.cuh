// Tensor-core building blocks of the port's Hopper kernels: f32 products at
// f32 accuracy on the TF32 tensor cores (3xTF32), and asynchronous copies
// from device memory into shared memory (cp.async), and the loads of bf16
// rows that take the copies' place.
//
// 3xTF32: each f32 operand x is split into hi = tf32(x) (round to nearest,
// ties away) and lo = tf32(x - hi); a * b is then lo_a hi_b + hi_a lo_b +
// hi_a hi_b, accumulated in f32 in that order (the small terms first), for
// every 8-deep step of k. The lo_a lo_b term and the rounding of lo are
// below f32's own rounding of the sum. One TF32 product alone keeps about
// 11 bits of each operand (relative error ~3e-4), too coarse for the
// port's f32 tolerances; tests/test_torch_port_tf32x3.py emulates both in
// numpy.
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, with
// gid = lane / 4 and q = lane % 4:
//   A (16 x 8, row major): a0 = A[gid][q], a1 = A[gid + 8][q],
//                          a2 = A[gid][q + 4], a3 = A[gid + 8][q + 4];
//   B (8 x 8, k x n):      b0 = B[q][gid], b1 = B[q + 4][gid];
//   C (16 x 8):            c0 = C[gid][2q], c1 = C[gid][2q + 1],
//                          c2 = C[gid + 8][2q], c3 = C[gid + 8][2q + 1].
// So each row of C lies on one quad of lanes (the four lanes of one gid).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// x rounded to TF32, to nearest with ties away: what cvt.rna.tf32.f32
// gives for every finite or infinite x, in two integer instructions where
// ptxas emulates the cvt in five
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[j] += a @ B_j for the kN 8-column tiles j of one 8-deep step at f32
// accuracy, from B_j's f32 fragments b[j] (zero-padded past the real width:
// no branch between the tiles, so their loads and products batch). Each
// term goes to every tile before the next term, so kN independent
// products are in flight; each tile still adds lo·hi, hi·lo, hi·hi in order.
template <int kN>
__device__ __forceinline__ void mma3_tiles(float (*c)[4], const uint32_t a_hi[4],
                                           const uint32_t a_lo[4],
                                           const float (*b)[2]) {
  uint32_t hi[kN][2], lo[kN][2];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    split(b[j][0], hi[j][0], lo[j][0]);
    split(b[j][1], hi[j][1], lo[j][1]);
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) mma(c[j], a_lo, hi[j][0], hi[j][1]);
#pragma unroll
  for (int j = 0; j < kN; ++j) mma(c[j], a_hi, lo[j][0], lo[j][1]);
#pragma unroll
  for (int j = 0; j < kN; ++j) mma(c[j], a_hi, hi[j][0], hi[j][1]);
}

// A B fragment's two values split ahead of use: {hi(b0), hi(b1), lo(b0),
// lo(b1)}, for weights staged once and read by every tile
__device__ __forceinline__ uint4 split_pair(float b0, float b1) {
  uint4 v;
  split(b0, v.x, v.z);
  split(b1, v.y, v.w);
  return v;
}

// mma3_tiles from B fragments split ahead of use (split_pair): the same
// terms in the same order, without the splits
template <int kN>
__device__ __forceinline__ void mma3_tiles_split(float (*c)[4], const uint32_t a_hi[4],
                                                 const uint32_t a_lo[4],
                                                 const uint4* b) {
#pragma unroll
  for (int j = 0; j < kN; ++j) mma(c[j], a_lo, b[j].x, b[j].y);
#pragma unroll
  for (int j = 0; j < kN; ++j) mma(c[j], a_hi, b[j].z, b[j].w);
#pragma unroll
  for (int j = 0; j < kN; ++j) mma(c[j], a_hi, b[j].x, b[j].y);
}

// Products whose operands are exact in TF32 (bf16 values widened to f32:
// 8 significant bits, TF32 keeps 11), whose lo parts are zero. mma1_tiles:
// both operands exact, one pass (hi·hi) gives the f32-accurate product.
// mma2_tiles_split: B exact, A an f32 value: the two passes of mma3 whose
// terms are not zero (lo·hi, then hi·hi), so the sums equal mma3's bit for
// bit. The B fragments are the f32 values' own bits.
template <int kN>
__device__ __forceinline__ void mma1_tiles(float (*c)[4], const float a[4],
                                           const float (*b)[2]) {
  uint32_t av[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) av[i] = __float_as_uint(a[i]);
#pragma unroll
  for (int j = 0; j < kN; ++j)
    mma(c[j], av, __float_as_uint(b[j][0]), __float_as_uint(b[j][1]));
}
template <int kN>
__device__ __forceinline__ void mma2_tiles_split(float (*c)[4], const uint32_t a_hi[4],
                                                 const uint32_t a_lo[4],
                                                 const uint4* b) {
#pragma unroll
  for (int j = 0; j < kN; ++j) mma(c[j], a_lo, b[j].x, b[j].y);
#pragma unroll
  for (int j = 0; j < kN; ++j) mma(c[j], a_hi, b[j].x, b[j].y);
}
// the A fragment of 4 f32 values, split
__device__ __forceinline__ void split_a(const float v[4], uint32_t hi[4],
                                        uint32_t lo[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(v[i], hi[i], lo[i]);
}

// the same sum in the four lanes of a quad
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// ------------------------------------------------------------- cp.async
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src (16-byte aligned) to dst, or 16 zero bytes when !valid
// (src is then not read, but must be a valid address)
__device__ __forceinline__ void copy16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, or 4 zero bytes when !valid
__device__ __forceinline__ void copy4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// 4 f32 values of a row into dst (16-byte aligned shared memory): from f32
// rows an asynchronous 16-byte copy; from bf16 rows (8 bytes, 8-byte
// aligned) a load now, widened to f32 and stored, which the caller's wait
// and __syncwarp order as they order the copies. Zeros when !valid.
__device__ __forceinline__ void fetch4(float* dst, const float* src, bool valid) {
  copy16(dst, src, valid);
}
__device__ __forceinline__ void fetch4(float* dst, const __nv_bfloat16* src,
                                       bool valid) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v = make_float4(a.x, a.y, b.x, b.y);
  }
  *reinterpret_cast<float4*>(dst) = v;
}
// one value, likewise (cp.async of 4 bytes from f32)
__device__ __forceinline__ void fetch1(float* dst, const float* src, bool valid) {
  copy4(dst, src, valid);
}
__device__ __forceinline__ void fetch1(float* dst, const __nv_bfloat16* src,
                                       bool valid) {
  *dst = valid ? __bfloat162float(*src) : 0.f;
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

}  // namespace tc
