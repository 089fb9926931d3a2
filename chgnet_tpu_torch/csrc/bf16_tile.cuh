// bf16 tensor-core building blocks of the port's Hopper kernels: rows kept
// in shared memory as bf16 (asynchronous copies of 8 or 16 bytes, gathers
// of indexed rows, an XOR swizzle of 16-byte chunks), ldmatrix fragments,
// and f32 products at f32 accuracy on the bf16 tensor cores when B holds
// bf16 values.
//
// Products of two bf16 operands (mma_pair): every product of two bf16
// values is exact in f32, so one pass of mma.sync.m16n8k16 with f32
// accumulation gives the f32 product up to the order of its f32 adds.
// Products of an f32 A and a bf16 B: A is an f32 value a. a splits
// into hi = bf16(a) (round to nearest even) and lo = bf16(a - hi); a * b is
// then lo b + hi b, two passes of mma.sync.m16n8k16 with f32 accumulation,
// the small term first. hi b and lo b are exact in f32, and a - hi - lo is
// at most 2^-9 of a - hi, itself at most 2^-9 of a: the product keeps
// within about 2^-17 of sum |a b| of the f32 product, against 2^-9 for one
// bf16 pass (tests/test_torch_port_bf16_split.py emulates both on the CPU).
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, with
// gid = lane / 4 and q = lane % 4, two bf16 values a register (the lower
// column in the low half):
//   A (16 x 16): a0 = A[gid][2q, 2q+1],   a1 = A[gid + 8][2q, 2q+1],
//                a2 = A[gid][2q+8, 2q+9], a3 = A[gid + 8][2q+8, 2q+9];
//   B (16 x 8):  b0 = B[2q, 2q+1][gid],   b1 = B[2q+8, 2q+9][gid];
//   C (16 x 8):  c0 = C[gid][2q], c1 = C[gid][2q + 1],
//                c2 = C[gid + 8][2q], c3 = C[gid + 8][2q + 1].
// So the C tiles of columns 16s..16s+7 and 16s+8..16s+15 are, value for
// value, the A fragment of the 16-deep step s of a product that takes C as
// its A operand: the backward's d_y passes from one product to the next in
// registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace bt {

// ------------------------------------------------------------- layouts
// A [rows][kChunks * 8] bf16 tile, row r's 16-byte chunk c stored at chunk
// c ^ (r & 7): the 8 rows an ldmatrix reads at one logical chunk, and the
// 8 rows of a C fragment's lanes at one column, fall on 8 distinct groups
// of 4 banks. Chunks stay whole (copies of 16 bytes, and of 8 within one).
// Byte offset of row r, column col:
template <int kChunks>
__device__ __forceinline__ int at(int r, int col) {
  return r * kChunks * 16 + ((((col >> 3) ^ (r & 7)) << 4) | ((col & 7) << 1));
}

// ---------------------------------------------------------- conversions
__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}
// two values rounded to bf16 (nearest even), x in the low half
__device__ __forceinline__ uint32_t pack(float x, float y) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&p);
}
// the pair (x, y) split into hi = bf16(x, y) and lo = bf16(x - hi, y - hi)
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& lo) {
  hi = pack(x, y);
  lo = pack(x - lo_f(hi), y - hi_f(hi));
}

// ------------------------------------------------------- tensor cores
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c0 += a @ B, c1 += a @ B' for the two 8-column tiles of b = {b0, b1 of
// tile 0, b0, b1 of tile 1}, a of bf16 values: one pass
__device__ __forceinline__ void mma_pair(float c0[4], float c1[4], const uint32_t a[4],
                                         const uint32_t b[4]) {
  mma(c0, a, b[0], b[1]);
  mma(c1, a, b[2], b[3]);
}

// c0 += a @ B for the two 8-column tiles of b = {b0, b1 of tile 0, b0, b1 of
// tile 1}, a split into hi and lo: lo first, then hi, in each tile
__device__ __forceinline__ void mma2_pair(float c0[4], float c1[4], const uint32_t hi[4],
                                          const uint32_t lo[4], const uint32_t b[4]) {
  mma(c0, lo, b[0], b[1]);
  mma(c1, lo, b[2], b[3]);
  mma(c0, hi, b[0], b[1]);
  mma(c1, hi, b[2], b[3]);
}

// Four 8 x 8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and register i receives its fragment: row gid,
// columns 2q and 2q + 1; with trans, column gid, rows 2q and 2q + 1.
__device__ __forceinline__ void ldsm4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tc::smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(tc::smem_addr(p))
      : "memory");
}

// ------------------------------------------------------------- cp.async
// 8 bytes from src (8-byte aligned) to dst, or 8 zero bytes when !valid
__device__ __forceinline__ void copy8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   tc::smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}
// 16 bytes to dst of which the first n (0..16) come from src, the rest zero
__device__ __forceinline__ void copy16_n(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   tc::smem_addr(dst)),
               "l"(src), "r"(n));
}


// A lane's walk over the units of a tile's rows, per_row units a row: units
// lane, lane + 32, ... as (row r, unit c), with no division in the loop
struct Walk {
  int r, c, dr, dc, per;
  __device__ __forceinline__ Walk(int lane, int per_row) : per(per_row) {
    dr = 32 / per_row;
    dc = 32 - dr * per_row;
    r = lane / per_row;
    c = lane - r * per_row;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
};

// One unit of n values (8: 16 bytes, src 16-byte aligned; 4: 8 bytes, src
// 8-byte aligned) to dst, or zeros when !valid (src must still be a valid
// address)
__device__ __forceinline__ void copy_unit(void* dst, const void* src, bool valid, int n) {
  if (n == 8)
    tc::copy16(dst, src, valid);
  else
    copy8(dst, src, valid);
}

// Copies of the kRows rows from row0 of a [n_rows, width] bf16 array into
// a [kRows][kChunks * 8] slot (at()), units of n values (w walks width / n
// a row); zeros from n_rows on. The caller commits them.
template <int kChunks, int kRows = 16>
__device__ __forceinline__ void copy_rows(char* slot, const __nv_bfloat16* src, long row0,
                                          long n_rows, int width, int n, Walk w) {
  for (; w.r < kRows; w.next()) {
    const long l = row0 + w.r;
    const bool ok = l < n_rows;
    copy_unit(slot + at<kChunks>(w.r, n * w.c), src + (ok ? l : 0) * width + n * w.c, ok, n);
  }
}

// Copies of kRows gathered rows into a [kRows][kChunks * 8] slot (at()):
// slot row r takes row s_r of tab [n_src, width], where lane r of the
// warp holds s_r in ix, a zero row for s_r outside [0, n_src); units of n
// values (w walks width / n a row). Every lane runs n_it =
// ceil(kRows * width / n / 32) steps: the row's index comes by a shuffle
// of the whole warp. The caller commits them.
template <int kChunks, int kRows = 16>
__device__ __forceinline__ void gather_rows(char* slot, const __nv_bfloat16* tab, int ix,
                                            int n_src, int width, int n, int n_it, Walk w) {
  for (int it = 0; it < n_it; ++it, w.next()) {
    const int s = __shfl_sync(0xffffffffu, ix, w.r & 31);
    if (w.r < kRows) {
      const bool ok = s >= 0 && s < n_src;
      copy_unit(slot + at<kChunks>(w.r, n * w.c), tab + (ok ? (long)s * width + n * w.c : 0),
                ok, n);
    }
  }
}

}  // namespace bt
