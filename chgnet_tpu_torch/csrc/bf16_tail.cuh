// The bf16 tail tiles shared by the serving kernels of gated_message.cu
// (tcb16::tail_fwd_bf16_kernel, tcb16::tail_bwd_bf16_kernel) and the
// one-kernel pass of fused_pass.cu (tcp16::pass_fwd_bf16_kernel,
// tcp16::pass_bwd_bf16_kernel): a warp's 16-row tiles of bf16 rows in
// shared memory (bt::at swizzle) and the whole-row stores of its outputs,
// W2 staged once a block in bf16, and the second product of the gated
// tail's backward, d_h = d_y @ W2^T, on the bf16 tensor cores at f32
// accuracy (bf16_tile.cuh: the f32 A operand split into a bf16 hi and lo,
// two passes of mma.sync.m16n8k16). Both sources include it, so the tiles
// cannot drift apart.
#pragma once

#include "bf16_tile.cuh"
#include "gated_tail.cuh"
#include "tf32x3.cuh"

namespace {
namespace tcb16 {

using chgnet::bf16;
constexpr int kRows = 16;                             // rows of a warp's tile
constexpr int kAccBytes = kRows * 2 * kMaxD * 2;      // one acc stage
constexpr int kRowBytes = kRows * kMaxD * 2;          // g or weights
constexpr int kParkBytes = kRows * 2 * kMaxD * 4;     // z, gz, d_h in f32
constexpr int kMaskBytes = kRows * 2;
constexpr int kWBytes = 2 * kMaxD * kMaxD * 2;        // W2c, W2g
constexpr int kParamBytes = 6 * kMaxD * 4;            // b2, ncs, ncb, ngs, ngb
constexpr int kSmemPerBlock = 232448;                 // sm_90's opt-in limit

// sigmoid with the fast exponential and division (a few ulp): the row
// phases' cost is their instructions
__device__ __forceinline__ float sigm_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float silu_grad_of(float x, float s) {  // s = sigm(x)
  return s * (1.f + x * (1.f - s));
}

// the copy loops walk their units with no division (bf16_tile.cuh)
using bt::Walk;

// The rows of a stage from row0 up to n_rows, out to rows of width D (g
// layout, kChunks 8) or 2D (acc layout, kChunks 16: the gate half at
// column kMaxD), n values a store (16 bytes, 8 where D % 8 != 0; w: units
// of n)
template <int kChunks>
__device__ __forceinline__ void store_rows(const char* st, bf16* out, long row0,
                                           int n_rows, int d, int n, Walk w) {
  constexpr bool kAcc = kChunks == 16;
  const int u = n == 8 ? d >> 3 : d >> 2;
  const int per_row = kAcc ? 2 * u : u;
  const long left = n_rows - row0;
  const int rows = left < kRows ? (int)left : kRows;
  for (; w.r < rows; w.next()) {
    const int r = w.r;
    const int c = w.c;
    const int half = kAcc && c >= u;
    const char* src = st + bt::at<kChunks>(r, half * kMaxD + n * (c - half * u));
    bf16* dst = out + (row0 + r) * per_row * n + n * c;
    if (n == 8)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    else
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  }
}

// d_h = d_y_h @ W_h^T, d_y's fragments (v[h], the C layout) taken as A
__device__ __forceinline__ void product_dh(const float v[8][4], const char* w, int d8,
                                           int d16, int lane, float dh[8][4]) {
  const int lr = lane & 7;
  const int lm = lane >> 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) dh[nt][j] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks >= d16) break;
    uint32_t hi[4], lo[4];
    bt::split(v[2 * ks][0], v[2 * ks][1], hi[0], lo[0]);
    bt::split(v[2 * ks][2], v[2 * ks][3], hi[1], lo[1]);
    bt::split(v[2 * ks + 1][0], v[2 * ks + 1][1], hi[2], lo[2]);
    bt::split(v[2 * ks + 1][2], v[2 * ks + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (2 * jp >= d8) break;
      uint32_t b[4];
      bt::ldsm4(b, w + bt::at<8>(16 * jp + lr + 8 * (lm >> 1), 16 * ks + 8 * (lm & 1)));
      bt::mma2_pair(dh[2 * jp], dh[2 * jp + 1], hi, lo, b);
    }
  }
}

// The block's W2c and W2g (with kW2) in bf16 at w_s, zero-padded to kMaxD
// (bt::at<8>), and at b2_s b2 (the gate half at kMaxD; zero without kW2),
// then nc_scale, nc_bias, ng_scale, ng_bias in f32, each kMaxD long and
// zero past D
template <bool kW2>
__device__ __forceinline__ void stage_tail(char* w_s, float* b2_s, const TailT<bf16>& t,
                                           int d) {
  for (int i = threadIdx.x; kW2 && i < 2 * kMaxD * kMaxD; i += blockDim.x) {
    const int h = i / (kMaxD * kMaxD);
    const int k = (i / kMaxD) % kMaxD;
    const int n = i % kMaxD;
    bf16 v = __float2bfloat16(0.f);
    if (k < d && n < d) v = (h ? t.w2g : t.w2c)[k * d + n];
    *reinterpret_cast<bf16*>(w_s + h * kMaxD * kMaxD * 2 + bt::at<8>(k, n)) = v;
  }
  float* ncs_s = b2_s + 2 * kMaxD;
  float* ncb_s = ncs_s + kMaxD;
  float* ngs_s = ncb_s + kMaxD;
  float* ngb_s = ngs_s + kMaxD;
  for (int i = threadIdx.x; i < 2 * kMaxD; i += blockDim.x) {
    const int h = i / kMaxD;
    const int e = i % kMaxD;
    b2_s[i] = kW2 && e < d ? chgnet::to_f(t.b2[h * d + e]) : 0.f;
    if (h == 0) {
      ncs_s[e] = e < d ? chgnet::to_f(t.ncs[e]) : 0.f;
      ncb_s[e] = e < d ? chgnet::to_f(t.ncb[e]) : 0.f;
      ngs_s[e] = e < d ? chgnet::to_f(t.ngs[e]) : 0.f;
      ngb_s[e] = e < d ? chgnet::to_f(t.ngb[e]) : 0.f;
    }
  }
}

}  // namespace tcb16
}  // namespace
