// Gather-project-sum: the first Linear of a conv layer's gated MLP over
// gathered table rows,
//
//     out[l] = sum_p  T_p[idx_p[l]] @ W_p  +  stream[l]
//
// with T_p [S, dt] f32 tables, idx_p [L] i32 gather streams, W_p [dt, K]
// f32 and stream [L, K] (aligned projections and bias, computed outside).
//
// Replaces chgnet_tpu/ops/gproj.py _gproj_kernel (:62, wrapper _gproj_pallas
// :175). The TPU kernel DMAs the union source window of each 512-row block
// and expands it with one-hot MXU matmuls before applying the weights; on
// Hopper the rows are gathered directly, and the order of the two steps is
// chosen by the tables' length (the wrapper, ops/gproj.py, picks the route).
//
// Bound: the function needs the fewer FLOPs of two orders, gather first
// (2 * L * n_pairs * dt * K) or project each (table, W) first (2 * S * dt * K)
// and add the gathered rows (L * K per pair). Where the tables are short
// (AtomConv: S = atoms << L = edges) the projected tables stay in L2 and
// the function is bound by bytes: the [L, K] stream read and out written.
// Where they are long (BondConv and AngleUpdate: S = edges ~ L = angles)
// the products at 3xTF32 take less time than the gathered rows' bytes.
// Design: every product runs on the tensor cores at f32 accuracy (3xTF32,
// tf32x3.cuh), with W_p staged once per block in shared memory, swizzled
// so that the B fragments hit 32 distinct banks. Short tables, two
// launches: gproj_project_kernel computes P_p = T_p @ W_p into a scratch
// buffer (a table that pairs share is read from L1 after the first), then
// gproj_gather_add_kernel adds stream[l] + P_0[idx_0[l]] + P_1[idx_1[l]] +
// ... in pair order, a float4 per thread. Long tables, one launch:
// gproj_tc_kernel, persistent, in which every warp is its own pipeline and
// owns 16 rows of the stream; it gathers the rows of each (tile, pair) unit
// into a ring of four stages with cp.async, three units in flight while it
// multiplies the fourth; a tile's sums start from its stream rows. A
// tile's indices are loaded one tile ahead, once per distinct stream. Sums
// run in a fixed order; out-of-range indices gather a zero row.
// bf16 (compute_dtype="bfloat16", the _bf16 entries): tables, W, stream and
// out in bf16, every product and sum in f32, out rounded once. Short route:
// the f32 kernels' design instantiated for bf16; a bf16 value is exact in
// TF32, so each product of a bf16 row and a bf16 W takes one TF32 pass
// (tc::mma1_tiles), which equals 3xTF32's result; the projected table is
// rounded to bf16, as the plain path does (models/functions.py:407-412
// projects in bf16). Long route: a kernel of its own on the bf16 tensor
// cores, gproj_bf16_tc_kernel (below gproj_tc_kernel). Its rows stay bf16:
// each (tile, pair) unit's 16 gathered rows are copied by cp.async in
// 16-byte chunks (8-byte ones where dt % 8 != 0) straight into a ring of
// three 2 KB bf16 stages, zero rows for out-of-range indices, and the
// tile's stream rows likewise into a stream slot; W is staged once a block
// in bf16 (48 KB for 3 pairs); every product is one mma.sync.m16n8k16 pass
// of bf16 A and B, both by ldmatrix (B transposed), which is exact in f32
// as the TF32 pass was, up to the order of the f32 adds. The sums start
// from the stream rows, run in f32 and round nothing before the store, as
// the TPU kernel (chgnet_tpu/ops/gproj.py:155-159: the gathered sum
// rounded to bf16 is the gathered row itself): the two routes differ by
// the short route's one rounding of each projected row. With 10 KB a warp
// (3 pairs) the block holds 16 warps at up to 128 registers; measured side
// by side (PERF.md §6), three stages at 16 warps beat four at 14 and at 12.
// Wider calls (tables up to kWideDt = 128 wide, K up to kWideK = 256: a
// 128-wide model's first layers) take the short route only: one pair's W is
// then 128 KB, so no launch can stage every pair's W at once, and
// gproj_project_wide_kernel stages one pair's W at a time (the block
// projects its tiles of that table, then the next pair's) and runs K in
// chunks of 128 columns on the short route's product. The long route's
// tables, gathered and projected at once, stay at dt <= 64 and K <= 128
// (the wrapper, ops/gproj.py gproj_route, sends wider calls short).
#include "bf16_tile.cuh"
#include "common.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kMaxPairs = 3;
constexpr int kMaxDt = 64;
constexpr int kMaxK = 128;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;     // stream (or table) rows of a warp's tile
constexpr int kStages = 4;    // (tile, pair) units in a warp's ring
constexpr int kUnitFloats = kRows * kMaxDt;
constexpr int kPairWFloats = kMaxDt * kMaxK;
// the short route's widest call, one pair's W staged at a time (128 KB)
constexpr int kWideDt = 128;
constexpr int kWideK = 256;
constexpr int kWidePairWFloats = kWideDt * kWideK;

struct Pairs {
  const void* tab[kMaxPairs];  // float or bf16 tables, as the launch's S
  const int* idx[kMaxPairs];
  int same_idx[kMaxPairs];  // first pair with the same index stream
};

// W_p[k][n] lives at k * kMaxK + (n ^ wswz(k)); a unit's row r, column c at
// r * kMaxDt + (c ^ aswz(r)): conflict-free B and A fragments
__device__ __forceinline__ int wswz(int k) { return 8 * (k & 3); }
__device__ __forceinline__ int aswz(int r) { return 4 * (r & 7); }

// every pair's W, zero-padded to kMaxDt x kMaxK, by the whole block
template <typename S>
__device__ void stage_w(float* w_s, const S* __restrict__ w, int n_pairs,
                        int dt, int k_out) {
  for (int i = threadIdx.x; i < n_pairs * kPairWFloats; i += kThreads) {
    const int p = i / kPairWFloats;
    const int k = (i / kMaxK) % kMaxDt;
    const int n = i % kMaxK;
    const float v =
        k < dt && n < k_out ? chgnet::to_f(w[((long)p * dt + k) * k_out + n]) : 0.f;
    w_s[p * kPairWFloats + k * kMaxK + (n ^ wswz(k))] = v;
  }
}

// acc[nt] += A @ W for the warp's 16 rows and 128 columns of W from w
// (rows kStride floats apart; W is zero-padded), eight 8-column tiles at a
// time; load_a(ks, v) gives A's fragment of the 8-deep step ks. The step
// loop stays rolled: a fully unrolled kernel outgrows the instruction cache.
// kExact: A and W are bf16 values, exact in TF32, so one pass gives what
// 3xTF32 gives.
template <bool kExact, int kStride = kMaxK, typename LoadA>
__device__ __forceinline__ void product(LoadA load_a, const float* w, int dt8,
                                        int lane, float acc[16][4]) {
  const int gid = lane >> 2;
  const int q = lane & 3;
#pragma unroll 1
  for (int ks = 0; ks < dt8; ++ks) {
    float av[4];
    load_a(ks, av);
    uint32_t hi[4], lo[4];
    if constexpr (!kExact) tc::split_a(av, hi, lo);
    const int k0 = ks * 8 + q;
    const int k1 = k0 + 4;
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      float b[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = (8 * part + j) * 8 + gid;
        b[j][0] = w[k0 * kStride + (n ^ wswz(k0))];
        b[j][1] = w[k1 * kStride + (n ^ wswz(k1))];
      }
      if constexpr (kExact)
        tc::mma1_tiles<8>(acc + 8 * part, av, b);
      else
        tc::mma3_tiles<8>(acc + 8 * part, hi, lo, b);
    }
  }
}

// ------------------------------------------------- long tables: gather first
// this warp's index registers for the tile at row0: lane r < 16 holds
// idx_p[row0 + r], -1 past n_rows; pairs that share a stream share it
__device__ __forceinline__ void load_idx(const Pairs& pairs, int n_pairs,
                                         long row0, int n_rows, int lane,
                                         int ix[kMaxPairs]) {
  const long l = row0 + lane;
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    if (p < n_pairs && pairs.same_idx[p] == p)
      ix[p] = lane < kRows && l < n_rows ? __ldg(pairs.idx[p] + l) : -1;
    else if (p < n_pairs)
      ix[p] = pairs.same_idx[p] == 0 ? ix[0] : ix[1];
    else
      ix[p] = -1;
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads, 1)
    gproj_tc_kernel(Pairs pairs, int n_pairs, const S* __restrict__ w,
                    const S* __restrict__ stream, S* __restrict__ out,
                    int n_rows, int n_src, int dt, int k_out) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [n_pairs][kMaxDt][kMaxK]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* ring = w_s + n_pairs * kPairWFloats + warp * kStages * kUnitFloats;
  stage_w(w_s, w, n_pairs, dt, k_out);
  for (int i = lane; i < kStages * kUnitFloats; i += 32) ring[i] = 0.f;
  __syncthreads();  // the only block barrier

  const int gid = lane >> 2;
  const int q = lane & 3;
  const int dt4 = dt / 4;
  const int dt8 = (dt + 7) / 8;
  const int n_tiles = (n_rows + kRows - 1) / kRows;
  const int step = gridDim.x * kWarps;
  const int first = blockIdx.x * kWarps + warp;
  const int n_mine = first < n_tiles ? (n_tiles - 1 - first) / step + 1 : 0;
  const int n_units = n_mine * n_pairs;

  // the copies of unit u = (tile u / n_pairs, pair u % n_pairs): lane
  // copies 16-byte chunk lane % 16 of rows lane / 16 + 2 i
  int ix[kMaxPairs], ix_next[kMaxPairs];
  load_idx(pairs, n_pairs, (long)first * kRows, n_rows, lane, ix);
  load_idx(pairs, n_pairs, (long)(first + step) * kRows, n_rows, lane, ix_next);
  const int chunk = lane & 15;
  auto fetch = [&](int u) {
    const int p = u % n_pairs;
    if (p == 0 && u > 0) {  // the next tile: rotate its indices in
      const int tile = first + (u / n_pairs + 1) * step;
#pragma unroll
      for (int k = 0; k < kMaxPairs; ++k) ix[k] = ix_next[k];
      load_idx(pairs, n_pairs, (long)tile * kRows, n_rows, lane, ix_next);
    }
    const int mine = p == 0 ? ix[0] : p == 1 ? ix[1] : ix[2];
    const S* tab = static_cast<const S*>(
        p == 0 ? pairs.tab[0] : p == 1 ? pairs.tab[1] : pairs.tab[2]);
    float* unit = ring + (u % kStages) * kUnitFloats;
#pragma unroll
    for (int i = 0; i < kRows / 2; ++i) {
      const int r = (lane >> 4) + 2 * i;
      const int s = __shfl_sync(0xffffffffu, mine, r);
      if (chunk < dt4) {
        const bool ok = s >= 0 && s < n_src;
        const S* src = tab + (ok ? (long)s * dt + 4 * chunk : 0);
        tc::copy16(unit + r * kMaxDt + ((4 * chunk) ^ aswz(r)), src, ok);
      }
    }
  };

  int next = 0;  // the next unit to fetch
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (next < n_units) fetch(next++);
    tc::commit();
  }
  float acc[16][4];
  for (int u = 0; u < n_units; ++u) {
    tc::wait_pending<kStages - 2>();  // unit u has landed
    __syncwarp();  // ... for every lane, and unit u - 1 is consumed
    if (next < n_units) fetch(next++);  // into unit u - 1's slot
    tc::commit();
    const int p = u % n_pairs;
    const long row0 = (long)(first + (u / n_pairs) * step) * kRows;
    if (p == 0) {  // the tile's sums start from the stream
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const long l = row0 + gid + 8 * rr;
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          const int c = nt * 8 + 2 * q;
          float2 v = make_float2(0.f, 0.f);
          if (l < n_rows && c < k_out)
            v = chgnet::ldg2(stream + l * k_out + c);
          acc[nt][2 * rr] = v.x;
          acc[nt][2 * rr + 1] = v.y;
        }
      }
    }
    const float* unit = ring + (u % kStages) * kUnitFloats;
    const int sw = aswz(gid);
    product<chgnet::is_bf16<S>>(
        [&](int ks, float v[4]) {
          const int c0 = (ks * 8 + q) ^ sw;
          const int c1 = (ks * 8 + q + 4) ^ sw;
          v[0] = unit[gid * kMaxDt + c0];
          v[1] = unit[(gid + 8) * kMaxDt + c0];
          v[2] = unit[gid * kMaxDt + c1];
          v[3] = unit[(gid + 8) * kMaxDt + c1];
        },
        w_s + p * kPairWFloats, dt8, lane, acc);
    if (p == n_pairs - 1) {  // the tile's last pair: store
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const long l = row0 + gid + 8 * rr;
        if (l >= n_rows) continue;
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          const int c = nt * 8 + 2 * q;
          if (c >= k_out) break;
          chgnet::store2(out + l * k_out + c, acc[nt][2 * rr], acc[nt][2 * rr + 1]);
        }
      }
    }
  }
}

// ------------------------------- long tables in bf16: the bf16 tensor cores
// gproj_tc_kernel's schedule (persistent warps, each its own pipeline of
// (tile, pair) units through a ring of kBfStages stages, indices a tile ahead
// once per distinct stream) on bf16 stages: a unit's 16 gathered rows take
// 2 KB ([16][kMaxDt] bf16, bt::at<8>), a tile's stream rows 4 KB ([16][kMaxK],
// bt::at<16>), W_p 16 KB ([kMaxDt][kMaxK], bt::at<16>), all free of bank
// conflicts for ldmatrix. A tile's stream rows travel with its first unit
// into one of bf_slots(n_pairs) stream slots: enough that a slot is read
// (at the tile's first unit, before the fetch that may refill it) before
// the copy of a later tile's stream lands in it.
constexpr int kBfWarps = 16;  // a block's warps at most (shared memory may allow fewer)
constexpr int kBfStages = 3;  // (tile, pair) units in a warp's ring
constexpr int kBfUnitBytes = kRows * kMaxDt * 2;
constexpr int kBfStreamBytes = kRows * kMaxK * 2;
constexpr int kBfPairWBytes = kMaxDt * kMaxK * 2;
constexpr int kSmemPerBlock = 232448;  // sm_90's opt-in limit
__host__ __device__ inline int bf_slots(int n_pairs) {
  return (kBfStages - 1 + n_pairs - 1) / n_pairs;
}
__host__ __device__ inline int bf_warp_bytes(int n_pairs) {
  return kBfStages * kBfUnitBytes + bf_slots(n_pairs) * kBfStreamBytes;
}
// a block's warps for n_pairs: as many as shared memory holds, up to kBfWarps
inline int bf_warps(int n_pairs) {
  const int fit = (kSmemPerBlock - n_pairs * kBfPairWBytes) / bf_warp_bytes(n_pairs);
  return fit < kBfWarps ? fit : kBfWarps;
}
inline size_t bf_smem_bytes(int n_pairs) {
  return (size_t)n_pairs * kBfPairWBytes + (size_t)bf_warps(n_pairs) * bf_warp_bytes(n_pairs);
}

// acc[nt] += A @ W for the warp's 16 rows of a unit (bf16, bt::at<8>) and W
// (bf16, bt::at<16>, zero-padded), over the 16-deep steps below dt and the
// 8-column tile pairs below k_out: one bf16 pass a product, A by ldmatrix,
// B by ldmatrix.trans. The step loop stays rolled (the instruction cache).
__device__ __forceinline__ void bf_product(const char* unit, const char* w, int dt16,
                                           int kp, int lane, float acc[16][4]) {
  const int lr = lane & 7;
  const int lm = lane >> 3;
#pragma unroll 1
  for (int ks = 0; ks < dt16; ++ks) {
    uint32_t a[4];
    bt::ldsm4(a, unit + bt::at<8>(lr + 8 * (lm & 1), 16 * ks + 8 * (lm >> 1)));
#pragma unroll
    for (int jp = 0; jp < 8; ++jp) {
      if (jp >= kp) break;
      uint32_t b[4];
      bt::ldsm4_t(b, w + bt::at<16>(16 * ks + lr + 8 * (lm & 1), 16 * jp + 8 * (lm >> 1)));
      bt::mma_pair(acc[2 * jp], acc[2 * jp + 1], a, b);
    }
  }
}

__global__ void __launch_bounds__(32 * kBfWarps, 1)
    gproj_bf16_tc_kernel(Pairs pairs, int n_pairs, const chgnet::bf16* __restrict__ w,
                         const chgnet::bf16* __restrict__ stream,
                         chgnet::bf16* __restrict__ out, int n_rows, int n_src, int dt,
                         int k_out) {
  using chgnet::bf16;
  extern __shared__ float4 smem4[];
  char* w_s = reinterpret_cast<char*>(smem4);  // [n_pairs][kMaxDt][kMaxK]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_slots = bf_slots(n_pairs);
  // this warp's ring, then its stream slots
  char* ring = w_s + n_pairs * kBfPairWBytes + warp * bf_warp_bytes(n_pairs);
  char* st_s = ring + kBfStages * kBfUnitBytes;
  // every pair's W zero-padded, 8 columns (a 16-byte chunk) a step; this
  // warp's buffers zeroed (the copies never write past dt or k_out)
  for (int i = threadIdx.x; i < n_pairs * kMaxDt * (kMaxK / 8); i += blockDim.x) {
    const int p = i / (kMaxDt * (kMaxK / 8));
    const int k = (i / (kMaxK / 8)) % kMaxDt;
    const int n0 = 8 * (i % (kMaxK / 8));
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 2 * j;
      const long at = ((long)p * dt + k) * k_out + n;
      const float x = k < dt && n < k_out ? chgnet::to_f(w[at]) : 0.f;
      const float y = k < dt && n + 1 < k_out ? chgnet::to_f(w[at + 1]) : 0.f;
      v[j] = bt::pack(x, y);
    }
    *reinterpret_cast<uint4*>(w_s + p * kBfPairWBytes + bt::at<16>(k, n0)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  for (int i = lane; i < bf_warp_bytes(n_pairs) / 16; i += 32)
    reinterpret_cast<float4*>(ring)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();  // the only block barrier

  const int gid = lane >> 2;
  const int q = lane & 3;
  const int lr = lane & 7;
  const int lm = lane >> 3;
  const int dt16 = (dt + 15) / 16;
  const int kp = (k_out + 15) / 16;  // pairs of 8-column tiles
  const int n_tiles = (n_rows + kRows - 1) / kRows;
  const int step = gridDim.x * n_warps;
  const int first = blockIdx.x * n_warps + warp;
  const int n_mine = first < n_tiles ? (n_tiles - 1 - first) / step + 1 : 0;
  const int n_units = n_mine * n_pairs;
  // the copies' units: 16 bytes, or 8 where a row is not a multiple of 8 values
  const int n_tab = dt % 8 == 0 ? 8 : 4;
  const int n_st = k_out % 8 == 0 ? 8 : 4;
  const bt::Walk tab_walk(lane, dt / n_tab);
  const int tab_it = (kRows * (dt / n_tab) + 31) / 32;
  const bt::Walk st_walk(lane, k_out / n_st);

  int ix[kMaxPairs], ix_next[kMaxPairs];
  load_idx(pairs, n_pairs, (long)first * kRows, n_rows, lane, ix);
  load_idx(pairs, n_pairs, (long)(first + step) * kRows, n_rows, lane, ix_next);
  // the fetch cursor: pair fp of this warp's tile ft, its stream slot fs
  int fp = 0, ft = 0, fs = 0;
  auto fetch = [&](int u) {
    if (fp == 0 && ft > 0) {  // the next tile: rotate its indices in
#pragma unroll
      for (int k = 0; k < kMaxPairs; ++k) ix[k] = ix_next[k];
      load_idx(pairs, n_pairs, (long)(first + (ft + 1) * step) * kRows, n_rows, lane,
               ix_next);
    }
    const int mine = fp == 0 ? ix[0] : fp == 1 ? ix[1] : ix[2];
    const bf16* tab = static_cast<const bf16*>(
        fp == 0 ? pairs.tab[0] : fp == 1 ? pairs.tab[1] : pairs.tab[2]);
    bt::gather_rows<kMaxDt / 8>(ring + (u % kBfStages) * kBfUnitBytes, tab, mine, n_src, dt,
                                n_tab, tab_it, tab_walk);
    if (fp == 0)
      bt::copy_rows<kMaxK / 8>(st_s + fs * kBfStreamBytes, stream,
                               (long)(first + ft * step) * kRows, n_rows, k_out, n_st,
                               st_walk);
    if (++fp == n_pairs) {
      fp = 0;
      ++ft;
      if (++fs == n_slots) fs = 0;
    }
  };

  int next = 0;  // the next unit to fetch
#pragma unroll 1
  for (int s = 0; s < kBfStages - 1; ++s) {
    if (next < n_units) fetch(next++);
    tc::commit();
  }
  float acc[16][4];
  int p = 0, slot = 0;  // the unit's pair, its tile's stream slot
  long row0 = (long)first * kRows;
  for (int u = 0; u < n_units; ++u) {
    tc::wait_pending<kBfStages - 2>();  // unit u (and its tile's stream) has landed
    __syncwarp();  // ... for every lane, and unit u - 1 is consumed
    if (p == 0) {  // the tile's sums start from its stream rows
      const char* st = st_s + slot * kBfStreamBytes;
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (jp < kp)
          bt::ldsm4(v, st + bt::at<kMaxK / 8>(lr + 8 * (lm & 1), 16 * jp + 8 * (lm >> 1)));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[2 * jp + (i >> 1)][2 * (i & 1)] = bt::lo_f(v[i]);
          acc[2 * jp + (i >> 1)][2 * (i & 1) + 1] = bt::hi_f(v[i]);
        }
      }
      __syncwarp();  // the slot read: the fetch below may refill it
    }
    if (next < n_units) fetch(next++);  // into unit u - 1's stage
    tc::commit();
    bf_product(ring + (u % kBfStages) * kBfUnitBytes, w_s + p * kBfPairWBytes, dt16, kp, lane,
               acc);
    if (p == n_pairs - 1) {  // the tile's last pair: store
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const long l = row0 + gid + 8 * rr;
        if (l >= n_rows) continue;
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          const int c = nt * 8 + 2 * q;
          if (c >= k_out) break;
          chgnet::store2(out + l * k_out + c, acc[nt][2 * rr], acc[nt][2 * rr + 1]);
        }
      }
    }
    if (++p == n_pairs) {
      p = 0;
      row0 += (long)step * kRows;
      if (++slot == n_slots) slot = 0;
    }
  }
}

// -------------------------------------------- short tables: project first
// proj[p][s] = T_p[s] @ W_p for every row s < n_src, 16 rows a warp; a
// bf16 proj is rounded to bf16 here, as the plain path rounds its
// projected tables
template <typename S>
__global__ void __launch_bounds__(kThreads, 1)
    gproj_project_kernel(Pairs pairs, int n_pairs, const S* __restrict__ w,
                         S* __restrict__ proj, int n_src, int dt, int k_out) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  stage_w(w_s, w, n_pairs, dt, k_out);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const int q = lane & 3;
  const int dt8 = (dt + 7) / 8;
  const int n_tiles = (n_src + kRows - 1) / kRows;
  for (int tile = blockIdx.x * kWarps + warp; tile < n_tiles;
       tile += gridDim.x * kWarps) {
    const long s0 = (long)tile * kRows;
#pragma unroll 1
    for (int p = 0; p < n_pairs; ++p) {
      // a table shared with an earlier pair comes from L1 the second time
      const S* tab = static_cast<const S*>(
          p == 0 ? pairs.tab[0] : p == 1 ? pairs.tab[1] : pairs.tab[2]);
      float acc[16][4] = {};
      product<chgnet::is_bf16<S>>(
          [&](int ks, float v[4]) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const long s = s0 + gid + 8 * (i & 1);
              const int c = ks * 8 + q + 4 * (i >> 1);
              v[i] = s < n_src && c < dt ? chgnet::to_f(__ldg(tab + s * dt + c)) : 0.f;
            }
          },
          w_s + p * kPairWFloats, dt8, lane, acc);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const long s = s0 + gid + 8 * rr;
        if (s >= n_src) continue;
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          const int c = nt * 8 + 2 * q;
          if (c >= k_out) break;
          chgnet::store2(proj + ((long)p * n_src + s) * k_out + c, acc[nt][2 * rr],
                         acc[nt][2 * rr + 1]);
        }
      }
    }
  }
}

// gproj_project_kernel for tables up to kWideDt wide and K up to kWideK:
// the block stages one pair's W (its rows kWideK floats apart, swizzled as
// stage_w's), projects every tile of its own of that pair's table in chunks
// of 128 columns, then stages the next pair's W. A chunk's products are the
// short route's, so each projected value is the same sum in the same order.
template <typename S>
__global__ void __launch_bounds__(kThreads, 1)
    gproj_project_wide_kernel(Pairs pairs, int n_pairs, const S* __restrict__ w,
                              S* __restrict__ proj, int n_src, int dt, int k_out) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [kWideDt][kWideK]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const int q = lane & 3;
  const int dt8 = (dt + 7) / 8;
  const int n_tiles = (n_src + kRows - 1) / kRows;
#pragma unroll 1
  for (int p = 0; p < n_pairs; ++p) {
    __syncthreads();  // the previous pair's W read by every warp
    for (int i = threadIdx.x; i < kWidePairWFloats; i += kThreads) {
      const int k = i / kWideK;
      const int n = i % kWideK;
      const float v =
          k < dt && n < k_out ? chgnet::to_f(w[((long)p * dt + k) * k_out + n]) : 0.f;
      w_s[k * kWideK + (n ^ wswz(k))] = v;
    }
    __syncthreads();
    const S* tab = static_cast<const S*>(
        p == 0 ? pairs.tab[0] : p == 1 ? pairs.tab[1] : pairs.tab[2]);
    for (int tile = blockIdx.x * kWarps + warp; tile < n_tiles;
         tile += gridDim.x * kWarps) {
      const long s0 = (long)tile * kRows;
#pragma unroll 1
      for (int c0 = 0; c0 < k_out; c0 += 128) {
        float acc[16][4] = {};
        product<chgnet::is_bf16<S>, kWideK>(
            [&](int ks, float v[4]) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const long s = s0 + gid + 8 * (i & 1);
                const int c = ks * 8 + q + 4 * (i >> 1);
                v[i] = s < n_src && c < dt ? chgnet::to_f(__ldg(tab + s * dt + c)) : 0.f;
              }
            },
            w_s + c0, dt8, lane, acc);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const long s = s0 + gid + 8 * rr;
          if (s >= n_src) continue;
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            const int c = c0 + nt * 8 + 2 * q;
            if (c >= k_out) break;
            chgnet::store2(proj + ((long)p * n_src + s) * k_out + c, acc[nt][2 * rr],
                           acc[nt][2 * rr + 1]);
          }
        }
      }
    }
  }
}

// out[l] = stream[l] + proj[0][idx_0[l]] + proj[1][idx_1[l]] + ..., in
// pair order, 4 columns a thread, added in f32 and rounded to S once
template <typename S>
__global__ void __launch_bounds__(kThreads)
    gproj_gather_add_kernel(Pairs pairs, int n_pairs, const S* __restrict__ proj,
                            const S* __restrict__ stream,
                            S* __restrict__ out, int n_rows, int n_src,
                            int k_out) {
  const int k4 = k_out / 4;
  const long n = (long)n_rows * k4;
  for (long i = blockIdx.x * (long)kThreads + threadIdx.x; i < n;
       i += (long)gridDim.x * kThreads) {
    const long l = i / k4;
    const int c = (int)(i - l * k4);
    float4 v;
    chgnet::ldg_v(v, stream + i * 4);
#pragma unroll
    for (int p = 0; p < kMaxPairs; ++p) {
      if (p >= n_pairs) break;
      const int s = __ldg((p == 0 ? pairs.idx[0] : p == 1 ? pairs.idx[1] : pairs.idx[2]) + l);
      if (s >= 0 && s < n_src) {
        float4 pv;
        chgnet::ldg_v(pv, proj + ((long)p * n_src + s) * k_out + 4 * c);
        chgnet::vadd(v, pv);
      }
    }
    chgnet::store_v(out + i * 4, v);
  }
}

size_t w_smem(int n_pairs) { return (size_t)n_pairs * kPairWFloats * sizeof(float); }

// blocks of one full wave of fn at smem bytes and threads a block
// (negative: minus a cudaError_t)
template <typename Fn>
int wave(Fn fn, size_t smem, int threads = kThreads) {
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  return err == cudaSuccess ? chgnet::sm_count() * per_sm : -(int)err;
}

// a call the long route does not take; wide: nor the short route (tables
// up to kWideDt, K up to kWideK)
bool bad_shape(int n_pairs, int dt, int k_out, bool wide = false) {
  const int max_dt = wide ? kWideDt : kMaxDt;
  const int max_k = wide ? kWideK : kMaxK;
  return n_pairs < 1 || n_pairs > kMaxPairs || dt < 4 || dt > max_dt || dt % 4 ||
         k_out < 4 || k_out > max_k || k_out % 4;
}

Pairs make_pairs(int n_pairs, const void* const* tabs, const void* const* idxs) {
  Pairs pairs;
  for (int p = 0; p < kMaxPairs; ++p) {
    pairs.tab[p] = p < n_pairs ? tabs[p] : nullptr;
    pairs.idx[p] = p < n_pairs ? static_cast<const int*>(idxs[p]) : nullptr;
    pairs.same_idx[p] = p;
    for (int e = p - 1; e >= 0; --e)
      if (pairs.idx[e] == pairs.idx[p]) pairs.same_idx[p] = e;
  }
  return pairs;
}

}  // namespace

extern "C" size_t gproj_smem_bytes(int n_pairs, int dt, int k_out) {
  (void)dt;
  (void)k_out;
  return w_smem(n_pairs) + (size_t)kWarps * kStages * kUnitFloats * sizeof(float);
}

namespace {

int gproj_long(int n_pairs, const void* const* tabs, const void* const* idxs,
               const float* w, const float* stream, float* out, int n_rows, int n_src,
               int dt, int k_out, void* cuda_stream) {
  if (bad_shape(n_pairs, dt, k_out)) return (int)cudaErrorInvalidValue;
  if (n_rows > 0) {
    const Pairs pairs = make_pairs(n_pairs, tabs, idxs);
    const size_t smem = gproj_smem_bytes(n_pairs, dt, k_out);
    const int cap = wave(gproj_tc_kernel<float>, smem);
    if (cap < 0) return -cap;
    const int want = (n_rows + kRows * kWarps - 1) / (kRows * kWarps);
    gproj_tc_kernel<float><<<want < cap ? want : cap, kThreads, smem,
                             static_cast<cudaStream_t>(cuda_stream)>>>(
        pairs, n_pairs, w, stream, out, n_rows, n_src, dt, k_out);
  }
  return (int)cudaGetLastError();
}

int gproj_long(int n_pairs, const void* const* tabs, const void* const* idxs,
               const chgnet::bf16* w, const chgnet::bf16* stream, chgnet::bf16* out,
               int n_rows, int n_src, int dt, int k_out, void* cuda_stream) {
  if (bad_shape(n_pairs, dt, k_out)) return (int)cudaErrorInvalidValue;
  if (n_rows > 0) {
    const Pairs pairs = make_pairs(n_pairs, tabs, idxs);
    const int warps = bf_warps(n_pairs);
    const size_t smem = bf_smem_bytes(n_pairs);
    const int cap = wave(gproj_bf16_tc_kernel, smem, 32 * warps);
    if (cap < 0) return -cap;
    const int want = (n_rows + kRows * warps - 1) / (kRows * warps);
    gproj_bf16_tc_kernel<<<want < cap ? want : cap, 32 * warps, smem,
                           static_cast<cudaStream_t>(cuda_stream)>>>(
        pairs, n_pairs, w, stream, out, n_rows, n_src, dt, k_out);
  }
  return (int)cudaGetLastError();
}

template <typename S>
int gproj_short(int n_pairs, const void* const* tabs, const void* const* idxs,
                const S* w, const S* stream, S* out, S* proj, int n_rows,
                int n_src, int dt, int k_out, void* cuda_stream) {
  if (bad_shape(n_pairs, dt, k_out, true)) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  const Pairs pairs = make_pairs(n_pairs, tabs, idxs);
  if (n_src > 0 && bad_shape(n_pairs, dt, k_out)) {  // one pair's W at a time
    const size_t smem = kWidePairWFloats * sizeof(float);
    const int cap = wave(gproj_project_wide_kernel<S>, smem);
    if (cap < 0) return -cap;
    const int want = (n_src + kRows * kWarps - 1) / (kRows * kWarps);
    gproj_project_wide_kernel<S><<<want < cap ? want : cap, kThreads, smem, st>>>(
        pairs, n_pairs, w, proj, n_src, dt, k_out);
  } else if (n_src > 0) {
    const size_t smem = w_smem(n_pairs);
    const int cap = wave(gproj_project_kernel<S>, smem);
    if (cap < 0) return -cap;
    const int want = (n_src + kRows * kWarps - 1) / (kRows * kWarps);
    gproj_project_kernel<S><<<want < cap ? want : cap, kThreads, smem, st>>>(
        pairs, n_pairs, w, proj, n_src, dt, k_out);
  }
  const int cap = wave(gproj_gather_add_kernel<S>, 0);
  if (cap < 0) return -cap;
  const long units = (long)n_rows * (k_out / 4);
  const long want = (units + kThreads - 1) / kThreads;
  gproj_gather_add_kernel<S><<<want < cap ? (int)want : cap, kThreads, 0, st>>>(
      pairs, n_pairs, proj, stream, out, n_rows, n_src, k_out);
  return (int)cudaGetLastError();
}

}  // namespace

// The long-table route (gather first). tabs/idxs: n_pairs pointers each;
// w: [n_pairs * dt, k_out] row-major; stream: [n_rows, k_out]. Requires
// 4 <= dt <= 64, 4 <= k_out <= 128, both multiples of 4, 1 <= n_pairs <= 3
// and 16-byte aligned tables, w, stream and out (checked by the wrapper).
// The _bf16 entries take bf16 tables, w, stream, out (and proj): products
// and sums run in f32 and out is rounded to bf16 once; the long route by
// gproj_bf16_tc_kernel, on the bf16 tensor cores.
extern "C" int gproj_f32(int n_pairs, const void* const* tabs,
                         const void* const* idxs, const float* w,
                         const float* stream, float* out, int n_rows,
                         int n_src, int dt, int k_out, void* cuda_stream) {
  return gproj_long(n_pairs, tabs, idxs, w, stream, out, n_rows, n_src, dt, k_out,
                    cuda_stream);
}

extern "C" int gproj_bf16(int n_pairs, const void* const* tabs,
                          const void* const* idxs, const chgnet::bf16* w,
                          const chgnet::bf16* stream, chgnet::bf16* out, int n_rows,
                          int n_src, int dt, int k_out, void* cuda_stream) {
  return gproj_long(n_pairs, tabs, idxs, w, stream, out, n_rows, n_src, dt, k_out,
                    cuda_stream);
}

// The short-table route (project first), two launches: proj [n_pairs,
// n_src, k_out] (16-byte aligned scratch from the caller) = each pair's
// table @ W, then out = stream + the gathered rows of proj in pair order.
// Arguments and requirements otherwise as gproj_f32's, but dt <= 128 and
// k_out <= 256 (over 64 or 128: one pair's W staged at a time).
extern "C" int gproj_short_f32(int n_pairs, const void* const* tabs,
                               const void* const* idxs, const float* w,
                               const float* stream, float* out, float* proj,
                               int n_rows, int n_src, int dt, int k_out,
                               void* cuda_stream) {
  return gproj_short(n_pairs, tabs, idxs, w, stream, out, proj, n_rows, n_src, dt,
                     k_out, cuda_stream);
}

extern "C" int gproj_short_bf16(int n_pairs, const void* const* tabs,
                                const void* const* idxs, const chgnet::bf16* w,
                                const chgnet::bf16* stream, chgnet::bf16* out,
                                chgnet::bf16* proj, int n_rows, int n_src, int dt,
                                int k_out, void* cuda_stream) {
  return gproj_short(n_pairs, tabs, idxs, w, stream, out, proj, n_rows, n_src, dt,
                     k_out, cuda_stream);
}

// The dynamic shared memory, warps a block and blocks of one wave on the
// current device of the long route's kernels at 3 pairs, info[3 * i ..]
// for gproj_tc_kernel<float> (i = 0) and gproj_bf16_tc_kernel (1); nothing
// is launched. For the build report.
extern "C" int gproj_tc_occupancy(int* info) {
  const size_t smem[2] = {gproj_smem_bytes(3, kMaxDt, kMaxK), bf_smem_bytes(3)};
  const int warps[2] = {kWarps, bf_warps(3)};
  const int waves[2] = {wave(gproj_tc_kernel<float>, smem[0]),
                        wave(gproj_bf16_tc_kernel, smem[1], 32 * warps[1])};
  for (int i = 0; i < 2; ++i) {
    if (waves[i] < 0) return -waves[i];
    info[3 * i] = (int)smem[i];
    info[3 * i + 1] = warps[i];
    info[3 * i + 2] = waves[i];
  }
  return (int)cudaSuccess;
}
