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
// Hopper a block gathers its rows directly.
//
// Bound: the function needs the fewer FLOPs of two orders, gather first
// (2 * L * n_pairs * dt * K) or project each (table, W) first (2 * S * dt * K)
// and add the gathered rows (L * K per pair). In AtomConv the atom tables
// are short (S = atoms << L = edges): the function is bound by bytes (the
// [L, K] stream read and out written), and this kernel, which gathers
// first, does far more work than it needs. In BondConv and AngleUpdate
// S = edges is close to L = angles, and the function is bound by f32
// operations. Projecting short tables first is later work. TF32 tensor
// cores would be faster but are not exact enough for the port's f32
// contract.
// Design: all pair weights (n_pairs * dt * K floats, 96 KB for 3 pairs at
// 64 x 128) are staged once in dynamic shared memory per block, and each
// block walks 64-row tiles of the stream. For every pair the tile's rows
// of T_p are gathered into shared memory, then each of 256 threads
// accumulates an 8-row x 4-column register tile with f32 FMAs: rows are
// read as broadcasts (a warp shares its 8 rows) and the weight row as one
// float4 per lane, conflict-free. The pairs and the depth are summed in a
// fixed order; out-of-range indices gather a zero row.
#include "common.cuh"

namespace {

constexpr int kMaxPairs = 3;
constexpr int kTile = 64;     // stream rows per tile
constexpr int kThreads = 256; // 8 warps x 32 lanes
constexpr int kRowsPerWarp = kTile / (kThreads / 32);

struct Pairs {
  const float* tab[kMaxPairs];
  const int* idx[kMaxPairs];
};

__global__ void __launch_bounds__(kThreads)
    gproj_kernel(Pairs pairs, int n_pairs, const float* __restrict__ w,
                 const float* __restrict__ stream, float* __restrict__ out,
                 int n_rows, int n_src, int dt, int k_out) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [n_pairs][dt][k_out]
  float* g_s = w_s + (long)n_pairs * dt * k_out;  // [kTile][dt]

  const int n_w4 = n_pairs * dt * k_out / 4;
  for (int i = threadIdx.x; i < n_w4; i += kThreads)
    reinterpret_cast<float4*>(w_s)[i] = reinterpret_cast<const float4*>(w)[i];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = lane * 4;
  const bool col_ok = col < k_out;
  const int dt4 = dt / 4;
  const int n_tiles = (n_rows + kTile - 1) / kTile;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long row0 = (long)tile * kTile;
    float acc[kRowsPerWarp][4];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

    for (int p = 0; p < n_pairs; ++p) {
      __syncthreads();  // weights staged / previous pair's rows consumed
      const float* tab = pairs.tab[p];
      const int* idx = pairs.idx[p];
      for (int i = threadIdx.x; i < kTile * dt4; i += kThreads) {
        const int r = i / dt4;
        const int c = i - r * dt4;
        const long l = row0 + r;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (l < n_rows) {
          const int s = idx[l];
          if (s >= 0 && s < n_src)
            v = reinterpret_cast<const float4*>(tab + (long)s * dt)[c];
        }
        reinterpret_cast<float4*>(g_s + r * dt)[c] = v;
      }
      __syncthreads();
      if (col_ok) {
        const float* wp = w_s + (long)p * dt * k_out + col;
        const float* gp = g_s + warp * kRowsPerWarp * dt;
        for (int k = 0; k < dt; k += 4) {
          const float4 w0 = *reinterpret_cast<const float4*>(wp + (k + 0) * k_out);
          const float4 w1 = *reinterpret_cast<const float4*>(wp + (k + 1) * k_out);
          const float4 w2 = *reinterpret_cast<const float4*>(wp + (k + 2) * k_out);
          const float4 w3 = *reinterpret_cast<const float4*>(wp + (k + 3) * k_out);
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float4 g = *reinterpret_cast<const float4*>(gp + r * dt + k);
            acc[r][0] = fmaf(g.x, w0.x, acc[r][0]);
            acc[r][1] = fmaf(g.x, w0.y, acc[r][1]);
            acc[r][2] = fmaf(g.x, w0.z, acc[r][2]);
            acc[r][3] = fmaf(g.x, w0.w, acc[r][3]);
            acc[r][0] = fmaf(g.y, w1.x, acc[r][0]);
            acc[r][1] = fmaf(g.y, w1.y, acc[r][1]);
            acc[r][2] = fmaf(g.y, w1.z, acc[r][2]);
            acc[r][3] = fmaf(g.y, w1.w, acc[r][3]);
            acc[r][0] = fmaf(g.z, w2.x, acc[r][0]);
            acc[r][1] = fmaf(g.z, w2.y, acc[r][1]);
            acc[r][2] = fmaf(g.z, w2.z, acc[r][2]);
            acc[r][3] = fmaf(g.z, w2.w, acc[r][3]);
            acc[r][0] = fmaf(g.w, w3.x, acc[r][0]);
            acc[r][1] = fmaf(g.w, w3.y, acc[r][1]);
            acc[r][2] = fmaf(g.w, w3.z, acc[r][2]);
            acc[r][3] = fmaf(g.w, w3.w, acc[r][3]);
          }
        }
      }
    }

    if (col_ok) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const long l = row0 + warp * kRowsPerWarp + r;
        if (l >= n_rows) break;
        const float4 s =
            *reinterpret_cast<const float4*>(stream + l * k_out + col);
        const float4 o = make_float4(acc[r][0] + s.x, acc[r][1] + s.y,
                                     acc[r][2] + s.z, acc[r][3] + s.w);
        *reinterpret_cast<float4*>(out + l * k_out + col) = o;
      }
    }
  }
}

}  // namespace

extern "C" size_t gproj_smem_bytes(int n_pairs, int dt, int k_out) {
  return ((size_t)n_pairs * dt * k_out + (size_t)kTile * dt) * sizeof(float);
}

// tabs/idxs: n_pairs pointers each; w: [n_pairs * dt, k_out] row-major;
// stream: [n_rows, k_out]. Requires dt % 4 == 0, k_out % 4 == 0,
// k_out <= 128, 1 <= n_pairs <= 3 and 16-byte aligned tables, w, stream
// and out (checked by the wrapper).
extern "C" int gproj_f32(int n_pairs, const void* const* tabs,
                         const void* const* idxs, const float* w,
                         const float* stream, float* out, int n_rows,
                         int n_src, int dt, int k_out, void* cuda_stream) {
  if (n_pairs < 1 || n_pairs > kMaxPairs || dt % 4 || k_out % 4 ||
      k_out > 128)
    return (int)cudaErrorInvalidValue;
  if (n_rows > 0) {
    Pairs pairs;
    for (int p = 0; p < kMaxPairs; ++p) {
      pairs.tab[p] = p < n_pairs ? static_cast<const float*>(tabs[p]) : nullptr;
      pairs.idx[p] = p < n_pairs ? static_cast<const int*>(idxs[p]) : nullptr;
    }
    const size_t smem = gproj_smem_bytes(n_pairs, dt, k_out);
    cudaError_t err = cudaFuncSetAttribute(
        gproj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gproj_kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int n_tiles = (n_rows + kTile - 1) / kTile;
    const int cap = chgnet::sm_count() * per_sm;
    const int grid = n_tiles < cap ? n_tiles : cap;
    gproj_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(cuda_stream)>>>(
        pairs, n_pairs, w, stream, out, n_rows, n_src, dt, k_out);
  }
  return (int)cudaGetLastError();
}
