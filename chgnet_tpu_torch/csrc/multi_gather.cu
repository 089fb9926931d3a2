// Multi-gather sum: out[l] = sum_k T_k[idx_k[l]] (+ stream[l]), K = 1..4
// tables of one width d, a zero row where idx_k[l] lies outside [0, S_k).
//
// Replaces chgnet_tpu/ops/stream_ops.py _multi_gather_kernel (:775, wrapper
// _multi_gather_pallas :878), the fused sum of K window gathers behind
// ops/scatter.py gather_sum and twin_reduce. The TPU kernel DMAs a source
// window per part and output block and expands each with one-hot MXU
// matmuls into a VMEM accumulator; on Hopper a thread simply loads its
// 16-byte unit of each part's row and adds.
//
// Bound: bytes. The function reads K index streams, the table rows they
// name (short tables, like AtomConv's atom table, stay in L2 and are read
// from device memory once) and the stream, and writes L rows; it does K - 1
// (+ 1) adds per element. Design: one thread per (row, float4 unit), so a
// warp reads neighbouring units of the same or the next source row of each
// part and writes contiguous output; a thread loads its K indices first,
// then its K rows, then adds in f32 from zero in part order, the
// stream last, which is the order of the plain PyTorch version (and of the
// TPU body at 128 lanes), so kernel and plain version agree bit for bit.
// bf16 rows (compute_dtype="bfloat16"): units of 4 bf16 (8 bytes) widened
// to f32, the same f32 adds, one rounding at the store; the plain version
// widens, adds in the same order and rounds once, so the two still agree
// bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParts = 4;

struct Parts {
  const void* table[kMaxParts];
  const int* idx[kMaxParts];
  int n_src[kMaxParts];
};

// S: the storage type of the tables, stream and out (float or bf16); a
// thread's unit is 4 elements, summed in f32 and rounded once at the store
template <typename S, int K, bool kStream>
__global__ void __launch_bounds__(kThreads)
    gather_sum_kernel(Parts p, const S* __restrict__ stream, S* __restrict__ out,
                      long n_rows, int units) {
  const long total = n_rows * units;
  for (long t = (long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (long)gridDim.x * blockDim.x) {
    const long l = t / units;
    const int u = (int)(t - l * units);
    int s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = __ldg(p.idx[k] + l);
    float4 v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = chgnet::vzero<float4>();
      if (s[k] >= 0 && s[k] < p.n_src[k])
        chgnet::ldg_v(v[k], static_cast<const S*>(p.table[k]) +
                                 ((long)s[k] * units + u) * 4);
    }
    float4 acc = chgnet::vzero<float4>();
#pragma unroll
    for (int k = 0; k < K; ++k) chgnet::vadd(acc, v[k]);
    if (kStream) {
      float4 sv;
      chgnet::load_v(sv, stream + t * 4);
      chgnet::vadd(acc, sv);
    }
    chgnet::store_v(out + t * 4, acc);
  }
}

int grid_for(long total) {
  const long want = (total + kThreads - 1) / kThreads;
  const long cap = (long)chgnet::sm_count() * 32;
  return (int)(want < cap ? want : cap);
}

template <typename S, int K>
void launch(const Parts& p, const S* stream, S* out, long n_rows, int units,
            cudaStream_t st) {
  const int grid = grid_for(n_rows * units);
  if (stream != nullptr) {
    gather_sum_kernel<S, K, true><<<grid, kThreads, 0, st>>>(p, stream, out,
                                                             n_rows, units);
  } else {
    gather_sum_kernel<S, K, false><<<grid, kThreads, 0, st>>>(p, nullptr, out,
                                                              n_rows, units);
  }
}

template <typename S>
int gather_sum_rows(int n_parts, const void* const* tables,
                    const void* const* idxs, const int* n_srcs, const S* stream,
                    S* out, long n_rows, int d, void* cuda_stream) {
  if (n_parts < 1 || n_parts > kMaxParts || d < 4 || d % 4 ||
      !chgnet::vec4_ok(out, d) || (stream && !chgnet::vec4_ok(stream, d)))
    return (int)cudaErrorInvalidValue;
  Parts p;
  for (int k = 0; k < kMaxParts; ++k) {
    const int j = k < n_parts ? k : 0;
    if (!chgnet::vec4_ok(static_cast<const S*>(tables[j]), d))
      return (int)cudaErrorInvalidValue;
    p.table[k] = tables[j];
    p.idx[k] = static_cast<const int*>(idxs[j]);
    p.n_src[k] = n_srcs[j];
  }
  if (n_rows > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
    switch (n_parts) {
      case 1: launch<S, 1>(p, stream, out, n_rows, d / 4, st); break;
      case 2: launch<S, 2>(p, stream, out, n_rows, d / 4, st); break;
      case 3: launch<S, 3>(p, stream, out, n_rows, d / 4, st); break;
      default: launch<S, 4>(p, stream, out, n_rows, d / 4, st); break;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// tables[k] [n_srcs[k], d], idxs[k] [n_rows] int32, stream [n_rows, d] or
// null, out [n_rows, d]; every tensor contiguous f32 on 16-byte aligned
// storage, d % 4 == 0, 1 <= n_parts <= 4.
extern "C" int gather_sum_rows_f32(int n_parts, const void* const* tables,
                                   const void* const* idxs, const int* n_srcs,
                                   const float* stream, float* out,
                                   long n_rows, int d, void* cuda_stream) {
  return gather_sum_rows(n_parts, tables, idxs, n_srcs, stream, out, n_rows, d,
                         cuda_stream);
}

// The same with bf16 tables, stream and out (8-byte aligned), summed in f32.
extern "C" int gather_sum_rows_bf16(int n_parts, const void* const* tables,
                                    const void* const* idxs, const int* n_srcs,
                                    const chgnet::bf16* stream, chgnet::bf16* out,
                                    long n_rows, int d, void* cuda_stream) {
  return gather_sum_rows(n_parts, tables, idxs, n_srcs, stream, out, n_rows, d,
                         cuda_stream);
}
