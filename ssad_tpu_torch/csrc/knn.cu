// k-NN cosine scoring for Hopper (sm_90a): mean of the k largest cosine
// similarities per query, as 1 - mean(top-k).
//
// Replaces the resident Pallas TPU kernel `_knn_kernel`
// (ssad_tpu/ops/knn.py:42-77, launched by knn_cosine_scores_pallas at
// :84-119).  Same function: L2-normalised f32 queries (N, D) against an
// L2-normalised f32 bank (M, D), sims in IEEE f32, top-k that counts
// duplicate bank rows separately, output 1 - mean(top-k) per query.
//
// What bounds it on this card.  On the serving path N = 8, M = 700,
// D = 512: about 1.45 MB of input against 5.7 MFLOP, so it is bound by
// memory and, at that size, by launch latency, not by arithmetic.  The
// f32 work is done with FMAs on the CUDA cores (no TF32, no bf16):
// scores are 1 - cos with cos close to 1, so the TPU kernel runs its
// matmul at Precision.HIGHEST, and a tensor-core product in TF32 would
// cost about three digits of the signal.
//
// Design.  The TPU keeps the whole (<= 1024, 512) bank resident in VMEM;
// a Hopper block has at most 227 KB of shared memory, so here the bank is
// walked row by row from global memory (L2-resident after the first
// touch) and only the queries are staged in shared memory.
//   Stage 1: grid (query tiles of 8) x (bank splits), so that even N = 8
//     spreads over many SMs.  Each of a block's 8 warps takes bank rows in
//     turn; its 32 lanes split the row's D columns (coalesced loads),
//     accumulate the 8 dot products and the row's squared norm with FMAs,
//     and reduce them with a xor butterfly, after which every lane holds
//     the same sums.  Each lane keeps the running top-k of VALUES for all
//     8 queries in registers (a max/min insertion cascade), so every
//     candidate is inserted on its own and duplicate rows count like
//     lax.top_k / torch.topk.  The block merges its warps' lists and writes
//     (N, splits, k) partial top-k values.
//   Stage 2: one thread per query merges its splits * k candidates and
//     writes 1 - (t0 + t1 + ... ) / k, summed largest first as the TPU
//     kernel does.
// Both normalisations are fused: queries are divided by max(|q|, 1e-12)
// in shared memory; each bank row's dot products are divided by
// max(|b|, 1e-12), computed in the same pass over the row.
//
// C interface (bound with ctypes): ssad_knn_cosine_scores returns the
// cudaError_t of the launches (0 on success).  It launches on the given
// stream, does not synchronise and allocates nothing: the caller passes
// the (N, splits, k) partial buffer and the (N,) output.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQueriesPerBlock = 8;  // one query row per warp when normalising
constexpr float kEps = 1e-12f;
constexpr int kMergeThreads = 128;

static_assert(kQueriesPerBlock == kWarps, "each warp normalises one query row");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// insert v into t[0] >= t[1] >= ... >= t[K-1]; the smallest falls off
template <int K>
__device__ __forceinline__ void topk_insert(float (&t)[K], float v) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float hi = fmaxf(t[i], v);
    v = fminf(t[i], v);
    t[i] = hi;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_partial_kernel(const float* __restrict__ queries, const float* __restrict__ bank,
                   float* __restrict__ partial, int n, int m, int d,
                   int rows_per_split, int splits) {
  extern __shared__ float qs[];  // [kQueriesPerBlock][d]
  __shared__ float s_top[kWarps][kQueriesPerBlock][K];

  const int q0 = blockIdx.x * kQueriesPerBlock;
  const int split = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kQueriesPerBlock * d; i += kThreads) {
    const int r = i / d;
    const int qi = q0 + r;
    qs[i] = qi < n ? queries[(size_t)qi * d + (i - r * d)] : 0.f;
  }
  __syncthreads();
  {
    float* row = qs + warp * d;
    float ss = 0.f;
    for (int c = lane; c < d; c += 32) ss = fmaf(row[c], row[c], ss);
    const float den = fmaxf(sqrtf(warp_sum(ss)), kEps);
    for (int c = lane; c < d; c += 32) row[c] = row[c] / den;
  }
  __syncthreads();

  float top[kQueriesPerBlock][K];
#pragma unroll
  for (int r = 0; r < kQueriesPerBlock; ++r)
#pragma unroll
    for (int i = 0; i < K; ++i) top[r][i] = -CUDART_INF_F;

  const int row_begin = split * rows_per_split;
  const int row_end = min(m, row_begin + rows_per_split);
  for (int j = row_begin + warp; j < row_end; j += kWarps) {
    const float* b = bank + (size_t)j * d;
    float acc[kQueriesPerBlock];
#pragma unroll
    for (int r = 0; r < kQueriesPerBlock; ++r) acc[r] = 0.f;
    float ss = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float bv = __ldg(b + c);
      ss = fmaf(bv, bv, ss);
#pragma unroll
      for (int r = 0; r < kQueriesPerBlock; ++r) acc[r] = fmaf(qs[r * d + c], bv, acc[r]);
    }
    const float den = fmaxf(sqrtf(warp_sum(ss)), kEps);
#pragma unroll
    for (int r = 0; r < kQueriesPerBlock; ++r) topk_insert<K>(top[r], warp_sum(acc[r]) / den);
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kQueriesPerBlock; ++r)
#pragma unroll
      for (int i = 0; i < K; ++i) s_top[warp][r][i] = top[r][i];
  }
  __syncthreads();
  if (threadIdx.x < kQueriesPerBlock) {
    const int r = threadIdx.x;
    const int qi = q0 + r;
    if (qi < n) {
      float t[K];
#pragma unroll
      for (int i = 0; i < K; ++i) t[i] = -CUDART_INF_F;
      for (int w = 0; w < kWarps; ++w)
#pragma unroll
        for (int i = 0; i < K; ++i) topk_insert<K>(t, s_top[w][r][i]);
      float* dst = partial + ((size_t)qi * splits + split) * K;
#pragma unroll
      for (int i = 0; i < K; ++i) dst[i] = t[i];
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kMergeThreads)
knn_merge_kernel(const float* __restrict__ partial, float* __restrict__ out, int n, int splits) {
  const int qi = blockIdx.x * kMergeThreads + threadIdx.x;
  if (qi >= n) return;
  float t[K];
#pragma unroll
  for (int i = 0; i < K; ++i) t[i] = -CUDART_INF_F;
  const float* p = partial + (size_t)qi * splits * K;
  for (int i = 0; i < splits * K; ++i) topk_insert<K>(t, p[i]);
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) total += t[i];
  out[qi] = 1.f - total / (float)K;
}

template <int K>
int launch(const float* q, const float* b, float* partial, float* out, int n, int m,
           int d, int rows_per_split, int splits, cudaStream_t stream) {
  const size_t smem = (size_t)kQueriesPerBlock * d * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn_partial_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((n + kQueriesPerBlock - 1) / kQueriesPerBlock, splits);
  knn_partial_kernel<K><<<grid, kThreads, smem, stream>>>(q, b, partial, n, m, d,
                                                         rows_per_split, splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  knn_merge_kernel<K><<<(n + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, stream>>>(
      partial, out, n, splits);
  e = cudaGetLastError();
  return (int)e;
}

}  // namespace

extern "C" int ssad_knn_cosine_scores(const float* queries, const float* bank, float* partial,
                                      float* out, int n, int m, int d, int k,
                                      int rows_per_split, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(queries, bank, partial, out, n, m, d, rows_per_split, splits, s);
    case 2: return launch<2>(queries, bank, partial, out, n, m, d, rows_per_split, splits, s);
    case 3: return launch<3>(queries, bank, partial, out, n, m, d, rows_per_split, splits, s);
    case 4: return launch<4>(queries, bank, partial, out, n, m, d, rows_per_split, splits, s);
    case 5: return launch<5>(queries, bank, partial, out, n, m, d, rows_per_split, splits, s);
    case 6: return launch<6>(queries, bank, partial, out, n, m, d, rows_per_split, splits, s);
    case 7: return launch<7>(queries, bank, partial, out, n, m, d, rows_per_split, splits, s);
    case 8: return launch<8>(queries, bank, partial, out, n, m, d, rows_per_split, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
