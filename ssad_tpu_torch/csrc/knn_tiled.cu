// Streaming k-NN cosine scoring for Hopper (sm_90a) with bf16x3
// similarities: mean of the k largest similarities per query, as
// 1 - mean(top-k), for banks of any size.
//
// Replaces the Pallas TPU kernel `_knn_tiled_kernel`
// (ssad_tpu/ops/knn.py:165-227, launched by knn_cosine_scores_pallas_tiled
// at :230-276).  Same function: the caller passes the L2-normalised
// queries (N, D) and bank (M, D), each split by bit masking into a bf16
// pair (hi = x with its low 16 bits cleared, lo = bf16(x - hi); :149-162),
// and the similarity is qh.bh + qh.bl + ql.bh accumulated in f32 (the
// ql.bl term dropped, as on the TPU).  Every bank row is inserted into a
// running top-k of VALUES on its own, so duplicate rows count, within a
// tile, across tiles and across blocks alike.  Rows at or past M are
// masked.  Output 1 - (t0 + ... + t_{k-1}) / k, summed largest first.
//
// What bounds it on this card.  At the request shape N = 6728 queries
// (8 images x 841 windows) against M = 29435 rows, D = 512, it reads
// 74 MB (22 us) and does 608 GFLOP of bf16 products (three per pair of
// elements): 0.62 ms on bf16 tensor cores.  So it is bound by operations,
// and by the tensor cores; the (N, M) similarity matrix (792 MB in f32)
// must never reach device memory.
//
// Design (a first, simple kernel: wmma 16x16x16 bf16 -> f32, no wgmma/TMA).
//   Stage 1: grid (query tiles of 128) x (bank splits).  A block walks the
//     128-row bank tiles of its split.  For each tile it runs a 128x128
//     GEMM over D in 32-deep stages: the four bf16 operand slices
//     (qh, ql, bh, bl) are copied into shared memory with cp.async, double
//     buffered, and eight warps (4 x 2, each 32 x 64 of the output) issue
//     three wmma products per fragment pair and 16-deep step into a fresh
//     f32 accumulator, then add it to the running sum (see Accuracy).  The
//     128x128 f32 tile is then stored to shared memory (aliasing the
//     operand buffers) and each thread inserts 64 values of one query row
//     into its k registers (a max/min cascade); columns are visited in a
//     lane-rotated order so the reads are free of bank conflicts.  At the
//     end of its split the block merges its two per-row lists and writes
//     (N, splits, k) partial top-k values.
//   Stage 2: one thread per query merges its splits * k candidates.
// The splits exist because N = 6728 gives only 53 query tiles for 132
// SMs; the wrapper picks them so that about eight waves of blocks run.
//
// Accuracy.  The tensor cores' f32 accumulation is not an IEEE sum: a
// product added to a large accumulator can lose its low bits.  Over all 96
// mma steps of D = 512 in one accumulator the error grows with the
// similarity, to 7e-6 at cos ~ 1 (measured on an H100), the regime of real
// patch embeddings.  Each step's sum is small (16 terms of three split
// pairs), so its own loss is small, and the running sum takes 32
// round-to-nearest adds: 1.9e-7 from the plain f32 sums at cos ~ 1.
//
// C interface (bound with ctypes): ssad_knn_tiled_scores returns the
// cudaError_t of the launches (0 on success).  It launches on the given
// stream, does not synchronise and allocates nothing: the caller passes
// the split operands (D padded to a multiple of 32 with zeros), the
// (N, splits, k) partial buffer and the (N,) output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBQ = 128;          // queries per block
constexpr int kBM = 128;          // bank rows per tile
constexpr int kBK = 32;           // depth of one pipeline stage
constexpr int kLd = kBK + 8;      // bf16 row pitch in shared memory (80 B)
constexpr int kSimLd = kBM + 4;   // f32 row pitch of the similarity tile
constexpr int kThreads = 256;     // 8 warps
constexpr int kMergeThreads = 128;

constexpr int kMatElems = kBQ * kLd;                  // one operand slice
constexpr int kStageElems = 4 * kMatElems;            // qh, ql, bh, bl
constexpr int kStageBytes = kStageElems * 2;          // 40960
constexpr int kSimBytes = kBQ * kSimLd * 4;           // 67584
constexpr int kSmemBytes = 2 * kStageBytes;           // 81920: two stages, sims alias them

static_assert(kBQ == kBM, "one slice shape for queries and bank");
static_assert(kSimBytes <= kSmemBytes, "the similarity tile fits in the operand buffers");
static_assert(4 * kBQ * (kBK / 8) == 8 * kThreads, "eight 16-byte copies per thread and stage");

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// copy depth slice kc of the query tile (rows q0..) and bank tile (rows
// b0..) into one stage; rows past n or m are zero-filled
__device__ __forceinline__ void load_stage(__nv_bfloat16* stage, const __nv_bfloat16* qh,
                                           const __nv_bfloat16* ql, const __nv_bfloat16* bh,
                                           const __nv_bfloat16* bl, int q0, int b0, int kc,
                                           int n, int m, int dp) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int seg = threadIdx.x + s * kThreads;  // 0 .. 2047
    const int mat = seg >> 9;                    // 0 qh, 1 ql, 2 bh, 3 bl
    const int row = (seg >> 2) & (kBQ - 1);
    const int part = seg & 3;                    // 16-byte part of the 64-byte row
    const __nv_bfloat16* base = mat == 0 ? qh : mat == 1 ? ql : mat == 2 ? bh : bl;
    const int grow = (mat < 2 ? q0 : b0) + row;
    const bool ok = grow < (mat < 2 ? n : m);
    const __nv_bfloat16* src = base + (size_t)(ok ? grow : 0) * dp + kc * kBK + part * 8;
    cp_async16(stage + mat * kMatElems + row * kLd + part * 8, src, ok ? 16 : 0);
  }
  cp_async_commit();
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
knn_tiled_partial_kernel(const __nv_bfloat16* __restrict__ qh, const __nv_bfloat16* __restrict__ ql,
                         const __nv_bfloat16* __restrict__ bh, const __nv_bfloat16* __restrict__ bl,
                         float* __restrict__ partial, int n, int m, int dp, int tiles_per_split,
                         int splits) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
  float* sims = reinterpret_cast<float*>(smem);  // [kBQ][kSimLd], after a tile's GEMM

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBQ;
  const int split = blockIdx.y;
  const int n_tiles = (m + kBM - 1) / kBM;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int nk = dp / kBK;

  // GEMM layout: warp (wr, wc) owns output rows wr*32.. and cols wc*64..
  const int wr = warp % 4, wc = warp / 4;
  // top-k layout: thread owns query row (warp % 4) * 32 + lane, half warp / 4
  const int my_row = (warp % 4) * 32 + lane;
  const int my_half = warp / 4;

  float top[K];
#pragma unroll
  for (int i = 0; i < K; ++i) top[i] = -CUDART_INF_F;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int b0 = tile * kBM;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    load_stage(stages, qh, ql, bh, bl, q0, b0, 0, n, m, dp);
    for (int kc = 0; kc < nk; ++kc) {
      if (kc + 1 < nk) {
        load_stage(stages + ((kc + 1) & 1) * kStageElems, qh, ql, bh, bl, q0, b0, kc + 1, n, m,
                   dp);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* st = stages + (kc & 1) * kStageElems;
      const __nv_bfloat16* sqh = st;
      const __nv_bfloat16* sql = st + kMatElems;
      const __nv_bfloat16* sbh = st + 2 * kMatElems;
      const __nv_bfloat16* sbl = st + 3 * kMatElems;
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> ah[2], al[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int off = (wr * 32 + i * 16) * kLd + ks * 16;
          wmma::load_matrix_sync(ah[i], sqh + off, kLd);
          wmma::load_matrix_sync(al[i], sql + off, kLd);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // B = bank slice^T: (k, col) is row col of the slice, a col-major view
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bhf, blf;
          const int off = (wc * 64 + j * 16) * kLd + ks * 16;
          wmma::load_matrix_sync(bhf, sbh + off, kLd);
          wmma::load_matrix_sync(blf, sbl + off, kLd);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            // this 16-deep step's three products into a fresh accumulator,
            // then one IEEE f32 add per element into the running sum
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> step;
            wmma::fill_fragment(step, 0.f);
            wmma::mma_sync(step, al[i], bhf, step);
            wmma::mma_sync(step, ah[i], blf, step);
            wmma::mma_sync(step, ah[i], bhf, step);
#pragma unroll
            for (int t = 0; t < step.num_elements; ++t) acc[i][j].x[t] += step.x[t];
          }
        }
      }
      __syncthreads();  // the next iteration refills this stage
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(sims + (wr * 32 + i * 16) * kSimLd + wc * 64 + j * 16, acc[i][j],
                                kSimLd, wmma::mem_row_major);
    __syncthreads();
    const float* srow = sims + my_row * kSimLd + my_half * 64;
    const int valid = min(64, m - (b0 + my_half * 64));  // columns of real bank rows
#pragma unroll 4
    for (int c = 0; c < 64; ++c) {
      const int col = (c + lane) & 63;  // lane-rotated: conflict-free reads
      if (col < valid) topk_insert<K>(top, srow[col]);
    }
    __syncthreads();  // the next tile's copies overwrite the similarity tile
  }

  // merge the two halves of each row, then write this split's top-k
  float* s_top = reinterpret_cast<float*>(smem);  // [2][kBQ][K]
#pragma unroll
  for (int i = 0; i < K; ++i) s_top[(my_half * kBQ + my_row) * K + i] = top[i];
  __syncthreads();
  if (threadIdx.x < kBQ) {
    const int r = threadIdx.x;
    const int qi = q0 + r;
    if (qi < n) {
      float t[K];
#pragma unroll
      for (int i = 0; i < K; ++i) t[i] = s_top[r * K + i];
#pragma unroll
      for (int i = 0; i < K; ++i) topk_insert<K>(t, s_top[(kBQ + r) * K + i]);
      float* dst = partial + ((size_t)qi * splits + split) * K;
#pragma unroll
      for (int i = 0; i < K; ++i) dst[i] = t[i];
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kMergeThreads)
knn_tiled_merge_kernel(const float* __restrict__ partial, float* __restrict__ out, int n,
                       int splits) {
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
int launch(const __nv_bfloat16* qh, const __nv_bfloat16* ql, const __nv_bfloat16* bh,
           const __nv_bfloat16* bl, float* partial, float* out, int n, int m, int dp,
           int tiles_per_split, int splits, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(knn_tiled_partial_kernel<K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + kBQ - 1) / kBQ, splits);
  knn_tiled_partial_kernel<K><<<grid, kThreads, kSmemBytes, stream>>>(
      qh, ql, bh, bl, partial, n, m, dp, tiles_per_split, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  knn_tiled_merge_kernel<K><<<(n + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0,
                              stream>>>(partial, out, n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssad_knn_tiled_scores(const void* qh, const void* ql, const void* bh,
                                     const void* bl, float* partial, float* out, int n, int m,
                                     int dp, int k, int tiles_per_split, int splits,
                                     void* stream) {
  if (n <= 0 || m <= 0 || dp <= 0 || dp % kBK != 0) return (int)cudaErrorInvalidValue;
  const auto* a = static_cast<const __nv_bfloat16*>(qh);
  const auto* b = static_cast<const __nv_bfloat16*>(ql);
  const auto* c = static_cast<const __nv_bfloat16*>(bh);
  const auto* d = static_cast<const __nv_bfloat16*>(bl);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(a, b, c, d, partial, out, n, m, dp, tiles_per_split, splits, s);
    case 2: return launch<2>(a, b, c, d, partial, out, n, m, dp, tiles_per_split, splits, s);
    case 3: return launch<3>(a, b, c, d, partial, out, n, m, dp, tiles_per_split, splits, s);
    case 4: return launch<4>(a, b, c, d, partial, out, n, m, dp, tiles_per_split, splits, s);
    case 5: return launch<5>(a, b, c, d, partial, out, n, m, dp, tiles_per_split, splits, s);
    case 6: return launch<6>(a, b, c, d, partial, out, n, m, dp, tiles_per_split, splits, s);
    case 7: return launch<7>(a, b, c, d, partial, out, n, m, dp, tiles_per_split, splits, s);
    case 8: return launch<8>(a, b, c, d, partial, out, n, m, dp, tiles_per_split, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
