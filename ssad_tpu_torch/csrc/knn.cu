// k-NN cosine scoring for Hopper (sm_90a): mean of the k largest cosine
// similarities per query, as 1 - mean(top-k).
//
// Replaces the resident Pallas TPU kernel `_knn_kernel`
// (ssad_tpu/ops/knn.py:42-77, launched by knn_cosine_scores_pallas at
// :84-119).  Same function: L2-normalised f32 queries (N, D) against an
// L2-normalised f32 bank (M, D), both divided by max(|x|, 1e-12), sims in
// IEEE f32 FMAs (no TF32, no bf16), top-k of VALUES that counts duplicate
// bank rows separately, output 1 - (t0 + ... + t_{k-1}) / k summed largest
// first, 1 <= k <= 8.
//
// What bounds it on this card.  On the image path N = 8 (a request batch)
// or 300 (the fit), M = 700, D = 512: 1.4 MB of bank against 5.7 or 215
// MFLOP, so by bytes at N = 8 (0.43 us) and by the f32 FMA rate at
// N = 300 (3.2 us).  At these sizes launch and memory latency weigh more
// than either bound, so the design is one launch that puts the bank
// across many SMs and keeps several slices of it in flight.
//
// Design.  One launch; grid (cluster size, query tiles), one thread-block
// cluster per query tile of BQ (8, 16 or 32) queries, picked by N.
//   * Each CTA of a cluster takes a contiguous share of the bank rows
//     (at most about 100 KB of it at D = 512) and walks it in chunks of 48
//     rows.  For a chunk it streams D in slices of BK = 2048 / BQ floats:
//     the query and bank slices are copied into shared memory as rows,
//     with 16-byte cp.async in a ring of three stages.
//   * Register tiling: each of the 192 threads owns 8 queries x 8 bank
//     rows of dot products over two 16-byte pieces of every slice; the
//     KS = 256 / BQ depth groups split a slice, so that a small query tile
//     still keeps every thread busy.  Per piece a thread reads 8 + 8
//     float4s and does 256 FMAs: every shared-memory value feeds 8 FMAs.
//     Query pieces are XOR-swizzled by row so that a quarter warp's reads
//     do not collide on banks.  In the same pass four lanes per row sum the
//     squares of each bank row and query row.  At most 168 registers, so
//     two CTAs fit an SM and a 16-CTA cluster finds room in a GPC.
//   * The depth groups' partial sums meet in shared memory (aliasing the
//     stages); they are summed in order and divided by the two norms, and
//     four lanes per query insert the chunk's similarities into running
//     top-k lists of 8 values (a max/min cascade, so every row counts on
//     its own).
//   * After the last chunk the four lanes merge their lists by warp
//     shuffles and bitonic merges of sorted lists, and write the CTA's
//     list into rank 0's shared memory through distributed shared memory.
//     After one cluster.sync() rank 0's lanes (each a quarter of the
//     ranks) merge the lists the same way and write the scores.  No
//     partial buffer reaches device memory.
// Why this shape: with 4-byte transposed copies, and then with a 4 x 4
// tile, the CTAs were held by their copy and shared-memory instruction
// rates; with 256 threads and 64-row chunks one CTA filled an SM, a GPC
// then held one cluster, and the fit's ten clusters ran in two waves.
//
// C interface (bound with ctypes): ssad_knn_cosine_scores returns the
// cudaError_t of the launch (0 on success).  It launches on the given
// stream and device, does not synchronise and allocates nothing: the
// caller passes 16-byte aligned operands with D a multiple of 4, the (N,)
// output and the launch plan (query tile, cluster size, rows per CTA;
// ssad_tpu_torch/ops/knn.py::_plan).
// ssad_knn_occupancy reports how many such clusters the card holds at once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 192;
constexpr int kBM = 48;        // bank rows per chunk
constexpr int kStages = 3;     // ring of staged slices
constexpr int kSteps = 2;      // float4 steps per thread and slice
constexpr int kMinBlocks = 2;  // CTAs per SM the registers must allow
constexpr int kTQ = 8;         // queries per thread
constexpr int kTM = 8;         // bank rows per thread
constexpr int kMG = kBM / kTM; // row groups (6)
constexpr int kMaxK = 8;
constexpr int kMaxCluster = 16;  // CTAs per cluster (non-portable size)
constexpr int kLanesPerQuery = 4;  // top-k lanes per query, neighbours in a warp
constexpr int kRP = kBM + 1;   // pitch of the depth groups' partial sums
constexpr int kNormLanes = kThreads / kBM;  // neighbouring lanes per row for the norms (4)
constexpr float kEps = 1e-12f;
static_assert(kNormLanes * kBM == kThreads && 32 % kNormLanes == 0, "norm lanes in warps");

template <int BQ>
struct Tile {
  static constexpr int QG = BQ / kTQ;             // query groups
  static constexpr int KS = kThreads / (QG * kMG);  // depth groups: 32, 16, 8
  static constexpr int BK = 4 * kSteps * KS;      // slice depth: kSteps float4s per group
  static constexpr int SP = BK + 4;               // slice row pitch: 16-byte rows
  static constexpr int VECS = BK / 4;             // 16-byte pieces of a slice row
  static constexpr int NV = BK / kNormLanes;      // values per norm lane and slice
  static constexpr int kStageFloats = kStages * (BQ + kBM) * SP;
  static constexpr int kRedFloats = KS * BQ * kRP;  // aliases the stages after the loop
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kStageFloats > kRedFloats ? kStageFloats : kRedFloats);
  static_assert(QG * kMG * KS == kThreads, "one micro-tile per thread");
  static_assert(NV % 4 == 0, "float4 norm reads");
  static_assert(BQ * kLanesPerQuery <= kThreads && BQ * kLanesPerQuery % 32 == 0 &&
                    BQ * kNormLanes % 32 == 0,
                "whole warps of top-k and query-norm lanes");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

// insert v into t[0] >= t[1] >= ... >= t[7]; the smallest falls off
__device__ __forceinline__ void topk_insert(float (&t)[kMaxK], float v) {
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) {
    const float hi = fmaxf(t[i], v);
    v = fminf(t[i], v);
    t[i] = hi;
  }
}

// the squares of NV values of a slice row: the pieces p, p + 4 lanes, ...
template <int NV>
__device__ __forceinline__ float sumsq(const float* p, float acc) {
#pragma unroll
  for (int v = 0; v < NV; v += 4) {
    const float4 u = *reinterpret_cast<const float4*>(p + 4 * v);
    acc = fmaf(u.x, u.x, acc);
    acc = fmaf(u.y, u.y, acc);
    acc = fmaf(u.z, u.z, acc);
    acc = fmaf(u.w, u.w, acc);
  }
  return acc;
}

// a[] <- the 8 largest of a[] and b[], both sorted largest first: the
// elementwise max of a and reversed b is bitonic and holds the 8 largest;
// three half-cleaner stages sort it
__device__ __forceinline__ void merge_sorted(float (&a)[kMaxK], const float (&b)[kMaxK]) {
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) a[i] = fmaxf(a[i], b[kMaxK - 1 - i]);
#pragma unroll
  for (int j = kMaxK / 2; j > 0; j >>= 1)
#pragma unroll
    for (int i = 0; i < kMaxK; ++i)
      if ((i & j) == 0) {
        const float hi = fmaxf(a[i], a[i + j]);
        a[i + j] = fminf(a[i], a[i + j]);
        a[i] = hi;
      }
}

// merge the lists of each group of kLanesPerQuery neighbouring lanes;
// every lane of the group ends with the group's list (whole warps call it)
__device__ __forceinline__ void merge_lanes(float (&t)[kMaxK]) {
#pragma unroll
  for (int off = 1; off < kLanesPerQuery; off <<= 1) {
    float u[kMaxK];
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) u[i] = __shfl_xor_sync(0xffffffffu, t[i], off);
    merge_sorted(t, u);
  }
}

// 16-byte piece `chunk` of query row r lies at piece chunk ^ (r / 8): the
// threads of a quarter warp read query rows 8 apart, which would otherwise
// fall on the same banks
template <int BQ>
__device__ __forceinline__ int swizzle(int r, int chunk) {
  return chunk ^ ((r / kTQ) & (Tile<BQ>::VECS - 1));
}

// copy depth slice kc of the query tile and of the chunk's bank rows into
// ring stage `st` as [row][depth], 16 bytes per copy; rows and depth past
// the ends are zero-filled (D is a multiple of 4).  Always commits one
// group (empty past the end).
template <int BQ>
__device__ __forceinline__ void load_slice(float* qs, float* bs, const float* __restrict__ q,
                                           const float* __restrict__ b, int q0, int n, int c0,
                                           int r_end, int d, int kc, int nk, int st) {
  using T = Tile<BQ>;
  if (kc < nk) {
    const int k0 = kc * T::BK;
    float* qd = qs + st * BQ * T::SP;
    float* bd = bs + st * kBM * T::SP;
    for (int i = threadIdx.x; i < (BQ + kBM) * T::VECS; i += kThreads) {
      const int r = i / T::VECS, v = (i % T::VECS) * 4, col = k0 + v;
      if (r < BQ) {
        const bool ok = q0 + r < n && col < d;
        cp_async16(qd + r * T::SP + swizzle<BQ>(r, v / 4) * 4,
                   ok ? q + (size_t)(q0 + r) * d + col : q, ok);
      } else {
        const int br = r - BQ;
        const bool ok = c0 + br < r_end && col < d;
        cp_async16(bd + br * T::SP + v, ok ? b + (size_t)(c0 + br) * d + col : b, ok);
      }
    }
  }
  cp_async_commit();
}

template <int BQ>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
knn_cluster_kernel(const float* __restrict__ q, const float* __restrict__ b,
                   float* __restrict__ out, int n, int m, int d, int k, int rows_per_cta) {
  using T = Tile<BQ>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                              // [kStages][BQ][SP]
  float* bs = qs + kStages * BQ * T::SP;         // [kStages][kBM][SP]
  float* red = smem;                             // [KS][BQ][kRP], after a chunk's slices
  __shared__ float qss[BQ];
  __shared__ float bss[kBM];
  __shared__ __align__(16) float lists[kMaxCluster * BQ * kMaxK];  // rank 0: every CTA's

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int r_begin = min(m, rank * rows_per_cta);
  const int r_end = min(m, r_begin + rows_per_cta);
  const int nk = (d + T::BK - 1) / T::BK;

  // dot-product layout: thread (tm, tq, ks) owns bank rows tm + 6 i,
  // queries 8 tq .. 8 tq + 7 and the 16-byte pieces ks * kSteps .. of
  // every slice
  const int tm = tid % kMG;
  const int tq = (tid / kMG) % T::QG;
  const int ks = tid / (kMG * T::QG);
  // norm layout: four neighbouring lanes per row of a slice, lane npart
  // takes the pieces npart + 4 v (the four cover the row whatever the
  // swizzle)
  const int nrow = tid / kNormLanes;
  const int npart = tid % kNormLanes;
  // top-k layout: the first BQ * 4 threads, four lanes per query; lane
  // my_part takes chunk columns my_part + 4 c
  const int my_q = tid / kLanesPerQuery;
  const int my_part = tid % kLanesPerQuery;

  float top[kMaxK];
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) top[i] = -CUDART_INF_F;

  for (int c0 = r_begin; c0 < r_end; c0 += kBM) {
    float acc[kTQ][kTM];
#pragma unroll
    for (int j = 0; j < kTQ; ++j)
#pragma unroll
      for (int i = 0; i < kTM; ++i) acc[j][i] = 0.f;
    float bsq = 0.f, qsq = 0.f;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) load_slice<BQ>(qs, bs, q, b, q0, n, c0, r_end, d, s, nk, s);

    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait_ring();
      __syncthreads();
      // refill the stage read in the previous iteration: every thread has
      // passed this iteration's barrier, so it is free
      load_slice<BQ>(qs, bs, q, b, q0, n, c0, r_end, d, kc + kStages - 1, nk,
                     (kc + kStages - 1) % kStages);
      const int st = kc % kStages;
      const float* qsl = qs + st * BQ * T::SP;
      const float* bsl = bs + st * kBM * T::SP;
#pragma unroll
      for (int step = 0; step < kSteps; ++step) {
        const int chunk = ks * kSteps + step;
        const int qchunk = swizzle<BQ>(tq * kTQ, chunk);  // where the query float4s lie
        float4 bv[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          bv[i] = *reinterpret_cast<const float4*>(bsl + (tm + i * kMG) * T::SP + 4 * chunk);
#pragma unroll
        for (int j = 0; j < kTQ; ++j) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qsl + (tq * kTQ + j) * T::SP + 4 * qchunk);
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            acc[j][i] = fmaf(qv.x, bv[i].x, acc[j][i]);
            acc[j][i] = fmaf(qv.y, bv[i].y, acc[j][i]);
            acc[j][i] = fmaf(qv.z, bv[i].z, acc[j][i]);
            acc[j][i] = fmaf(qv.w, bv[i].w, acc[j][i]);
          }
        }
      }
      bsq = sumsq<T::NV>(bsl + nrow * T::SP + 4 * npart, bsq);
      if (nrow < BQ) qsq = sumsq<T::NV>(qsl + nrow * T::SP + 4 * npart, qsq);  // whole warps
    }
    __syncthreads();  // red aliases the stages

#pragma unroll
    for (int j = 0; j < kTQ; ++j)
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        red[(ks * BQ + tq * kTQ + j) * kRP + tm + i * kMG] = acc[j][i];
#pragma unroll
    for (int off = 1; off < kNormLanes; off <<= 1) {
      bsq += __shfl_xor_sync(0xffffffffu, bsq, off);
      qsq += __shfl_xor_sync(0xffffffffu, qsq, off);
    }
    if (npart == 0) {  // the divisors, max(|x|, 1e-12)
      bss[nrow] = fmaxf(sqrtf(bsq), kEps);
      if (nrow < BQ) qss[nrow] = fmaxf(sqrtf(qsq), kEps);
    }
    __syncthreads();

    // sum the depth groups in order and divide by the norms; the
    // similarity of (query qi, column col) goes to red[qi][col]
    for (int o = tid; o < BQ * kBM; o += kThreads) {
      const int qi = o / kBM, col = o % kBM;
      float sim = -CUDART_INF_F;
      if (c0 + col < r_end) {
        float dot = 0.f;
#pragma unroll
        for (int s = 0; s < T::KS; ++s) dot += red[(s * BQ + qi) * kRP + col];
        sim = dot / (qss[qi] * bss[col]);
      }
      red[qi * kRP + col] = sim;
    }
    __syncthreads();
    if (tid < BQ * kLanesPerQuery) {
#pragma unroll
      for (int c = 0; c < kBM / kLanesPerQuery; ++c)
        topk_insert(top, red[my_q * kRP + my_part + c * kLanesPerQuery]);
    }
    __syncthreads();  // the next chunk refills the stages that red aliases
  }

  // this CTA's list per query, from its four lanes' lists, written into
  // rank 0's shared memory through distributed shared memory
  merge_lanes(top);
  if (tid < BQ * kLanesPerQuery && my_part == 0) {
    float4* dst = reinterpret_cast<float4*>(
        cluster.map_shared_rank(lists, 0) + (rank * BQ + my_q) * kMaxK);
    dst[0] = make_float4(top[0], top[1], top[2], top[3]);
    dst[1] = make_float4(top[4], top[5], top[6], top[7]);
  }
  // the writes are visible to rank 0 after the barrier; no CTA reads
  // another's memory after it, so the others may exit
  cluster.sync();
  if (rank == 0 && tid < BQ * kLanesPerQuery) {  // whole warps
    // lane my_part merges the lists of ranks my_part, my_part + 4, ...;
    // then the four lanes merge
    const int ranks = static_cast<int>(cluster.num_blocks());
    float t[kMaxK];
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) t[i] = -CUDART_INF_F;
#pragma unroll
    for (int r0 = 0; r0 < kMaxCluster; r0 += kLanesPerQuery) {
      const int r = r0 + my_part;
      if (r < ranks) {
        const float4* src = reinterpret_cast<const float4*>(lists + (r * BQ + my_q) * kMaxK);
        const float4 lo = src[0], hi = src[1];
        const float u[kMaxK] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        merge_sorted(t, u);
      }
    }
    merge_lanes(t);
    if (my_part == 0 && q0 + my_q < n) {
      float total = 0.f;
      for (int i = 0; i < k; ++i) total += t[i];
      out[q0 + my_q] = 1.f - total / (float)k;
    }
  }
}

// the kernel's attributes, set once per device (setting them twice from
// two threads is harmless)
template <int BQ>
cudaError_t configure() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(knn_cluster_kernel<BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Tile<BQ>::kSmemBytes);
  if (e == cudaSuccess)  // clusters of up to 16 CTAs
    e = cudaFuncSetAttribute(knn_cluster_kernel<BQ>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

template <int BQ>
void fill_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int cluster, int tiles,
                 cudaStream_t stream) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster, tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Tile<BQ>::kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

template <int BQ>
int launch(const float* q, const float* b, float* out, int n, int m, int d, int k, int cluster,
           int rows_per_cta, cudaStream_t stream) {
  cudaError_t e = configure<BQ>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr = {};
  fill_config<BQ>(cfg, attr, cluster, (n + BQ - 1) / BQ, stream);
  e = cudaLaunchKernelEx(&cfg, knn_cluster_kernel<BQ>, q, b, out, n, m, d, k, rows_per_cta);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int BQ>
int occupancy(int cluster, int* active_clusters) {
  cudaError_t e = configure<BQ>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr = {};
  fill_config<BQ>(cfg, attr, cluster, 1, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(active_clusters, knn_cluster_kernel<BQ>, &cfg);
}

}  // namespace

extern "C" int ssad_knn_cosine_scores(const float* queries, const float* bank, float* out, int n,
                                      int m, int d, int k, int bq, int cluster, int rows_per_cta,
                                      int device, void* stream) {
  if (n <= 0 || m <= 0 || d <= 0 || d % 4 != 0 || k < 1 || k > kMaxK || k > m || cluster < 1 ||
      cluster > kMaxCluster || rows_per_cta < 1 || (long long)cluster * rows_per_cta < m ||
      (reinterpret_cast<uintptr_t>(queries) | reinterpret_cast<uintptr_t>(bank)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ssad::on_device(device, [&]() {
    switch (bq) {
      case 8: return launch<8>(queries, bank, out, n, m, d, k, cluster, rows_per_cta, s);
      case 16: return launch<16>(queries, bank, out, n, m, d, k, cluster, rows_per_cta, s);
      case 32: return launch<32>(queries, bank, out, n, m, d, k, cluster, rows_per_cta, s);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}

extern "C" int ssad_knn_occupancy(int bq, int cluster, int device, int* active_clusters) {
  return ssad::on_device(device, [&]() {
    switch (bq) {
      case 8: return occupancy<8>(cluster, active_clusters);
      case 16: return occupancy<16>(cluster, active_clusters);
      case 32: return occupancy<32>(cluster, active_clusters);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}
