// Streaming k-NN cosine scoring for Hopper (sm_90a) with bf16x3
// similarities: mean of the k largest similarities per query, as
// 1 - mean(top-k), for banks of any size.
//
// Replaces the Pallas TPU kernel `_knn_tiled_kernel`
// (ssad_tpu/ops/knn.py:165-227, launched by knn_cosine_scores_pallas_tiled
// at :230-276).  Same function: the caller passes the L2-normalised
// queries (N, D) and bank (M, D), each split by bit masking into a bf16
// pair (hi = x with its low 16 bits cleared, lo = bf16(x - hi); :149-162),
// and the similarity is ql.bh + qh.bl + qh.bh accumulated in f32 (the
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
// never leaves the registers.
//
// Design.
//   Stage 1: grid (query tiles of 128) x (bank splits), query tiles
//     fastest, so the CTAs resident at one time walk the same few bank
//     splits and the bank comes from device memory about once per wave.
//     A CTA walks the 128-row bank tiles of its split.  Per tile and per
//     64-deep slice of D, the four bf16 operand slices (qh, ql: 128 query
//     rows; bh, bl: 128 bank rows; 128 bytes a row, 128-byte swizzled)
//     land in a 3-stage ring of shared memory.  Two consumer warpgroups
//     own 64 query rows each and run wgmma m64n128k16 bf16 -> f32 on
//     them, A and B read from shared memory through matrix descriptors
//     (both K-major).  One producer warp fills the ring with TMA loads
//     (tensor maps with 128-byte swizzle; rows past N or M read as zeros)
//     against mbarrier full/empty pairs, and gives its registers to the
//     consumers (setmaxnreg 40 / 232).
//     After the tile's last slice each thread holds 2 query rows x 32
//     bank columns of similarities in registers (the accumulator layout
//     of the PTX ISA) and inserts them into two running top-k lists (a
//     max/min cascade).  A row's values are visited only when their
//     maximum beats the row's k-th value, which after the first tiles
//     almost never happens: the top-k then costs a max over 32 registers
//     per row and tile.  No similarity goes to shared or device memory.
//     A warpgroup keeps a group of products in flight while it adds the
//     previous one into its running sum and runs a tile's top-k (two
//     fresh accumulators, see Accuracy), so the tensor cores do not wait
//     for either.  At the end of its split each quad of lanes that
//     shares a row merges its lists by shuffles and writes (N, splits, k)
//     partial top-k values.
//   Stage 2: one thread per query merges its splits * k candidates.
// The wrapper (ops/knn.py `_tiled_plan`) picks the splits that keep the
// last wave's idle SMs few.
//
// Accuracy.  The tensor cores' f32 accumulation is not an IEEE sum: a
// product added to a large accumulator can lose its low bits.  Over all 96
// products of D = 512 in one accumulator the error grows with the
// similarity, to 7e-6 at cos ~ 1 (measured on an H100).  So each group of
// kGroup 16-deep steps sums its three products per step into a fresh
// accumulator (scale-d = 0 on its first wgmma; order ql.bh, qh.bl,
// qh.bh), which is then added to the running sum with IEEE f32 adds.
// kGroup is 4, one 64-deep slice; -DSSAD_KNN_TILED_GROUP=1 builds the
// finer variant for accuracy readings (scripts/torch_patch_margin.py).
//
// C interface (bound with ctypes): ssad_knn_tiled_scores returns the
// cudaError_t of the launches (0 on success).  It launches on the given
// stream, does not synchronise and allocates nothing: the caller passes
// the split operands (D padded to a multiple of 64 with zeros), the
// (N, splits, k) partial buffer and the (N,) output.  The TMA tensor maps
// are encoded on the host per call (cuTensorMapEncodeTiled, reached
// through the runtime's driver entry point, so no -lcuda).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;                          // queries per CTA: two warpgroups of 64
constexpr int kBN = 128;                          // bank rows per tile: the wgmma's N
constexpr int kBK = 64;                           // depth of a slice: 128 bytes of bf16
constexpr int kStages = 3;                        // slices in flight
constexpr int kConsumerThreads = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup (one warp works)
constexpr int kOpBytes = kBQ * kBK * 2;           // one operand slice: 16 KB
constexpr int kStageBytes = 4 * kOpBytes;         // qh, ql, bh, bl: 64 KB
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + room to align to 1024
constexpr int kHalfBytes = 64 * kBK * 2;          // one warpgroup's 64 query rows: 8 KB
constexpr int kMaxK = 8;
constexpr int kMergeThreads = 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
#ifndef SSAD_KNN_TILED_GROUP
#define SSAD_KNN_TILED_GROUP 4
#endif
constexpr int kGroup = SSAD_KNN_TILED_GROUP;  // 16-deep steps per fresh accumulator

static_assert(kBK % (16 * kGroup) == 0, "a slice holds whole groups");
static_assert(kSmemBytes + 2 * kStages * 8 <= 227 * 1024, "one CTA fits an SM's shared memory");
static_assert(kBQ == kBN, "one slice shape (and one TMA box) for queries and bank");
static_assert(kBK * 2 == 128, "a slice row is one 128-byte swizzle row");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---- wgmma ------------------------------------------------------------------

// descriptor of a K-major operand in shared memory: rows of 128 bytes,
// 128-byte swizzle, 8-row groups 1024 bytes apart (SBO), LBO unused (1)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of d across a wgmma
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 16, K-major) * B (16 x 128, K-major), bf16 -> f32
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Issue one group of the products: kGroup 16-deep steps from step `first` of
// the slice, three wgmmas a step (ql.bh, qh.bl, qh.bh) into the fresh
// accumulator f (scale-d = 0 on the first).  Addresses: this warpgroup's
// 64 query rows of qh and ql, and the 128 bank rows of bh and bl.
__device__ __forceinline__ void issue_group(float (&f)[64], uint32_t qh, uint32_t ql, uint32_t bh,
                                            uint32_t bl, int first) {
  const uint64_t dqh = smem_desc(qh), dql = smem_desc(ql);
  const uint64_t dbh = smem_desc(bh), dbl = smem_desc(bl);
  fence_operands(f);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kGroup; ++s) {
    const uint64_t step = 2 * (first + s);  // 32 bytes a step, in the descriptor's 16-byte units
    wgmma_m64n128k16(f, dql + step, dbh + step, s != 0);
    wgmma_m64n128k16(f, dqh + step, dbl + step, 1);
    wgmma_m64n128k16(f, dqh + step, dbh + step, 1);
  }
  wgmma_commit();
}

// ---- top-k --------------------------------------------------------------------

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

// insert the values of one row that beat its k-th value (rare after the
// first tiles, so the caller tests the row's maximum first)
template <int K, int H>
__device__ __forceinline__ void topk_row(float (&t)[K], const float (&r)[64]) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float v = r[4 * j + 2 * H + c];
      if (v > t[K - 1]) topk_insert<K>(t, v);
    }
  }
}

// The tile's similarities, straight from the accumulator: r[4j + 2h + c]
// is row (lane / 4 + 8h) of the warp's 16, column 8j + 2(lane % 4) + c.
// col is this thread's first column in the bank (b0 + 2(lane % 4)); a
// partial last tile masks its columns at or past m.
template <int K>
__device__ __forceinline__ void topk_tile(float (&t0)[K], float (&t1)[K], float (&r)[64], int col,
                                          int m, bool full) {
  if (!full) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (col + 8 * j + c >= m) r[4 * j + c] = r[4 * j + 2 + c] = -CUDART_INF_F;
  }
  // each row's maximum, in four independent chains
  float x0[4], x1[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    x0[a] = fmaxf(r[4 * a], r[4 * a + 1]);
    x1[a] = fmaxf(r[4 * a + 2], r[4 * a + 3]);
  }
#pragma unroll
  for (int j = 4; j < kBN / 8; ++j) {
    x0[j % 4] = fmaxf(x0[j % 4], fmaxf(r[4 * j], r[4 * j + 1]));
    x1[j % 4] = fmaxf(x1[j % 4], fmaxf(r[4 * j + 2], r[4 * j + 3]));
  }
  if (fmaxf(fmaxf(x0[0], x0[1]), fmaxf(x0[2], x0[3])) > t0[K - 1]) topk_row<K, 0>(t0, r);
  if (fmaxf(fmaxf(x1[0], x1[1]), fmaxf(x1[2], x1[3])) > t1[K - 1]) topk_row<K, 1>(t1, r);
}

// merge the lists of the 4 lanes that share a row, then one lane writes
// the split's top-k of its two rows
template <int K>
__device__ __forceinline__ void write_partial(float (&t0)[K], float (&t1)[K], float* partial,
                                              int row0, int n, int split, int splits) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    float o0[K], o1[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      o0[i] = __shfl_xor_sync(0xffffffffu, t0[i], off);
      o1[i] = __shfl_xor_sync(0xffffffffu, t1[i], off);
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {
      topk_insert<K>(t0, o0[i]);
      topk_insert<K>(t1, o1[i]);
    }
  }
  if ((threadIdx.x & 3) == 0) {
    if (row0 < n) {
      float* dst = partial + ((size_t)row0 * splits + split) * K;
#pragma unroll
      for (int i = 0; i < K; ++i) dst[i] = t0[i];
    }
    if (row0 + 8 < n) {
      float* dst = partial + ((size_t)(row0 + 8) * splits + split) * K;
#pragma unroll
      for (int i = 0; i < K; ++i) dst[i] = t1[i];
    }
  }
}

// ---- mbarriers and TMA ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that
// outlasts ~4e9 cycles traps (a launch error, not a hung card)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 32)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                         int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- the kernels ------------------------------------------------------------------

// TMA producer warp + two consumer warpgroups
template <int K>
__global__ void __launch_bounds__(kThreads, 1)
knn_tiled_partial_kernel(const __grid_constant__ CUtensorMap qh_map,
                         const __grid_constant__ CUtensorMap ql_map,
                         const __grid_constant__ CUtensorMap bh_map,
                         const __grid_constant__ CUtensorMap bl_map, float* __restrict__ partial,
                         int n, int m, int dp, int tiles_per_split, int splits) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  unsigned char* ring = align1024(smem_raw);
  const int q0 = blockIdx.x * kBQ, split = blockIdx.y, nk = dp / kBK;
  const int t_begin = split * tiles_per_split;  // this CTA's bank tiles, and its 64-deep slices
  const int n_slices = (min((m + kBN - 1) / kBN, t_begin + tiles_per_split) - t_begin) * nk;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads / 32);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      for (int i = 0; i < n_slices; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        unsigned char* stage = ring + s * kStageBytes;
        const int x = (i % nk) * kBK, b0 = (t_begin + i / nk) * kBN;
        mbar_arrive_expect_tx(&full[s], kStageBytes);
        tma_load(stage, &qh_map, &full[s], x, q0);
        tma_load(stage + kOpBytes, &ql_map, &full[s], x, q0);
        tma_load(stage + 2 * kOpBytes, &bh_map, &full[s], x, b0);
        tma_load(stage + 3 * kOpBytes, &bl_map, &full[s], x, b0);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    // Groups of kGroup 16-deep steps alternate between the fresh accumulators f
    // and g: group j + 1 is issued before group j is added into the
    // running sum r (and, after a tile's last group, before the tile's
    // top-k), so the tensor cores work while this warpgroup adds.
    float r[64], f[64], g[64], t0[K], t1[K];
#pragma unroll
    for (int j = 0; j < 64; ++j) r[j] = f[j] = g[j] = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) t0[j] = t1[j] = -CUDART_INF_F;
    const uint32_t half = (threadIdx.x / 128) * kHalfBytes;  // this warpgroup's query rows
    constexpr int kGroups = kBK / 16 / kGroup;               // groups per slice
    const int n_groups = n_slices * kGroups;
    auto issue = [&](float(&acc)[64], int j) {
      const int i = j / kGroups, s = i % kStages;
      if (j % kGroups == 0) mbar_wait(&full[s], (i / kStages) & 1);
      const uint32_t stage = smem_u32(ring + s * kStageBytes);
      issue_group(acc, stage + half, stage + kOpBytes + half, stage + 2 * kOpBytes,
                  stage + 3 * kOpBytes, (j % kGroups) * kGroup);
    };
    auto finish = [&](float(&acc)[64], int j) {
      fence_operands(acc);
      const int i = j / kGroups, kc = i % nk;
      const bool last = j % kGroups == kGroups - 1;
      if (last && (threadIdx.x & 31) == 0) mbar_arrive(&empty[i % kStages]);  // refill it
      if (kc == 0 && j % kGroups == 0) {
#pragma unroll
        for (int x = 0; x < 64; ++x) r[x] = 0.f;
      }
#pragma unroll
      for (int x = 0; x < 64; ++x) r[x] += acc[x];
      if (last && kc == nk - 1) {
        const int b0 = (t_begin + i / nk) * kBN;
        topk_tile<K>(t0, t1, r, b0 + 2 * (threadIdx.x & 3), m, b0 + kBN <= m);
      }
    };
    // the first pair outside the loop, so that at every read of f or g
    // the waits before it visibly cover that accumulator's group
    issue(f, 0);
    if (n_groups > 1) {
      issue(g, 1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    finish(f, 0);
    for (int j = 2; j < n_groups; j += 2) {
      issue(f, j);
      wgmma_wait<1>();
      finish(g, j - 1);
      if (j + 1 < n_groups) {
        issue(g, j + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      finish(f, j);
    }
    if (n_groups % 2 == 0) {
      wgmma_wait<0>();
      finish(g, n_groups - 1);
    }
    const int t = threadIdx.x;  // rows of the accumulator layout: warp w of its group, 16 w..
    write_partial<K>(t0, t1, partial, q0 + (t / 128) * 64 + (t % 128) / 32 * 16 + (t % 32) / 4,
                     n, split, splits);
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

// ---- host side ----------------------------------------------------------------------

struct Operands {
  const void *qh, *ql, *bh, *bl;
  float *partial, *out;
  int n, m, dp, tiles_per_split, splits;
};

// a 2-D bf16 tensor map of (rows, dp) with 128 x 64 boxes, 128-byte swizzle;
// rows past the end read as zeros
cudaError_t encode_map(CUtensorMap* map, const void* ptr, int rows, int dp) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                            &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)dp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)dp * 2};
  const cuuint32_t box[2] = {kBK, kBQ};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a kernel's shared-memory attribute, set once per device
template <typename Kernel>
cudaError_t configure(Kernel kernel, bool (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

template <int K>
int launch(const Operands& o, cudaStream_t stream) {
  static bool configured[64] = {};
  CUtensorMap maps[4];
  const void* ptrs[4] = {o.qh, o.ql, o.bh, o.bl};
  cudaError_t e;
  for (int i = 0; i < 4; ++i)
    if ((e = encode_map(&maps[i], ptrs[i], i < 2 ? o.n : o.m, o.dp)) != cudaSuccess) return (int)e;
  if ((e = configure(knn_tiled_partial_kernel<K>, configured)) != cudaSuccess) return (int)e;
  const dim3 grid((o.n + kBQ - 1) / kBQ, o.splits);
  knn_tiled_partial_kernel<K><<<grid, kThreads, kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], o.partial, o.n, o.m, o.dp, o.tiles_per_split, o.splits);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  knn_tiled_merge_kernel<K><<<(o.n + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0,
                              stream>>>(o.partial, o.out, o.n, o.splits);
  return (int)cudaGetLastError();
}

int launch_k(const Operands& o, int k, cudaStream_t s) {
  switch (k) {
    case 1: return launch<1>(o, s);
    case 2: return launch<2>(o, s);
    case 3: return launch<3>(o, s);
    case 4: return launch<4>(o, s);
    case 5: return launch<5>(o, s);
    case 6: return launch<6>(o, s);
    case 7: return launch<7>(o, s);
    case 8: return launch<8>(o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// runs fn on `device`, restoring the caller's current device afterwards
template <typename Fn>
int on_device(int device, Fn fn) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return (int)e;
  if (cur != device && (e = cudaSetDevice(device)) != cudaSuccess) return (int)e;
  const int status = fn();
  if (cur != device) cudaSetDevice(cur);
  return status;
}

}  // namespace

extern "C" int ssad_knn_tiled_scores(const void* qh, const void* ql, const void* bh,
                                     const void* bl, float* partial, float* out, int n, int m,
                                     int dp, int k, int tiles_per_split, int splits, int device,
                                     void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(qh) | reinterpret_cast<uintptr_t>(ql) |
                         reinterpret_cast<uintptr_t>(bh) | reinterpret_cast<uintptr_t>(bl);
  const long long tiles = (m + (long long)kBN - 1) / kBN;
  if (n <= 0 || m <= 0 || dp <= 0 || dp % kBK != 0 || k < 1 || k > kMaxK || k > m ||
      tiles_per_split < 1 || splits < 1 || (long long)tiles_per_split * splits < tiles ||
      (long long)tiles_per_split * (splits - 1) >= tiles || ptrs % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Operands o = {qh, ql, bh, bl, partial, out, n, m, dp, tiles_per_split, splits};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() { return launch_k(o, k, s); });
}

// CTAs of the partial kernel resident per SM (the occupancy calculator)
extern "C" int ssad_knn_tiled_occupancy(int device, int* blocks) {
  return on_device(device, [&]() {
    static bool configured[64] = {};
    const cudaError_t e = configure(knn_tiled_partial_kernel<3>, configured);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, knn_tiled_partial_kernel<3>, kThreads, kSmemBytes);
  });
}

// the depth of a fresh accumulator's group, in elements (16 per step)
extern "C" int ssad_knn_tiled_group_depth() { return 16 * kGroup; }
