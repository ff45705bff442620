// Fused folded stem for 32x32 patches on Hopper (sm_90a): 4x4/s1 conv
// with padding (2,1), inference BatchNorm affine, ReLU, round to bf16,
// 3x3/s2/pad-1 maxpool.  (N, 32, 32, 3) bf16 -> (N, 16, 16, 64) bf16,
// both channels last.
//
// Replaces the Pallas TPU kernel `_stem_pool_kernel`
// (ssad_tpu/ops/stem_pool.py:284-348, launched by stem_pool_pallas at
// :351-391).  Same function as its oracle stem_pool_xla (:245-259): the
// 48 taps of a pixel, in (ky, kx, c) order, are bf16 x bf16 products (each
// exact in f32) summed in f32; then y * scale' + bias' in f32 as a product
// then a sum, ReLU, one rounding to bf16 (RNE); the max of the rounded
// values over the 3x3 window.  Rounding is monotone, so pooling the
// rounded values equals rounding the pooled ones, and zero padding of the
// pool equals -inf padding because every value is >= 0 after the ReLU.
//
// What bounds it on this card.  At N = 6728 patches (one served batch of
// 8 images x 841 windows) it reads 41.3 MB of patches and writes 220.5 MB
// of pooled maps: 262 MB, 78 us at 3.35 TB/s.  It does 42.3 GFLOP, 43 us
// on bf16 tensor cores.  So it is bound by the bytes, provided the conv
// runs on the tensor cores and its 881 MB of output never leaves the SM.
//
// Design.  The conv of a patch is the product C(1024 x 64) = A(1024 x 48)
// . B(48 x 64), A the im2col rows, B the folded weights, done with
// mma.sync.m16n8k16 bf16 -> f32 (three 16-deep steps per 16-pixel tile).
//   * A block of 4 warps walks patches (a grid-stride loop over N, one
//     wave of blocks, so that B is loaded once per block).  Each lane
//     keeps its B fragments (48 registers) for the whole run.
//   * The patch is staged zero-padded, 35 x 35 x 3 bf16 (pitch 106), in
//     shared memory by 4-byte cp.async (zero-filled at the padding), one
//     patch ahead into a second buffer, so its load overlaps the previous
//     patch's work.  A lane gathers its A fragment elements straight from
//     it: the tap (ky, kx, c) of pixel (i, j) lies at (i + ky) * 106 +
//     j * 3 + kx * 3 + c, so no im2col tile is built.
//   * Row bands: the conv runs 8 rows at a time (16 m-tiles, 4 per warp).
//     The epilogue works on the accumulator registers (their layout is
//     fixed by the PTX ISA): affine, ReLU, RNE rounding, and a 4-byte store
//     into a ring of 9 bf16 conv rows (36 KB; row r in slot (r + 1) % 9).
//     Pooled rows 4b .. 4b + 3 need conv rows 8b - 1 .. 8b + 7, so the
//     previous band's last row stays in the ring as the halo.  16-byte
//     chunks of a row's 64 channels are XOR-swizzled with the pixel's low
//     bits, so both the epilogue's stores and the pool's reads are free of
//     bank conflicts.
//   * Pool: each thread walks one pooled column and 8 channels down the
//     band, taking each conv row's max over 3 columns once (__hmax2) and
//     the max of 3 such rows per pooled pixel, written with coalesced
//     16-byte stores.
//   About 52 KB of shared memory and at most 128 registers per thread, so
//   four blocks (16 warps) are resident per SM.
//
// Numerics.  The tensor cores' f32 accumulation inside an mma is not an
// IEEE sum; at K = 48 (three mma steps) an element whose f32 sum sits on a
// bf16 rounding boundary can round the other way.  The plain version's
// limit (rtol 2^-7, atol 1e-6, fewer than 1e-3 of elements not bit-equal)
// holds it.
//
// C interface (bound with ctypes): ssad_stem_pool returns the cudaError_t
// of the launch (0 on success).  It launches on the given stream and
// device, does not synchronise and allocates nothing; the weights come
// n-major, (64, 48) bf16.  ssad_stem_pool_occupancy reports the resident
// blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kSide = 32;                 // patch side
constexpr int kPadSide = 35;              // 2 + 32 + 1: the conv's (2, 1) padding
constexpr int kCin = 3;
constexpr int kXP = 106;                  // padded row pitch in bf16 (even: 4-byte stores)
constexpr int kTaps = 16 * kCin;          // 48 = the product's depth
constexpr int kChannels = 64;
constexpr int kPooledSide = 16;
constexpr int kThreads = 128;             // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;
constexpr int kBandRows = 8;              // conv rows per band
constexpr int kRing = kBandRows + 1;      // the band and its halo row
constexpr int kNTiles = kChannels / 8;    // n8 tiles of the product
constexpr int kKSteps = kTaps / 16;       // k16 steps of the product
constexpr int kChunks = kChannels / 8;    // 16-byte chunks of 8 bf16 per pixel

constexpr int kXsWords = kPadSide * kXP / 2;  // the padded patch, as 4-byte words
constexpr int kRingBytes = kRing * kSide * kChannels * 2;  // dynamic shared memory

static_assert(kTaps % 16 == 0, "whole k16 steps");
static_assert(kBandRows * 2 % kWarps == 0, "m16 tiles of a band split evenly over the warps");
static_assert(kPooledSide * kChunks == kThreads, "one pooled column and chunk per thread");

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float relu(float y) { return y > 0.f ? y : 0.f; }

__device__ __forceinline__ uint32_t pack_raw(unsigned short lo, unsigned short hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint4 max_bf16x8(uint4 a, uint4 b) {
  return make_uint4(max_bf16x2(a.x, b.x), max_bf16x2(a.y, b.y), max_bf16x2(a.z, b.z),
                    max_bf16x2(a.w, b.w));
}

// element offset of chunk `chunk` of ring pixel q (slot * 32 + column)
__device__ __forceinline__ int ring_offset(int q, int chunk) {
  return q * kChannels + ((chunk ^ (q & 7)) * 8);
}

// max of chunk `chunk` of conv row r over columns 2 oj - 1 .. 2 oj + 1
// (column -1 is the pool's padding: left out)
__device__ __forceinline__ uint4 row_max(const __nv_bfloat16* ring, int r, int oj, int chunk) {
  const int q = ((r + 1) % kRing) * kSide;
  const int c = 2 * oj;
  uint4 m = *reinterpret_cast<const uint4*>(ring + ring_offset(q + c, chunk));
  m = max_bf16x8(m, *reinterpret_cast<const uint4*>(ring + ring_offset(q + c + 1, chunk)));
  if (c > 0) m = max_bf16x8(m, *reinterpret_cast<const uint4*>(ring + ring_offset(q + c - 1, chunk)));
  return m;
}

// offset of tap t (in (ky, kx, c) order) from a pixel's corner in the
// padded patch: ky * pitch + kx * 3 + c, and kx * 3 + c = t % 12
__device__ __forceinline__ int tap_offset(int t) { return (t / 12) * kXP + t % 12; }

// d += a . b, one m16n8k16 bf16 product with f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(ok ? 4 : 0));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// copy patch `patch` (if < n) zero-padded into xs with cp.async, and
// commit one group (empty past the end): word w holds elements 2w, 2w + 1
// of one padded row (the pitch is even); the data sit at rows 2..33,
// elements 6..101, the rest is zero-filled
__device__ __forceinline__ void stage_patch(uint32_t* xs, const __nv_bfloat16* __restrict__ x,
                                            int patch, int n) {
  if (patch < n) {
    const uint32_t* xp =
        reinterpret_cast<const uint32_t*>(x + (size_t)patch * kSide * kSide * kCin);
    for (int w = threadIdx.x; w < kXsWords; w += kThreads) {
      const int r = (2 * w) / kXP, e = 2 * w - r * kXP;
      const bool in = r >= 2 && r < 2 + kSide && e >= 6 && e < 6 + kSide * kCin;
      cp_async4(xs + w, in ? xp + ((r - 2) * kSide * kCin + e - 6) / 2 : xp, in);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
stem_pool_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int n) {
  __shared__ __align__(16) uint32_t xs_words[2][kXsWords + 1];  // two [35][106] bf16 patches
  extern __shared__ __align__(16) __nv_bfloat16 ring[];  // [kRing][32][64]: 9 conv rows
  __shared__ float s_scale[kChannels], s_bias[kChannels];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the mma fragments' group and thread in group

  if (tid < kChannels) {
    s_scale[tid] = scale[tid];
    s_bias[tid] = bias[tid];
  }
  // B fragments, kept for the whole run: b0 = (W[k][n], W[k + 1][n]) and
  // b1 = (W[k + 8][n], W[k + 9][n]) for k = 16 s + 2 t, n = 8 nt + g,
  // from the n-major weights (two neighbouring k in one 4-byte word)
  uint32_t bfr[kKSteps][kNTiles][2];
  {
    const uint32_t* w32 = reinterpret_cast<const uint32_t*>(wt);
#pragma unroll
    for (int s = 0; s < kKSteps; ++s)
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const int base = ((nt * 8 + g) * kTaps + 16 * s + 2 * t) / 2;
        bfr[s][nt][0] = w32[base];
        bfr[s][nt][1] = w32[base + 4];
      }
  }

  stage_patch(xs_words[0], x, blockIdx.x, n);
  for (int patch = blockIdx.x, buf = 0; patch < n; patch += gridDim.x, buf ^= 1) {
    // prefetch the next patch into the other buffer (its last reader, the
    // previous patch's conv, finished before that patch's pool barrier)
    stage_patch(xs_words[buf ^ 1], x, patch + gridDim.x, n);
    cp_async_wait<1>();
    __syncthreads();  // this patch is in; the previous patch's pool has read the ring
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(xs_words[buf]);

    __nv_bfloat16* op = out + (size_t)patch * kPooledSide * kPooledSide * kChannels;
#pragma unroll 1
    for (int band = 0; band < kSide / kBandRows; ++band) {
      // conv rows 8 band .. 8 band + 7: 16 m16 tiles, warp w takes w, w + 4, ...
#pragma unroll 1
      for (int mt = warp; mt < 2 * kBandRows; mt += kWarps) {
        const int i = band * kBandRows + mt / 2, j0 = (mt % 2) * 16;
        const int p0 = i * kXP + (j0 + g) * kCin;  // corner of pixel (i, j0 + g)
        const int p1 = p0 + 8 * kCin;              // pixel (i, j0 + g + 8)
        float acc[kNTiles][4];
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
        for (int s = 0; s < kKSteps; ++s) {
          const int k0 = 16 * s + 2 * t;
          const int o0 = tap_offset(k0), o1 = tap_offset(k0 + 1);
          const int o8 = tap_offset(k0 + 8), o9 = tap_offset(k0 + 9);
          const uint32_t a[4] = {pack_raw(xs[p0 + o0], xs[p0 + o1]), pack_raw(xs[p1 + o0], xs[p1 + o1]),
                                 pack_raw(xs[p0 + o8], xs[p0 + o9]), pack_raw(xs[p1 + o8], xs[p1 + o9])};
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt) mma_bf16(acc[nt], a, bfr[s][nt][0], bfr[s][nt][1]);
        }
        // epilogue: acc[nt][0..1] is pixel j0 + g, channels 8 nt + 2 t, +1;
        // acc[nt][2..3] pixel j0 + g + 8
        const int q0 = ((i + 1) % kRing) * kSide + j0 + g, q1 = q0 + 8;
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const int ch = nt * 8 + 2 * t;
          const float s0 = s_scale[ch], s1 = s_scale[ch + 1];
          const float c0 = s_bias[ch], c1 = s_bias[ch + 1];
          // y * s + b as a product then a sum (no contraction), as the oracle
          const float y0 = relu(__fadd_rn(__fmul_rn(acc[nt][0], s0), c0));
          const float y1 = relu(__fadd_rn(__fmul_rn(acc[nt][1], s1), c1));
          const float y2 = relu(__fadd_rn(__fmul_rn(acc[nt][2], s0), c0));
          const float y3 = relu(__fadd_rn(__fmul_rn(acc[nt][3], s1), c1));
          *reinterpret_cast<uint32_t*>(ring + ring_offset(q0, nt) + 2 * t) = pack_bf16x2(y0, y1);
          *reinterpret_cast<uint32_t*>(ring + ring_offset(q1, nt) + 2 * t) = pack_bf16x2(y2, y3);
        }
      }
      __syncthreads();

      // pool rows 4 band .. 4 band + 3: thread -> pooled column oj = tid / 8,
      // chunk tid % 8; it walks the band's conv rows 8 band - 1 .. 8 band + 7
      // once, taking each row's max over columns 2 oj - 1 .. 2 oj + 1
      {
        const int oj = tid / kChunks, chunk = tid % kChunks;
        uint4 prev = band > 0 ? row_max(ring, band * kBandRows - 1, oj, chunk)
                              : make_uint4(0u, 0u, 0u, 0u);  // bf16 zeros: a neutral pad post-ReLU
#pragma unroll
        for (int l = 0; l < kBandRows / 2; ++l) {
          const int r = band * kBandRows + 2 * l;
          const uint4 a = row_max(ring, r, oj, chunk), b = row_max(ring, r + 1, oj, chunk);
          const uint4 m = max_bf16x8(prev, max_bf16x8(a, b));
          *reinterpret_cast<uint4*>(op + ((band * 4 + l) * kPooledSide + oj) * kChannels +
                                    chunk * 8) = m;
          prev = b;
        }
      }
      __syncthreads();  // the next band overwrites the ring rows just pooled
    }
  }
}

// the kernel's shared-memory attribute, and its blocks per SM and the SMs
// of `device` from the occupancy calculator, once per device
cudaError_t launch_shape(int device, int* blocks_per_sm, int* sms) {
  static int cached_blocks[64] = {}, cached_sms[64] = {};
  if (device >= 0 && device < 64 && cached_blocks[device] > 0) {
    *blocks_per_sm = cached_blocks[device];
    *sms = cached_sms[device];
    return cudaSuccess;
  }
  cudaError_t e = cudaFuncSetAttribute(stem_pool_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, stem_pool_kernel, kThreads,
                                                      kRingBytes);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess && *blocks_per_sm < 1) e = cudaErrorLaunchOutOfResources;
  if (e == cudaSuccess && device >= 0 && device < 64) {
    cached_blocks[device] = *blocks_per_sm;
    cached_sms[device] = *sms;
  }
  return e;
}

}  // namespace

extern "C" int ssad_stem_pool(const void* x, const void* wt, const float* scale, const float* bias,
                              void* out, int n, int device, void* stream) {
  if (n <= 0 || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wt)) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return ssad::on_device(device, [&]() {
    int blocks_per_sm = 0, sms = 0;
    cudaError_t e = launch_shape(device, &blocks_per_sm, &sms);
    if (e != cudaSuccess) return (int)e;
    const int grid = n < blocks_per_sm * sms ? n : blocks_per_sm * sms;
    stem_pool_kernel<<<grid, kThreads, kRingBytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt), scale, bias,
        static_cast<__nv_bfloat16*>(out), n);
    return (int)cudaGetLastError();
  });
}

extern "C" int ssad_stem_pool_occupancy(int device, int* blocks_per_sm) {
  return ssad::on_device(device, [&]() {
    int sms = 0;
    return (int)launch_shape(device, blocks_per_sm, &sms);
  });
}
