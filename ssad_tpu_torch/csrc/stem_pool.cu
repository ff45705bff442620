// Fused folded stem for 32x32 patches on Hopper (sm_90a): 4x4/s1 conv
// with padding (2,1), inference BatchNorm affine, ReLU, round to bf16,
// 3x3/s2/pad-1 maxpool.  (N, 32, 32, 3) bf16 -> (N, 16, 16, 64) bf16,
// both channels last.
//
// Replaces the Pallas TPU kernel `_stem_pool_kernel`
// (ssad_tpu/ops/stem_pool.py:284-348, launched by stem_pool_pallas at
// :351-391).  Same function as its oracle stem_pool_xla (:245-259): the
// 48 taps of a pixel, in (ky, kx, c) order, are bf16 x bf16 products (each
// exact in f32) summed in f32; then y * scale' + bias' in f32, ReLU, one
// rounding to bf16 (RNE); the max of the rounded values over the 3x3
// window.  Rounding is monotone, so pooling the rounded values equals
// rounding the pooled ones, and zero padding of the pool equals -inf
// padding because every value is >= 0 after the ReLU.
//
// What bounds it on this card.  At N = 6728 patches (one served batch of
// 8 images x 841 windows) it reads 41.3 MB of patches and writes 220.5 MB
// of pooled maps: 262 MB, 78 us at 3.35 TB/s.  It does 42.3 GFLOP, which
// is 43 us on bf16 tensor cores and 0.63 ms as f32 FMAs on the CUDA cores.
// The unfused chain would also write and re-read the 881 MB conv output.
//
// Design (a first, simple kernel).  One block per patch, 256 threads.
//   1. Stage the zero-padded 35x35x3 patch and the (48, 64) folded
//      weights in shared memory as f32.
//   2. Conv: each thread computes two neighbouring pixels x 32 channels
//      (64 f32 accumulators) per task, four tasks per thread; the 48 taps
//      are FMAs in (ky, kx, c) order, the weights of a tap read as float4
//      broadcasts (all lanes of a warp share the channel half).  The
//      affine, ReLU and rounding follow, and the 32x32x64 bf16 conv tile
//      is kept in 128 KB of dynamic shared memory; it never reaches device
//      memory.  Rows of 64 channels are stored as 16-byte chunks, the
//      chunk index XOR-swizzled with the pixel's low bits to spread banks.
//   3. Pool: each thread takes one pooled pixel x 8 channels per task and
//      takes the bf16 max of up to 9 chunks (__hmax2); the output rows of
//      64 channels (128 B) are written with coalesced 16-byte stores.
// The FMAs run on the CUDA cores, so this design is bound by f32 issue
// rate (~0.63 ms at N = 6728), not by the bytes; tensor cores are later
// work.  Any N works (one block per patch); no padding of N is needed.
//
// C interface (bound with ctypes): ssad_stem_pool returns the cudaError_t
// of the launch (0 on success).  It launches on the given stream, does not
// synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSide = 32;                 // patch side
constexpr int kPadSide = 35;              // 2 + 32 + 1: the conv's (2, 1) padding
constexpr int kCin = 3;
constexpr int kTaps = 16 * kCin;          // 4 x 4 x 3
constexpr int kChannels = 64;
constexpr int kPooledSide = 16;
constexpr int kPixels = kSide * kSide;    // 1024 conv pixels per patch
constexpr int kThreads = 256;
constexpr int kChunks = kChannels / 8;    // 16-byte chunks of 8 bf16 per pixel row
constexpr int kHalf = kChannels / 2;      // channels per conv task

constexpr int kConvBytes = kPixels * kChannels * 2;                // 131072
constexpr int kWeightBytes = kTaps * kChannels * 4;                // 12288
constexpr int kInputFloats = kPadSide * kPadSide * kCin;           // 3675
constexpr int kInputBytes = (kInputFloats * 4 + 15) / 16 * 16;     // 14704
constexpr int kSmemBytes = kConvBytes + kWeightBytes + kInputBytes;

static_assert(kPixels / 2 * 2 == kThreads * 4, "four conv tasks per thread");
static_assert(kPooledSide * kPooledSide * kChunks == kThreads * 8, "eight pool tasks per thread");

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// element offset of chunk `chunk` of conv pixel p in the swizzled tile
__device__ __forceinline__ int conv_offset(int p, int chunk) {
  return p * kChannels + ((chunk ^ (p & 7)) * 8);
}

// affine + ReLU + rounding of 32 accumulators, stored as four chunks
__device__ __forceinline__ void store_pixel(__nv_bfloat16* conv, int p, int chunk0,
                                            const float (&acc)[kHalf], const float* s,
                                            const float* b) {
#pragma unroll
  for (int q = 0; q < kHalf / 8; ++q) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int ch = (chunk0 + q) * 8 + e;
      // y * s + b as a product then a sum (no contraction), as the oracle
      const float y = __fadd_rn(__fmul_rn(acc[q * 8 + e], s[ch]), b[ch]);
      v[e] = y > 0.f ? y : 0.f;
    }
    const uint4 u = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                               pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
    *reinterpret_cast<uint4*>(conv + conv_offset(p, chunk0 + q)) = u;
  }
}

__global__ void __launch_bounds__(kThreads)
stem_pool_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(smem);          // [1024][64]
  float* ws = reinterpret_cast<float*>(smem + kConvBytes);               // [48][64]
  float* xs = reinterpret_cast<float*>(smem + kConvBytes + kWeightBytes);  // [35][35][3]
  __shared__ float s_scale[kChannels], s_bias[kChannels];

  const int tid = threadIdx.x;
  const size_t patch = blockIdx.x;
  const __nv_bfloat16* xp = x + patch * kPixels * kCin;

  for (int i = tid; i < kTaps * kChannels; i += kThreads) ws[i] = __bfloat162float(w[i]);
  if (tid < kChannels) {
    s_scale[tid] = scale[tid];
    s_bias[tid] = bias[tid];
  }
  for (int i = tid; i < kInputFloats; i += kThreads) {
    const int r = i / (kPadSide * kCin);
    const int rem = i - r * (kPadSide * kCin);
    const int col = rem / kCin;
    const int c = rem - col * kCin;
    const int sr = r - 2, sc = col - 2;
    xs[i] = (sr >= 0 && sr < kSide && sc >= 0 && sc < kSide)
                ? __bfloat162float(xp[(sr * kSide + sc) * kCin + c])
                : 0.f;
  }
  __syncthreads();

  // conv: task t -> channel half t / 512, pixel pair t % 512
#pragma unroll 1
  for (int it = 0; it < 4; ++it) {
    const int t = it * kThreads + tid;
    const int half = t >> 9;
    const int p0 = (t & 511) * 2;
    const int i = p0 / kSide, j0 = p0 % kSide;
    float acc0[kHalf], acc1[kHalf];
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      acc0[c] = 0.f;
      acc1[c] = 0.f;
    }
#pragma unroll
    for (int ky = 0; ky < 4; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 4; ++kx) {
#pragma unroll
        for (int c = 0; c < kCin; ++c) {
          const int tap = (ky * 4 + kx) * kCin + c;
          const float a0 = xs[((i + ky) * kPadSide + j0 + kx) * kCin + c];
          const float a1 = xs[((i + ky) * kPadSide + j0 + kx + 1) * kCin + c];
          const float4* wr = reinterpret_cast<const float4*>(ws + tap * kChannels + half * kHalf);
#pragma unroll
          for (int q = 0; q < kHalf / 4; ++q) {
            const float4 wv = wr[q];
            acc0[4 * q + 0] = fmaf(a0, wv.x, acc0[4 * q + 0]);
            acc0[4 * q + 1] = fmaf(a0, wv.y, acc0[4 * q + 1]);
            acc0[4 * q + 2] = fmaf(a0, wv.z, acc0[4 * q + 2]);
            acc0[4 * q + 3] = fmaf(a0, wv.w, acc0[4 * q + 3]);
            acc1[4 * q + 0] = fmaf(a1, wv.x, acc1[4 * q + 0]);
            acc1[4 * q + 1] = fmaf(a1, wv.y, acc1[4 * q + 1]);
            acc1[4 * q + 2] = fmaf(a1, wv.z, acc1[4 * q + 2]);
            acc1[4 * q + 3] = fmaf(a1, wv.w, acc1[4 * q + 3]);
          }
        }
      }
    }
    store_pixel(conv, p0, half * (kHalf / 8), acc0, s_scale, s_bias);
    store_pixel(conv, p0 + 1, half * (kHalf / 8), acc1, s_scale, s_bias);
  }
  __syncthreads();

  // pool: task u -> pooled pixel u / 8, chunk u % 8
  __nv_bfloat16* op = out + patch * (kPooledSide * kPooledSide * kChannels);
#pragma unroll 1
  for (int it = 0; it < 8; ++it) {
    const int u = it * kThreads + tid;
    const int opix = u / kChunks, chunk = u % kChunks;
    const int oi = opix / kPooledSide, oj = opix % kPooledSide;
    uint4 m = make_uint4(0u, 0u, 0u, 0u);  // bf16 zeros: a neutral pad post-ReLU
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const int r = 2 * oi + dy;
      if (r < 0 || r >= kSide) continue;
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int c = 2 * oj + dx;
        if (c < 0 || c >= kSide) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(conv + conv_offset(r * kSide + c, chunk));
        m.x = max_bf16x2(m.x, v.x);
        m.y = max_bf16x2(m.y, v.y);
        m.z = max_bf16x2(m.z, v.z);
        m.w = max_bf16x2(m.w, v.w);
      }
    }
    *reinterpret_cast<uint4*>(op + opix * kChannels + chunk * 8) = m;
  }
}

}  // namespace

extern "C" int ssad_stem_pool(const void* x, const void* w, const float* scale,
                              const float* bias, void* out, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(stem_pool_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  stem_pool_kernel<<<n, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), scale, bias,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}
