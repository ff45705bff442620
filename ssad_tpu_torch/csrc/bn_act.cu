// Inference BatchNorm, optional residual add and optional ReLU in one pass
// over a bf16 or f32 activation, on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no Pallas kernel for this,
// because XLA fuses the BatchNorm's affine, the residual add and the ReLU
// into the convolutions on the TPU.  In eager PyTorch the same chain is
// eight elementwise passes over each activation (x.float(), subtract,
// multiply, add, the cast back, the ReLU, the residual add, its ReLU), about
// 43 bytes of device memory traffic per element in bf16.
//
// Per element, in the compute dtype T (the rounding is the identity in f32):
//   y = round(((f32(x) - mean[c]) * mul[c]) + bias[c])
//   with a residual r:                y = round(f32(y) + f32(r'))
//     r' = r (the identity shortcut), or
//     r' = round(((f32(r) - rmean[c]) * rmul[c]) + rbias[c])
//          (the projection shortcut's BatchNorm, computed in the same pass)
//   with relu:                        y = relu(y), NaN passed through
// which is FlaxBatchNorm's eval-mode chain (models/resnet.py) step by step.
// mul = rsqrt(var + eps) * weight comes from the caller, computed there as
// the chain computes it.  The bits are the chain's: each step is an IEEE
// f32 operation with round-to-nearest (__fsub_rn, __fmul_rn, __fadd_rn, so
// nvcc cannot contract a product and a sum into an FMA, which rounds once),
// and each rounding to bf16 is __float2bfloat16_rn, as c10::BFloat16's.
//
// What bounds it on this card.  It does 3 to 8 flops an element against 4
// (x in, y out) to 6 (and the residual) bytes in bf16: about one flop a
// byte, far below the ~295 at which the H100 stops being bound by its 3.35
// TB/s.  So the least time is the bytes: at the widest site of the wide
// trunk, 6,728 x 256 x 16 x 16 bf16 with a projection residual, 2.65 GB,
// 0.79 ms.
//
// Design.  Each element is read once and written once:
//   * 16-byte loads and stores (8 bf16 or 4 f32 a thread), the widths
//     being multiples of 8, with two vectors a thread in flight per loop
//     step, and a grid-stride loop over as many blocks as are resident on
//     the card's 132 SMs (the occupancy calculator's count).
//   * Channels-last activations (what cuDNN returns for the NHWC views the
//     port feeds it): element i has channel i % C.  The grid's stride is a
//     multiple of C / 8 vectors, so a thread meets the same 8 channels at
//     every step and keeps their parameters in registers, loaded once.
//   * NCHW-contiguous activations (and channels last with C not a multiple
//     of the vector): element i has channel (i / inner) % C; each lane of a
//     vector finds its own, one division a vector, and reads the parameters
//     through the read-only cache.
//   Pointers must be 16-byte aligned and the element count a multiple of
//   the vector (conv outputs are fresh allocations and every trunk width a
//   multiple of 8): anything else is refused, not run a slower way.
//
// C interface (bound with ctypes): ssad_bn_act returns the cudaError_t of
// the launch (0 on success; cudaErrorInvalidValue for what it refuses).  It
// launches on the given stream and device, does not synchronise and
// allocates nothing.  x, residual and out share one dense layout; `inner`
// is 1 (channels last) or HW (NCHW); residual is null for none; rmean,
// rmul, rbias are null for the identity shortcut.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

using ssad::aligned16;
using ssad::kMaxDevices;
using ssad::resident_blocks;

constexpr int kThreads = 256;

enum Residual { kNone = 0, kIdentity = 1, kNormed = 2 };

struct Affine {
  const float* mean;
  const float* mul;
  const float* bias;
};

struct Args {
  const void* x;
  const void* r;
  void* out;
  Affine a, ra;
  long long n;
  int channels;
  long long inner;
  bool relu;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round to T and back: the chain's `.to(dtype)` seen from f32
template <typename T>
__device__ __forceinline__ float rounded(float v) { return to_f32(from_f32<T>(v)); }

// (x - mean) * mul + bias as three IEEE operations, in the chain's order
__device__ __forceinline__ float affine(float x, float mean, float mul, float bias) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), bias);
}

struct Params {
  float mean, mul, bias;
};

template <typename T, int RES>
__device__ __forceinline__ T element(T x, T r, Params p, Params rp, bool relu) {
  float y = rounded<T>(affine(to_f32(x), p.mean, p.mul, p.bias));
  if (RES == kIdentity) y = rounded<T>(__fadd_rn(y, to_f32(r)));
  if (RES == kNormed)
    y = rounded<T>(__fadd_rn(y, rounded<T>(affine(to_f32(r), rp.mean, rp.mul, rp.bias))));
  if (relu && !(y > 0.f) && y == y) y = 0.f;  // y == y: a NaN passes, as F.relu lets it
  return from_f32<T>(y);
}

__device__ __forceinline__ Params params(const Affine& a, int c) {
  return {__ldg(a.mean + c), __ldg(a.mul + c), __ldg(a.bias + c)};
}

// 16 bytes of T
template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

template <typename T>
__device__ __forceinline__ Vec<T> load(const T* p, long long v) {
  return reinterpret_cast<const Vec<T>*>(p)[v];
}

// Channels last, C a multiple of the vector: every thread keeps the
// parameters of its 8 (bf16) or 4 (f32) channels in registers.  The host
// makes gridDim.x * kThreads a multiple of `groups` = C / kN.
template <typename T, int RES>
__global__ void __launch_bounds__(kThreads)
bn_act_channels_last_kernel(const T* __restrict__ x, const T* __restrict__ r,
                            T* __restrict__ out, Affine a, Affine ra, long long vectors,
                            int groups, bool relu) {
  constexpr int kN = Vec<T>::kN;
  const long long stride = (long long)gridDim.x * kThreads;
  long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int c0 = (int)(v % groups) * kN;
  Params p[kN], rp[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    p[j] = params(a, c0 + j);
    rp[j] = RES == kNormed ? params(ra, c0 + j) : p[j];
  }
  auto apply = [&](const Vec<T>& xv, const Vec<T>& rv) {
    Vec<T> o;
#pragma unroll
    for (int j = 0; j < kN; ++j) o.v[j] = element<T, RES>(xv.v[j], rv.v[j], p[j], rp[j], relu);
    return o;
  };
  Vec<T>* o = reinterpret_cast<Vec<T>*>(out);
  // two vectors in flight a thread: both loads before either store
  for (; v + stride < vectors; v += 2 * stride) {
    const Vec<T> x0 = load(x, v), x1 = load(x, v + stride);
    Vec<T> r0 = x0, r1 = x1;
    if (RES != kNone) {
      r0 = load(r, v);
      r1 = load(r, v + stride);
    }
    o[v] = apply(x0, r0);
    o[v + stride] = apply(x1, r1);
  }
  if (v < vectors) {
    const Vec<T> x0 = load(x, v);
    o[v] = apply(x0, RES != kNone ? load(r, v) : x0);
  }
}

// Any dense layout: element i has channel (i / inner) % channels, found per
// lane from the vector's first element.
template <typename T, int RES>
__global__ void __launch_bounds__(kThreads)
bn_act_planar_kernel(const T* __restrict__ x, const T* __restrict__ r, T* __restrict__ out,
                     Affine a, Affine ra, long long vectors, long long inner, int channels,
                     bool relu) {
  constexpr int kN = Vec<T>::kN;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < vectors; v += stride) {
    const long long q = v * kN / inner;
    long long rem = v * kN - q * inner;
    int c = (int)(q % channels);
    const Vec<T> xv = load(x, v);
    const Vec<T> rv = RES != kNone ? load(r, v) : xv;
    Vec<T> o;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const Params p = params(a, c);
      o.v[j] = element<T, RES>(xv.v[j], rv.v[j], p, RES == kNormed ? params(ra, c) : p, relu);
      if (++rem == inner) {
        rem = 0;
        c = c + 1 == channels ? 0 : c + 1;
      }
    }
    reinterpret_cast<Vec<T>*>(out)[v] = o;
  }
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <typename T, int RES>
int launch(const Args& g, int device, cudaStream_t stream) {
  constexpr int kN = Vec<T>::kN;
  if (g.n % kN || !aligned16(g.x) || !aligned16(g.out) || (RES != kNone && !aligned16(g.r)))
    return (int)cudaErrorInvalidValue;
  const long long vectors = g.n / kN;
  const long long needed = (vectors + kThreads - 1) / kThreads;
  long long blocks = 0;
  if (g.inner == 1 && g.channels % kN == 0) {
    const int groups = g.channels / kN;
    const int step = groups / gcd(groups, kThreads);  // blocks whose threads span whole rows
    static int cached_rows[kMaxDevices] = {};
    int e = resident_blocks(bn_act_channels_last_kernel<T, RES>, kThreads, device, &blocks,
                            cached_rows);
    if (e) return e;
    long long grid = needed < blocks ? needed : blocks;
    grid = (grid + step - 1) / step * step;
    bn_act_channels_last_kernel<T, RES><<<(unsigned)grid, kThreads, 0, stream>>>(
        static_cast<const T*>(g.x), static_cast<const T*>(g.r), static_cast<T*>(g.out), g.a,
        g.ra, vectors, groups, g.relu);
    return (int)cudaGetLastError();
  }
  static int cached_planar[kMaxDevices] = {};
  int e = resident_blocks(bn_act_planar_kernel<T, RES>, kThreads, device, &blocks, cached_planar);
  if (e) return e;
  bn_act_planar_kernel<T, RES><<<(unsigned)(needed < blocks ? needed : blocks), kThreads, 0,
                                 stream>>>(
      static_cast<const T*>(g.x), static_cast<const T*>(g.r), static_cast<T*>(g.out), g.a, g.ra,
      vectors, g.inner, g.channels, g.relu);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const Args& g, int device, cudaStream_t stream) {
  if (g.r == nullptr) return launch<T, kNone>(g, device, stream);
  if (g.ra.mean == nullptr) return launch<T, kIdentity>(g, device, stream);
  return launch<T, kNormed>(g, device, stream);
}

}  // namespace

// dtype: 0 bfloat16, 1 float32
extern "C" int ssad_bn_act(const void* x, const void* residual, void* out, const float* mean,
                           const float* mul, const float* bias, const float* rmean,
                           const float* rmul, const float* rbias, long long n, int channels,
                           long long inner, int dtype, int relu, int device, void* stream) {
  if (n <= 0 || channels <= 0 || inner <= 0 || (dtype != 0 && dtype != 1) || !x || !out ||
      !mean || !mul || !bias || ((rmean || rmul || rbias) && !(residual && rmean && rmul && rbias)))
    return (int)cudaErrorInvalidValue;
  const Args g{x, residual, out, {mean, mul, bias}, {rmean, rmul, rbias},
               n, channels, inner, relu != 0};
  return ssad::on_device(device, [&]() {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0 ? launch_dtype<__nv_bfloat16>(g, device, s) : launch_dtype<float>(g, device, s);
  });
}
