// The transformer trunk's pointwise chains (models/vit.py) in two passes, on
// Hopper (sm_90a):
//
//   residual_ln:  x' = x + gamma * y           (the LayerScale'd residual)
//                 n  = round(LayerNorm(x'))    (the next branch's input)
//   silu_mul:     out = round(round(silu(a)) * b),  a, b = the halves of h
//
// Replaces no TPU kernel: the JAX package has no Pallas kernel for these,
// because XLA fuses a block's elementwise chains into its products on the
// TPU.  In eager PyTorch a block runs them as ten library passes over the
// (B, N, C) stream (LayerNorm, the cast to the compute dtype, LayerScale's
// product, the residual add, each twice; SiLU on the chunked view and its
// product with b), about 4.59 GB a block at ViT-g's 32 x 1,029 x 1,536.
//
// Bits.  Both give the library passes' bits.  Each step is the IEEE f32
// operation those passes make, in their order (__fmul_rn, __fadd_rn,
// __fdiv_rn and the like, so nvcc cannot contract or reorder anything it
// was not given as such), and each rounding to bf16 is __float2bfloat16_rn,
// as c10::BFloat16's.  y is promoted to f32 before gamma multiplies it, as
// an f32 gamma times a bf16 tensor is.  SiLU is ATen's x / (1 + expf(-x)) in
// f32 with IEEE division, rounded to the dtype, then multiplied by b in f32
// and rounded again.  The LayerNorm is ATen's vectorized kernel's
// (aten/src/ATen/native/cuda/layer_norm_kernel.cu): the same Welford sums
// combined in the same tree (see residual_ln_kernel), var = sigma2 / C,
// rstd = rsqrtf(var + eps), then gamma * (rstd * (x - mean)) + beta with
// the one FMA its build contracts; the result rounded once to the compute
// dtype, where `.to(dtype)` rounded it.
//
// What bounds it on this card.  Both do a few to ~30 flops an element
// against 10 to 16 bytes: far below the ~295 flops a byte at which the H100
// stops being bound by its 3.35 TB/s.  So the only gain is fewer bytes: one
// read of each input and one write of each output.  At ViT-g's shapes (B =
// 32, N = 1,029, C = 1,536, hidden 4,096, bf16 branches) a block's three
// residual_ln calls move 303.5 + 607.0 + 505.8 MB and its silu_mul 809.2 MB.
//
// Design.
//   * residual_ln: one warp a row.  A lane holds its vectors of 4 values
//     (a float4 of x, 8 bytes of a bf16 y) in registers: 48 values a lane
//     at width 1,536.  The LayerNorm's statistics are warp-shuffle sums
//     over those registers: no second read of the row from memory.  gamma
//     and the LayerNorm's affine are read through the read-only path and
//     stay in L1/L2.  x' is written out of place: the trunk keeps
//     references to the stream after its tap blocks.  Widths are multiples
//     of 8 up to 1,536: 12 vectors a lane, ViT-g's width, which is the one
//     instantiation; narrower rows leave lanes' last vectors idle.
//   * silu_mul: a block walks rows; its threads walk the row's 16-byte
//     vectors, loading a and b (the two halves of the w12 output) and
//     writing the contiguous (rows, hidden) result.
//   Pointers must be 16-byte aligned and the widths multiples of 8: anything
//   else is refused, not run a slower way.
//
// C interface (bound with ctypes): each function returns the cudaError_t of
// its launch (0 on success; cudaErrorInvalidValue for what it refuses),
// launches on the given stream and device, does not synchronise and
// allocates nothing.  dtype: 0 bfloat16, 1 float32 (the branch output y, n
// and silu_mul's tensors; x and x' are always float32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

using ssad::aligned16;
using ssad::kMaxDevices;

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kRowsPerBlock = kThreads / kWarp;
constexpr int kVec = 4;     // residual_ln: ATen's LayerNorm vector, 4 values
constexpr int kSiluVec = 8;  // silu_mul: 16 bytes of bf16
constexpr int kAtenThreads = 128;  // ATen's vectorized LayerNorm: 4 warps a row
// residual_ln: vectors a lane holds, so rows up to 1,536 wide (ViT-g's) stay in registers
constexpr int kVectorsPerLane = 12;
constexpr int kMaxWidth = kVectorsPerLane * kVec * kWarp;

// N values (4 or 8) moved as whole 8- or 16-byte words: float4s of f32,
// one word of bf16 pairs
template <int N>
struct Bf16Word;
template <>
struct Bf16Word<4> {
  using type = uint2;
};
template <>
struct Bf16Word<8> {
  using type = uint4;
};

template <int N>
__device__ __forceinline__ void load(const float* p, float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + j);
    v[j] = a.x, v[j + 1] = a.y, v[j + 2] = a.z, v[j + 3] = a.w;
  }
}

template <int N>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[N]) {
  using Word = typename Bf16Word<N>::type;
  const Word w = *reinterpret_cast<const Word*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

// a parameter vector's values, through the read-only path
template <int N>
__device__ __forceinline__ void load_param(const float* p, float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p + j));
    v[j] = a.x, v[j + 1] = a.y, v[j + 2] = a.z, v[j + 3] = a.w;
  }
}

template <int N>
__device__ __forceinline__ void store(float* p, const float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 4)
    *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
}

// rounds each value to bf16 (round to nearest even, as __float2bfloat16_rn)
template <int N>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[N]) {
  using Word = typename Bf16Word<N>::type;
  Word w;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<Word*>(p) = w;
}

// ATen's WelfordDataLN, cuWelfordOnlineSum and cuWelfordCombine
// (aten/src/ATen/native/cuda/layer_norm_kernel.cu) with the FMAs its build
// contracts: this card's library LayerNorm computes its statistics so.
struct Welford {
  float mean, sigma2, count;
};

// `count` is c.count + 1 and `inv` its IEEE reciprocal, both known when
// the kernel is compiled
__device__ __forceinline__ Welford online(float val, Welford c, float count, float inv) {
  const float delta = __fsub_rn(val, c.mean);
  const float mean = __fmaf_rn(delta, inv, c.mean);
  return {mean, __fmaf_rn(delta, __fsub_rn(val, mean), c.sigma2), count};
}

// cuWelfordCombine(b, a): b is the thread's own, a the one it is given
__device__ __forceinline__ Welford combine(Welford b, Welford a) {
  const float count = __fadd_rn(a.count, b.count);
  if (!(count > 0.f)) return {0.f, 0.f, count};
  const float delta = __fsub_rn(b.mean, a.mean);
  const float coef = __frcp_rn(count);
  const float na = __fmul_rn(a.count, coef), nb = __fmul_rn(b.count, coef);
  const float mean = __fmaf_rn(na, a.mean, __fmul_rn(nb, b.mean));
  const float spread = __fmul_rn(__fmul_rn(delta, delta), a.count);
  return {mean, __fmaf_rn(spread, nb, __fadd_rn(a.sigma2, b.sigma2)), count};
}

__device__ __forceinline__ Welford shfl_down(Welford w, int offset) {
  return {__shfl_down_sync(0xffffffffu, w.mean, offset),
          __shfl_down_sync(0xffffffffu, w.sigma2, offset),
          __shfl_down_sync(0xffffffffu, w.count, offset)};
}

struct RowArgs {
  const float* x;
  const void* y;
  const float* gamma;
  const float* weight;
  const float* bias;
  float* x_out;
  void* n_out;
  long long rows;
  int width;
  float eps;
};

// One warp a row; kVectorsPerLane vectors of 4 a lane, the lane's m-th at
// vector lane + 32 m of the row.  RES: x' = x + gamma * y, written to x_out.
// LN: n = round(LayerNorm(x')), written to n_out.
//
// The statistics are ATen's, step for step.  ATen's kernel gives a row 128
// threads (4 warps); thread t folds vectors t, t + 128, ... into a Welford
// sum, element by element; each warp combines its lanes by shuffles down
// (offsets 16 .. 1); then warp 0 takes warp 2, warp 1 warp 3, and warp 0
// warp 1.  Vector lane + 32 m belongs to its thread lane + 32 (m % 4), as
// that thread's (m / 4)-th: so this lane carries the sums of the four
// threads with its lane number, one a warp of ATen's, in the same order.
template <typename T, bool RES, bool LN>
__global__ void __launch_bounds__(kThreads) residual_ln_kernel(RowArgs g) {
  static_assert(kAtenThreads == 4 * kWarp, "a lane carries one thread of each of 4 warps");
  const int lane = threadIdx.x % kWarp;
  const int vectors = g.width / kVec;
  const T* y = static_cast<const T*>(g.y);
  T* n_out = static_cast<T*>(g.n_out);
  const long long step = (long long)gridDim.x * kRowsPerBlock;
  // warp-uniform: every lane of a warp walks the same rows
  for (long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
       row < g.rows; row += step) {
    const long long base = row * g.width;
    float v[kVectorsPerLane][kVec], yv[kVectorsPerLane][kVec];
    // every load of the row in flight before any arithmetic
#pragma unroll
    for (int m = 0; m < kVectorsPerLane; ++m) {
      const int c = (lane + m * kWarp) * kVec;
      if (c < g.width) {
        load(g.x + base + c, v[m]);
        if (RES) load(y + base + c, yv[m]);
      }
    }
    if (RES) {
#pragma unroll
      for (int m = 0; m < kVectorsPerLane; ++m) {
        const int c = (lane + m * kWarp) * kVec;
        if (c < g.width) {
          float gm[kVec];
          load_param(g.gamma + c, gm);
#pragma unroll
          for (int j = 0; j < kVec; ++j) v[m][j] = __fadd_rn(v[m][j], __fmul_rn(gm[j], yv[m][j]));
          store(g.x_out + base + c, v[m]);
        }
      }
    }
    if (LN) {
      Welford w[4] = {};
#pragma unroll
      for (int m = 0; m < kVectorsPerLane; ++m)
        if (lane + m * kWarp < vectors)
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            // value j of the thread's (m / 4)-th vector: its count after it
            const float count = (float)(kVec * (m / 4) + j + 1);
            w[m % 4] = online(v[m][j], w[m % 4], count, 1.f / count);
          }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int offset = kWarp / 2; offset > 0; offset /= 2)
          w[k] = combine(w[k], shfl_down(w[k], offset));
      const Welford t = combine(combine(w[0], w[2]), combine(w[1], w[3]));
      const float mean = __shfl_sync(0xffffffffu, t.mean, 0);
      const float var = __fdiv_rn(__shfl_sync(0xffffffffu, t.sigma2, 0), (float)g.width);
      const float rstd = rsqrtf(__fadd_rn(var, g.eps));
#pragma unroll
      for (int m = 0; m < kVectorsPerLane; ++m) {
        const int c = (lane + m * kWarp) * kVec;
        if (c < g.width) {
          float wt[kVec], b[kVec], o[kVec];
          load_param(g.weight + c, wt);
          load_param(g.bias + c, b);
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            o[j] = __fmaf_rn(wt[j], __fmul_rn(rstd, __fsub_rn(v[m][j], mean)), b[j]);
          store(n_out + base + c, o);
        }
      }
    }
  }
}

// round to T and back: a `.to(dtype)` seen from f32
template <typename T>
__device__ __forceinline__ float rounded(float v);
template <>
__device__ __forceinline__ float rounded<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rounded<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A block walks rows (grid-stride), its threads the row's 16-byte vectors.
template <typename T>
__global__ void __launch_bounds__(kThreads)
silu_mul_kernel(const T* __restrict__ h, T* __restrict__ out, long long rows, int hidden) {
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* a_row = h + row * 2 * hidden;
    const T* b_row = a_row + hidden;
    T* o_row = out + row * hidden;
    for (int c = threadIdx.x * kSiluVec; c < hidden; c += kThreads * kSiluVec) {
      float a[kSiluVec], b[kSiluVec], o[kSiluVec];
      load(a_row + c, a);
      load(b_row + c, b);
#pragma unroll
      for (int j = 0; j < kSiluVec; ++j) {
        const float s = rounded<T>(__fdiv_rn(a[j], __fadd_rn(1.f, expf(-a[j]))));
        o[j] = __fmul_rn(s, b[j]);
      }
      store(o_row + c, o);
    }
  }
}

// resident blocks of `kernel` on the whole card, at most `needed`
template <typename K>
int launch_grid(K kernel, long long needed, int device, int (&cached)[kMaxDevices],
                unsigned* grid) {
  long long blocks = 0;
  const int e = ssad::resident_blocks(kernel, kThreads, device, &blocks, cached);
  *grid = (unsigned)(needed < blocks ? needed : blocks);
  return e;
}

template <typename T, bool RES, bool LN>
int launch_rows(const RowArgs& g, int device, cudaStream_t stream) {
  auto kernel = residual_ln_kernel<T, RES, LN>;
  static int cached[kMaxDevices] = {};
  unsigned grid = 0;
  const int e =
      launch_grid(kernel, (g.rows + kRowsPerBlock - 1) / kRowsPerBlock, device, cached, &grid);
  if (e) return e;
  kernel<<<grid, kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_form(const RowArgs& g, int device, cudaStream_t stream) {
  if (!g.y) return launch_rows<T, false, true>(g, device, stream);
  if (!g.weight) return launch_rows<T, true, false>(g, device, stream);
  return launch_rows<T, true, true>(g, device, stream);
}

template <typename T>
int launch_silu_mul(const void* h, void* out, long long rows, int hidden, int device,
                    cudaStream_t stream) {
  auto kernel = silu_mul_kernel<T>;
  static int cached[kMaxDevices] = {};
  unsigned grid = 0;
  const int e = launch_grid(kernel, rows, device, cached, &grid);
  if (e) return e;
  kernel<<<grid, kThreads, 0, stream>>>(static_cast<const T*>(h), static_cast<T*>(out), rows,
                                        hidden);
  return (int)cudaGetLastError();
}

}  // namespace

// x, x_out: (rows, width) f32; y, n_out: (rows, width) in dtype; gamma,
// weight, bias: (width,) f32.  y and gamma null: the LayerNorm alone (x_out
// null); weight and bias null: the residual alone (n_out null).
extern "C" int ssad_residual_ln(const float* x, const void* y, const float* gamma,
                                const float* weight, const float* bias, float* x_out,
                                void* n_out, long long rows, int width, float eps, int dtype,
                                int device, void* stream) {
  const bool res = y != nullptr, ln = weight != nullptr;
  if (rows <= 0 || width <= 0 || width % 8 || width > kMaxWidth ||
      (dtype != 0 && dtype != 1) || !x || !(res || ln) || res != (gamma && x_out) ||
      ln != (bias && n_out) || (!res && (gamma || x_out)) || (!ln && (bias || n_out)))
    return (int)cudaErrorInvalidValue;
  const void* pointers[] = {x, y, gamma, weight, bias, x_out, n_out};
  for (const void* p : pointers)
    if (p && !aligned16(p)) return (int)cudaErrorInvalidValue;
  const RowArgs g{x, y, gamma, weight, bias, x_out, n_out, rows, width, eps};
  return ssad::on_device(device, [&]() {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0 ? launch_form<__nv_bfloat16>(g, device, s) : launch_form<float>(g, device, s);
  });
}

// h: (rows, 2 * hidden), out: (rows, hidden), both in dtype
extern "C" int ssad_silu_mul(const void* h, void* out, long long rows, int hidden, int dtype,
                             int device, void* stream) {
  if (rows <= 0 || hidden <= 0 || hidden % kSiluVec || (dtype != 0 && dtype != 1) || !h || !out ||
      !aligned16(h) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  return ssad::on_device(device, [&]() {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0 ? launch_silu_mul<__nv_bfloat16>(h, out, rows, hidden, device, s)
                      : launch_silu_mul<float>(h, out, rows, hidden, device, s);
  });
}
