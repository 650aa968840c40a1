// w8a8 dense projections of the int8 serving mode, for sm_90a.
//
// Replaces three TPU kernels of dinounet_tpu/ops/dense_q8_pallas.py:
//   _q8_kernel (dense_q8): h row-major (B, N, K) -> y = (acc * a) * ws + b,
//     bf16 (B, N, D) -- ViT fc1;
//   _q8_stats_kernel (dense_q8_residual_stats): the same with an optional
//     exact-erf GELU prologue, then out = res + bf16(gamma) * bf16(y) in bf16
//     and the next LayerNorm's row statistics -- ViT fc2, ConvFFN fc2;
//   _cm_q8_kernel (dense_cm_q8_residual_stats): h channel-major (B, K, N),
//     the residual epilogue -- the attention and MSDA output projections.
// The weights arrive quantized once (wq (D, Kpad) int8, K contiguous, ws
// (D,) fp32: ops/dense_q8.py caches them on the frozen weight); the JAX
// package quantized them XLA-side on every call. Arithmetic as
// int8_gemm.cuh's header: the levels, the exact int32 sums and the rescale
// round where the plain versions do.
//
// What bounds it on an H100: at the ViT shapes (8 tiles of 1029 tokens,
// K = D = 768 or K = 3072) the int8 products are near the balance point of
// 1,979 TOPS and 3.35 TB/s (~590 int8 operations per byte); at the adapter's
// (5376 tokens, K = 192 or 384) the bytes of h, res and out bound them.
//
// Design. A call is two launches.
// 1. A quantize pass writes the int8 activations token-major, (B N, Kpad)
//    with Kpad = K rounded up to 16 and zeros past K, and one fp32 scale a
//    token. int8 wgmma takes both operands K-major only, so the channel-major
//    input of _cm_q8_kernel is transposed here: a block reads a panel of T
//    tokens over all of K (T consecutive tokens a channel) into shared
//    memory and writes each token's row of levels as 16-byte stores. The
//    row-major pass (int8_gemm.cuh) computes the GELU once per element and
//    keeps the bf16 row in shared memory between the maximum and the levels.
// 2. One GEMM, int8_gemm.cuh's s8 wgmma kernel fed by a TMA ring, with the
//    epilogue fused. With the residual (#11, #12), a row tile of 64 tokens
//    is one block's, which walks all of D in passes of 256 features, so it
//    sums each stored row's values and squares itself, in a fixed order,
//    with no second pass over out and no atomics; the rescale, LayerScale
//    and residual are applied to the accumulators in registers. An int8 K
//    step moves half the bytes of a bf16 step for the same products, so L2,
//    which holds the bf16 kernel's 64 x 256 tile to about a third of the
//    bf16 rate, leaves the int8 products twice the room. Without the
//    residual (#10, fc1: K 768, D 3072, the epilogue-heavy shape, 50.6 MB of
//    bf16 out against 6.3 MB of xq) a block of 128 rows walks a group of
//    passes, each consumer warpgroup 64 rows x 256 features, and stores
//    the rescaled tile as 16-byte vectors.
//
// The row-parallel mode of #11 and #12 (a backbone block split over a model
// axis: a rank holds K/n input columns of fc2 / the attention projection,
// so its product is a part of each output's sum). The activation's per-token
// scale must be the whole row's (max|x| over all of K: GSPMD reduces it
// across the ranks), so the quantize pass runs twice: once for the rank's
// row maxima (the GELU rounded where the one pass rounds it), which the
// caller all-reduces with MAX; then for the levels at the scale of the
// all-reduced maximum (the same quant_scale and quantize, so a level rounds
// as in the one pass). The GEMM stores its int32 accumulators as they stand
// (int8_gemm.cuh's kPartial); the caller sums them over the ranks (int32:
// exact in any order); then post_reduce_q8_stats_kernel runs #11's / #12's
// epilogue once on the sum: the rescale with the global scales, bias,
// LayerScale and residual at the kStats epilogue's rounding points, and the
// next LayerNorm's statistics summed in the kStats order (below), so that
// the split block's stream and statistics equal the whole block's bit for
// bit. The pass moves the int32 sum and the residual in and the bf16 stream
// out, 8 bytes an element: it is bound by those bytes.

#include <math.h>

#include "int8_gemm.cuh"

namespace {

namespace q8s {

using q8::quant_scale;
using q8::quantize16;

constexpr int kMaxSmem = 232448;  // the opt-in limit of a block

// ---------------------------------------------------------- quantize pass

constexpr int kCmThreads = 256;

// Channel-major x (B, K, N) bf16 -> token-major xq (B N, ldq) int8, zero in
// columns K..ldq-1, and one scale per (b, token) in scale[b * N + n]. Block
// (token panel, b) of T tokens (T divides 256): the panel [ldq][T] bf16 in
// shared memory (rows K.. zero), read a channel row at a time (8 tokens a
// 16-byte load where `vec`: N % 8 == 0 and x 16-byte aligned, else one),
// each thread's maxima over its channels of its tokens, the maxima met in
// shared memory, then the levels of each token written as 16-byte stores,
// 16 channels a store.
// The modes of int8_gemm.cuh's QuantMode: kAmaxOnly writes each token's
// max|x| to scale and stops after the maxima; kGivenScale takes the token's
// maximum from amax in place of its own.
template <int kMode>
__global__ void __launch_bounds__(kCmThreads)
quant_cm_kernel(const __nv_bfloat16* __restrict__ x, int K, int N, int T,
                int8_t* __restrict__ xq, int ldq, float* __restrict__ scale,
                const float* __restrict__ amax, int vec) {
  extern __shared__ __align__(16) unsigned char quant_cm_smem[];
  __nv_bfloat16* panel = reinterpret_cast<__nv_bfloat16*>(quant_cm_smem);  // [ldq][T]
  float* part = reinterpret_cast<float*>(quant_cm_smem + (size_t)ldq * T * 2);  // [256][8]
  float* a_s = part + 8 * kCmThreads;                                           // [T]
  const int b = blockIdx.y, n0 = blockIdx.x * T, tid = threadIdx.x;
  const __nv_bfloat16* xb = x + (size_t)b * K * N + n0;
  // a thread's tokens: t0 .. t0 + w - 1 (w = 8 with 16-byte loads, else 1)
  const int w = vec ? 8 : 1, groups = T / w;
  const int t0 = (tid % groups) * w;
  float m[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) m[u] = 0.f;
  if (vec) {
    const bool live = n0 + t0 < N;  // N % 8 == 0: all 8 or none
#pragma unroll 4
    for (int k = tid / groups; k < ldq; k += kCmThreads / groups) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (live && k < K) v = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)k * N + t0));
      *reinterpret_cast<uint4*>(panel + (size_t)k * T + t0) = v;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int u = 0; u < 8; ++u) m[u] = fmaxf(m[u], fabsf(__bfloat162float(e[u])));
    }
  } else {
    const bool live = n0 + t0 < N;
#pragma unroll 8
    for (int k = tid / groups; k < ldq; k += kCmThreads / groups) {
      const __nv_bfloat16 v = live && k < K ? xb[(size_t)k * N + t0] : __float2bfloat16(0.f);
      panel[(size_t)k * T + t0] = v;
      m[0] = fmaxf(m[0], fabsf(__bfloat162float(v)));
    }
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) part[tid * 8 + u] = m[u];
  __syncthreads();
  if (tid < T) {  // token tid: slot tid % w of the threads holding its group
    const int g = tid / w, u = tid % w;
    float mt = 0.f;
    if constexpr (kMode == q8::kGivenScale) {
      mt = n0 + tid < N ? amax[(size_t)b * N + n0 + tid] : 0.f;
    } else {
      for (int j = g; j < kCmThreads; j += groups) mt = fmaxf(mt, part[j * 8 + u]);
    }
    if constexpr (kMode == q8::kAmaxOnly) {
      if (n0 + tid < N) scale[(size_t)b * N + n0 + tid] = mt;
    } else {
      a_s[tid] = quant_scale(mt);
      if (n0 + tid < N) scale[(size_t)b * N + n0 + tid] = a_s[tid];
    }
  }
  if constexpr (kMode == q8::kAmaxOnly) return;
  __syncthreads();
  for (int i = tid; i < T * (ldq / 16); i += kCmThreads) {
    const int tt = i % T, c = i / T;
    if (n0 + tt >= N) continue;
    uint32_t wd[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const __nv_bfloat16* p = panel + (size_t)(16 * c + 2 * u) * T + tt;
      const __nv_bfloat162 pair = __halves2bfloat162(p[0], p[T]);
      wd[u] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    *reinterpret_cast<uint4*>(xq + ((size_t)b * N + n0 + tt) * ldq + 16 * c) =
        quantize16(make_uint4(wd[0], wd[1], wd[2], wd[3]),
                   make_uint4(wd[4], wd[5], wd[6], wd[7]), a_s[tt]);
  }
}

cudaError_t launch_quant_cm(const void* x, int B, int K, int N, void* xq, void* scale,
                            cudaStream_t stream, int mode, const void* amax) {
  const int ldq = q8::pad16(K);
  // panels of 64 tokens (128 bytes a channel row), narrower (down to 16)
  // where that fills the card with fewer than 3 blocks an SM (132 SMs), or
  // down to 8 where the panel does not fit
  int T = 64;
  auto smem = [&](int t) { return ldq * t * 2 + (8 * kCmThreads + t) * 4; };
  while ((T > 16 && (long long)B * ((N + T - 1) / T) < 3 * 132) || (T > 8 && smem(T) > kMaxSmem))
    T /= 2;
  if (smem(T) > kMaxSmem || (mode == q8::kGivenScale && amax == nullptr))
    return cudaErrorInvalidValue;
  static unsigned long long ready[3] = {0, 0, 0};  // one bit a device, a mode
  const int vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto launch = [&](auto kernel, unsigned long long* bits) {
    const cudaError_t err = set_smem_once(kernel, kMaxSmem, bits);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((N + T - 1) / T, B), kCmThreads, smem(T), stream>>>(
        static_cast<const __nv_bfloat16*>(x), K, N, T, static_cast<int8_t*>(xq), ldq,
        static_cast<float*>(scale), static_cast<const float*>(amax), vec);
    return cudaGetLastError();
  };
  if (mode == q8::kOnePass) return launch(quant_cm_kernel<q8::kOnePass>, &ready[0]);
  if (mode == q8::kAmaxOnly) return launch(quant_cm_kernel<q8::kAmaxOnly>, &ready[1]);
  if (mode == q8::kGivenScale) return launch(quant_cm_kernel<q8::kGivenScale>, &ready[2]);
  return cudaErrorInvalidValue;
}

cudaError_t launch_quantize(const void* h, int B, int N, int K, int channel_major, int gelu,
                            void* xq, void* a, cudaStream_t s, int mode = q8::kOnePass,
                            const void* amax = nullptr) {
  return channel_major ? launch_quant_cm(h, B, K, N, xq, a, s, mode, amax)
                       : q8::launch_quant_rows(h, B * N, K, xq, a, gelu, s, mode, amax);
}

// ------------------------------------------------------- post-reduce pass

// bf16(r + bf16(bf16(y) * bf16(g))): kStats's __hmul2, then its __hadd2 on
// the product read back from shared memory, two roundings. Written with
// __fmul_rn / __fadd_rn in fp32 (the product of two bf16 values is exact
// there, and a bf16 sum rounded through fp32 rounds as the exact sum does):
// __hmul2 and __hadd2 side by side are contracted by the compiler into one
// bf16 fma, one rounding, which moved a quarter of the outputs by an ulp.
__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float post_one(float y, float g, float r) {
  return bf16_rn(__fadd_rn(r, bf16_rn(__fmul_rn(bf16_rn(y), bf16_rn(g)))));
}

// A warp a row (rows grid-strided): out = res + bf16(y) * bf16(gamma) with
// y = (float(acc) * a) * ws + b, each rounded where q8_gemm_kernel's kStats
// epilogue rounds (the same rescale, post_one), and the stored row's mean
// and variance. The sums follow kStats's order, so that they too
// equal the whole block's: lane L plays that epilogue's thread (warpgroup
// L / 16, run L % 16), summing the features 256 q + 128 (L / 16) + 8 (L % 16)
// + 0 .. 7 of each pass q in order; the 16 lanes of a warpgroup meet by the
// same shuffles, then warpgroup 0's sum plus warpgroup 1's, with the same
// uncontracted arithmetic (int8_gemm.cuh's sum_in, square_in, row_mean,
// row_var).
__global__ void post_reduce_q8_stats_kernel(const int* __restrict__ acc,
                                            const float* __restrict__ a,
                                            const float* __restrict__ ws,
                                            const float* __restrict__ bias,
                                            const __nv_bfloat16* __restrict__ res,
                                            const float* __restrict__ gamma,
                                            __nv_bfloat16* __restrict__ out,
                                            float* __restrict__ mu, float* __restrict__ var,
                                            int rows, int D, int vec) {
  const int warps = blockDim.x / 32, lane = threadIdx.x % 32;
  const int base = 128 * (lane / 16) + 8 * (lane % 16);
  for (int row = blockIdx.x * warps + threadIdx.x / 32; row < rows; row += gridDim.x * warps) {
    const size_t o = (size_t)row * D;
    const float ar = a[row];
    float s1 = 0.f, s2 = 0.f;
    for (int col = base; col < D; col += q8::kCols) {
      if (vec) {
        const int4 a0 = __ldg(reinterpret_cast<const int4*>(acc + o + col));
        const int4 a1 = __ldg(reinterpret_cast<const int4*>(acc + o + col + 4));
        const int av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        uint4 rv = __ldg(reinterpret_cast<const uint4*>(res + o + col));
        __nv_bfloat16* r8 = reinterpret_cast<__nv_bfloat16*>(&rv);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int d = col + u;
          const float f = post_one(q8::rescale(av[u], ar, ws[d], bias[d]), gamma[d],
                                   __bfloat162float(r8[u]));
          r8[u] = __float2bfloat16_rn(f);
          s1 = q8::sum_in(s1, f);
          s2 = q8::square_in(s2, f);
        }
        *reinterpret_cast<uint4*>(out + o + col) = rv;
      } else {
        for (int u = 0; u < 8 && col + u < D; ++u) {
          const int d = col + u;
          const float f = post_one(q8::rescale(acc[o + d], ar, ws[d], bias[d]), gamma[d],
                                   __bfloat162float(res[o + d]));
          out[o + d] = __float2bfloat16_rn(f);
          s1 = q8::sum_in(s1, f);
          s2 = q8::square_in(s2, f);
        }
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float S1 = __shfl_sync(0xffffffffu, s1, 0) + __shfl_sync(0xffffffffu, s1, 16);
    const float S2 = __shfl_sync(0xffffffffu, s2, 0) + __shfl_sync(0xffffffffu, s2, 16);
    if (lane == 0) {
      mu[row] = q8::row_mean(S1, D);
      var[row] = q8::row_var(S1, S2, D);
    }
  }
}

}  // namespace q8s

}  // namespace

// h (B, N, K) row-major or (B, K, N) channel-major bf16 -> xq (B N, pad16(K))
// int8 and a (B N) fp32: the quantize pass alone (gelu: row-major only).
// With amax (B N) fp32, the levels at the scales of those maxima (the
// row-parallel mode's second pass), else of each token's own.
extern "C" int quantize_act(const void* h, const void* amax, void* xq, void* a, int B, int N,
                            int K, int channel_major, int gelu, void* stream) {
  if (B < 1 || N < 1 || K < 1 || (channel_major && gelu)) return (int)cudaErrorInvalidValue;
  return (int)q8s::launch_quantize(h, B, N, K, channel_major, gelu, xq, a,
                                   static_cast<cudaStream_t>(stream),
                                   amax ? q8::kGivenScale : q8::kOnePass, amax);
}

// h as quantize_act's -> amax (B N) fp32: each token's max|act(h)| over the
// K channels the caller holds (the row-parallel mode's first pass).
extern "C" int quantize_amax(const void* h, void* amax, int B, int N, int K, int channel_major,
                             int gelu, void* stream) {
  if (B < 1 || N < 1 || K < 1 || amax == nullptr || (channel_major && gelu))
    return (int)cudaErrorInvalidValue;
  return (int)q8s::launch_quantize(h, B, N, K, channel_major, gelu, nullptr, amax,
                                   static_cast<cudaStream_t>(stream), q8::kAmaxOnly);
}

// The row-parallel mode of #11 (row-major h, gelu) and #12 (channel-major):
// the levels of h at the scales of the all-reduced maxima amax (B N) into xq
// (B N, pad16(K)) int8 and a (B N) fp32, then the rank's int32 product with
// the cached weight wq (D, pad16(K)) into acc (B N, D) int32, nothing else.
extern "C" int dense_q8_partial(const void* h, const void* wq, const void* amax, void* xq,
                                void* a, void* acc, int B, int N, int K, int D,
                                int channel_major, int gelu, void* stream) {
  if (B < 1 || N < 1 || K < 1 || D < 1 || amax == nullptr || acc == nullptr ||
      (channel_major && gelu))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = q8s::launch_quantize(h, B, N, K, channel_major, gelu, xq, a, s,
                                         q8::kGivenScale, amax);
  if (err != cudaSuccess) return (int)err;
  q8::Args p = {};
  p.acc = static_cast<int*>(acc);
  p.rows = B * N;
  p.K = K;
  p.D = D;
  p.vec = D % 4 == 0 && aligned16(acc);
  return q8::launch_gemm<q8::kPartial, q8::kSplitRows>(xq, wq, q8::pad16(K), p, s);
}

// acc (rows, D) int32 summed over the ranks, a (rows) and ws, b, gamma (D)
// fp32, res and out (rows, D) bf16, mu and var (rows) fp32.
extern "C" int post_reduce_q8_stats(const void* acc, const void* a, const void* ws,
                                    const void* b, const void* res, const void* gamma,
                                    void* out, void* mu, void* var, int rows, int D,
                                    void* stream) {
  if (rows < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const int vec = D % 8 == 0 && aligned16(acc) && aligned16(res) && aligned16(out);
  constexpr int kWarps = 8;
  const int blocks = (rows + kWarps - 1) / kWarps;
  q8s::post_reduce_q8_stats_kernel<<<blocks, 32 * kWarps, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(acc), static_cast<const float*>(a),
      static_cast<const float*>(ws), static_cast<const float*>(b),
      static_cast<const __nv_bfloat16*>(res), static_cast<const float*>(gamma),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(mu), static_cast<float*>(var),
      rows, D, vec);
  return (int)cudaGetLastError();
}

// wq (D, pad16(K)) int8 and ws (D,) fp32, the cached weight; b, gamma (D,)
// fp32; res, out (B, N, D) bf16; mu, var (B, N) fp32; xq (B N, pad16(K))
// int8 and a (B N) fp32 scratch for the quantize pass. Without `residual`
// (dense_q8) res, gamma, mu and var are unused.
extern "C" int dense_q8(const void* h, const void* wq, const void* ws, const void* b,
                        const void* res, const void* gamma, void* xq, void* a,
                        void* out, void* mu, void* var, int B, int N, int K, int D,
                        int channel_major, int gelu, int residual, void* stream) {
  if (B < 1 || N < 1 || K < 1 || D < 1 || (channel_major && (gelu || !residual)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = q8s::launch_quantize(h, B, N, K, channel_major, gelu, xq, a, s);
  if (err != cudaSuccess) return (int)err;
  q8::Args p = {};
  p.a = static_cast<const float*>(a);
  p.ws = static_cast<const float*>(ws);
  p.bias = static_cast<const float*>(b);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.rows = B * N;
  p.K = K;
  p.D = D;
  const int ldq = q8::pad16(K);
  if (!residual) {
    p.vec = D % 8 == 0 && aligned16(out);
    return q8::launch_gemm<q8::kPlain, q8::kSplitRows>(xq, wq, ldq, p, s);
  }
  p.gamma = static_cast<const float*>(gamma);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.mu = static_cast<float*>(mu);
  p.var = static_cast<float*>(var);
  p.vec = D % 8 == 0 && aligned16(res) && aligned16(out);
  return q8::launch_gemm<q8::kStats, q8::kSplitFeatures>(xq, wq, ldq, p, s);
}
