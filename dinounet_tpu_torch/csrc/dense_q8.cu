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
// 2. With the residual (#11, #12), one GEMM with the epilogue and the
//    statistics fused, laid out as dense_stats.cu's bf16 kernel: a row tile
//    of 64 tokens is one block's, which walks all of D in passes of 256
//    features, so it sums each stored row's values and squares itself, in a
//    fixed order, with no second pass over out and no atomics. One
//    producer thread fills
//    a ring of kStages stages by TMA, each the A rows and the weight rows of
//    one 128-deep K step (one 128-byte swizzled row of int8 each: four k32
//    products), ragged rows and K zero-filled by the copy; the quantize
//    pass's 16-byte row pitch gives every shape a tensor map, N = 1029
//    included. Two consumer warpgroups run wgmma m64n128k32 s8 x s8 -> s32
//    with the accumulators in registers; the epilogue rescales them there
//    ((float(acc) * a) * ws + b with __fmul_rn / __fadd_rn), rounds through
//    LayerScale, stages a warpgroup's 64 x 128 bf16 tile in shared memory,
//    then adds the residual and stores out as 16-byte vectors while summing
//    the rows. An int8 K step moves half the bytes of a bf16 step for the
//    same products, so L2, which holds the bf16 kernel's 64 x 256 tile to
//    about a third of the bf16 rate, leaves the int8 products twice the
//    room.
//    Without the residual (#10, fc1) the GEMM is int8_gemm.cuh's WMMA kernel.

#include <math.h>
#include <string.h>

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
__global__ void __launch_bounds__(kCmThreads)
quant_cm_kernel(const __nv_bfloat16* __restrict__ x, int K, int N, int T,
                int8_t* __restrict__ xq, int ldq, float* __restrict__ scale, int vec) {
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
    for (int j = g; j < kCmThreads; j += groups) mt = fmaxf(mt, part[j * 8 + u]);
    a_s[tid] = quant_scale(mt);
    if (n0 + tid < N) scale[(size_t)b * N + n0 + tid] = a_s[tid];
  }
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
                            cudaStream_t stream) {
  const int ldq = q8::pad16(K);
  // panels of 64 tokens (128 bytes a channel row), narrower (down to 16)
  // where that fills the card with fewer than 3 blocks an SM (132 SMs), or
  // down to 8 where the panel does not fit
  int T = 64;
  auto smem = [&](int t) { return ldq * t * 2 + (8 * kCmThreads + t) * 4; };
  while ((T > 16 && (long long)B * ((N + T - 1) / T) < 3 * 132) || (T > 8 && smem(T) > kMaxSmem))
    T /= 2;
  if (smem(T) > kMaxSmem) return cudaErrorInvalidValue;
  static unsigned long long ready = 0;  // one bit a device
  const cudaError_t err = set_smem_once(quant_cm_kernel, kMaxSmem, &ready);
  if (err != cudaSuccess) return err;
  const int vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  quant_cm_kernel<<<dim3((N + T - 1) / T, B), kCmThreads, smem(T), stream>>>(
      static_cast<const __nv_bfloat16*>(x), K, N, T, static_cast<int8_t*>(xq), ldq,
      static_cast<float*>(scale), vec);
  return cudaGetLastError();
}

cudaError_t launch_quantize(const void* h, int B, int N, int K, int channel_major, int gelu,
                            void* xq, void* a, cudaStream_t s) {
  return channel_major ? launch_quant_cm(h, B, K, N, xq, a, s)
                       : q8::launch_quant_rows(h, B * N, K, xq, a, gelu, s);
}

// ------------------------------------------- GEMM + epilogue + statistics

constexpr int kStages = 4;     // ring stages
constexpr int kKStep = 128;    // K a stage: one 128-byte swizzled row of int8
constexpr int kRows = 64;      // token rows a block
constexpr int kCols = 256;     // features a pass, 128 a consumer warpgroup
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr uint32_t kABytes = kRows * kKStep;
constexpr uint32_t kWBytes = kCols * kKStep;
constexpr uint32_t kStageBytes = kABytes + kWBytes;
constexpr int kLdS = 128 + 8;  // staging pitch (bf16): [64 rows][128 features]
constexpr uint32_t kStagingBytes = 64 * kLdS * 2;  // a warpgroup's
// shared-memory plan (byte offsets from a 1024-byte-aligned base)
constexpr uint32_t kOffStaging = kStages * kStageBytes;
constexpr uint32_t kOffStats = kOffStaging + 2 * kStagingBytes;  // [2][64 rows][2] fp32
constexpr uint32_t kOffBars = kOffStats + 2 * 64 * 2 * 4;        // full, then empty, a stage
constexpr uint32_t kSmemBytes = kOffBars + 16 * kStages + 1024;   // + alignment

struct Args {
  const float* a;     // (rows) per-token scales
  const float* ws;    // (D) per-feature weight scales
  const float* bias;  // (D)
  const float* gamma;
  const __nv_bfloat16* res;  // (rows, D)
  __nv_bfloat16* out;        // (rows, D)
  float* mu;                 // (rows)
  float* var;
  int rows, K, D;
  int vec;  // res and out rows start 16-byte aligned
};

__global__ void __launch_bounds__(kThreads, 1)
q8_gemm_stats_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap w_map, const Args p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t full = base + kOffBars, empty = full + 8 * kStages;
  const int r0 = blockIdx.x * kRows;
  const int rows_valid = min(kRows, p.rows - r0);
  const int ktiles = (p.K + kKStep - 1) / kKStep;
  const int passes = (p.D + kCols - 1) / kCols;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);     // the producer's expect_tx
      mbar_init(empty + 8 * s, 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every copy
    if (tid != 0) return;
    for (int it = 0; it < ktiles * passes; ++it) {
      const int s = it % kStages;
      const int pass = it / ktiles;
      const int k0 = (it - pass * ktiles) * kKStep, d0 = pass * kCols;
      mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
      const uint32_t a_dst = base + s * kStageBytes, w_dst = a_dst + kABytes;
      const uint32_t bar = full + 8 * s;
      mbar_expect_tx(bar, kStageBytes);
      tma_load(a_dst, &a_map, k0, r0, bar);
#pragma unroll
      for (int j = 0; j < kCols / 128; ++j)
        tma_load(w_dst + j * 128 * kKStep, &w_map, k0, d0 + 128 * j, bar);
    }
    return;
  }

  const int cw = wg - 1, warp = tid / 32, lane = tid % 32;
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(sbase + kOffStaging + cw * kStagingBytes);
  const int ar = warp * 16 + lane / 4;     // accumulator rows ar and ar + 8
  const int vq = tid % 16, rq = tid / 16;  // epilogue: 16-byte run vq of rows rq + 8 i
  // the per-token scales of the accumulator rows (0 past the last row)
  const float a0 = ar < rows_valid ? p.a[r0 + ar] : 0.f;
  const float a1 = ar + 8 < rows_valid ? p.a[r0 + ar + 8] : 0.f;
  int acc[64];
  float s1[8], s2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s1[i] = s2[i] = 0.f;

  int it = 0;
  for (int pass = 0; pass < passes; ++pass) {
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const uint32_t a_tile = base + s * kStageBytes;
      const uint32_t w_tile = a_tile + kABytes + cw * 128 * kKStep;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKStep / 32; ++kk)  // 32 int8 of K: 32 bytes into each row
        wgmma_ss_n128_s8(acc, sw128_desc(a_tile + kk * 32, 16, 1024),
                         sw128_desc(w_tile + kk * 32, 16, 1024), kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: free its stage
      if (kt > 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + 8 * ((it - 1) % kStages));

    // rescale, bias and LayerScale on the accumulators: acc[4 j + 2 h + {0, 1}]
    // is row ar + 8 h, features 8 j + 2 (lane % 4) + {0, 1} of the warpgroup's
    // 128. At the adapter's K = 192 or 384 the epilogue's instructions, more
    // than the products, take the GEMM's time: bf16(y) * bf16(gamma) is one
    // bf16x2 product (exact in fp32, so its one rounding is the plain
    // version's)
    const int d_base = pass * kCols + 128 * cw;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const int d = d_base + c;
      const bool in0 = d < p.D, in1 = d + 1 < p.D;
      const float ws0 = in0 ? p.ws[d] : 0.f, ws1 = in1 ? p.ws[d + 1] : 0.f;
      const float bb0 = in0 ? p.bias[d] : 0.f, bb1 = in1 ? p.bias[d + 1] : 0.f;
      const __nv_bfloat162 gg = __floats2bfloat162_rn(in0 ? p.gamma[d] : 0.f,
                                                      in1 ? p.gamma[d + 1] : 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float a = h ? a1 : a0;
        const float y0 = __fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), a), ws0), bb0);
        const float y1 = __fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), a), ws1), bb1);
        *reinterpret_cast<__nv_bfloat162*>(st + (ar + 8 * h) * kLdS + c) =
            __hmul2(__floats2bfloat162_rn(y0, y1), gg);
      }
    }
    named_barrier(1 + cw, 128);
    // + residual, stored; the stored values summed per row. The residual's
    // 16-byte vectors of all 8 rows are requested before the first is used
    const int col = d_base + 8 * vq;
    uint4 rv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rq + 8 * i;
      rv[i] = p.vec && r < rows_valid && col < p.D
                  ? __ldg(reinterpret_cast<const uint4*>(p.res + (size_t)(r0 + r) * p.D + col))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rq + 8 * i;
      if (r < rows_valid && col < p.D) {
        const size_t o = (size_t)(r0 + r) * p.D + col;
        const uint4 lv = *reinterpret_cast<const uint4*>(st + r * kLdS + 8 * vq);
        const __nv_bfloat16* l8 = reinterpret_cast<const __nv_bfloat16*>(&lv);
        if (p.vec) {
          // res + l as bf16x2 sums: one rounding of the exact sum, which is
          // the plain version's fp32 sum rounded to bf16 (fp32 carries more
          // than twice bf16's bits, so rounding to it first changes nothing)
          __nv_bfloat162* r2 = reinterpret_cast<__nv_bfloat162*>(&rv[i]);
          const __nv_bfloat162* l2 = reinterpret_cast<const __nv_bfloat162*>(&lv);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            r2[u] = __hadd2(r2[u], l2[u]);
            const float2 f = __bfloat1622float2(r2[u]);
            s1[i] += f.x;
            s2[i] += f.x * f.x;
            s1[i] += f.y;
            s2[i] += f.y * f.y;
          }
          *reinterpret_cast<uint4*>(p.out + o) = rv[i];
        } else {
          for (int u = 0; u < 8 && col + u < p.D; ++u) {
            const __nv_bfloat16 ov =
                __float2bfloat16(__bfloat162float(p.res[o + u]) + __bfloat162float(l8[u]));
            p.out[o + u] = ov;
            const float f = __bfloat162float(ov);
            s1[i] += f;
            s2[i] += f * f;
          }
        }
      }
    }
    named_barrier(1 + cw, 128);  // the staging tile is free for the next pass
  }

  // row sums: 16 lanes a row, then the block's two warpgroups
  float* stats = reinterpret_cast<float*>(sbase + kOffStats);  // [2][64 rows][2]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], off);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], off);
    }
    if (vq == 0) {
      stats[(cw * 64 + rq + 8 * i) * 2] = s1[i];
      stats[(cw * 64 + rq + 8 * i) * 2 + 1] = s2[i];
    }
  }
  named_barrier(3, 256);
  if (cw == 0 && tid < rows_valid) {
    const float S1 = stats[2 * tid] + stats[2 * (64 + tid)];
    const float S2 = stats[2 * tid + 1] + stats[2 * (64 + tid) + 1];
    const float m = S1 / p.D;
    p.mu[r0 + tid] = m;
    p.var[r0 + tid] = fmaxf(S2 / p.D - m * m, 0.f);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// xq (rows, ldq) and wq (D, ldq) int8, both K contiguous
int launch_gemm_stats(const int8_t* xq, const int8_t* wq, int ldq, const Args& p,
                      cudaStream_t stream) {
  CUtensorMap a_map, w_map;
  memset(&a_map, 0, sizeof(a_map));
  memset(&w_map, 0, sizeof(w_map));
  const cuuint64_t strides[1] = {(cuuint64_t)ldq};
  // (rows, K): boxes of 64 rows x 128 channels; (D, K): 128 features x 128
  const cuuint64_t a_dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.rows};
  const cuuint32_t a_box[2] = {kKStep, kRows};
  int err = s8_sw128_map(&a_map, xq, 2, a_dims, strides, a_box);
  if (err != 0) return err;
  const cuuint64_t w_dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.D};
  const cuuint32_t w_box[2] = {kKStep, 128};
  if ((err = s8_sw128_map(&w_map, wq, 2, w_dims, strides, w_box)) != 0) return err;
  static unsigned long long ready = 0;  // one bit a device
  const cudaError_t e = set_smem_once(q8_gemm_stats_kernel, (int)kSmemBytes, &ready);
  if (e != cudaSuccess) return (int)e;
  q8_gemm_stats_kernel<<<(p.rows + kRows - 1) / kRows, kThreads, kSmemBytes, stream>>>(
      a_map, w_map, p);
  return (int)cudaGetLastError();
}

}  // namespace q8s

}  // namespace

// h (B, N, K) row-major or (B, K, N) channel-major bf16 -> xq (B N, pad16(K))
// int8 and a (B N) fp32: the quantize pass alone (gelu: row-major only).
extern "C" int quantize_act(const void* h, void* xq, void* a, int B, int N, int K,
                            int channel_major, int gelu, void* stream) {
  if (B < 1 || N < 1 || K < 1 || (channel_major && gelu)) return (int)cudaErrorInvalidValue;
  return (int)q8s::launch_quantize(h, B, N, K, channel_major, gelu, xq, a,
                                   static_cast<cudaStream_t>(stream));
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
  const int ldq = q8::pad16(K);
  auto* xq8 = static_cast<const int8_t*>(xq);
  auto* w8 = static_cast<const int8_t*>(wq);
  if (!residual) {
    // A = xq (B N, ldq) row-major; B = wq^T, column-major with ld ldq
    const q8::EpilogueArgs ep{static_cast<const float*>(a), static_cast<const float*>(ws),
                              static_cast<const float*>(b), static_cast<__nv_bfloat16*>(out)};
    return (int)q8::launch_gemm<true, false, q8::kPlain>(xq8, 0, ldq, w8, 0, ldq, 1, B * N, D,
                                                         K, ep, s);
  }
  q8s::Args p;
  p.a = static_cast<const float*>(a);
  p.ws = static_cast<const float*>(ws);
  p.bias = static_cast<const float*>(b);
  p.gamma = static_cast<const float*>(gamma);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.mu = static_cast<float*>(mu);
  p.var = static_cast<float*>(var);
  p.rows = B * N;
  p.K = K;
  p.D = D;
  p.vec = D % 8 == 0 && q8s::aligned16(res) && q8s::aligned16(out);
  if (!q8s::aligned16(xq) || !q8s::aligned16(wq)) return (int)cudaErrorInvalidValue;
  return q8s::launch_gemm_stats(xq8, w8, ldq, p, s);
}
