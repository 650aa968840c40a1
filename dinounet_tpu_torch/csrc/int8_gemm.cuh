// The int8 pieces shared by dense_q8.cu and qkv_q8_dmaj.cu, for sm_90a:
// the per-token symmetric quantization of row-major activations, and the
// one int8 tensor-core GEMM of the four w8a8 projections, templated on its
// epilogue.
//
// Arithmetic, as the JAX package's dense_q8_pallas.py and its references:
//   scale a = max(max|x|, 1e-12) / 127             IEEE division (__fdiv_rn)
//   q       = clip(rint(x / a), -127, 127)         half to even, IEEE division
//   acc     = sum_k q[k] * wq[k]                   int32, exact in any order
//   y       = (float(acc) * a) * ws + bias         fp32, each op rounded once
// The rescale uses __fmul_rn / __fadd_rn so that nvcc cannot contract it
// into an FMA: the kernels then round exactly where the plain PyTorch
// versions do, and differ from them only where erff and PyTorch's erf
// differ in the GELU prologue.
//
// The weights arrive quantized once (ops/dense_q8.py caches them on the
// weight tensor): wq (D, Kpad) int8, K contiguous and padded with zeros to
// a multiple of 16, the layout nn.Linear stores; ws (D,) fp32. The
// activations arrive from a quantize pass, token-major: xq (rows, Kpad).
//
// The GEMM: y[r][d] from acc = sum_k xq[r][k] wq[d][k], tokens as wgmma's M
// and features as its N (int8 wgmma takes both operands K-major only, so
// every op reads the same two operand layouts). A block owns a tile of
// token rows and walks a range of 256-feature passes over D. One producer
// thread fills a ring of kStages stages by TMA, each the block's rows and
// 256 weight rows over one 128-deep K step (a 128-byte swizzled row of int8
// each; rows past the end and K past K arrive as zeros); two consumer
// warpgroups run m64nNk32 s8 x s8 -> s32 products with the accumulators in
// registers. How they share a block's tiles (Layout):
//   kSplitFeatures (#11, #12): 64 rows; each warpgroup 128 of a pass's 256
//     features (m64n128). A block owns whole rows and walks all of D, as
//     the statistics need.
//   kSplitRows (#10, #13): 128 rows; each warpgroup 64 of them over all 256
//     features (m64n256), so a weight stage feeds twice the products of a
//     64-row block: at 52 products a byte of stage the weight's L2 traffic,
//     not the tensor cores, holds a 64-row block. For #10 a block walks a
//     group of passes, as few groups as let the blocks fill the card in one
//     wave; for #13 one pass (a 2-D grid). (Timed and not kept: 64-row
//     blocks walking all of D; two warpgroups alternating passes, one's
//     epilogue under the other's products.)
// The epilogues rescale the accumulators in registers and stage a
// warpgroup's 64 x 128 bf16 tile in shared memory, then:
//   kStats (#11, #12): y rounded through LayerScale, + the residual, stored
//     as 16-byte vectors, the stored rows' sums and squares summed in a
//     fixed order (no second pass over out, no atomics);
//   kPlain (#10): y stored, (rows, D), as 16-byte vectors;
//   kTokenColumns (#13): y stored transposed, (rows / N, D, N) with tokens
//     fastest (store_run below);
//   kPartial (#11's and #12's row-parallel mode, on a model axis): no
//     rescale, no bias, no statistics: the int32 accumulators (rows, D) as
//     they stand, staged 64 features at a time and stored as 16-byte
//     vectors, for the caller's int32 all-reduce (exact in any order) and
//     dense_q8.cu's post-reduce pass. A rank holds K/n of the input, so its
//     activation scale must be the whole row's: the quantize pass then runs
//     in two modes (QuantMode), the row maxima first (all-reduced by the
//     caller), then the levels at the scale of the given maximum.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper_common.cuh"

namespace {

namespace q8 {

__device__ __forceinline__ float gelu_exact(float x) {
  return x * 0.5f * (1.f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float quant_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
}

__device__ __forceinline__ int8_t quantize(float v, float a) {
  const float q = rintf(__fdiv_rn(v, a));
  return (int8_t)(int)fminf(fmaxf(q, -127.f), 127.f);
}

// four levels packed into a 32-bit word, the first in the low byte
__device__ __forceinline__ uint32_t pack4(float a, float v0, float v1, float v2, float v3) {
  return (uint32_t)(uint8_t)quantize(v0, a) | (uint32_t)(uint8_t)quantize(v1, a) << 8 |
         (uint32_t)(uint8_t)quantize(v2, a) << 16 | (uint32_t)(uint8_t)quantize(v3, a) << 24;
}

// 16 levels of the 16 bf16 in (lo, hi) as one 16-byte vector
__device__ __forceinline__ uint4 quantize16(uint4 lo, uint4 hi, float a) {
  const __nv_bfloat16* l = reinterpret_cast<const __nv_bfloat16*>(&lo);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&hi);
  auto f = [](const __nv_bfloat16* e, int i) { return __bfloat162float(e[i]); };
  return make_uint4(pack4(a, f(l, 0), f(l, 1), f(l, 2), f(l, 3)),
                    pack4(a, f(l, 4), f(l, 5), f(l, 6), f(l, 7)),
                    pack4(a, f(h, 0), f(h, 1), f(h, 2), f(h, 3)),
                    pack4(a, f(h, 4), f(h, 5), f(h, 6), f(h, 7)));
}

// The quantize passes' modes: the one pass of a whole row (its maximum, then
// its levels); the row maxima alone (max|x| over the rank's K, through the
// same GELU rounding); the levels at the scale quant_scale(amax) of a given
// maximum (the all-reduced one), which also writes that scale.
enum QuantMode { kOnePass = 0, kAmaxOnly = 1, kGivenScale = 2 };

// the 8 bf16 of x row xr at k0 .. k0 + 7 (zeros past K), through the GELU
// rounded to bf16 as the one-pass loop rounds it
template <bool kGelu>
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* xr, int k0, int K, int vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
  if (vec && k0 + 8 <= K) {
    v = __ldg(reinterpret_cast<const uint4*>(xr + k0));
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (k0 + u < K) e[u] = xr[k0 + u];
  }
  if (kGelu) {
#pragma unroll
    for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16(gelu_exact(__bfloat162float(e[u])));
  }
  return v;
}

// Row-major x (rows, K) bf16, optionally through the exact GELU rounded to
// bf16 (the JAX prologue's rounding point) -> xq (rows, ldq) int8, ldq =
// pad16(K), zero in columns K..ldq-1, and one scale a per row. A row is
// split into 16-element chunks taken by G = 2^lanes_log2 lanes (the power of
// two at or above the chunk count, at most 32); a block holds
// blockDim.x / G rows. A lane reads its chunks once (16-byte loads where
// `vec`: K % 8 == 0 and x 16-byte aligned), applies the GELU once per
// element, keeps the bf16 values in shared memory ([row][ldq] bf16) and
// takes their maximum; the maxima meet by shuffles within the G lanes; the
// lane then writes its chunks' levels as 16-byte stores.
// kAmaxOnly writes max|x| of each row to scale[row] (no levels, no shared
// memory); kGivenScale reads the row's maximum from amax[row] and writes
// the levels as each chunk arrives (no shared memory) and the scale.
template <bool kGelu, int kMode>
__global__ void __launch_bounds__(256)
quant_rows_kernel(const __nv_bfloat16* __restrict__ x, int rows, int K,
                  int8_t* __restrict__ xq, int ldq, float* __restrict__ scale,
                  const float* __restrict__ amax, int vec, int lanes_log2) {
  extern __shared__ __align__(16) unsigned char quant_rows_smem[];
  const int G = 1 << lanes_log2;
  const int sub = threadIdx.x & (G - 1), rloc = threadIdx.x >> lanes_log2;
  const int row = blockIdx.x * (blockDim.x >> lanes_log2) + rloc;
  const bool live = row < rows;
  if constexpr (kMode == kGivenScale) {
    if (!live) return;
    const float a = quant_scale(amax[row]);
    const __nv_bfloat16* xr = x + (size_t)row * K;
    int8_t* qr = xq + (size_t)row * ldq;
    for (int c = sub; c < ldq / 16; c += G)
      *reinterpret_cast<uint4*>(qr + 16 * c) =
          quantize16(load8<kGelu>(xr, 16 * c, K, vec), load8<kGelu>(xr, 16 * c + 8, K, vec), a);
    if (sub == 0) scale[row] = a;
    return;
  }
  if constexpr (kMode == kAmaxOnly) {
    float m = 0.f;
    if (live) {
      const __nv_bfloat16* xr = x + (size_t)row * K;
      for (int c = sub; c < ldq / 16; c += G) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint4 v = load8<kGelu>(xr, 16 * c + 8 * half, K, vec);
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
          for (int u = 0; u < 8; ++u) m = fmaxf(m, fabsf(__bfloat162float(e[u])));
        }
      }
    }
    for (int off = G / 2; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (live && sub == 0) scale[row] = m;
    return;
  }
  uint4* buf = reinterpret_cast<uint4*>(quant_rows_smem) + (size_t)rloc * (ldq / 8);
  const int chunks = ldq / 16;
  float m = 0.f;
  if (live) {
    const __nv_bfloat16* xr = x + (size_t)row * K;
#pragma unroll 4
    for (int c = sub; c < chunks; c += G) {
      uint4 v[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k0 = 16 * c + 8 * half;
        v[half] = make_uint4(0u, 0u, 0u, 0u);
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v[half]);
        if (vec && k0 + 8 <= K) {
          v[half] = __ldg(reinterpret_cast<const uint4*>(xr + k0));
        } else {
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (k0 + u < K) e[u] = xr[k0 + u];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (kGelu) e[u] = __float2bfloat16(gelu_exact(__bfloat162float(e[u])));
          m = fmaxf(m, fabsf(__bfloat162float(e[u])));
        }
        buf[2 * c + half] = v[half];
      }
    }
  }
  for (int off = G / 2; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (!live) return;
  const float a = quant_scale(m);
  int8_t* qr = xq + (size_t)row * ldq;
  for (int c = sub; c < chunks; c += G)
    *reinterpret_cast<uint4*>(qr + 16 * c) = quantize16(buf[2 * c], buf[2 * c + 1], a);
  if (sub == 0) scale[row] = a;
}

// ------------------------------------------------------------------ GEMM

enum Epilogue { kStats = 0, kPlain = 1, kTokenColumns = 2, kPartial = 3 };
enum Layout { kSplitFeatures = 0, kSplitRows = 1 };

constexpr int kStages = 4;     // ring stages
constexpr int kKStep = 128;    // K a stage: one 128-byte swizzled row of int8
constexpr int kCols = 256;     // features a pass
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr uint32_t kWBytes = kCols * kKStep;
constexpr uint32_t kStagingBytes = 64 * 128 * 2;  // a warpgroup's 64 x 128 bf16 tile

template <int kLayout>
struct Plan {
  static constexpr int kRows = kLayout == kSplitRows ? 128 : 64;     // token rows a block
  static constexpr int kHalves = kLayout == kSplitFeatures ? 1 : 2;  // 128-feature halves
  static constexpr uint32_t kABytes = kRows * kKStep;
  static constexpr uint32_t kStageBytes = kABytes + kWBytes;
  // shared-memory plan (byte offsets from a 1024-byte-aligned base)
  static constexpr uint32_t kOffStaging = kStages * kStageBytes;
  static constexpr uint32_t kOffStats = kOffStaging + 2 * kStagingBytes;  // [2][64][2] fp32
  static constexpr uint32_t kOffBars =
      kOffStats + (kLayout == kSplitFeatures ? 2 * 64 * 2 * 4 : 0);  // full, then empty
  static constexpr uint32_t kSmemBytes = kOffBars + 16 * kStages + 1024;  // + alignment
};
static_assert(Plan<kSplitRows>::kSmemBytes <= 232448, "over a block's shared memory");

struct Args {
  const float* a;            // (rows) per-token scales
  const float* ws;           // (D) per-feature weight scales
  const float* bias;         // (D)
  const float* gamma;        // (D), kStats
  const __nv_bfloat16* res;  // (rows, D), kStats
  __nv_bfloat16* out;        // (rows, D); kTokenColumns (rows / N, D, N)
  int* acc;                  // (rows, D), kPartial
  float* mu;                 // (rows), kStats
  float* var;
  int rows, K, D;
  int N;                 // kTokenColumns: tokens an image
  int vec;               // kStats, kPlain, kPartial: res, out and acc rows 16-byte aligned
  int passes_per_block;  // block (x, y) takes passes y * passes_per_block ..
};

// the staging tile, 64 x 128 bf16 unpadded: 16-byte chunk c of row r sits
// at chunk c ^ (r % 8), so the fragment's bf16x2 writes and the rows'
// 16-byte reads meet no bank conflict (rows padded by 16 bytes measured no
// faster for the statistics, and the 128-row layout has no room for them)
__device__ __forceinline__ int row_slot(int r, int c) {
  const int chunk = c >> 3;
  return r * 128 + ((chunk & 8) | ((chunk ^ r) & 7)) * 8 + (c & 7);
}

// kPartial's staging tile, 64 rows x 64 int32 (16 KB, the bf16 tile's
// room): 16-byte chunk c of row r sits at chunk c ^ (2 r % 8) within its
// group of 8, so that a half-warp's 8-byte writes (4 rows, 2 chunks each)
// and a quarter-warp's 16-byte reads (one row) meet no bank conflict
__device__ __forceinline__ int int_slot(int r, int c) {
  const int chunk = c >> 2;
  return r * 64 + ((chunk & 8) | ((chunk ^ (2 * r)) & 7)) * 4 + (c & 3);
}

// element u (a constant after unrolling) of 8 bf16 in a 16-byte vector, read
// without taking the vector's address (which would put it on the stack)
__device__ __forceinline__ __nv_bfloat16 lane_of(const uint4& v, int u) {
  const uint32_t w = u < 2 ? v.x : u < 4 ? v.y : u < 6 ? v.z : v.w;
  return __ushort_as_bfloat16((unsigned short)(u & 1 ? w >> 16 : w & 0xffffu));
}

// The row statistics' arithmetic, each operation rounded on its own
// (intrinsics nvcc does not contract): the kStats epilogue and dense_q8.cu's
// post-reduce pass sum the same values in the same order with these, so
// that their statistics agree bit for bit
__device__ __forceinline__ float sum_in(float s, float f) { return __fadd_rn(s, f); }
__device__ __forceinline__ float square_in(float s, float f) { return __fmaf_rn(f, f, s); }
__device__ __forceinline__ float row_mean(float S1, int D) { return __fdiv_rn(S1, (float)D); }
__device__ __forceinline__ float row_var(float S1, float S2, int D) {
  const float m = row_mean(S1, D);
  return fmaxf(__fsub_rn(__fdiv_rn(S2, (float)D), __fmul_rn(m, m)), 0.f);
}

// y = (float(acc) * a) * ws + bias, each operation rounded once
__device__ __forceinline__ float rescale(int acc, float a, float ws, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), a), ws), bias);
}

// kTokenColumns: out (rows / N, D, N). Within one image a feature's tokens
// are contiguous in out, but a row of N = 1029 bf16 is 2058 bytes, so the
// row's alignment changes from feature to feature. A warpgroup's tile goes
// out a run (its tokens within one image) and 64 features at a time: feature
// c's token k of the run is staged at [c][k + m], m the misalignment (in
// elements) of the run's first token in out, so that chunk j of a staged row
// (9 chunks of 16 bytes: 64 tokens and up to 7 of shift) is the
// 16-byte-aligned chunk j of the run's stretch of out. The chunks the run
// covers go out as one 16-byte load and store a lane (task 8 c + s: no bank
// conflict, a warp's stores on 4 rows); the elements at the run's two ends
// (8 a row for a run of 64, at most 14) then go out 2 bytes a lane, a row's
// on neighbouring lanes, so that no lane waits on another's branch.
constexpr int kColPitch = 72;  // bf16 a staged feature row
static_assert(64 * kColPitch * 2 <= kStagingBytes, "64 staged features");

__device__ __forceinline__ int run_shift(int b, int d, int n0, int N, int D) {
  return (int)(((unsigned)b * D + d) * (unsigned)N + n0) & 7;  // exact mod 8
}

// features d0 .. d0 + 63, tokens n0 .. n0 + len - 1 of image b
__device__ __forceinline__ void store_run(const __nv_bfloat16* st, __nv_bfloat16* out, int N,
                                          int D, int b, int n0, int len, int d0, int tid) {
  const long long row0 = ((long long)b * D + d0) * N + n0;  // feature d0's first token
  for (int i = tid; i < 64 * 8; i += 128) {  // the covered chunks: 8 slots a row
    const int c = i / 8;
    const int m = run_shift(b, d0 + c, n0, N, D);
    const int j = (m > 0) + i % 8, first = 8 * j - m;  // the run's token at the chunk's start
    if (d0 + c >= D || first + 8 > len) continue;
    *reinterpret_cast<uint4*>(out + row0 + (long long)c * N + first) =
        *reinterpret_cast<const uint4*>(st + c * kColPitch + 8 * j);
  }
  // the ends: the head's tokens 0 .. h - 1 and the tail's from where the
  // covered chunks stop; 8 slots a row where the two ends hold 8 tokens or
  // none (len a multiple of 8), else 16
  const int slots = len % 8 == 0 ? 8 : 16;
  for (int i = tid; i < 64 * slots; i += 128) {
    const int c = i / slots, sl = i % slots;
    const int m = run_shift(b, d0 + c, n0, N, D);
    const int h = m > 0 ? min(8 - m, len) : 0;
    const int tail = max(h, 8 * ((len + m) / 8) - m);
    const int k = sl < h ? sl : tail + sl - h;
    if (d0 + c >= D || k >= len) continue;
    out[row0 + (long long)c * N + k] = st[c * kColPitch + k + m];
  }
}

template <int kEpi, int kLayout>
__global__ void __launch_bounds__(kThreads, 1)
q8_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
               const __grid_constant__ CUtensorMap w_map, const Args p) {
  using P = Plan<kLayout>;
  static_assert(kEpi != kStats || kLayout == kSplitFeatures,
                "the statistics need a block to own whole rows");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t full = base + P::kOffBars, empty = full + 8 * kStages;
  const int r0 = blockIdx.x * P::kRows;
  const int ktiles = (p.K + kKStep - 1) / kKStep;
  const int passes = (p.D + kCols - 1) / kCols;
  const int pass0 = blockIdx.y * p.passes_per_block;
  const int npass = min(p.passes_per_block, passes - pass0);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);  // the producer's expect_tx
      mbar_init(empty + 8 * s, 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every copy
    if constexpr (P::kHalves == 2) setmaxnreg_dec<24>();
    if (tid != 0) return;
    for (int it = 0; it < ktiles * npass; ++it) {
      const int s = it % kStages;
      const int q = it / ktiles;
      const int k0 = (it - q * ktiles) * kKStep, d0 = (pass0 + q) * kCols;
      mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
      const uint32_t a_dst = base + s * P::kStageBytes, w_dst = a_dst + P::kABytes;
      const uint32_t bar = full + 8 * s;
      mbar_expect_tx(bar, P::kStageBytes);
      tma_load(a_dst, &a_map, k0, r0, bar);
#pragma unroll
      for (int j = 0; j < kCols / 128; ++j)
        tma_load(w_dst + j * 128 * kKStep, &w_map, k0, d0 + 128 * j, bar);
    }
    return;
  }
  // m64n256's 128 accumulators a thread: the consumers take the producer's
  // registers (on an H100, without it the GEMM took 1.5x the time at the ViT fc1
  // and 2.8x at the qkv)
  if constexpr (P::kHalves == 2) setmaxnreg_inc<240>();

  const int cw = wg - 1, warp = tid / 32, lane = tid % 32;
  // the warpgroup's token rows: the block's 64, or its half of 128
  const int rw = r0 + (kLayout == kSplitRows ? 64 * cw : 0);
  const int rows_valid = min(64, p.rows - rw);  // <= 0 for a half past the end
  __nv_bfloat16* st =
      reinterpret_cast<__nv_bfloat16*>(sbase + P::kOffStaging + cw * kStagingBytes);
  const int ar = warp * 16 + lane / 4;     // accumulator rows ar and ar + 8
  const int vq = tid % 16, rq = tid / 16;  // row stores: 16-byte run vq of rows rq + 8 i
  // the per-token scales of the accumulator rows (0 past the last row;
  // kPartial rescales nothing)
  const float a0 = kEpi != kPartial && ar < rows_valid ? p.a[rw + ar] : 0.f;
  const float a1 = kEpi != kPartial && ar + 8 < rows_valid ? p.a[rw + ar + 8] : 0.f;
  int acc[64 * P::kHalves];
  float s1[8], s2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s1[i] = s2[i] = 0.f;

  int it = 0;
  for (int q = 0; q < npass; ++q) {
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const uint32_t stage = base + s * P::kStageBytes;
      const uint32_t a_tile = stage + (kLayout == kSplitRows ? cw * 64 * kKStep : 0);
      const uint32_t w_tile =
          stage + P::kABytes + (kLayout == kSplitFeatures ? cw * 128 * kKStep : 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKStep / 32; ++kk)  // 32 int8 of K: 32 bytes into each row
        wgmma_s8(acc, sw128_desc(a_tile + kk * 32, 16, 1024),
                 sw128_desc(w_tile + kk * 32, 16, 1024), kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: free its stage
      if (kt > 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + 8 * ((it - 1) % kStages));

    // acc[64 h + 4 j + 2 hh + {0, 1}] is row ar + 8 hh, features 8 j + 2 (lane % 4)
    // + {0, 1} of the warpgroup's 128-feature half h
#pragma unroll
    for (int h = 0; h < P::kHalves; ++h) {
      const int d_base = (pass0 + q) * kCols + 128 * (kLayout == kSplitFeatures ? cw : h);
      if constexpr (kEpi == kStats) {
        // rescale, bias and LayerScale: at the adapter's K = 192 or 384 the
        // epilogue's instructions, more than the products, take the GEMM's
        // time: bf16(y) * bf16(gamma) is one bf16x2 product (exact in fp32,
        // so its one rounding is the plain version's)
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
          for (int hh = 0; hh < 2; ++hh) {
            const float a = hh ? a1 : a0;
            const float y0 = rescale(acc[64 * h + 4 * j + 2 * hh], a, ws0, bb0);
            const float y1 = rescale(acc[64 * h + 4 * j + 2 * hh + 1], a, ws1, bb1);
            *reinterpret_cast<__nv_bfloat162*>(st + row_slot(ar + 8 * hh, c)) =
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
                      ? __ldg(reinterpret_cast<const uint4*>(p.res + (size_t)(rw + r) * p.D + col))
                      : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = rq + 8 * i;
          if (r < rows_valid && col < p.D) {
            const size_t o = (size_t)(rw + r) * p.D + col;
            const uint4 lv = *reinterpret_cast<const uint4*>(st + row_slot(r, 8 * vq));
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
                s1[i] = sum_in(s1[i], f.x);
                s2[i] = square_in(s2[i], f.x);
                s1[i] = sum_in(s1[i], f.y);
                s2[i] = square_in(s2[i], f.y);
              }
              *reinterpret_cast<uint4*>(p.out + o) = rv[i];
            } else {
              for (int u = 0; u < 8 && col + u < p.D; ++u) {
                const __nv_bfloat16 ov = __float2bfloat16(__bfloat162float(p.res[o + u]) +
                                                          __bfloat162float(l8[u]));
                p.out[o + u] = ov;
                const float f = __bfloat162float(ov);
                s1[i] = sum_in(s1[i], f);
                s2[i] = square_in(s2[i], f);
              }
            }
          }
        }
      } else if constexpr (kEpi == kPlain) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = 8 * j + 2 * (lane % 4);
          const int d = d_base + c;
          const bool in0 = d < p.D, in1 = d + 1 < p.D;
          const float ws0 = in0 ? p.ws[d] : 0.f, ws1 = in1 ? p.ws[d + 1] : 0.f;
          const float bb0 = in0 ? p.bias[d] : 0.f, bb1 = in1 ? p.bias[d + 1] : 0.f;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float a = hh ? a1 : a0;
            *reinterpret_cast<__nv_bfloat162*>(st + row_slot(ar + 8 * hh, c)) =
                __floats2bfloat162_rn(rescale(acc[64 * h + 4 * j + 2 * hh], a, ws0, bb0),
                                      rescale(acc[64 * h + 4 * j + 2 * hh + 1], a, ws1, bb1));
          }
        }
        named_barrier(1 + cw, 128);
        const int col = d_base + 8 * vq;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = rq + 8 * i;
          if (r >= rows_valid || col >= p.D) continue;
          const uint4 lv = *reinterpret_cast<const uint4*>(st + row_slot(r, 8 * vq));
          __nv_bfloat16* o = p.out + (size_t)(rw + r) * p.D + col;
          if (p.vec) {
            *reinterpret_cast<uint4*>(o) = lv;
          } else {
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (col + u < p.D) o[u] = lane_of(lv, u);
          }
        }
      } else if constexpr (kEpi == kPartial) {
        // the accumulators as they stand: 64 features of the half at a time
        // staged as int32 pairs, then stored as 16-byte vectors
        int* sti = reinterpret_cast<int*>(st);
#pragma unroll
        for (int sub = 0; sub < 2; ++sub) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = 8 * j + 2 * (lane % 4);
            const int jj = 8 * sub + j;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              *reinterpret_cast<int2*>(sti + int_slot(ar + 8 * hh, c)) =
                  make_int2(acc[64 * h + 4 * jj + 2 * hh], acc[64 * h + 4 * jj + 2 * hh + 1]);
          }
          named_barrier(1 + cw, 128);
          const int col = d_base + 64 * sub + 4 * vq;  // 16 runs of 4 features a row
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = rq + 8 * i;
            if (r >= rows_valid || col >= p.D) continue;
            const int4 v = *reinterpret_cast<const int4*>(sti + int_slot(r, 4 * vq));
            int* o = p.acc + (size_t)(rw + r) * p.D + col;
            if (p.vec) {
              *reinterpret_cast<int4*>(o) = v;
            } else {
              const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int u = 0; u < 4; ++u)
                if (col + u < p.D) o[u] = e[u];
            }
          }
          named_barrier(1 + cw, 128);
        }
      } else {  // kTokenColumns
        // y as bf16 pairs (features c, c + 1 of token ar + 8 hh), all parameter
        // loads issued together; then staged a run and 64 features at a time
        uint32_t y2[32];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int d = d_base + 8 * j + 2 * (lane % 4);
          const bool in0 = d < p.D, in1 = d + 1 < p.D;
          const float ws0 = in0 ? p.ws[d] : 0.f, ws1 = in1 ? p.ws[d + 1] : 0.f;
          const float bb0 = in0 ? p.bias[d] : 0.f, bb1 = in1 ? p.bias[d + 1] : 0.f;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float a = hh ? a1 : a0;
            const __nv_bfloat162 y =
                __floats2bfloat162_rn(rescale(acc[64 * h + 4 * j + 2 * hh], a, ws0, bb0),
                                      rescale(acc[64 * h + 4 * j + 2 * hh + 1], a, ws1, bb1));
            y2[2 * j + hh] = *reinterpret_cast<const uint32_t*>(&y);
          }
        }
        for (int t0 = 0; t0 < rows_valid;) {  // the run: tokens t0 .. t0 + len - 1
          const int b = (rw + t0) / p.N, n0 = rw + t0 - b * p.N;
          const int len = min(rows_valid - t0, p.N - n0);
#pragma unroll
          for (int sub = 0; sub < 2; ++sub) {  // features 64 sub .. of the half
            const int d0 = d_base + 64 * sub;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int c = 8 * j + 2 * (lane % 4);
              const int m0 = run_shift(b, d0 + c, n0, p.N, p.D);
              const int m1 = run_shift(b, d0 + c + 1, n0, p.N, p.D);
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int k = ar + 8 * hh - t0;
                if (k < 0 || k >= len) continue;
                const uint32_t y = y2[2 * (8 * sub + j) + hh];
                st[c * kColPitch + k + m0] = __ushort_as_bfloat16((unsigned short)(y & 0xffffu));
                st[(c + 1) * kColPitch + k + m1] = __ushort_as_bfloat16((unsigned short)(y >> 16));
              }
            }
            named_barrier(1 + cw, 128);
            store_run(st, p.out, p.N, p.D, b, n0, len, d0, tid);
            named_barrier(1 + cw, 128);
          }
          t0 += len;
        }
      }
      named_barrier(1 + cw, 128);  // the staging tile is free for the next half
    }
  }

  if constexpr (kEpi == kStats) {
    // row sums: 16 lanes a row, then the block's two warpgroups
    float* stats = reinterpret_cast<float*>(sbase + P::kOffStats);  // [2][64 rows][2]
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
      p.mu[rw + tid] = row_mean(S1, p.D);
      p.var[rw + tid] = row_var(S1, S2, p.D);
    }
  }
}

// xq (rows, ldq) and wq (D, ldq) int8, K contiguous, into p's epilogue: 0
// or a cudaError_t
template <int kEpi, int kLayout>
int launch_gemm(const void* xq, const void* wq, int ldq, Args p, cudaStream_t stream) {
  using P = Plan<kLayout>;
  if (!aligned16(xq) || !aligned16(wq) || (kEpi == kTokenColumns && !aligned16(p.out)) ||
      (kEpi == kPartial && p.acc == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap a_map, w_map;
  memset(&a_map, 0, sizeof(a_map));
  memset(&w_map, 0, sizeof(w_map));
  const cuuint64_t strides[1] = {(cuuint64_t)ldq};
  // (rows, K): boxes of the block's rows x 128 channels; (D, K): 128 features x 128
  const cuuint64_t a_dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.rows};
  const cuuint32_t a_box[2] = {kKStep, (cuuint32_t)P::kRows};
  int err = s8_sw128_map(&a_map, xq, 2, a_dims, strides, a_box);
  if (err != 0) return err;
  const cuuint64_t w_dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.D};
  const cuuint32_t w_box[2] = {kKStep, 128};
  if ((err = s8_sw128_map(&w_map, wq, 2, w_dims, strides, w_box)) != 0) return err;
  const int row_tiles = (p.rows + P::kRows - 1) / P::kRows;
  const int passes = (p.D + kCols - 1) / kCols;
  // the passes a block walks: all of D where it sums whole rows (kStats);
  // one for the token columns (a 2-D grid: on an H100 0.060 ms for the ViT
  // qkv against 0.071 with pass groups); for kPlain a group, as many groups
  // as fill the card's SMs once beside the row tiles (0.047 ms for the ViT
  // fc1 against 0.052 on the 2-D grid); kPartial as kPlain
  int groups = kEpi == kTokenColumns ? passes : 1;
  if (kEpi == kPlain || kEpi == kPartial) {
    const int sms = sm_count();
    if (sms < 1) return (int)cudaErrorInvalidDevice;
    groups = max(1, min(passes, sms / row_tiles));
  }
  p.passes_per_block = (passes + groups - 1) / groups;
  const dim3 grid(row_tiles, (passes + p.passes_per_block - 1) / p.passes_per_block);
  static unsigned long long ready = 0;  // one bit a device
  const cudaError_t e =
      set_smem_once(q8_gemm_kernel<kEpi, kLayout>, (int)P::kSmemBytes, &ready);
  if (e != cudaSuccess) return (int)e;
  q8_gemm_kernel<kEpi, kLayout><<<grid, kThreads, P::kSmemBytes, stream>>>(a_map, w_map, p);
  return (int)cudaGetLastError();
}

inline int pad16(int n) { return (n + 15) / 16 * 16; }

// the row pass over x (rows, K) in `mode` (QuantMode): into xq (rows,
// pad16(K)) and scale (rows), or with kAmaxOnly the maxima into scale, with
// kGivenScale from the maxima amax. Blocks of up to 256 threads, as many rows
// as 48 KB of staged rows hold where the one pass stages them.
inline cudaError_t launch_quant_rows(const void* x, int rows, int K, void* xq, void* scale,
                                     bool gelu, cudaStream_t stream, int mode = kOnePass,
                                     const void* amax = nullptr) {
  constexpr int kMaxSmem = 232448;  // the opt-in limit of a block
  const int ldq = pad16(K);
  const int row_bytes = ldq * 2;
  if (row_bytes > kMaxSmem || (mode == kGivenScale && amax == nullptr))
    return cudaErrorInvalidValue;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < 32 && (1 << lanes_log2) < ldq / 16) ++lanes_log2;
  const bool staged = mode == kOnePass;
  const int per_block =
      staged ? max(1, min(256 >> lanes_log2, 49152 / row_bytes)) : 256 >> lanes_log2;
  const int blocks = (rows + per_block - 1) / per_block;
  const int threads = per_block << lanes_log2, smem = staged ? per_block * row_bytes : 0;
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* qp = static_cast<int8_t*>(xq);
  auto* sp = static_cast<float*>(scale);
  auto* mp = static_cast<const float*>(amax);
  const int vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  static unsigned long long ready[2] = {0, 0};  // one bit a device, an instance
  if (staged) {
    cudaError_t err =
        gelu ? set_smem_once(quant_rows_kernel<true, kOnePass>, kMaxSmem, &ready[1])
             : set_smem_once(quant_rows_kernel<false, kOnePass>, kMaxSmem, &ready[0]);
    if (err != cudaSuccess) return err;
  }
  auto launch = [&](auto kernel) {
    kernel<<<blocks, threads, smem, stream>>>(xp, rows, K, qp, ldq, sp, mp, vec, lanes_log2);
  };
  if (mode == kOnePass)
    gelu ? launch(quant_rows_kernel<true, kOnePass>)
         : launch(quant_rows_kernel<false, kOnePass>);
  else if (mode == kAmaxOnly)
    gelu ? launch(quant_rows_kernel<true, kAmaxOnly>)
         : launch(quant_rows_kernel<false, kAmaxOnly>);
  else if (mode == kGivenScale)
    gelu ? launch(quant_rows_kernel<true, kGivenScale>)
         : launch(quant_rows_kernel<false, kGivenScale>);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace q8

}  // namespace
