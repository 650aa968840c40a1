// Fused RoPE + multi-head self-attention, for sm_90a, in three layouts.
//
// Replaces three TPU kernels of dinounet_tpu/ops/attention_pallas.py, which
// compute the same function over three layouts:
//   _kernel_pm_dmaj (fused_rope_attention_premapped_dmaj), the Dh-major
//     layout of the stats-threaded ViT chain (ViT-S/B/L, Dh = 64):
//       qkv (B, 3, M, Dh, N) bf16 -> out (B, M, Dh, N) bf16
//   _kernel (fused_rope_attention), the row-major layout of the unfused
//     blocks (the SwiGLU ViT-7B, Dh = 128):
//       qkv (B, N, 3, M, Dh) bf16 -> out (B, N, M, Dh) bf16
//   _kernel_pm (fused_rope_attention_premapped), the (B, 3, M, N, Dh) layout
//     the stats-threaded chain takes with DINOUNET_TPU_ATTN_LAYOUT=ndh:
//       qkv (B, 3, M, N, Dh) bf16 -> out (B, M, Dh, N) bf16
// each with the model's RoPE tables sin, cos (N, Dh) fp32 (identity rows for
// the prefix tokens), or none (null pointers: no rotation).
// out = softmax(q k^T / sqrt(Dh)) v per (b, head). RoPE runs in fp32 with
// rotate-half's sign folded in here: r[d] = x[d] cos[d] + x[(d + Dh/2) % Dh]
// sin[d] (-sin[d] for d < Dh/2); q is scaled by Dh^-1/2 before its bf16
// rounding. Scores are fp32 from the tensor cores, probabilities exp(s -
// running row max) are rounded to bf16 for the PV product, and the output is
// divided by the fp32 sum of those rounded probabilities. Keys past N are
// masked with -inf; query rows past N are computed on zeros and not stored.
// Dh is 64 or 128. Forward only: the backbone is frozen.
//
// What bounds it on an H100: a head does 4 N^2 Dh FLOP on 6 N Dh bytes of
// q/k/v (0.27 GFLOP on 0.8 MB at dinounet_b's N = 1029, Dh = 64), so it is
// compute-bound once the score matrix stays on chip, and only wgmma reaches
// Hopper's tensor-core rate. At Dh = 64 the N^2 exponentials of the softmax
// cost the SM's special-function units about as long as the products cost
// the tensor cores.
//
// Design (the shape of Hopper's fast attention kernels, kept simple):
// 1. A pre-pass writes rotated-and-scaled q, rotated k and v once into one
//    scratch layout for all three inputs, (3, B, M, Npad, Dh) bf16 token-major
//    (Npad = N rounded up to 128, zero past N), since every query tile reads
//    every key tile of its head. The token-major inputs are read in 16-byte
//    vectors, 8 channels of one token a thread. The Dh-major input is
//    transposed through shared memory: a block takes 64 tokens of every
//    channel row, read as aligned 16-byte vectors (row d starts at element
//    d N, 16-byte aligned only where d N is a multiple of 8, so the block
//    reads the aligned window around its tokens and shifts by the row's
//    offset), and writes 16-byte runs of 8 channels a token.
// 2. The flash loop: one block per (b, head, 128-query tile), three
//    warpgroups. A producer thread starts TMA copies (cp.async.bulk.tensor
//    over a 2-D tensor map of the scratch, 128-row boxes of one 64-channel
//    panel in the 128-byte swizzle that the wgmma descriptors read; the map
//    is encoded per call on the host with cuTensorMapEncodeTiled, found
//    through the CUDA runtime: the library links no libcuda): the q tile once, then K and V
//    through a ring of stages (4 at Dh = 64, 2 at Dh = 128), each with its
//    own mbarriers for K and for V (QK^T starts before V lands) and one that
//    the consumers arrive on when the stage is free. Two consumer
//    warpgroups own 64 query rows each:
//    - S = Q K^T is wgmma m64n128k16 with both operands K-major in shared
//      memory; the fp32 scores stay in registers;
//    - the online softmax runs on those registers: a row of the accumulator
//      lies in one quad of threads, so the row max takes two shuffles, and
//      each thread keeps its part of the row sum until the epilogue;
//    - P, rounded to bf16 in registers, is already laid out as wgmma's
//      register A operand (the accumulator's fragment layout), and O += P V
//      is wgmma m64n{Dh}k16 with V token-major in shared memory, the
//      transposed (MN-major) B form;
//    - O stays in registers as an fp32 m64n{Dh} accumulator (32 or 64 a
//      thread), rescaled by alpha in registers.
//    While one warpgroup runs its softmax the other's products keep the
//    tensor cores busy (with one consumer warpgroup a block, kConsumers = 1,
//    the path's three shapes ran 18-28 % slower in kernel_ab.py on an NVIDIA
//    H100 80GB HBM3 at 700 W). Keys past N exist only in the last key tile, the one
//    place the scores are masked; a warpgroup whose 64 rows all lie past N
//    (the last tile of N = 1029) does not start.
// 3. The epilogue divides O by the row sum, rounds to bf16 and stages the
//    warpgroup's 64 rows in shared memory, then stores in 16-byte runs:
//    along Dh for the row-major output; along N for the channel-major one
//    (a channel row starts at element d N, so each row's run is aligned
//    16-byte vectors with at most 7 scalar stores at either end).
// Departures from the fastest known form, left for later work: no
// setmaxnreg (the consumers fit the 168 registers a thread that one
// 384-thread block an SM leaves: ptxas gives the loop 127 at Dh = 64 and 159
// at Dh = 128, no spills; a setmaxnreg.inc that asks for more than the block
// holds would stall), no intra-warpgroup overlap of the next
// QK^T with the softmax, no persistent blocks. Four loop instances: Dh 64
// or 128 times row- or channel-major epilogue.

#include <math.h>

#include "hopper_common.cuh"

namespace {

constexpr int kConsumers = 2;     // consumer warpgroups a block, 64 query rows each
constexpr int kBlockQ = 64 * kConsumers;        // query rows a block
constexpr int kThreads = 128 * (1 + kConsumers);  // + the producer warpgroup
constexpr int kBlockK = 128;      // keys a ring stage; the scratch's token padding
constexpr int kPanel = 64;        // channels of one 128-byte swizzled panel
constexpr int kPanelBytes = 128 * kPanel * 2;  // 128 rows of one panel: one TMA box
constexpr int kPrepTokens = 64;   // tokens a Dh-major pre-pass block
constexpr float kLog2e = 1.4426950408889634f;

constexpr uint32_t cmax(uint32_t a, uint32_t b) { return a > b ? a : b; }

// the qkv layout: (B, 3, M, Dh, N), (B, N, 3, M, Dh) or (B, 3, M, N, Dh)
enum Layout { kDmaj, kRowMajor, kNdh };

// shared-memory plan of one flash-loop block (byte offsets from a
// 1024-byte-aligned base: the swizzle repeats every 8 rows of 128 bytes)
template <int DH>
struct Plan {
  static constexpr int kPanels = DH / kPanel;
  static constexpr int kStages = DH == 64 ? 4 : 2;
  static constexpr uint32_t kTileBytes = kPanels * kPanelBytes;  // 128 rows of q, k or v
  static constexpr int kLdR = DH + 8;  // row-major staging: [64 rows][DH]
  static constexpr int kLdC = 64 + 8;  // channel-major staging: [DH][64 rows]
  static constexpr uint32_t kStageBytes = 2 * cmax(64 * kLdR, DH * kLdC);  // a warpgroup's
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = q + kTileBytes;
  static constexpr uint32_t v = k + kStages * kTileBytes;
  static constexpr uint32_t o = v + kStages * kTileBytes;
  // mbarriers: q, then K full, V full and stage free of each stage
  static constexpr uint32_t bars = o + kConsumers * kStageBytes;
  static constexpr uint32_t bytes = bars + 8 * (1 + 3 * kStages) + 1024;  // + alignment
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the 8 channels d0..d0+7 of one token: y = x cos + xp sin (-sin for d <
// Dh/2), xp the rotate-half partners, times mul, rounded to bf16; no tables:
// x times mul
template <int DH>
__device__ __forceinline__ uint4 rope8(const float (&x)[8], const float (&xp)[8],
                                       const float* __restrict__ sin,
                                       const float* __restrict__ cos, int n, int d0,
                                       float mul) {
  float r[8];
  if (sin != nullptr) {
    const float4* s4 = reinterpret_cast<const float4*>(sin + (size_t)n * DH + d0);
    const float4* c4 = reinterpret_cast<const float4*>(cos + (size_t)n * DH + d0);
    const float4 s0 = s4[0], s1 = s4[1], c0 = c4[0], c1 = c4[1];
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float sign = d0 < DH / 2 ? -1.f : 1.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) r[u] = x[u] * c[u] + xp[u] * (sign * s[u]);
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) r[u] = x[u];
  }
  uint4 y;
  __nv_bfloat16* y8 = reinterpret_cast<__nv_bfloat16*>(&y);
#pragma unroll
  for (int u = 0; u < 8; ++u) y8[u] = __float2bfloat16(r[u] * mul);
  return y;
}

// token-major pre-pass of the row-major and (N, Dh) layouts (NDH): scratch
// (3, B, M, Npad, Dh); each thread takes 8 adjacent channels of one token
// (16-byte reads and writes)
template <int DH, bool NDH>
__global__ void rope_prep_tokens_kernel(const __nv_bfloat16* __restrict__ qkv,
                                        const float* __restrict__ sin,
                                        const float* __restrict__ cos,
                                        __nv_bfloat16* __restrict__ scratch, int B, int M,
                                        int N, int Npad, float scale) {
  constexpr int kChunks = DH / 8;
  const size_t total = (size_t)3 * B * M * Npad * kChunks;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int d0 = (int)(i % kChunks) * 8;
    size_t r = i / kChunks;
    const int n = (int)(r % Npad);
    r /= Npad;
    const int m = (int)(r % M);
    r /= M;
    const int b = (int)(r % B);
    const int part = (int)(r / B);  // 0 q, 1 k, 2 v
    uint4 y = make_uint4(0u, 0u, 0u, 0u);
    if (n < N) {
      const __nv_bfloat16* row =
          NDH ? qkv + ((((size_t)b * 3 + part) * M + m) * N + n) * DH
              : qkv + (((size_t)b * N + n) * 3 + part) * M * DH + (size_t)m * DH;
      const uint4 xv = *reinterpret_cast<const uint4*>(row + d0);
      if (part == 2) {
        y = xv;
      } else {
        const uint4 pv = *reinterpret_cast<const uint4*>(row + (d0 + DH / 2) % DH);
        const __nv_bfloat16* x8 = reinterpret_cast<const __nv_bfloat16*>(&xv);
        const __nv_bfloat16* p8 = reinterpret_cast<const __nv_bfloat16*>(&pv);
        float x[8], xp[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          x[u] = __bfloat162float(x8[u]);
          xp[u] = __bfloat162float(p8[u]);
        }
        y = rope8<DH>(x, xp, sin, cos, n, d0, part == 0 ? scale : 1.f);
      }
    }
    *reinterpret_cast<uint4*>(scratch + i * 8) = y;
  }
}

// Dh-major pre-pass: one block per (64 tokens, (b, part, head) plane of the
// input); the plane's (Dh, 64) window goes through shared memory and leaves
// token-major
template <int DH>
__global__ void __launch_bounds__(256)
rope_prep_dmaj_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ sin,
                      const float* __restrict__ cos, __nv_bfloat16* __restrict__ scratch,
                      int B, int M, int N, int Npad, float scale) {
  constexpr int kVecs = kPrepTokens / 8 + 1;  // aligned vectors that cover 64 tokens
  constexpr int kLd = 8 * kVecs;
  // row d at d * kLd + 8 * (d / 8): rows of one 8-channel chunk spread over banks
  __shared__ __align__(16) __nv_bfloat16 tile[DH * kLd + DH];
  const int plane = blockIdx.y;  // (b, part, head) in the input's order
  const int m = plane % M, part = (plane / M) % 3, b = plane / (3 * M);
  const int n0 = blockIdx.x * kPrepTokens;
  const int count = min(kPrepTokens, N - n0);  // tokens below N (none past N)
  const __nv_bfloat16* x = qkv + (size_t)plane * DH * N;
  // the window of row d starts `shift` elements before token n0 (the
  // plane starts 16-byte aligned: Dh N is a multiple of 8)
  for (int i = threadIdx.x; i < DH * kVecs; i += blockDim.x) {
    const int d = i / kVecs, v = i % kVecs;
    const int shift = (d * N + n0) & 7;
    if (8 * v < shift + count)
      *reinterpret_cast<uint4*>(tile + d * kLd + 8 * (d / 8) + 8 * v) =
          *reinterpret_cast<const uint4*>(x + (size_t)d * N + n0 - shift + 8 * v);
  }
  __syncthreads();
  constexpr int kChunks = DH / 8;
  __nv_bfloat16* y_plane = scratch + (((size_t)part * B + b) * M + m) * Npad * DH;
  for (int i = threadIdx.x; i < kPrepTokens * kChunks; i += blockDim.x) {
    const int c = i % kChunks, j = i / kChunks;
    uint4 y = make_uint4(0u, 0u, 0u, 0u);
    // channel d of token j in the tile
    auto at = [&](int d) { return tile[d * kLd + 8 * (d / 8) + ((d * N + n0) & 7) + j]; };
    if (j < count) {
      __nv_bfloat16* y8 = reinterpret_cast<__nv_bfloat16*>(&y);
      if (part == 2) {
#pragma unroll
        for (int u = 0; u < 8; ++u) y8[u] = at(8 * c + u);
      } else {
        float xs[8], xp[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          xs[u] = __bfloat162float(at(8 * c + u));
          xp[u] = __bfloat162float(at((8 * c + u + DH / 2) % DH));
        }
        y = rope8<DH>(xs, xp, sin, cos, n0 + j, 8 * c, part == 0 ? scale : 1.f);
      }
    }
    *reinterpret_cast<uint4*>(y_plane + (size_t)(n0 + j) * DH + 8 * c) = y;
  }
}

// the flash loop over the scratch (tensor map `map`: 3 B M Npad rows of Dh);
// grid (ceil(N / kBlockQ), M, B): every block has a query row below N (the
// q copy is one 128-row box whatever kBlockQ); out row-major (B, N, M, Dh)
// or channel-major (B, M, Dh, N)
template <int DH, bool kChannelMajor>
__global__ void __launch_bounds__(kThreads, 1)
rope_attention_kernel(const __grid_constant__ CUtensorMap map, __nv_bfloat16* __restrict__ out,
                      int B, int M, int N, int Npad) {
  using L = Plan<DH>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_full = base + L::bars;
  const int b = blockIdx.z, m = blockIdx.y, n0 = blockIdx.x * kBlockQ;
  const int head = b * M + m;
  const int active = min(kConsumers, (N - n0 + 63) / 64);  // warpgroups with a row below N
  const int tiles = (N + kBlockK - 1) / kBlockK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(q_full + 8 * (1 + s), 1);              // K of stage s landed
      mbar_init(q_full + 8 * (1 + S + s), 1);          // V of stage s landed
      mbar_init(q_full + 8 * (1 + 2 * S + s), 128 * active);  // stage s free
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread starts every copy
    if (threadIdx.x != 0) return;
    const int rows = B * M * Npad;  // scratch rows of each of q, k and v
    const int row_k = rows + head * Npad, row_v = 2 * rows + head * Npad;
    mbar_expect_tx(q_full, L::kTileBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      tma_load(base + L::q + p * kPanelBytes, &map, p * kPanel, head * Npad + n0, q_full);
    for (int t = 0; t < tiles; ++t) {
      const int s = t % S;
      const uint32_t k_full = q_full + 8 * (1 + s), v_full = q_full + 8 * (1 + S + s);
      mbar_wait(q_full + 8 * (1 + 2 * S + s), ((t / S) & 1) ^ 1);
      mbar_expect_tx(k_full, L::kTileBytes);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
        tma_load(base + L::k + s * L::kTileBytes + p * kPanelBytes, &map, p * kPanel,
                 row_k + t * kBlockK, k_full);
      mbar_expect_tx(v_full, L::kTileBytes);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
        tma_load(base + L::v + s * L::kTileBytes + p * kPanelBytes, &map, p * kPanel,
                 row_v + t * kBlockK, v_full);
    }
    return;
  }

  const int cw = wg - 1;  // consumer warpgroup: query rows n0 + 64 cw ...
  if (cw >= active) return;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  // this thread's accumulator rows (of the warpgroup's 64): r0 and r0 + 8
  const int r0 = warp * 16 + lane / 4;
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const uint32_t q_rows = base + L::q + cw * 64 * 128;
  mbar_wait(q_full, 0);

  for (int t = 0; t < tiles; ++t) {
    const int s = t % S;
    const uint32_t ph = (t / S) & 1;
    const uint32_t k_tile = base + L::k + s * L::kTileBytes;
    const uint32_t v_tile = base + L::v + s * L::kTileBytes;

    // S = Q K^T: 64 rows x 128 keys, K-major operands; 16 channels a step
    // (32 bytes into a 128-byte swizzled row, then the next panel)
    float sc[64];
    mbar_wait(q_full + 8 * (1 + s), ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
      wgmma_ss_n128(sc, sw128_desc(q_rows + off, 16, 1024), sw128_desc(k_tile + off, 16, 1024),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // sc[4j + {0, 1}]: row r0, keys 8j + 2 (lane % 4) + {0, 1}; sc[4j + {2, 3}]:
    // row r0 + 8, the same keys
    const int valid = N - t * kBlockK;
    if (valid < kBlockK) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int key = 8 * j + 2 * (lane % 4);
        if (key >= valid) sc[4 * j] = sc[4 * j + 2] = -INFINITY;
        if (key + 1 >= valid) sc[4 * j + 1] = sc[4 * j + 3] = -INFINITY;
      }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    float alpha[2], ml[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = ex2((m_run[h] - mx[h]) * kLog2e);  // 0 on the first tile
      ml[h] = mx[h] * kLog2e;
      m_run[h] = mx[h];  // finite: every key tile holds a key below N
    }
    // P = exp(s - m) rounded to bf16, packed in pairs: pa[4 kk .. 4 kk + 3]
    // is the A fragment of keys 16 kk .. 16 kk + 15
    uint32_t pa[32];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const __nv_bfloat162 p2 = __floats2bfloat162_rn(ex2(fmaf(sc[2 * i], kLog2e, -ml[i & 1])),
                                                      ex2(fmaf(sc[2 * i + 1], kLog2e, -ml[i & 1])));
      pa[i] = *reinterpret_cast<const uint32_t*>(&p2);
      const float2 f = __bfloat1622float2(p2);
      sum[i & 1] += f.x + f.y;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + sum[h];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }

    // O += P V: V token-major (MN-major B), 16 keys a step = 16 rows of
    // 128 bytes; its second 64-channel panel (Dh = 128) one panel further
    mbar_wait(q_full + 8 * (1 + S + s), ph);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
      const uint64_t vd = sw128_desc(v_tile + kk * 16 * 128, kPanelBytes, 1024);
      if constexpr (DH == 64)
        wgmma_rs_n64(o, a, vd);
      else
        wgmma_rs_n128(o, a, vd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(q_full + 8 * (1 + 2 * S + s));
  }

  // epilogue: O / l in bf16, staged per warpgroup, stored in 16-byte runs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
  __nv_bfloat16* st =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + (base - raw) + L::o + cw * L::kStageBytes);
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(o[4 * j] / l_run[0], o[4 * j + 1] / l_run[0]);
    const __nv_bfloat162 hi =
        __floats2bfloat162_rn(o[4 * j + 2] / l_run[1], o[4 * j + 3] / l_run[1]);
    if (kChannelMajor) {  // [DH][64 rows]
      st[c * L::kLdC + r0] = lo.x;
      st[(c + 1) * L::kLdC + r0] = lo.y;
      st[c * L::kLdC + r0 + 8] = hi.x;
      st[(c + 1) * L::kLdC + r0 + 8] = hi.y;
    } else {  // [64 rows][DH]
      *reinterpret_cast<__nv_bfloat162*>(st + r0 * L::kLdR + c) = lo;
      *reinterpret_cast<__nv_bfloat162*>(st + (r0 + 8) * L::kLdR + c) = hi;
    }
  }
  named_barrier(1 + cw, 128);
  const int q0 = n0 + 64 * cw;
  const int rows = min(64, N - q0);  // query rows below N
  if (!kChannelMajor) {  // (B, N, M, Dh): a token's Dh channels adjacent
    constexpr int kChunks = DH / 8;
    for (int i = tid; i < rows * kChunks; i += 128) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      *reinterpret_cast<uint4*>(out + (((size_t)b * N + q0 + r) * M + m) * DH + c) =
          *reinterpret_cast<const uint4*>(st + r * L::kLdR + c);
    }
  } else {  // (B, M, Dh, N): 8 lanes a channel row, a 16-byte vector each
    const int li = lane % 8;
    for (int d = warp * 4 + lane / 8; d < DH; d += 16) {
      const size_t g = ((size_t)head * DH + d) * N + q0;  // the run's first element
      const int lead = min(rows, (int)((8 - (g & 7)) & 7));
      const int vecs = (rows - lead) / 8;
      const int tail = lead + 8 * vecs;
      const __nv_bfloat16* src = st + d * L::kLdC;
      __nv_bfloat16* dst = out + g;
      if (li < lead) dst[li] = src[li];
      if (li < vecs) {
        uint4 v;
        __nv_bfloat16* v8 = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
        for (int u = 0; u < 8; ++u) v8[u] = src[lead + 8 * li + u];
        *reinterpret_cast<uint4*>(dst + lead + 8 * li) = v;
      }
      if (tail + li < rows) dst[tail + li] = src[tail + li];
    }
  }
}

// the scratch as a 2-D tensor of `rows` rows of DH bf16, read in boxes of
// 128 rows x 64 channels with the 128-byte swizzle
int scratch_map(CUtensorMap* map, void* scratch, int DH, long long rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)DH, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)DH * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {(cuuint32_t)kPanel, (cuuint32_t)kBlockK};
  return bf16_sw128_map(map, scratch, 2, dims, strides, box);
}

// the loop instance's shared-memory size, set once a device
template <int DH, bool CM>
cudaError_t prepare_loop() {
  static unsigned long long ready = 0;  // one bit a device
  return set_smem_once(rope_attention_kernel<DH, CM>, (int)Plan<DH>::bytes, &ready);
}

template <int DH, Layout kLayout>
int launch(const void* qkv, const void* sin, const void* cos, void* scratch, void* out, int B,
           int M, int N, float scale, cudaStream_t stream) {
  constexpr bool kChannelMajor = kLayout != kRowMajor;
  const int Npad = (N + kBlockK - 1) / kBlockK * kBlockK;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(qkv);
  const float* s = static_cast<const float*>(sin);
  const float* c = static_cast<const float*>(cos);
  __nv_bfloat16* sc = static_cast<__nv_bfloat16*>(scratch);
  if (kLayout == kDmaj) {
    rope_prep_dmaj_kernel<DH><<<dim3(Npad / kPrepTokens, 3 * B * M), 256, 0, stream>>>(
        x, s, c, sc, B, M, N, Npad, scale);
  } else {
    const size_t items = (size_t)3 * B * M * Npad * (DH / 8);
    const int blocks = (int)((items + 255) / 256 < 8192 ? (items + 255) / 256 : 8192);
    rope_prep_tokens_kernel<DH, kLayout == kNdh><<<blocks, 256, 0, stream>>>(
        x, s, c, sc, B, M, N, Npad, scale);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map;
  const int map_err = scratch_map(&map, scratch, DH, 3LL * B * M * Npad);
  if (map_err != 0) return map_err;
  err = prepare_loop<DH, kChannelMajor>();
  if (err != cudaSuccess) return (int)err;
  rope_attention_kernel<DH, kChannelMajor>
      <<<dim3((N + kBlockQ - 1) / kBlockQ, M, B), kThreads, Plan<DH>::bytes, stream>>>(
          map, static_cast<__nv_bfloat16*>(out), B, M, N, Npad);
  return (int)cudaGetLastError();
}

template <Layout kLayout>
int dispatch(const void* qkv, const void* sin, const void* cos, void* scratch, void* out,
             int B, int M, int Dh, int N, float scale, void* stream) {
  if (B < 1 || M < 1 || N < 1 || (sin == nullptr) != (cos == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64) return launch<64, kLayout>(qkv, sin, cos, scratch, out, B, M, N, scale, st);
  if (Dh == 128) return launch<128, kLayout>(qkv, sin, cos, scratch, out, B, M, N, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Every entry: sin, cos the (N, Dh) fp32 RoPE tables or both null (no
// rotation); scratch (3, B, M, ceil(N / 128) * 128, Dh) bf16, allocated by
// the caller; qkv, scratch and the tables 16-byte aligned.

// Dh-major: qkv (B, 3, M, Dh, N), out (B, M, Dh, N)
extern "C" int rope_attention_dmaj(const void* qkv, const void* sin, const void* cos,
                                   void* scratch, void* out, int B, int M, int Dh, int N,
                                   float scale, void* stream) {
  return dispatch<kDmaj>(qkv, sin, cos, scratch, out, B, M, Dh, N, scale, stream);
}

// row-major: qkv (B, N, 3, M, Dh), out (B, N, M, Dh)
extern "C" int rope_attention_rowmajor(const void* qkv, const void* sin, const void* cos,
                                       void* scratch, void* out, int B, int M, int Dh, int N,
                                       float scale, void* stream) {
  return dispatch<kRowMajor>(qkv, sin, cos, scratch, out, B, M, Dh, N, scale, stream);
}

// (N, Dh) planes: qkv (B, 3, M, N, Dh), out (B, M, Dh, N)
extern "C" int rope_attention_ndh(const void* qkv, const void* sin, const void* cos,
                                  void* scratch, void* out, int B, int M, int Dh, int N,
                                  float scale, void* stream) {
  return dispatch<kNdh>(qkv, sin, cos, scratch, out, B, M, Dh, N, scale, stream);
}
