// Fused RoPE + multi-head self-attention, for sm_90a, in three layouts.
//
// Replaces three TPU kernels of dinounet_tpu/ops/attention_pallas.py, which
// compute the same function over three layouts:
//   _kernel_pm_dmaj (fused_rope_attention_premapped_dmaj), the Dh-major
//     layout of the stats-threaded ViT chain (ViT-S/B/L, Dh = 64):
//       qkv   (B, 3, M, Dh, N) bf16 -> out (B, M, Dh, N) bf16
//       sin_t, cos_t (Dh, N) fp32
//   _kernel (fused_rope_attention), the row-major layout of the unfused
//     blocks (the SwiGLU ViT-7B, Dh = 128):
//       qkv   (B, N, 3, M, Dh) bf16 -> out (B, N, M, Dh) bf16
//       sin, cos (N, Dh) fp32
//   _kernel_pm (fused_rope_attention_premapped), the (B, 3, M, N, Dh) layout
//     the stats-threaded chain takes with DINOUNET_TPU_ATTN_LAYOUT=ndh:
//       qkv   (B, 3, M, N, Dh) bf16 -> out (B, M, Dh, N) bf16
//       sin, cos (N, Dh) fp32
// out = softmax(q k^T / sqrt(Dh)) v per (b, head). RoPE runs in fp32 on
// tables with rotate-half's sign folded into sin (identity entries -- sin 0,
// cos 1 -- for the prefix tokens): r[d] = x[d] cos[d] + x[(d + Dh/2) % Dh]
// sin[d]; q is scaled by Dh^-1/2 before its bf16 rounding. Scores accumulate
// in fp32 on the tensor cores, probabilities are rounded to bf16 for the PV
// product, and the output is divided by the fp32 sum of those rounded
// probabilities. Dh is 64 or 128. Forward only: the backbone is frozen.
//
// What bounds it on an H100: at dinounet_b shapes (N = 1029 tokens, Dh = 64)
// a head does 2 * 2 * N^2 * Dh = 0.27 GFLOP on 0.4 MB of q/k/v, about 650
// FLOP/byte, and at the 7B's Dh = 128 twice that: compute-bound once the
// score matrix stays on chip. The TPU kernels held a head's whole N x N score
// matrix in VMEM; a Hopper SM has 227 KB of shared memory, so this kernel is
// flash-style instead: one block takes one (b, head, 64-query tile), loops
// over 64-key tiles with an online softmax (running row max and row sum, the
// output rescaled as the max moves), and never writes scores to device
// memory. Each key tile is read by every query tile of its head, so the RoPE
// rotation is not redone there: a pre-pass writes rotated-and-scaled q,
// rotated k and v once into a scratch buffer zero-padded to a multiple of 64
// tokens, in the layout the tile loads read with 16-byte copies (Dh-major
// planes for the Dh-major input, token-major rows for the row-major one, so
// the pre-pass reads and writes contiguous rows in both), and the next key
// tile is prefetched into registers while the current one is multiplied.
// The (B, 3, M, N, Dh) layout holds each (b, part, head) as a contiguous
// (N, Dh) plane, so its pre-pass reads those rows in 16-byte vectors and
// writes the token-major scratch of the row-major layout, and its epilogue
// stores channel-major as the Dh-major layout does. One flash loop serves
// all three (the template parameter Layout; token-major tiles for the
// row-major and (N, Dh) inputs): the tiles keep their scratch layout in
// shared memory and the WMMA fragments (bf16 x bf16 -> fp32, 16 x 16 x 16)
// read them column- or row-major as each product needs; only the pre-pass
// and the epilogue's store differ, each instance compiled for its own. Four warps each own 16 query
// rows. The output accumulator is an fp32 tile in shared memory that each
// warp rescales by its rows' alpha and then accumulates p v into directly
// (WMMA accumulator load, multiply-add, store), so no separate p v buffer
// exists: 63 KB a block at Dh = 64 (3 blocks an SM), 96 KB (row-major) or
// 99 KB (Dh-major) at Dh = 128 (2 blocks an SM; a 128-query tile or a
// separate p v tile would leave one). Keys past N are masked with -inf; query
// rows past N are computed on zeros and not stored. wgmma, TMA and
// register-resident outputs are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int kTile = 64;        // queries per block and keys per step
constexpr int kWarps = 4;        // each owns 16 query rows
constexpr int kThreads = 32 * kWarps;
constexpr int kLdP = kTile + 8;  // bf16 probability tile row pitch (elements)
constexpr int kLdS = kTile + 4;  // fp32 score tile row pitch

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// the qkv layout: (B, 3, M, Dh, N), (B, N, 3, M, Dh) or (B, 3, M, N, Dh)
enum Layout { kDmaj, kRowMajor, kNdh };

// shared-memory plan of one block; q, k and v tiles in the scratch layout:
// Dh-major [d][token] (pitch kTile + 8) or token-major [token][d] (pitch
// Dh + 8). Every section starts on a 128-byte boundary.
template <int DH, bool RM>
struct Smem {
  static constexpr int kLdT = RM ? DH + 8 : kTile + 8;
  static constexpr size_t kTileBytes = sizeof(__nv_bfloat16) * (RM ? kTile : DH) * kLdT;
  static constexpr int kLdO = DH + 4;
  static constexpr size_t p = 0;  // bf16 probabilities [query][key]
  static constexpr size_t k = p + sizeof(__nv_bfloat16) * kTile * kLdP;
  static constexpr size_t v = k + kTileBytes;
  // the q tile until its fragments are loaded, then the fp32 scores
  static constexpr size_t sq = v + kTileBytes;
  static constexpr size_t o = sq + cmax(sizeof(float) * kTile * kLdS, kTileBytes);
  static constexpr size_t stats = o + sizeof(float) * kTile * kLdO;
  static constexpr size_t bytes = stats + sizeof(float) * 3 * kTile;
};

// Dh-major pre-pass: scratch (3, B, M, Dh, Npad), rotated and scaled q,
// rotated k, v; zero past N
__global__ void rope_prep_dmaj_kernel(const __nv_bfloat16* __restrict__ qkv,
                                      const float* __restrict__ sin_t,
                                      const float* __restrict__ cos_t,
                                      __nv_bfloat16* __restrict__ scratch, int B,
                                      int M, int DH, int N, int Npad, float scale) {
  const size_t total = (size_t)3 * B * M * DH * Npad;
  const int half = DH / 2;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int n = (int)(i % Npad);
    size_t r = i / Npad;
    const int d = (int)(r % DH);
    r /= DH;
    const int m = (int)(r % M);
    r /= M;
    const int b = (int)(r % B);
    const int which = (int)(r / B);  // 0 q, 1 k, 2 v
    float y = 0.f;
    if (n < N) {
      const __nv_bfloat16* x = qkv + (((size_t)b * 3 + which) * M + m) * DH * N;
      const float xv = __bfloat162float(x[(size_t)d * N + n]);
      if (which == 2) {
        y = xv;
      } else {
        const int dp = d < half ? d + half : d - half;
        const float xp = __bfloat162float(x[(size_t)dp * N + n]);
        y = xv * cos_t[(size_t)d * N + n] + xp * sin_t[(size_t)d * N + n];
        if (which == 0) y *= scale;
      }
    }
    scratch[i] = __float2bfloat16(y);
  }
}

// token-major pre-pass of the row-major and (N, Dh) layouts (NDH): scratch
// (3, B, M, Npad, Dh), the same values; each thread takes 8 adjacent channels
// of one token (16-byte reads and writes)
template <int DH, bool NDH>
__global__ void rope_prep_rowmajor_kernel(const __nv_bfloat16* __restrict__ qkv,
                                          const float* __restrict__ sin_t,
                                          const float* __restrict__ cos_t,
                                          __nv_bfloat16* __restrict__ scratch, int B,
                                          int M, int N, int Npad, float scale) {
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
    const int which = (int)(r / B);  // 0 q, 1 k, 2 v
    uint4 y = make_uint4(0u, 0u, 0u, 0u);
    if (n < N) {
      const __nv_bfloat16* row =
          NDH ? qkv + ((((size_t)b * 3 + which) * M + m) * N + n) * DH
              : qkv + (((size_t)b * N + n) * 3 + which) * M * DH + (size_t)m * DH;
      const uint4 xv = *reinterpret_cast<const uint4*>(row + d0);
      if (which == 2) {
        y = xv;
      } else {
        const uint4 pv = *reinterpret_cast<const uint4*>(row + (d0 + DH / 2) % DH);
        const __nv_bfloat16* x8 = reinterpret_cast<const __nv_bfloat16*>(&xv);
        const __nv_bfloat16* p8 = reinterpret_cast<const __nv_bfloat16*>(&pv);
        const float* s = sin_t + (size_t)n * DH + d0;
        const float* c = cos_t + (size_t)n * DH + d0;
        __nv_bfloat16* y8 = reinterpret_cast<__nv_bfloat16*>(&y);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v = __bfloat162float(x8[j]) * c[j] + __bfloat162float(p8[j]) * s[j];
          if (which == 0) v *= scale;
          y8[j] = __float2bfloat16(v);
        }
      }
    }
    *reinterpret_cast<uint4*>(scratch + i * 8) = y;
  }
}

// one (Dh x 64) or (64 x Dh) tile of the scratch as 16-byte vectors, kVec a
// thread: rows of 8-element chunks, (DH or 64) rows in the tile's layout
template <int DH, bool RM>
struct TileRegs {
  static constexpr int kVec = DH * kTile / 8 / kThreads;
  static constexpr int kRowChunks = (RM ? DH : kTile) / 8;
  uint4 r[kVec];

  // g: the plane of one (which, b, head); tok0: the tile's first token
  __device__ void load(const __nv_bfloat16* g, int tok0, int Npad) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / kRowChunks;
      const int c = (idx % kRowChunks) * 8;
      const size_t off = RM ? (size_t)(tok0 + row) * DH + c
                            : (size_t)row * Npad + tok0 + c;
      r[i] = *reinterpret_cast<const uint4*>(g + off);
    }
  }
  __device__ void store(__nv_bfloat16* s) const {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / kRowChunks;
      const int c = (idx % kRowChunks) * 8;
      *reinterpret_cast<uint4*>(s + row * Smem<DH, RM>::kLdT + c) = r[i];
    }
  }
};

template <int DH, Layout kLayout>
__global__ void __launch_bounds__(kThreads)
rope_attention_kernel(const __nv_bfloat16* __restrict__ scratch,
                      __nv_bfloat16* __restrict__ out, int B, int M, int N,
                      int Npad) {
  constexpr bool RM = kLayout != kDmaj;  // token-major tiles
  using L = Smem<DH, RM>;
  constexpr int kLdT = L::kLdT;
  constexpr int kLdO = L::kLdO;
  // the fragment layouts that read the tiles in their scratch layout
  using QLayout = typename std::conditional<RM, wmma::row_major, wmma::col_major>::type;
  using KLayout = typename std::conditional<RM, wmma::col_major, wmma::row_major>::type;
  using VLayout = typename std::conditional<RM, wmma::row_major, wmma::col_major>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem + L::p);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::k);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + L::v);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::sq);
  float* st_s = reinterpret_cast<float*>(smem + L::sq);
  float* o_s = reinterpret_cast<float*>(smem + L::o);
  float* m_s = reinterpret_cast<float*>(smem + L::stats);
  float* l_s = m_s + kTile;
  float* a_s = l_s + kTile;

  const int b = blockIdx.z;
  const int m = blockIdx.y;
  const int n0 = blockIdx.x * kTile;
  const size_t plane = (size_t)DH * Npad;
  const __nv_bfloat16* q_g = scratch + ((size_t)(0 * B + b) * M + m) * plane;
  const __nv_bfloat16* k_g = scratch + ((size_t)(1 * B + b) * M + m) * plane;
  const __nv_bfloat16* v_g = scratch + ((size_t)(2 * B + b) * M + m) * plane;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;

  TileRegs<DH, RM> kr, vr;
  {
    TileRegs<DH, RM> qr;
    qr.load(q_g, n0, Npad);
    qr.store(q_s);
  }
  kr.load(k_g, 0, Npad);
  vr.load(v_g, 0, Npad);
  for (int i = threadIdx.x; i < kTile * kLdO; i += kThreads) o_s[i] = 0.f;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  kr.store(k_s);
  vr.store(v_s);
  __syncthreads();

  // this warp's q rows, as DH/16 A fragments
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, QLayout> qa[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const __nv_bfloat16* src = RM ? q_s + row0 * kLdT + kk * 16
                                  : q_s + kk * 16 * kLdT + row0;
    wmma::load_matrix_sync(qa[kk], src, kLdT);
  }
  __syncthreads();  // the q tile's memory holds the scores from here on

  for (int k0 = 0; k0 < N; k0 += kTile) {
    const bool more = k0 + kTile < N;
    if (more) {  // next key tile in flight while this one is multiplied
      kr.load(k_g, k0 + kTile, Npad);
      vr.load(v_g, k0 + kTile, Npad);
    }

    // scores: 16 query rows x 64 keys per warp (B = k^T, Dh x keys)
#pragma unroll
    for (int kb = 0; kb < kTile / 16; ++kb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, KLayout> kf;
        const __nv_bfloat16* src = RM ? k_s + kb * 16 * kLdT + kk * 16
                                      : k_s + kk * 16 * kLdT + kb * 16;
        wmma::load_matrix_sync(kf, src, kLdT);
        wmma::mma_sync(acc, qa[kk], kf, acc);
      }
      wmma::store_matrix_sync(st_s + row0 * kLdS + kb * 16, acc, kLdS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this key tile, one row at a time, two keys a lane
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r;
      float s0 = st_s[row * kLdS + lane];
      float s1 = st_s[row * kLdS + lane + 32];
      if (k0 + lane >= N) s0 = -INFINITY;
      if (k0 + lane + 32 >= N) s1 = -INFINITY;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, mx);  // finite: key k0 < N is valid
      const __nv_bfloat16 p0 = __float2bfloat16(__expf(s0 - m_new));
      const __nv_bfloat16 p1 = __float2bfloat16(__expf(s1 - m_new));
      p_s[row * kLdP + lane] = p0;
      p_s[row * kLdP + lane + 32] = p1;
      float sum = __bfloat162float(p0) + __bfloat162float(p1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);  // 0 on the first tile
        a_s[row] = alpha;
        l_s[row] = l_s[row] * alpha + sum;
        m_s[row] = m_new;
      }
    }
    __syncwarp();

    // this warp's output rows: o = o * alpha + p v (B = v, keys x Dh)
    for (int i = lane; i < 16 * DH; i += 32) {
      const int row = row0 + i / DH;
      o_s[row * kLdO + i % DH] *= a_s[row];
    }
    __syncwarp();
#pragma unroll
    for (int db = 0; db < DH / 16; ++db) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* o_tile = o_s + row0 * kLdO + db * 16;
      wmma::load_matrix_sync(acc, o_tile, kLdO, wmma::mem_row_major);
#pragma unroll
      for (int kb = 0; kb < kTile / 16; ++kb) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, VLayout> vf;
        const __nv_bfloat16* src = RM ? v_s + kb * 16 * kLdT + db * 16
                                      : v_s + db * 16 * kLdT + kb * 16;
        wmma::load_matrix_sync(pf, p_s + row0 * kLdP + kb * 16, kLdP);
        wmma::load_matrix_sync(vf, src, kLdT);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(o_tile, acc, kLdO, wmma::mem_row_major);
    }
    __syncthreads();  // every warp is done with k_s and v_s
    if (more) {
      kr.store(k_s);
      vr.store(v_s);
      __syncthreads();
    }
  }

  if (kLayout == kRowMajor) {  // (B, N, M, Dh): one token's Dh channels adjacent
    for (int i = threadIdx.x; i < kTile * DH; i += kThreads) {
      const int j = i / DH;
      const int d = i - j * DH;
      const int n = n0 + j;
      if (n < N)
        out[(((size_t)b * N + n) * M + m) * DH + d] =
            __float2bfloat16(o_s[j * kLdO + d] / l_s[j]);
    }
  } else {  // (B, M, Dh, N): one channel's tokens adjacent
    __nv_bfloat16* o_g = out + ((size_t)b * M + m) * DH * N;
    for (int i = threadIdx.x; i < DH * kTile; i += kThreads) {
      const int d = i / kTile;
      const int j = i - d * kTile;
      const int n = n0 + j;
      if (n < N) o_g[(size_t)d * N + n] = __float2bfloat16(o_s[j * kLdO + d] / l_s[j]);
    }
  }
}

template <int DH, Layout kLayout>
int launch(const void* qkv, const void* sin_t, const void* cos_t, void* scratch,
           void* out, int B, int M, int N, float scale, cudaStream_t stream) {
  constexpr bool RM = kLayout != kDmaj;
  const int Npad = (N + kTile - 1) / kTile * kTile;
  const size_t items = (size_t)3 * B * M * DH * Npad / (RM ? 8 : 1);
  const int prep_blocks = (int)((items + 255) / 256 < 8192 ? (items + 255) / 256 : 8192);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(qkv);
  const float* s = static_cast<const float*>(sin_t);
  const float* c = static_cast<const float*>(cos_t);
  __nv_bfloat16* sc = static_cast<__nv_bfloat16*>(scratch);
  if (RM)
    rope_prep_rowmajor_kernel<DH, kLayout == kNdh><<<prep_blocks, 256, 0, stream>>>(
        x, s, c, sc, B, M, N, Npad, scale);
  else
    rope_prep_dmaj_kernel<<<prep_blocks, 256, 0, stream>>>(x, s, c, sc, B, M, DH, N,
                                                           Npad, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = Smem<DH, RM>::bytes;
  err = cudaFuncSetAttribute(rope_attention_kernel<DH, kLayout>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rope_attention_kernel<DH, kLayout>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Npad / kTile, M, B);
  rope_attention_kernel<DH, kLayout><<<grid, kThreads, smem, stream>>>(
      sc, static_cast<__nv_bfloat16*>(out), B, M, N, Npad);
  return (int)cudaGetLastError();
}

template <Layout kLayout>
int dispatch(const void* qkv, const void* sin_t, const void* cos_t, void* scratch,
             void* out, int B, int M, int Dh, int N, float scale, void* stream) {
  if (B < 1 || M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 64) return launch<64, kLayout>(qkv, sin_t, cos_t, scratch, out, B, M, N, scale, s);
  if (Dh == 128) return launch<128, kLayout>(qkv, sin_t, cos_t, scratch, out, B, M, N, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Dh-major: sin_t/cos_t (Dh, N); scratch (3, B, M, Dh, ceil(N / 64) * 64)
// bf16, allocated by the caller
extern "C" int rope_attention_dmaj(const void* qkv, const void* sin_t,
                                   const void* cos_t, void* scratch, void* out,
                                   int B, int M, int Dh, int N, float scale,
                                   void* stream) {
  return dispatch<kDmaj>(qkv, sin_t, cos_t, scratch, out, B, M, Dh, N, scale, stream);
}

// row-major: sin/cos (N, Dh); scratch (3, B, M, ceil(N / 64) * 64, Dh) bf16,
// allocated by the caller
extern "C" int rope_attention_rowmajor(const void* qkv, const void* sin, const void* cos,
                                       void* scratch, void* out, int B, int M, int Dh,
                                       int N, float scale, void* stream) {
  return dispatch<kRowMajor>(qkv, sin, cos, scratch, out, B, M, Dh, N, scale, stream);
}

// (N, Dh) planes: qkv (B, 3, M, N, Dh), sin/cos (N, Dh), out (B, M, Dh, N);
// scratch (3, B, M, ceil(N / 64) * 64, Dh) bf16, allocated by the caller
extern "C" int rope_attention_ndh(const void* qkv, const void* sin, const void* cos,
                                  void* scratch, void* out, int B, int M, int Dh, int N,
                                  float scale, void* stream) {
  return dispatch<kNdh>(qkv, sin, cos, scratch, out, B, M, Dh, N, scale, stream);
}
