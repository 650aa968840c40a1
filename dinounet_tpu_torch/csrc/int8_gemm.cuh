// The int8 pieces shared by dense_q8.cu and qkv_q8_dmaj.cu, for sm_90a:
// the per-token symmetric quantization of row-major activations, and the
// int8 tensor-core GEMM of the plain and qkv projections (dense_q8 and
// qkv_q8_dmaj) with their w8a8 rescale epilogues.
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
// a multiple of 16, the layout nn.Linear stores; ws (D,) fp32.
//
// The GEMM: C[m][n] = sum_k A[m][k] B[k][n] per batch (blockIdx.z), each
// operand row- or column-major in device memory. A block computes a 64 x 128
// tile of C over K in steps of 64 with WMMA int8 m16n16k16 products (eight
// warps, 32 x 32 each). Shared memory holds each operand tile as 16 x 16-byte
// blocks, one per WMMA fragment, each stored in the operand's own layout
// (16 consecutive bytes of the contiguous dimension per row), so every
// fragment pointer is 256-byte aligned and every staging store is one
// 16-byte store; a thread loads 16 contiguous bytes of an operand per chunk
// (one vector load where the row is 16-byte aligned and in range, byte by
// byte at ragged edges). The next K step's chunks are loaded into registers
// while the tensor cores work on the current one. The int32 tile goes
// through shared memory to the epilogue, which writes bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <math.h>

#include <type_traits>

#include "hopper_common.cuh"

namespace {

namespace q8 {

using namespace nvcuda;

constexpr int kBM = 64;    // rows of C per block
constexpr int kBN = 128;   // columns of C per block
constexpr int kBK = 64;    // reduction step
constexpr int kThreads = 256;
constexpr int kLdC = kBN + 4;

// epilogues: rows are tokens and columns features (the plain dense op), or
// rows are features and columns tokens (the qkv projection's transposed,
// token-fast output)
enum Epilogue { kPlain = 0, kTokenColumns = 1 };

struct EpilogueArgs {
  const float* a;             // per-token activation scales
  const float* ws;            // per-feature weight scales
  const float* bias;          // per-feature bias (fp32)
  __nv_bfloat16* out;         // (batch, rows, columns) row-major
};

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
template <bool kGelu>
__global__ void __launch_bounds__(256)
quant_rows_kernel(const __nv_bfloat16* __restrict__ x, int rows, int K,
                  int8_t* __restrict__ xq, int ldq, float* __restrict__ scale, int vec,
                  int lanes_log2) {
  extern __shared__ __align__(16) unsigned char quant_rows_smem[];
  const int G = 1 << lanes_log2;
  const int sub = threadIdx.x & (G - 1), rloc = threadIdx.x >> lanes_log2;
  const int row = blockIdx.x * (blockDim.x >> lanes_log2) + rloc;
  const bool live = row < rows;
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

// 16 consecutive int8 values: one 16-byte load when all are in range and the
// address is aligned, else byte by byte with zeros out of range.
__device__ __forceinline__ uint4 load16(const int8_t* p, int valid, bool vec) {
  if (valid >= 16 && vec) return *reinterpret_cast<const uint4*>(p);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  int8_t* e = reinterpret_cast<int8_t*>(&v);
  for (int i = 0; i < 16; ++i)
    if (i < valid) e[i] = p[i];
  return v;
}

template <bool kARowMajor, bool kBRowMajor, int kEpi>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const int8_t* __restrict__ A, long long a_batch, int lda, bool a_vec,
            const int8_t* __restrict__ Bm, long long b_batch, int ldb, bool b_vec,
            int M, int N, int K, EpilogueArgs ep) {
  // operand tiles as 16 x 16-byte blocks: A block (mi, ks) and B block
  // (ks, nj) at ((outer * inner-count) + inner) * 256
  __shared__ __align__(128) int8_t a_s[kBM * kBK];
  __shared__ __align__(128) int8_t b_s[kBK * kBN];
  __shared__ __align__(128) int c_s[kBM * kLdC];

  const int z = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int wm = (warp / 4) * 32;
  const int wn = (warp % 4) * 32;
  const int8_t* Ab = A + z * a_batch;
  const int8_t* Bb = Bm + z * b_batch;

  // this thread's A chunk (one) and B chunks (two): 16 bytes along the
  // operand's contiguous dimension
  auto a_chunk = [&](int k0, int8_t** dst) -> uint4 {
    const int outer = t / 4, inner = (t % 4) * 16;
    if (kARowMajor) {  // outer: row m, inner: k
      *dst = a_s + ((outer >> 4) * (kBK / 16) + (inner >> 4)) * 256 + (outer & 15) * 16;
      const int m = m0 + outer, k = k0 + inner;
      return load16(Ab + (size_t)m * lda + k, m < M ? K - k : 0, a_vec);
    }
    // outer: k, inner: row m
    *dst = a_s + ((inner >> 4) * (kBK / 16) + (outer >> 4)) * 256 + (outer & 15) * 16;
    const int k = k0 + outer, m = m0 + inner;
    return load16(Ab + (size_t)k * lda + m, k < K ? M - m : 0, a_vec);
  };
  auto b_chunk = [&](int k0, int c, int8_t** dst) -> uint4 {
    if (kBRowMajor) {  // outer: k, inner: column n
      const int outer = c / (kBN / 16), inner = (c % (kBN / 16)) * 16;
      *dst = b_s + ((outer >> 4) * (kBN / 16) + (inner >> 4)) * 256 + (outer & 15) * 16;
      const int k = k0 + outer, n = n0 + inner;
      return load16(Bb + (size_t)k * ldb + n, k < K ? N - n : 0, b_vec);
    }
    // outer: column n, inner: k
    const int outer = c / (kBK / 16), inner = (c % (kBK / 16)) * 16;
    *dst = b_s + ((inner >> 4) * (kBN / 16) + (outer >> 4)) * 256 + (outer & 15) * 16;
    const int n = n0 + outer, k = k0 + inner;
    return load16(Bb + (size_t)n * ldb + k, n < N ? K - k : 0, b_vec);
  };

  using ALayout = typename std::conditional<kARowMajor, wmma::row_major, wmma::col_major>::type;
  using BLayout = typename std::conditional<kBRowMajor, wmma::row_major, wmma::col_major>::type;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  int8_t *da, *db0, *db1;
  uint4 va = a_chunk(0, &da), vb0 = b_chunk(0, t, &db0), vb1 = b_chunk(0, t + kThreads, &db1);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    *reinterpret_cast<uint4*>(da) = va;
    *reinterpret_cast<uint4*>(db0) = vb0;
    *reinterpret_cast<uint4*>(db1) = vb1;
    __syncthreads();
    if (k0 + kBK < K) {  // the next step's chunks in flight during the MMAs
      va = a_chunk(k0 + kBK, &da);
      vb0 = b_chunk(k0 + kBK, t, &db0);
      vb1 = b_chunk(k0 + kBK, t + kThreads, &db1);
    }
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, BLayout> bf[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            bf[j], b_s + (ks * (kBN / 16) + (wn / 16 + j)) * 256, 16);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, ALayout> af;
        wmma::load_matrix_sync(af, a_s + ((wm / 16 + i) * (kBK / 16) + ks) * 256, 16);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af, bf[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c_s + (wm + 16 * i) * kLdC + wn + 16 * j, acc[i][j],
                              kLdC, wmma::mem_row_major);
  __syncthreads();

  for (int i = t; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN;
    const int c = i - r * kBN;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m >= M || n >= N) continue;
    const float f = __int2float_rn(c_s[r * kLdC + c]);
    const size_t o = ((size_t)z * M + m) * N + n;
    if (kEpi == kTokenColumns) {
      const float y = __fadd_rn(__fmul_rn(__fmul_rn(f, ep.a[(size_t)z * N + n]), ep.ws[m]),
                                ep.bias[m]);
      ep.out[o] = __float2bfloat16(y);
    } else {
      const float y = __fadd_rn(__fmul_rn(__fmul_rn(f, ep.a[(size_t)z * M + m]), ep.ws[n]),
                                ep.bias[n]);
      ep.out[o] = __float2bfloat16(y);
    }
  }
}

inline bool aligned16(const void* p, long long ld, long long batch_stride) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 16 == 0 &&
         batch_stride % 16 == 0;
}

template <bool kARowMajor, bool kBRowMajor, int kEpi>
cudaError_t launch_gemm(const int8_t* A, long long a_batch, int lda,
                        const int8_t* Bm, long long b_batch, int ldb, int batch,
                        int M, int N, int K, const EpilogueArgs& ep,
                        cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  gemm_kernel<kARowMajor, kBRowMajor, kEpi><<<grid, kThreads, 0, stream>>>(
      A, a_batch, lda, aligned16(A, lda, a_batch), Bm, b_batch, ldb,
      aligned16(Bm, ldb, b_batch), M, N, K, ep);
  return cudaGetLastError();
}

inline int pad16(int n) { return (n + 15) / 16 * 16; }

// the row pass over x (rows, K) into xq (rows, pad16(K)) and scale (rows):
// blocks of up to 256 threads, as many rows as 48 KB of staged rows hold
inline cudaError_t launch_quant_rows(const void* x, int rows, int K, void* xq, void* scale,
                                     bool gelu, cudaStream_t stream) {
  constexpr int kMaxSmem = 232448;  // the opt-in limit of a block
  const int ldq = pad16(K);
  const int row_bytes = ldq * 2;
  if (row_bytes > kMaxSmem) return cudaErrorInvalidValue;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < 32 && (1 << lanes_log2) < ldq / 16) ++lanes_log2;
  const int per_block = max(1, min(256 >> lanes_log2, 49152 / row_bytes));
  const int blocks = (rows + per_block - 1) / per_block;
  const int threads = per_block << lanes_log2, smem = per_block * row_bytes;
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* qp = static_cast<int8_t*>(xq);
  auto* sp = static_cast<float*>(scale);
  const int vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  static unsigned long long ready[2] = {0, 0};  // one bit a device, an instance
  cudaError_t err = gelu ? set_smem_once(quant_rows_kernel<true>, kMaxSmem, &ready[1])
                         : set_smem_once(quant_rows_kernel<false>, kMaxSmem, &ready[0]);
  if (err != cudaSuccess) return err;
  if (gelu)
    quant_rows_kernel<true><<<blocks, threads, smem, stream>>>(xp, rows, K, qp, ldq, sp, vec,
                                                              lanes_log2);
  else
    quant_rows_kernel<false><<<blocks, threads, smem, stream>>>(xp, rows, K, qp, ldq, sp, vec,
                                                               lanes_log2);
  return cudaGetLastError();
}

}  // namespace q8

}  // namespace
