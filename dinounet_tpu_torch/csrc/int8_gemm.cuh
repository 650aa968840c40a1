// The int8 pieces shared by dense_q8.cu and qkv_q8_dmaj.cu, for sm_90a:
// per-token symmetric quantization passes and one int8 tensor-core GEMM
// with the w8a8 rescale epilogues.
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

namespace {

namespace q8 {

using namespace nvcuda;

constexpr int kBM = 64;    // rows of C per block
constexpr int kBN = 128;   // columns of C per block
constexpr int kBK = 64;    // reduction step
constexpr int kThreads = 256;
constexpr int kLdC = kBN + 4;

// epilogues: rows are tokens and columns features (the dense ops), with or
// without the LayerScale residual; or rows are features and columns tokens
// (the qkv projection's transposed, token-fast output)
enum Epilogue { kPlain = 0, kResidual = 1, kTokenColumns = 2 };

struct EpilogueArgs {
  const float* a;             // per-token activation scales
  const float* ws;            // per-feature weight scales
  const float* bias;          // per-feature bias (fp32)
  const __nv_bfloat16* res;   // kResidual: residual, laid out as out
  const float* gamma;         // kResidual: LayerScale
  __nv_bfloat16* out;         // (batch, rows, columns) row-major
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

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

// Row-major x (rows, K) bf16, optionally through the exact GELU rounded to
// bf16 (the JAX prologue's rounding point) -> xq (rows, ldq) int8, zero in
// columns K..ldq-1, and one scale a per row. One warp per row, two passes
// over the row (the maximum, then the levels).
template <bool kGelu>
__global__ void quant_rows_kernel(const __nv_bfloat16* __restrict__ x, int rows,
                                  int K, int8_t* __restrict__ xq, int ldq,
                                  float* __restrict__ scale) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + (size_t)row * K;
  auto value = [&](int k) {
    const float v = __bfloat162float(xr[k]);
    return kGelu ? bf16_round(gelu_exact(v)) : v;
  };
  float m = 0.f;
  for (int k = lane; k < K; k += 32) m = fmaxf(m, fabsf(value(k)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float a = quant_scale(m);
  int8_t* qr = xq + (size_t)row * ldq;
  for (int k = lane; k < ldq; k += 32) qr[k] = k < K ? quantize(value(k), a) : 0;
  if (lane == 0) scale[row] = a;
}

// Channel-major x (B, K, N) bf16 -> xq (B, K, ldq) int8, zero in tokens
// N..ldq-1, and one scale per (b, token) in scale[b * N + n]. A block takes
// 32 tokens (threadIdx.x, coalesced) and splits K over 8 thread rows.
constexpr int kColTokens = 32;
constexpr int kColSplit = 8;

__global__ void quant_cols_kernel(const __nv_bfloat16* __restrict__ x, int K, int N,
                                  int8_t* __restrict__ xq, int ldq,
                                  float* __restrict__ scale) {
  __shared__ float part[kColSplit][kColTokens];
  const int b = blockIdx.y;
  const int n = blockIdx.x * kColTokens + threadIdx.x;
  const int ty = threadIdx.y;
  const __nv_bfloat16* xb = x + (size_t)b * K * N;
  int8_t* qb = xq + (size_t)b * K * ldq;
  float m = 0.f;
  if (n < N)
    for (int k = ty; k < K; k += kColSplit)
      m = fmaxf(m, fabsf(__bfloat162float(xb[(size_t)k * N + n])));
  part[ty][threadIdx.x] = m;
  __syncthreads();
  m = 0.f;
#pragma unroll
  for (int i = 0; i < kColSplit; ++i) m = fmaxf(m, part[i][threadIdx.x]);
  if (n >= ldq) return;
  const float a = quant_scale(m);
  for (int k = ty; k < K; k += kColSplit)
    qb[(size_t)k * ldq + n] =
        n < N ? quantize(__bfloat162float(xb[(size_t)k * N + n]), a) : 0;
  if (ty == 0 && n < N) scale[(size_t)b * N + n] = a;
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
      if (kEpi == kResidual) {
        const float ly = bf16_round(__fmul_rn(bf16_round(y), bf16_round(ep.gamma[n])));
        ep.out[o] = __float2bfloat16(__fadd_rn(__bfloat162float(ep.res[o]), ly));
      } else {
        ep.out[o] = __float2bfloat16(y);
      }
    }
  }
}

// One warp per stored row: mean and variance over its D values, in fp32.
__global__ void row_stats_kernel(const __nv_bfloat16* __restrict__ x,
                                 float* __restrict__ mu, float* __restrict__ var,
                                 int rows, int D) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + (size_t)row * D;
  float s = 0.f, s2 = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = __bfloat162float(xr[d]);
    s += v;
    s2 += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  if (lane == 0) {
    const float m = s / D;
    mu[row] = m;
    var[row] = fmaxf(s2 / D - m * m, 0.f);
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

inline cudaError_t launch_quant_rows(const void* x, int rows, int K, void* xq, int ldq,
                                     void* scale, bool gelu, cudaStream_t stream) {
  constexpr int kRowsPerBlock = 8;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* qp = static_cast<int8_t*>(xq);
  auto* sp = static_cast<float*>(scale);
  if (gelu)
    quant_rows_kernel<true><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(xp, rows, K, qp, ldq, sp);
  else
    quant_rows_kernel<false><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(xp, rows, K, qp, ldq, sp);
  return cudaGetLastError();
}

inline int pad16(int n) { return (n + 15) / 16 * 16; }

}  // namespace q8

}  // namespace
