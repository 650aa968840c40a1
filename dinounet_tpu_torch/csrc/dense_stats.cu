// Dense projection + bias + LayerScale residual + next-LayerNorm row statistics,
// for sm_90a.
//
// Replaces two TPU kernels of dinounet_tpu/ops/dense_stats_pallas.py:
//   _cm_kernel (called by dense_cm_residual_stats): the activation arrives
//     channel-major, h (B, K, N) -- the attention and MSDA output projections;
//   _kernel (called by dense_residual_stats): h row-major, (B, N, K), with an
//     optional exact-erf GELU prologue -- ViT fc2 and ConvFFN fc2.
// Both compute, with w (K, D) bf16 and b, gamma (D,) fp32:
//   out = res + bf16(gamma) * (bf16(h^T w or h w) + bf16(b))   all in bf16
//   mu  = mean(out), var = max(mean(out^2) - mu^2, 0)          fp32, per row
// rounding at the points the TPU kernel's _reference / _cm_reference do: the
// fp32 accumulator to bf16, then each add and multiply rounded to bf16. The
// statistics describe the stored bf16 rows. The GELU prologue rounds
// gelu(fp32(h)) to bf16 before the product; erff is exact here (the TPU
// kernel's Abramowitz-Stegun erf existed only because Mosaic has no erf).
//
// What bounds it on an H100: the products are (N x K) x (K x D) with
// N = 1029 or 5376 tokens per image, K in {192, 384, 768, 3072} and D = 768;
// at K >= 384 they are compute-bound (hundreds of FLOP per byte moved), at
// K = 192 closer to the memory line. One templated GEMM kernel covers both
// layouts: a block computes a 64-token x 128-feature tile over K in steps of
// 32 with WMMA bf16 tensor-core products (eight warps, 32 x 32 each). The A
// tile is stored in shared memory in the layout it arrives in (channel-major
// or row-major) and read as a column- or row-major fragment, so neither
// layout needs a transpose pass; the GELU is applied once per loaded A
// element (an A tile is loaded once per 128 output features: 6 times at
// D = 768). The next K step's A and W tiles are loaded into registers --
// 16-byte loads where the row is 16-byte aligned -- while the tensor cores
// work on the current one. The epilogue applies bias, LayerScale and
// residual and writes bf16. The row statistics need the whole D-wide row,
// which a 128-column tile does not hold, so a second small pass reads the
// stored rows back (12.6 MB at the ViT shape, B = 8: a few microseconds of
// HBM time) instead of a block holding 64 x 768 fp32 accumulators. TMA,
// a deeper pipeline and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>

using namespace nvcuda;

namespace {

constexpr int kBM = 64;    // tokens per block
constexpr int kBN = 128;   // output features per block
constexpr int kBK = 32;    // reduction step
constexpr int kThreads = 256;
constexpr int kLdArm = kBK + 8;  // row-major A tile pitch: [token][k]
constexpr int kLdAcm = kBM + 8;  // channel-major A tile pitch: [k][token]
constexpr int kLdW = kBN + 8;
constexpr int kLdC = kBN + 4;
constexpr int kASize = kBM * kLdArm > kBK * kLdAcm ? kBM * kLdArm : kBK * kLdAcm;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float gelu_exact(float x) {
  return x * 0.5f * (1.f + erff(x * 0.70710678118654752f));
}

// 8 consecutive bf16 values: one 16-byte load when all are in range and the
// address is aligned, else element by element with zeros out of range.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int valid,
                                       bool aligned) {
  if (valid >= 8 && aligned) return *reinterpret_cast<const uint4*>(p);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
  for (int i = 0; i < 8; ++i)
    if (i < valid) e[i] = p[i];
  return v;
}

__device__ __forceinline__ uint4 gelu8(uint4 v) {
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    e[i] = __float2bfloat16(gelu_exact(__bfloat162float(e[i])));
  return v;
}

template <bool kChannelMajor, bool kGelu>
__global__ void __launch_bounds__(kThreads)
dense_residual_kernel(const __nv_bfloat16* __restrict__ h,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ res,
                      const float* __restrict__ gamma,
                      __nv_bfloat16* __restrict__ out, int N, int K, int D) {
  __shared__ __align__(128) __nv_bfloat16 a_s[kASize];
  __shared__ __align__(128) __nv_bfloat16 w_s[kBK * kLdW];
  __shared__ __align__(128) float c_s[kBM * kLdC];

  const int b = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int wm = (warp / 4) * 32;
  const int wn = (warp % 4) * 32;
  const __nv_bfloat16* h_b = h + (size_t)b * N * K;

  // this thread's slots: 8 consecutive A elements, and 8 consecutive W
  // elements in each of two rows
  int a_row, a_col;  // position in the smem A tile
  if (kChannelMajor) {
    a_row = t / 8;          // k
    a_col = (t % 8) * 8;    // token
  } else {
    a_row = t / 4;          // token
    a_col = (t % 4) * 8;    // k
  }
  const int w_row = t / 16;
  const int w_col = (t % 16) * 8;
  const bool a_aligned = kChannelMajor ? (N % 8 == 0) : (K % 8 == 0);
  const bool w_aligned = D % 8 == 0;

  auto load_a = [&](int k0) -> uint4 {
    uint4 v;
    if (kChannelMajor) {
      const int k = k0 + a_row;
      const int tok = m0 + a_col;
      v = load8(h_b + (size_t)k * N + tok, k < K ? N - tok : 0, a_aligned);
    } else {
      const int tok = m0 + a_row;
      const int k = k0 + a_col;
      v = load8(h_b + (size_t)tok * K + k, tok < N ? K - k : 0, a_aligned);
    }
    return kGelu ? gelu8(v) : v;  // gelu(0) = 0 keeps the padding zero
  };
  auto load_w = [&](int k0, int r) -> uint4 {
    const int k = k0 + w_row + r;
    const int n = n0 + w_col;
    return load8(w + (size_t)k * D + n, k < K ? D - n : 0, w_aligned);
  };
  auto store = [&](uint4 a, uint4 w0, uint4 w1) {
    const int lda = kChannelMajor ? kLdAcm : kLdArm;
    *reinterpret_cast<uint4*>(a_s + a_row * lda + a_col) = a;
    *reinterpret_cast<uint4*>(w_s + w_row * kLdW + w_col) = w0;
    *reinterpret_cast<uint4*>(w_s + (w_row + 16) * kLdW + w_col) = w1;
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  store(load_a(0), load_w(0, 0), load_w(0, 16));
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    uint4 na, nw0, nw1;
    if (more) {  // next step's tiles in flight while this one multiplies
      na = load_a(k0 + kBK);
      nw0 = load_w(k0 + kBK, 0);
      nw1 = load_w(k0 + kBK, 16);
    }
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], w_s + ks * kLdW + wn + 16 * j, kLdW);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (kChannelMajor) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> af;
          wmma::load_matrix_sync(af, a_s + ks * kLdAcm + wm + 16 * i, kLdAcm);
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af, bf[j], acc[i][j]);
        } else {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
          wmma::load_matrix_sync(af, a_s + (wm + 16 * i) * kLdArm + ks, kLdArm);
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af, bf[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
    if (more) {
      store(na, nw0, nw1);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c_s + (wm + 16 * i) * kLdC + wn + 16 * j,
                              acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();

  for (int i = t; i < kBM * kBN; i += kThreads) {
    const int tt = i / kBN;
    const int j = i - tt * kBN;
    const int tok = m0 + tt;
    const int n = n0 + j;
    if (tok >= N || n >= D) continue;
    const float y = bf16_round(bf16_round(c_s[tt * kLdC + j]) + bf16_round(bias[n]));
    const float ly = bf16_round(y * bf16_round(gamma[n]));
    const size_t o = ((size_t)b * N + tok) * D + n;
    out[o] = __float2bfloat16(__bfloat162float(res[o]) + ly);
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

template <bool kChannelMajor, bool kGelu>
void launch_gemm(const void* h, const void* w, const void* b, const void* res,
                 const void* gamma, void* out, int B, int N, int K, int D,
                 cudaStream_t stream) {
  const dim3 grid((D + kBN - 1) / kBN, (N + kBM - 1) / kBM, B);
  dense_residual_kernel<kChannelMajor, kGelu><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(b), static_cast<const __nv_bfloat16*>(res),
      static_cast<const float*>(gamma), static_cast<__nv_bfloat16*>(out), N, K, D);
}

}  // namespace

extern "C" int dense_residual_stats(const void* h, const void* w, const void* b,
                                    const void* res, const void* gamma, void* out,
                                    void* mu, void* var, int B, int N, int K,
                                    int D, int channel_major, int gelu,
                                    void* stream) {
  if (B < 1 || N < 1 || K < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channel_major) {
    if (gelu)
      launch_gemm<true, true>(h, w, b, res, gamma, out, B, N, K, D, s);
    else
      launch_gemm<true, false>(h, w, b, res, gamma, out, B, N, K, D, s);
  } else {
    if (gelu)
      launch_gemm<false, true>(h, w, b, res, gamma, out, B, N, K, D, s);
    else
      launch_gemm<false, false>(h, w, b, res, gamma, out, B, N, K, D, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows = B * N;
  constexpr int kRowsPerBlock = 8;
  row_stats_kernel<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock,
                     0, s>>>(static_cast<const __nv_bfloat16*>(out),
                             static_cast<float*>(mu), static_cast<float*>(var),
                             rows, D);
  return (int)cudaGetLastError();
}
