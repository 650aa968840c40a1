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
// The weights arrive quantized (wq int8 (K, D), ws fp32 (D,)): the wrapper
// quantizes them on every call, as the JAX package does XLA-side.
// Arithmetic and the GEMM are in int8_gemm.cuh.
//
// Design. Each call is three launches: a quantize pass writes the int8
// activations and their per-token scales (the GELU applied there, once per
// element), the int8 GEMM applies the rescale and the epilogue, and, with the
// residual, a row-statistics pass reads the stored bf16 rows back (a
// 128-column tile does not hold a D = 768 row). On the TPU the channel-major
// kernel quantized outside only because Mosaic cannot move a per-token scale
// from lanes to sublanes; the row-major ones held a whole (R, K) row block in
// VMEM. On Hopper a block cannot hold 64 rows of K = 3072 bf16 with the
// GEMM's tiles, so both layouts quantize in the separate pass: it costs one
// write and one read of the int8 activations (half the bytes of the bf16
// input), counted in the call's time.
//
// What bounds it on an H100: at the ViT shapes (8 tiles of 1029 tokens,
// K = D = 768 or K/D = 3072) the int8 products are near the balance point of
// 1,979 TOPS and 3.35 TB/s (~590 int8 operations per byte); at the adapter's
// (5376 tokens, K = 192 or 384) they are bytes-bound. This first version uses
// WMMA (mma.sync), not wgmma, and register-staged loads, not TMA.

#include "int8_gemm.cuh"

extern "C" int dense_q8(const void* h, const void* wq, const void* ws, const void* b,
                        const void* res, const void* gamma, void* xq, void* a,
                        void* out, void* mu, void* var, int B, int N, int K, int D,
                        int channel_major, int gelu, int residual, void* stream) {
  using namespace q8;
  if (B < 1 || N < 1 || K < 1 || D < 1 || (channel_major && (gelu || !residual)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* xq8 = static_cast<int8_t*>(xq);
  auto* w8 = static_cast<const int8_t*>(wq);
  const EpilogueArgs ep{static_cast<const float*>(a), static_cast<const float*>(ws),
                        static_cast<const float*>(b),
                        static_cast<const __nv_bfloat16*>(res),
                        static_cast<const float*>(gamma),
                        static_cast<__nv_bfloat16*>(out)};
  cudaError_t err;
  if (channel_major) {
    // xq (B, K, Npad) with tokens contiguous: A column-major per batch
    const int ldq = pad16(N);
    const dim3 grid((ldq + kColTokens - 1) / kColTokens, B);
    quant_cols_kernel<<<grid, dim3(kColTokens, kColSplit), 0, s>>>(
        static_cast<const __nv_bfloat16*>(h), K, N, xq8, ldq, static_cast<float*>(a));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    err = launch_gemm<false, true, kResidual>(xq8, (long long)K * ldq, ldq, w8, 0, D,
                                              B, N, D, K, ep, s);
  } else {
    // xq (B * N, Kpad): A row-major, the batch folded into the rows
    const int ldq = pad16(K);
    if ((err = launch_quant_rows(h, B * N, K, xq, ldq, a, gelu, s)) != cudaSuccess)
      return (int)err;
    err = residual ? launch_gemm<true, true, kResidual>(xq8, 0, ldq, w8, 0, D, 1,
                                                        B * N, D, K, ep, s)
                   : launch_gemm<true, true, kPlain>(xq8, 0, ldq, w8, 0, D, 1, B * N,
                                                     D, K, ep, s);
  }
  if (err != cudaSuccess || !residual) return (int)err;
  const int rows = B * N;
  constexpr int kRowsPerBlock = 8;
  row_stats_kernel<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0,
                     s>>>(static_cast<const __nv_bfloat16*>(out), static_cast<float*>(mu),
                          static_cast<float*>(var), rows, D);
  return (int)cudaGetLastError();
}
