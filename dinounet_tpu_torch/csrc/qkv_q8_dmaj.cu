// w8a8 qkv projection into the Dh-major layout, for sm_90a.
//
// Replaces the TPU kernel _qkv_q8_dmaj_kernel of
// dinounet_tpu/ops/dense_q8_pallas.py (qkv_q8_dmaj_fused; its XLA twin
// qkv_q8_premapped_dmaj computes the same numbers). With x (B, N, C) bf16,
// wq (3C, Cpad) int8 (the weight quantized once, as nn.Linear stores it,
// K padded to 16) and ws, bias (3C,) fp32:
//   out[b, j, n] = bf16((acc[b, j, n] * a[b, n]) * ws[j] + bias[j]),
//   acc[b, j, n] = sum_c wq[j, c] * xq[b, n, c]
// i.e. the product Wq^T . Xq^T with tokens as the fast dimension of the
// output, (B, 3C, N) = (B, 3, M, Dh, N), which ops/attention.py's RoPE
// attention reads. Arithmetic and the GEMM are in int8_gemm.cuh.
//
// Design. On the TPU the first grid step of each batch quantized x into
// VMEM scratch and later steps reused it (pl.when(j == 0)); blocks on the
// card run in no order, so a quantize pass (one warp per token, the scale a
// max over C = 768 values) writes xq (B, N, Cpad) int8 and the scales first,
// and the GEMM reads Wq row-major as its A operand and xq column-major as
// its B operand, both with 16-byte loads.
//
// What bounds it on an H100: at dinounet_b (8 x 1029 tokens, C = 768, 3C =
// 2304) it moves ~51 MB of bf16 activations for 29 G int8 operations: bytes
// (~0.015 ms at 3.35 TB/s) over operations (~0.015 ms at 1,979 TOPS), about
// balanced. This first version uses WMMA, not wgmma, and no TMA.

#include "int8_gemm.cuh"

extern "C" int qkv_q8_dmaj(const void* x, const void* wq, const void* ws,
                           const void* bias, void* xq, void* a, void* out, int B,
                           int N, int C, int D3, void* stream) {
  using namespace q8;
  if (B < 1 || N < 1 || C < 1 || D3 < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ldq = pad16(C);
  cudaError_t err = launch_quant_rows(x, B * N, C, xq, a, false, s);
  if (err != cudaSuccess) return (int)err;
  const EpilogueArgs ep{static_cast<const float*>(a), static_cast<const float*>(ws),
                        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out)};
  // A = Wq (3C x C): wq[j][c] is row-major with ld Cpad; B = Xq^T (C x N):
  // xq[b][n][c] is column-major with ld Cpad
  return (int)launch_gemm<true, false, kTokenColumns>(
      static_cast<const int8_t*>(wq), 0, ldq, static_cast<const int8_t*>(xq),
      (long long)N * ldq, ldq, B, D3, N, C, ep, s);
}
