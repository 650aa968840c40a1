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
// attention reads. The arithmetic, the quantize pass and the GEMM are in
// int8_gemm.cuh.
//
// Design. On the TPU the first grid step of each batch quantized x into
// VMEM scratch and later steps reused it (pl.when(j == 0)); blocks on the
// card run in no order, so the row quantize pass (int8_gemm.cuh) writes xq
// (B N, Cpad) int8 and the scales first, token-major as for dense_q8. The
// GEMM is int8_gemm.cuh's s8 wgmma kernel with tokens as its M: a block
// takes 128 tokens of the flattened B N rows and one 256-feature pass of
// 3C, and the token-column epilogue writes each rescaled tile transposed
// into (B, 3C, N): a run of tokens within one image (a tile of B N rows can
// span two images: N = 1029 = 16 * 64 + 5) staged feature-major in shared
// memory, each feature row shifted by its misalignment in out, then stored
// as the 16-byte-aligned chunks of out it covers and element by element at
// its two ends.
//
// What bounds it on an H100: at dinounet_b (8 x 1029 tokens, C = 768, 3C =
// 2304) it moves ~51 MB of bf16 activations for 29 G int8 operations: bytes
// (~0.015 ms at 3.35 TB/s) over operations (~0.015 ms at 1,979 TOPS), about
// balanced.

#include "int8_gemm.cuh"

extern "C" int qkv_q8_dmaj(const void* x, const void* wq, const void* ws,
                           const void* bias, void* xq, void* a, void* out, int B,
                           int N, int C, int D3, void* stream) {
  using namespace q8;
  if (B < 1 || N < 1 || C < 1 || D3 < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_quant_rows(x, B * N, C, xq, a, false, s);
  if (err != cudaSuccess) return (int)err;
  Args p = {};
  p.a = static_cast<const float*>(a);
  p.ws = static_cast<const float*>(ws);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.rows = B * N;
  p.K = C;
  p.D = D3;
  p.N = N;
  return launch_gemm<kTokenColumns, kSplitRows>(xq, wq, pad16(C), p, s);
}
