// Transposed 2x2 convolution with stride 2 (exact x2 upsampling) with an
// optional InstanceNorm-apply + leaky ReLU prologue, for sm_90a.
//
// Replaces the TPU kernel dinounet_tpu/ops/decoder_tail_pallas.py
// _transpconv_kernel (called by transpconv2x2_cm). Channel-major (B, C, H, W):
//   x'[b, ci, j, x]            = bf16(leaky(x * s[b, ci] + t[b, ci]))  (or x)
//   y[b, c, 2j + p, 2x + q]    = bf16(sum_ci x'[b, ci, j, x] w[ci, c, p, q] + b[c])
// with w in torch's ConvTranspose2d layout (Cin, Cout, 2, 2): (p, q) index the
// taps directly (the JAX wrapper's spatial flip belongs to flax's layout).
// The Pallas body's uint32 bit-packing of the column interleave exists only
// because Mosaic cannot lower the lane interleave; here each thread stores
// its (q = 0, 1) pair as one 4-byte bf16x2 word of the interleaved row.
//
// What bounds it on an H100: a per-pixel GEMM Cin -> 4 * Cout with Cin =
// 2 * Cout or Cout, i.e. 8 * Cout FLOP per byte read and ~Cin / 4 per byte
// written: at Cout <= 256 it sits below the card's ridge (295 FLOP/byte in
// bf16), so HBM bounds it; the output (4x the pixels) dominates the bytes.
// Design: one block owns 128 consecutive pixels of the flattened (row,
// column) input plane, so narrow maps fill their blocks too, and 128 of the
// 4 * Cout GEMM columns (32 output channels x 2 x 2 taps); per step of 16
// input channels it stages the prologue-applied 128 x 16 input tile (items of
// 8 channels at one pixel: 8 coalesced loads, one 16-byte shared store) and
// the 16 x 128 weight slice (rows padded by 16 bytes against bank conflicts)
// in shared memory, eight warps run WMMA bf16 products with fp32
// accumulation (16 pixels x 128 columns each), and the epilogue adds the
// fp32 bias, rounds once and writes both output rows of its channels with
// coalesced 4-byte stores. The input is read through the (b, c, h, w)
// strides it comes with (NCHW or channels-last).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kTP = 128;       // input pixels per block
constexpr int kNB = 128;       // GEMM columns (c, p, q) per block
constexpr int kThreads = 256;  // 8 warps x 16 pixels
constexpr int kKC = 16;        // input channels per step
constexpr int kLdW = kNB + 8;
constexpr int kLdC = kNB + 4;
constexpr int kStageBytes = (kTP * kKC + kKC * kLdW) * 2;
constexpr int kEpilogueBytes = kTP * kLdC * 4;
constexpr int kSmemBytes = kStageBytes > kEpilogueBytes ? kStageBytes : kEpilogueBytes;

__global__ void __launch_bounds__(kThreads)
transpconv2x2_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias, const float* __restrict__ ps,
                     const float* __restrict__ pt, float slope,
                     __nv_bfloat16* __restrict__ y, int sxb, int sxc, int sxh, int sxw,
                     int Cin, int H, int W, int Cout, int n_ptiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [kTP][kKC]
  __nv_bfloat16* w_s = a_s + kTP * kKC;                          // [kKC][kLdW]
  float* c_s = reinterpret_cast<float*>(smem);                    // [kTP][kLdC]

  const int N = 4 * Cout;
  const int P = H * W;
  const int b = blockIdx.y;
  const int p0 = (blockIdx.x % n_ptiles) * kTP;
  const int n0 = (blockIdx.x / n_ptiles) * kNB;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int n_frags = min(kNB, N - n0) / 16;  // N is a multiple of 16

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kNB / 16];
#pragma unroll
  for (int nf = 0; nf < kNB / 16; ++nf) wmma::fill_fragment(acc[nf], 0.f);

  for (int k0 = 0; k0 < Cin; k0 += kKC) {
    __syncthreads();
    for (int e = t; e < kTP * 2; e += kThreads) {
      const int px = e % kTP;  // pixel, then channel half
      const int k8 = (e / kTP) * 8;
      const int p = p0 + px;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (p < P) {
        const int j = p / W, xx = p - (p / W) * W;
        const __nv_bfloat16* src = x + (size_t)b * sxb + (size_t)(k0 + k8) * sxc
                                   + (size_t)j * sxh + (size_t)xx * sxw;
        __nv_bfloat16* el = reinterpret_cast<__nv_bfloat16*>(&packed);
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(src[(size_t)i * sxc]);
        if (ps != nullptr) {
          const int ch = b * Cin + k0 + k8;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            v[i] = fmaf(v[i], ps[ch + i], pt[ch + i]);
            v[i] = v[i] >= 0.f ? v[i] : v[i] * slope;
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) el[i] = __float2bfloat16(v[i]);
      }
      *reinterpret_cast<uint4*>(a_s + px * kKC + k8) = packed;
    }
    for (int e = t; e < kKC * kNB / 8; e += kThreads) {
      const int col8 = e % (kNB / 8);
      const int kk = e / (kNB / 8);
      const int n = n0 + col8 * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n < N) v = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + kk) * N + n);
      *reinterpret_cast<uint4*>(w_s + kk * kLdW + col8 * 8) = v;
    }
    __syncthreads();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
    wmma::load_matrix_sync(af, a_s + warp * 16 * kKC, kKC);
#pragma unroll
    for (int nf = 0; nf < kNB / 16; ++nf) {
      if (nf < n_frags) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, w_s + nf * 16, kLdW);
        wmma::mma_sync(acc[nf], af, bf, acc[nf]);
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int nf = 0; nf < kNB / 16; ++nf)
    wmma::store_matrix_sync(c_s + warp * 16 * kLdC + nf * 16, acc[nf], kLdC,
                            wmma::mem_row_major);
  __syncthreads();

  // one item per (local channel, p, input pixel): the (q = 0, 1) pair
  const int c0 = n0 / 4;
  const int Wo = 2 * W;
  for (int e = t; e < kTP * 2 * (kNB / 4); e += kThreads) {
    const int px = e % kTP;
    const int rest = e / kTP;
    const int tap_row = rest % 2;
    const int cl = rest / 2;
    const int c = c0 + cl;
    const int p = p0 + px;
    if (c >= Cout || p >= P) continue;
    const int j = p / W, xx = p - (p / W) * W;
    const float bc = bias[c];
    const float* cr = c_s + px * kLdC + cl * 4 + tap_row * 2;
    __nv_bfloat162 o;
    o.x = __float2bfloat16(cr[0] + bc);
    o.y = __float2bfloat16(cr[1] + bc);
    *reinterpret_cast<__nv_bfloat162*>(
        y + (((size_t)b * Cout + c) * (2 * H) + 2 * j + tap_row) * Wo + 2 * xx) = o;
  }
}

}  // namespace

extern "C" int transpconv2x2(const void* x, int sxb, int sxc, int sxh, int sxw,
                             const void* w, const void* bias, const void* ps,
                             const void* pt, float slope, void* y, int B, int Cin,
                             int H, int W, int Cout, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cin % kKC || Cout < 1 || Cout % 4 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      transpconv2x2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int n_ptiles = (H * W + kTP - 1) / kTP;
  const int n_nblocks = (4 * Cout + kNB - 1) / kNB;
  const dim3 grid(n_ptiles * n_nblocks, B);
  transpconv2x2_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(ps),
      static_cast<const float*>(pt), slope, static_cast<__nv_bfloat16*>(y), sxb, sxc, sxh,
      sxw, Cin, H, W, Cout, n_ptiles);
  return (int)cudaGetLastError();
}
