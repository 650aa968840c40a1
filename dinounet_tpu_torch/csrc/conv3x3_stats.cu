// 3x3 SAME convolution with an InstanceNorm/BatchNorm-apply prologue and an
// InstanceNorm-statistics epilogue, over one or two inputs, for sm_90a.
//
// Replaces two TPU kernels:
//   dinounet_tpu/ops/decoder_tail_pallas.py _conv_kernel / _conv_kernel_merged
//     (called by conv3x3_cm): channel-major (B, C, H, W) maps;
//   dinounet_tpu/ops/conv_hwbc_pallas.py _conv_kernel (called by conv3x3_hwbc):
//     (H, W, B, C) maps, conv0's two inputs [transpconv_out, skip].
// Both compute, per output pixel (b, h, w) and output channel co,
//   x'  = bf16(leaky(x * s[b, ci] + t[b, ci]))      (no prologue: x' = x)
//   x'  = 0 outside the image                       (padding AFTER the prologue:
//                                                    leaky(0 * s + t) != 0)
//   y   = bf16(sum_{dy, dx, ci} x'[ci, h+dy-1, w+dx-1] w[dy, dx, ci, co] + b[co])
//   sum[b, co] += y, ssq[b, co] += y * y             (of the rounded bf16 y)
// The Pallas bodies' row stripes, 8-row halo windows, lane merges and edge
// masks exist for Mosaic's (8, 128) tiling; none of that is carried over.
// One kernel serves both layouts: it reads the inputs and writes the output
// through the (b, c, h, w) strides it is given, so an (H, W, B, C) view of an
// NCHW map needs no transpose, and the two-input form splits its reduction
// over the inputs, so the concatenation never exists.
//
// What bounds it on an H100: at the decoder's shapes (Cin 32..256, Cout
// 32..128, 128^2..512^2 maps, batch 8) a conv does 2 * 9 * Cin FLOP per
// output value against ~2 * (Cin + Cout) bytes per pixel moved, 100-300 FLOP
// per byte: near the card's ridge (295 FLOP/byte in bf16), so both the
// tensor cores and HBM matter. Design of this first version: implicit GEMM
// (M = output pixels, N = Cout, K = 9 * Cin). A block owns one output row
// segment of 128 pixels and all Cout; per step of 16 input channels it stages
// the 3 x 130 halo tile (prologue applied once per staged element, rounded to
// bf16, padding zeroed) and the 9 x 16 x Cout weight slice in shared memory,
// and eight warps run WMMA bf16 products with fp32 accumulation, each warp
// 16 pixels x Cout for the nine taps. The epilogue adds the fp32 bias, rounds
// once to bf16, stores, and reduces the statistics of the rounded values
// over the block's pixels with warp shuffles, then adds them to the (B, Cout)
// fp32 sums with one atomic per block and channel. The atomics' order changes
// from run to run, so the sums agree with a sequential sum to fp32 rounding.
// Staging is by items of 8 channels at one halo position: 8 independent
// loads (neighbouring threads on neighbouring columns, so each load of a
// warp is coalesced in an NCHW map), the prologue in registers, one 16-byte
// shared store; the weight rows are padded by 16 bytes so that a tensor-core
// fragment's 16 rows fall in different banks (unpadded, 64-256-byte rows put
// all 16 in the same 8 banks). cp.async/TMA staging, wgmma and a multi-row
// tile are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kTW = 128;          // output pixels per block (one row segment)
constexpr int kThreads = 256;     // 8 warps x 16 pixels
constexpr int kKC = 16;           // input channels per step
constexpr int kHaloW = kTW + 2;   // staged columns

struct ConvArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* x2;
  int c1, c2;
  int sxb, sxc, sxh, sxw;
  int s2b, s2c, s2h, s2w;
  const __nv_bfloat16* w;  // (3, 3, Cin, Cout)
  const float* bias;       // (Cout,)
  const float* ps;         // (B, Cin) or null: no prologue
  const float* pt;
  float slope;
  __nv_bfloat16* y;
  int syb, syc, syh, syw;
  float* sum;              // (B, Cout) or null: no statistics
  float* ssq;
  int B, H, W;
};

template <int kCout>
constexpr int smem_bytes() {
  constexpr int stage = (3 * kHaloW * kKC + 9 * kKC * (kCout + 8)) * 2;
  constexpr int epilogue = kTW * (kCout + 4) * 4;
  return stage > epilogue ? stage : epilogue;
}

template <int kNF>
__global__ void __launch_bounds__(kThreads) conv3x3_kernel(const ConvArgs a) {
  constexpr int kCout = 16 * kNF;
  constexpr int kLdW = kCout + 8;
  constexpr int kLdC = kCout + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [3][kHaloW][kKC]
  __nv_bfloat16* w_s = a_s + 3 * kHaloW * kKC;                   // [9 * kKC][kLdW]
  float* c_s = reinterpret_cast<float*>(smem);                    // [kTW][kLdC], after the loop

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int w0 = blockIdx.x * kTW;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  const int cin = a.c1 + a.c2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kNF];
#pragma unroll
  for (int nf = 0; nf < kNF; ++nf) wmma::fill_fragment(acc[nf], 0.f);

  for (int k0 = 0; k0 < cin; k0 += kKC) {
    const bool first = k0 < a.c1;
    const int kb = first ? k0 : k0 - a.c1;
    const int sc = first ? a.sxc : a.s2c;
    const int sh = first ? a.sxh : a.s2h;
    const int sw = first ? a.sxw : a.s2w;
    const __nv_bfloat16* base = (first ? a.x : a.x2)
        + (size_t)b * (first ? a.sxb : a.s2b) + (size_t)kb * sc;
    __syncthreads();  // the previous step's products are done with the tiles
    for (int e = t; e < 3 * kHaloW * 2; e += kThreads) {
      const int c = e % kHaloW;  // halo column, then row, then channel half
      const int rest = e / kHaloW;
      const int r = rest % 3;
      const int k8 = (rest / 3) * 8;
      const int hh = h - 1 + r;
      const int ww = w0 - 1 + c;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);  // the padding, after the prologue
      if (hh >= 0 && hh < a.H && ww >= 0 && ww < a.W) {
        const __nv_bfloat16* px = base + (size_t)k8 * sc + (size_t)hh * sh + (size_t)ww * sw;
        __nv_bfloat16* el = reinterpret_cast<__nv_bfloat16*>(&packed);
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(px[(size_t)j * sc]);
        if (a.ps != nullptr) {
          const int ch = b * cin + k0 + k8;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            v[j] = fmaf(v[j], a.ps[ch + j], a.pt[ch + j]);
            v[j] = v[j] >= 0.f ? v[j] : v[j] * a.slope;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) el[j] = __float2bfloat16(v[j]);
      }
      *reinterpret_cast<uint4*>(a_s + (r * kHaloW + c) * kKC + k8) = packed;
    }
    for (int e = t; e < 9 * kKC * kCout / 8; e += kThreads) {
      const int col8 = e % (kCout / 8);
      const int row = e / (kCout / 8);  // tap * kKC + kk
      const int tap = row / kKC;
      const int kk = row % kKC;
      *reinterpret_cast<uint4*>(w_s + row * kLdW + col8 * 8) =
          *reinterpret_cast<const uint4*>(a.w + ((size_t)tap * cin + k0 + kk) * kCout
                                          + col8 * 8);
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
      wmma::load_matrix_sync(af, a_s + (dy * kHaloW + warp * 16 + dx) * kKC, kKC);
#pragma unroll
      for (int nf = 0; nf < kNF; ++nf) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, w_s + tap * kKC * kLdW + nf * 16, kLdW);
        wmma::mma_sync(acc[nf], af, bf, acc[nf]);
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int nf = 0; nf < kNF; ++nf)
    wmma::store_matrix_sync(c_s + warp * 16 * kLdC + nf * 16, acc[nf], kLdC,
                            wmma::mem_row_major);
  __syncthreads();

  for (int co = warp; co < kCout; co += kThreads / 32) {
    const float bco = a.bias[co];
    float s = 0.f, q = 0.f;
    for (int px = lane; px < kTW; px += 32) {
      const int ww = w0 + px;
      if (ww < a.W) {
        const __nv_bfloat16 o = __float2bfloat16(c_s[px * kLdC + co] + bco);
        a.y[(size_t)b * a.syb + (size_t)co * a.syc + (size_t)h * a.syh
            + (size_t)ww * a.syw] = o;
        const float f = __bfloat162float(o);
        s += f;
        q += f * f;
      }
    }
    if (a.sum != nullptr) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        q += __shfl_xor_sync(0xffffffffu, q, off);
      }
      if (lane == 0) {
        atomicAdd(a.sum + b * kCout + co, s);
        atomicAdd(a.ssq + b * kCout + co, q);
      }
    }
  }
}

template <int kNF>
int launch(const ConvArgs& a, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<16 * kNF>();
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<kNF>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.W + kTW - 1) / kTW, a.H, a.B);
  conv3x3_kernel<kNF><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int conv3x3_stats(const void* x, const void* x2, int c1, int c2,
                             int sxb, int sxc, int sxh, int sxw,
                             int s2b, int s2c, int s2h, int s2w,
                             const void* w, const void* bias, const void* ps,
                             const void* pt, float slope, void* y,
                             int syb, int syc, int syh, int syw,
                             void* sum, void* ssq, int B, int H, int W, int cout,
                             void* stream) {
  if (B < 1 || H < 1 || W < 1 || c1 < 1 || c1 % kKC || c2 % kKC || H > 65535 ||
      B > 65535 || (c2 > 0 && x2 == nullptr))
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.x2 = static_cast<const __nv_bfloat16*>(x2);
  a.c1 = c1;
  a.c2 = c2;
  a.sxb = sxb; a.sxc = sxc; a.sxh = sxh; a.sxw = sxw;
  a.s2b = s2b; a.s2c = s2c; a.s2h = s2h; a.s2w = s2w;
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.ps = static_cast<const float*>(ps);
  a.pt = static_cast<const float*>(pt);
  a.slope = slope;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.syb = syb; a.syc = syc; a.syh = syh; a.syw = syw;
  a.sum = static_cast<float*>(sum);
  a.ssq = static_cast<float*>(ssq);
  a.B = B;
  a.H = H;
  a.W = W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 16: return launch<1>(a, s);
    case 32: return launch<2>(a, s);
    case 64: return launch<4>(a, s);
    case 128: return launch<8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
