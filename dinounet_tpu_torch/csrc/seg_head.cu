// 1x1 segmentation head over InstanceNorm-applied, leaky-ReLU-activated
// features, with fp32 logits, for sm_90a.
//
// Replaces the TPU kernel dinounet_tpu/ops/decoder_tail_pallas.py _seg_kernel
// (called by seg_head_cm). Channel-major (B, C, H, W) bf16 in, (B, K, H, W)
// fp32 out:
//   x'[b, c, p]   = bf16(leaky(x * s[b, c] + t[b, c]))
//   out[b, k, p]  = sum_c x'[b, c, p] * bf16(w[c, k]) + bias[k]     (fp32)
// The products of two bf16 values are exact in fp32, so only the order of
// the fp32 sum differs from the plain version.
//
// What bounds it on an H100: 2 * K FLOP per C-channel bf16 read (K = 3
// classes: 3 FLOP per byte), far below the card's ridge, so HBM bounds it:
// at the decoder's last stage it reads (8, 32, 512, 512) bf16 (134 MB) and
// writes (8, 3, 512, 512) fp32 (25 MB). Design: no tensor cores (N = K is
// tiny); each thread owns 4 consecutive pixels of one image, walks the C
// channels with one 8-byte load each (a warp reads 256 contiguous bytes per
// channel), applies the prologue and rounding in registers, and accumulates
// K fp32 sums per pixel against the weights and the per-(b, c) prologue
// coefficients staged in shared memory; the K outputs go out as 16-byte
// stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;  // pixels per thread

template <int kK>
__global__ void __launch_bounds__(kThreads)
seg_head_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ ps,
                const float* __restrict__ pt, float slope, float* __restrict__ out,
                int C, int HW, int K) {
  extern __shared__ float sm[];
  float* w_s = sm;              // [C][kK], zero beyond K, bf16-rounded values
  float* s_s = w_s + C * kK;    // [C]
  float* t_s = s_s + C;         // [C]
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < C * kK; i += kThreads) {
    const int c = i / kK, k = i % kK;
    w_s[i] = k < K ? w[c * K + k] : 0.f;
  }
  for (int c = threadIdx.x; c < C; c += kThreads) {
    s_s[c] = ps[b * C + c];
    t_s[c] = pt[b * C + c];
  }
  __syncthreads();

  const int p0 = (blockIdx.x * kThreads + threadIdx.x) * kPix;
  if (p0 >= HW) return;
  const bool full = p0 + kPix <= HW && HW % kPix == 0;
  float acc[kK][kPix];
#pragma unroll
  for (int k = 0; k < kK; ++k)
#pragma unroll
    for (int i = 0; i < kPix; ++i) acc[k][i] = 0.f;

  const __nv_bfloat16* xb = x + (size_t)b * C * HW + p0;
  for (int c = 0; c < C; ++c) {
    float v[kPix];
    const __nv_bfloat16* xc = xb + (size_t)c * HW;
    if (full) {
      const uint2 raw = *reinterpret_cast<const uint2*>(xc);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < kPix; ++i) v[i] = __bfloat162float(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kPix; ++i) v[i] = p0 + i < HW ? __bfloat162float(xc[i]) : 0.f;
    }
    const float s = s_s[c], t = t_s[c];
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      float a = fmaf(v[i], s, t);
      a = a >= 0.f ? a : a * slope;
      v[i] = __bfloat162float(__float2bfloat16(a));
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float wk = w_s[c * kK + k];
#pragma unroll
      for (int i = 0; i < kPix; ++i) acc[k][i] = fmaf(v[i], wk, acc[k][i]);
    }
  }
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    if (k >= K) break;
    const float bk = bias[k];
    float* o = out + ((size_t)b * K + k) * HW + p0;
    if (full) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[k][0] + bk, acc[k][1] + bk,
                                                  acc[k][2] + bk, acc[k][3] + bk);
    } else {
#pragma unroll
      for (int i = 0; i < kPix; ++i)
        if (p0 + i < HW) o[i] = acc[k][i] + bk;
    }
  }
}

template <int kK>
int launch(const void* x, const void* w, const void* bias, const void* ps,
           const void* pt, float slope, void* out, int B, int C, int HW, int K,
           cudaStream_t stream) {
  const int bytes = (C * kK + 2 * C) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      seg_head_kernel<kK>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((HW + kThreads * kPix - 1) / (kThreads * kPix), B);
  seg_head_kernel<kK><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(ps),
      static_cast<const float*>(pt), slope, static_cast<float*>(out), C, HW, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int seg_head(const void* x, const void* w, const void* bias, const void* ps,
                        const void* pt, float slope, void* out, int B, int C, int HW,
                        int K, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || C > 512 || HW < 1 || K < 1 || K > 32 ||
      ps == nullptr || pt == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 4) return launch<4>(x, w, bias, ps, pt, slope, out, B, C, HW, K, s);
  if (K <= 8) return launch<8>(x, w, bias, ps, pt, slope, out, B, C, HW, K, s);
  if (K <= 16) return launch<16>(x, w, bias, ps, pt, slope, out, B, C, HW, K, s);
  return launch<32>(x, w, bias, ps, pt, slope, out, B, C, HW, K, s);
}
