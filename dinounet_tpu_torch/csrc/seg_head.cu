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
// writes (8, 3, 512, 512) fp32 (25 MB), 0.048 ms at 3.35 TB/s.
//
// Design: a stream whose arithmetic stays under its loads. Each block
// works on one image; a warp takes 64 pixels at a time, a group of 4 lanes
// 8 consecutive pixels, and walks the C channels 16 at a time: a lane
// issues its 16-byte loads of 4 channels for two such chunks (a warp reads
// 4 x 128 contiguous bytes a load) before their arithmetic. The prologue
// (coefficients staged once a block in shared memory) and the bf16
// rounding run in registers, the rounding packing two channels of a pixel
// into the bf16 pair that mma.sync.m16n8k16 takes as its A operand (16
// pixels x 16 channels); the K-wide dot is that product against the
// weight's B fragments, built once a block, in 8-class tiles, with fp32
// accumulators. With the dot on CUDA cores (3 fused multiply-adds a value
// at K = 3, 24 at K = 14) the kernel's phases added up instead of
// overlapping; as a product it is one instruction per 16 x 16 x 8. The
// grid is one wave of resident blocks split evenly over the images. A
// lane stores its 8 pixels of a class as two 16-byte stores (staging a
// warp's logits in shared memory for whole-sector stores timed level).
// Where the input's pointer is not 16-byte aligned (a view at an odd
// element of a larger buffer) or H * W is not a multiple of 8, the same
// loop loads and stores element by element.

#include "hopper_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpPix = 64;  // pixels a warp takes at a time: 8 lane groups x 8
constexpr int kChunks = 2;    // 16-channel chunks whose loads are issued together
constexpr int kMaxC = 512;

// 8 pixels of one channel: one 16-byte load, or element loads masked at
// the image's end (0 past it)
template <bool kVec>
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int p0, int HW) {
  if (kVec) return __ldcs(reinterpret_cast<const uint4*>(p));
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  uint32_t e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = p0 + i < HW ? q[i] : 0u;
  return make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16,
                    e[6] | e[7] << 16);
}

__device__ __forceinline__ uint32_t word(const uint4& r, int m) {
  return m == 0 ? r.x : m == 1 ? r.y : m == 2 ? r.z : r.w;
}

// leaky(v * s + t) in fp32
__device__ __forceinline__ float act(float v, float2 st, float slope) {
  const float a = fmaf(v, st.x, st.y);
  return a >= 0.f ? a : a * slope;
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row-major) b (16 x 8 bf16, col-major)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// kNT tiles of 8 classes; kVec: 16-byte loads and stores. Lane (g, q) of a
// warp (g = lane / 4, q = lane % 4) loads channels c0 + 2q + {0, 1, 8, 9}
// of a chunk at its group's 8 pixels p0 .. p0 + 7; product m (0..3) of a
// chunk takes pixels p0 + 2m (A rows 0-7) and p0 + 2m + 1 (rows 8-15), and
// leaves the lane classes 8 nt + 2q + {0, 1} of those two pixels.
template <int kNT, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
seg_head_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ ps,
                const float* __restrict__ pt, float slope, float* __restrict__ out, int C,
                int HW, int K) {
  const int nchunk = (C + 15) / 16;
  extern __shared__ uint2 smem[];
  uint2* wf = smem;  // [nchunk][kNT][32 lanes] B fragments, zero past C and K
  float2* st = reinterpret_cast<float2*>(wf + nchunk * kNT * 32);  // [16 nchunk] (s, t)
  __shared__ float b_s[8 * kNT];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < nchunk * kNT * 32; i += kThreads) {
    const int l = i % 32, nt = (i / 32) % kNT, c = (i / (32 * kNT)) * 16 + 2 * (l % 4);
    const int n = nt * 8 + l / 4;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = c + (j & 1) + 8 * (j >> 1);
      v[j] = cc < C && n < K ? w[cc * K + n] : 0.f;
    }
    wf[i] = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  }
  for (int c = threadIdx.x; c < nchunk * 16; c += kThreads)
    st[c] = c < C ? make_float2(ps[(size_t)b * C + c], pt[(size_t)b * C + c])
                  : make_float2(0.f, 0.f);
  for (int k = threadIdx.x; k < 8 * kNT; k += kThreads) b_s[k] = k < K ? bias[k] : 0.f;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int units = (HW + kWarpPix - 1) / kWarpPix;
  const __nv_bfloat16* xb = x + (size_t)b * C * HW;
  for (int u = blockIdx.x * kWarps + warp; u < units; u += gridDim.x * kWarps) {
    const int p0 = u * kWarpPix + g * 8;
    const bool live = p0 < HW;
    float acc[kNT][4][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][m][j] = 0.f;
    __syncwarp();

    for (int c0 = 0; c0 < C; c0 += 16 * kChunks) {
      uint4 raw[kChunks][4];
#pragma unroll
      for (int h = 0; h < kChunks; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = c0 + 16 * h + 2 * q + (i & 1) + 8 * (i >> 1);
          raw[h][i] = live && c < C ? load8<kVec>(xb + (size_t)c * HW + p0, p0, HW)
                                    : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
      for (int h = 0; h < kChunks; ++h) {
        const int cb = c0 + 16 * h;
        if (cb >= C) break;
        float2 sti[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sti[i] = st[cb + 2 * q + (i & 1) + 8 * (i >> 1)];
        uint2 bf[kNT];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) bf[nt] = wf[((cb / 16) * kNT + nt) * 32 + lane];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          float lo[4], hi[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t v = word(raw[h][i], m);
            lo[i] = act(__uint_as_float(v << 16), sti[i], slope);
            hi[i] = act(__uint_as_float(v & 0xffff0000u), sti[i], slope);
          }
          const uint32_t a[4] = {pack2(lo[0], lo[1]), pack2(hi[0], hi[1]), pack2(lo[2], lo[3]),
                                 pack2(hi[2], hi[3])};
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) mma16816(acc[nt][m], a, bf[nt]);
        }
      }
    }

    // the group's 8 pixels of classes 8 nt + 2q + {0, 1}
    if (!live) continue;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = nt * 8 + 2 * q + j;
        if (k >= K) continue;
        const float bk = b_s[k];
        float v[8];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          v[2 * m] = acc[nt][m][j] + bk;
          v[2 * m + 1] = acc[nt][m][2 + j] + bk;
        }
        float* o = out + ((size_t)b * K + k) * HW + p0;
        if (kVec) {
          reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
          reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (p0 + i < HW) o[i] = v[i];
        }
      }
  }
}

template <int kNT, bool kVec>
int launch(const void* x, const void* w, const void* bias, const void* ps, const void* pt,
           float slope, void* out, int B, int C, int HW, int K, cudaStream_t stream) {
  // the B fragments and the prologue coefficients: at most 36 KB, under the
  // 48 KB a launch takes without an attribute
  constexpr int kMaxBytes = (kMaxC / 16) * kNT * 32 * 8 + kMaxC * 8;
  const int bytes = ((C + 15) / 16) * (kNT * 32 * 8 + 16 * 8);
  const auto kernel = seg_head_kernel<kNT, kVec>;
  static int per_sm = 0;  // resident blocks an SM, looked up once
  if (per_sm == 0) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kMaxBytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int sms = sm_count();
  if (sms == 0 || per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  // one wave split over the images, no more blocks than an image has warp units for
  const int units = (HW + kWarpPix - 1) / kWarpPix;
  int per_image = sms * per_sm / B;
  if (per_image > (units + kWarps - 1) / kWarps) per_image = (units + kWarps - 1) / kWarps;
  if (per_image < 1) per_image = 1;
  kernel<<<dim3(per_image, B), kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(ps),
      static_cast<const float*>(pt), slope, static_cast<float*>(out), C, HW, K);
  return (int)cudaGetLastError();
}

template <int kNT>
int launch_aligned(const void* x, const void* w, const void* bias, const void* ps,
                   const void* pt, float slope, void* out, int B, int C, int HW, int K,
                   cudaStream_t stream) {
  if (HW % 8 == 0 && aligned16(x) && aligned16(out))
    return launch<kNT, true>(x, w, bias, ps, pt, slope, out, B, C, HW, K, stream);
  return launch<kNT, false>(x, w, bias, ps, pt, slope, out, B, C, HW, K, stream);
}

}  // namespace

// x (B, C, HW) bf16, w (C, K) fp32 holding bf16 values, bias (K,) fp32, the
// prologue s and t (B, C) fp32 (required), out (B, K, HW) fp32
extern "C" int seg_head(const void* x, const void* w, const void* bias, const void* ps,
                        const void* pt, float slope, void* out, int B, int C, int HW,
                        int K, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || C > kMaxC || HW < 1 || K < 1 || K > 32 ||
      ps == nullptr || pt == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 8) return launch_aligned<1>(x, w, bias, ps, pt, slope, out, B, C, HW, K, s);
  if (K <= 16) return launch_aligned<2>(x, w, bias, ps, pt, slope, out, B, C, HW, K, s);
  return launch_aligned<4>(x, w, bias, ps, pt, slope, out, B, C, HW, K, s);
}
