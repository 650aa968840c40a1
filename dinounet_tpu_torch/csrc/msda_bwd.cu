// Multi-scale deformable attention backward (col2im), for sm_90a.
//
// Replaces the TPU kernel dinounet_tpu/ops/msda_pallas.py::_bwd_kernel,
// called by _backward_premapped (the VJP of every MSDA entry point). Same
// function, in the same layouts:
//   value (B, M, D, S) bf16      one head's D x S value map per (b, m)
//   xs, ys (B, M, P, Lq) fp32    pixel coordinates (align_corners=False)
//   aw     (B, M, P, Lq) fp32    softmaxed point weights
//   g      (B, M, D, Lq) fp32    cotangent of the forward output
// and out, all fp32:
//   gv     (B, M, D, S)   scatter-add transpose of the bilinear gather:
//                         gv[:, s] += aw * w_corner(s) * g[:, q]
//   ga     (B, M, P, Lq)  sum_d bilinear(v, x, y)[d] * g[d]
//   gx, gy (B, M, P, Lq)  aw * sum_d (d bilinear / dx or dy)[d] * g[d], from
//                         the separable derivatives of the corner weights
//                         (d wx/dx = -1 at x0, +1 at x0 + 1), in pixel units
// with zero padding outside the H x W map: an out-of-map corner adds nothing
// to any output. One level only (L = 1), D <= 64, P <= 16. gv must arrive
// zeroed: the kernel adds into it.
//
// What bounds it on an H100: shared-memory traffic and the scatter's
// atomics. Per query and head the kernel does P x 4 corners x D gathers and
// D scatter-adds (16 x 24 of each at dinounet_b shapes), one FMA each;
// device-memory traffic is one pass over g, the coordinates and the outputs
// plus one read of the value map per block. The TPU kernel built dense
// one-hot (S, Q) weight matrices for the MXU, S times the work; that is not
// carried over. Layout of the work:
// - One block per (b, head, query slice); the slices are chosen so that the
//   grid is about one block per SM (4 slices of 1344 queries for dinounet_b's
//   32 heads on 132 SMs). The block stages the head's value map in shared
//   memory as bf16 [S][D] (48 KB for dinounet_b) and keeps an fp32 [S][D]
//   partial of gv beside it (96 KB), then walks its slice in chunks of 512
//   queries whose g columns it stages as [q][D] (48 KB; 192 KB in all).
// - One warp per query, one lane per channel (two for D > 32). All lanes of
//   a warp sample the same corners, so the branches are uniform, the gathers
//   read D contiguous values, and each corner's D scatter-adds go to D
//   contiguous floats: distinct banks, no two lanes on one address. (A first
//   version gave each thread a query: neighbouring queries sample the same
//   corners, so the lanes of a warp collided on the same shared addresses
//   and the fp32 atomics serialised. At dinounet_b's train shapes on an
//   H100 80GB HBM3 at 700 W it took 1.00 ms of device time a call, this
//   layout 0.30 ms.) ga, gx and gy are per-lane partial sums reduced across
//   the warp with shuffles.
// - The block then adds the non-zero entries of its partial into global gv
//   with fp32 atomicAdd (global atomics, not a second pass). That makes gv
//   depend on the order in which blocks and warps arrive, at fp32 rounding;
//   ga, gx and gy are deterministic. Queries past Lq touch nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 512;   // 16 warps, one query each at a time
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;     // queries whose g columns are staged at once
constexpr int kMaxPoints = 16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// CH channels per lane: lane l holds channels l and l + 32
template <int CH>
__global__ void __launch_bounds__(kThreads)
msda_bwd_kernel(const __nv_bfloat16* __restrict__ value,
                const float* __restrict__ xs, const float* __restrict__ ys,
                const float* __restrict__ aw, const float* __restrict__ g,
                float* __restrict__ gv, float* __restrict__ ga,
                float* __restrict__ gx, float* __restrict__ gy,
                int M, int D, int H, int W, int P, int Lq, int slice) {
  extern __shared__ unsigned char smem[];
  const int S = H * W;
  float* gv_s = reinterpret_cast<float*>(smem);       // [S][D]
  float* g_s = gv_s + S * D;                           // [kChunk][D]
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(g_s + kChunk * D);  // [S][D]
  const size_t bm = (size_t)blockIdx.z * M + blockIdx.y;
  const __nv_bfloat16* v_g = value + bm * D * S;
  for (int i = threadIdx.x; i < D * S; i += kThreads) {
    const int d = i / S;
    const int s = i - d * S;
    v_s[s * D + d] = v_g[i];
    gv_s[i] = 0.f;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q_begin = blockIdx.x * slice;
  const int q_end = min(Lq, q_begin + slice);
  const float* g_g = g + bm * D * Lq;
  const size_t row0 = bm * P * Lq;
  for (int c0 = q_begin; c0 < q_end; c0 += kChunk) {
    const int n = min(kChunk, q_end - c0);
    __syncthreads();  // the value map is staged / the last chunk is done
    for (int i = threadIdx.x; i < D * n; i += kThreads) {
      const int d = i / n;
      const int j = i - d * n;
      g_s[j * D + d] = g_g[(size_t)d * Lq + c0 + j];
    }
    __syncthreads();

    for (int j = warp; j < n; j += kWarps) {
      const int q = c0 + j;
      float gq[CH];
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        const int d = lane + 32 * k;
        gq[k] = d < D ? g_s[j * D + d] : 0.f;
      }
      for (int p = 0; p < P; ++p) {
        const size_t at = row0 + (size_t)p * Lq + q;
        const float a = aw[at];
        // clamping to one pixel beyond the map keeps the int conversion in
        // range and leaves every out-of-map corner out of the map
        const float x = fminf(fmaxf(xs[at], -2.f), (float)W + 1.f);
        const float y = fminf(fmaxf(ys[at], -2.f), (float)H + 1.f);
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const float fx = x - x0f;
        const float fy = y - y0f;
        const int x0 = (int)x0f;
        const int y0 = (int)y0f;
        float s_val = 0.f, s_dx = 0.f, s_dy = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int dy = c >> 1;
          const int dx = c & 1;
          const int yy = y0 + dy;
          const int xx = x0 + dx;
          if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;  // warp-uniform
          const float wy = dy ? fy : 1.f - fy;
          const float wx = dx ? fx : 1.f - fx;
          const float wt = a * (wy * wx);
          const int pos = (yy * W + xx) * D;
          float t = 0.f;
#pragma unroll
          for (int k = 0; k < CH; ++k) {
            const int d = lane + 32 * k;
            if (d < D) {
              t = fmaf(__bfloat162float(v_s[pos + d]), gq[k], t);
              atomicAdd(gv_s + pos + d, wt * gq[k]);
            }
          }
          s_val = fmaf(wy * wx, t, s_val);
          s_dx = fmaf(dx ? wy : -wy, t, s_dx);
          s_dy = fmaf(dy ? wx : -wx, t, s_dy);
        }
        s_val = warp_sum(s_val);
        s_dx = warp_sum(s_dx);
        s_dy = warp_sum(s_dy);
        if (lane == 0) ga[at] = s_val;
        if (lane == 1) gx[at] = a * s_dx;
        if (lane == 2) gy[at] = a * s_dy;
      }
    }
  }
  __syncthreads();

  // global layout (D, S): consecutive threads add to consecutive positions
  float* gv_g = gv + bm * D * S;
  for (int i = threadIdx.x; i < D * S; i += kThreads) {
    const int d = i / S;
    const int s = i - d * S;
    const float t = gv_s[s * D + d];
    if (t != 0.f) atomicAdd(gv_g + i, t);
  }
}

template <int CH>
int launch(const void* value, const void* xs, const void* ys, const void* aw,
           const void* g, void* gv, void* ga, void* gx, void* gy, int B, int M,
           int D, int H, int W, int P, int Lq, cudaStream_t stream) {
  const size_t S = (size_t)H * W;
  const size_t smem = S * D * (sizeof(float) + sizeof(__nv_bfloat16)) +
                      (size_t)kChunk * D * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      msda_bwd_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // about one block per SM: split each head's queries into that many slices
  const int slices = max(1, min((Lq + kWarps - 1) / kWarps, sms / (B * M)));
  const int slice = (Lq + slices - 1) / slices;
  const dim3 grid((Lq + slice - 1) / slice, M, B);
  msda_bwd_kernel<CH><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(xs),
      static_cast<const float*>(ys), static_cast<const float*>(aw),
      static_cast<const float*>(g), static_cast<float*>(gv),
      static_cast<float*>(ga), static_cast<float*>(gx), static_cast<float*>(gy),
      M, D, H, W, P, Lq, slice);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int msda_bwd(const void* value, const void* xs, const void* ys,
                        const void* aw, const void* g, void* gv, void* ga,
                        void* gx, void* gy, int B, int M, int D, int H, int W,
                        int P, int Lq, void* stream) {
  if (D < 1 || D > 64 || P < 1 || P > kMaxPoints || B < 1 || M < 1 || Lq < 1 ||
      H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch<1>(value, xs, ys, aw, g, gv, ga, gx, gy, B, M, D, H, W, P, Lq, s);
  return launch<2>(value, xs, ys, aw, g, gv, ga, gx, gy, B, M, D, H, W, P, Lq, s);
}
