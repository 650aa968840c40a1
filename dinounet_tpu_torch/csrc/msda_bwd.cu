// Multi-scale deformable attention backward (col2im), for sm_90a.
//
// Replaces the TPU kernel dinounet_tpu/ops/msda_pallas.py::_bwd_kernel,
// called by _backward_premapped (the VJP of every MSDA entry point). Same
// function, in the same layouts:
//   value  (B, M, D, S) bf16 or fp32   one head's D x S value map per (b, m),
//                                      L levels concatenated along S
//   xs, ys (B, M, L*P, Lq) fp32        pixel coordinates (align_corners=False)
//                                      of point p of level l in row l*P + p
//   aw     (B, M, L*P, Lq) fp32        point weights
//   g      (B, M, D, Lq) fp32          cotangent of the forward output
// and out, all fp32:
//   gv     (B, M, D, S)   scatter-add transpose of the bilinear gather:
//                         gv[:, s] += aw * w_corner(s) * g[:, q]
//   ga     (B, M, LP, Lq) sum_d bilinear(v, x, y)[d] * g[d]
//   gx, gy (B, M, LP, Lq) aw * sum_d (d bilinear / dx or dy)[d] * g[d], from
//                         the separable derivatives of the corner weights
//                         (d wx/dx = -1 at x0, +1 at x0 + 1), in pixel units
// with zero padding outside each H_l x W_l map: an out-of-map corner adds
// nothing to any output. D <= 128, P <= 16 points a level, up to 4 levels,
// any S.
//
// What bounds it on an H100: the scatter's atomics and the gathers. Per
// query and head the kernel does L x P x 4 corners x D gathers and D
// scatter-adds (16 x 24 of each at dinounet_b shapes), one FMA each;
// device-memory traffic is one pass over g, the coordinates and the outputs
// plus the value map. The TPU kernel built dense one-hot (S, Q) weight
// matrices for the MXU, S times the work; that is not carried over. In both
// instances below one warp takes one query at a time, one lane per channel
// (CH = ceil(D / 32) channels a lane). All lanes of a warp sample the same
// corners, so the branches are uniform, the gathers read D contiguous values
// of a token-major [S][D] map, and each corner's D scatter-adds go to D
// contiguous floats: distinct banks or one run of cache lines, no two lanes
// on one address. (A first version gave each thread a query: neighbouring
// queries sample the same corners, so the lanes of a warp collided on the
// same addresses and the fp32 atomics serialised. At dinounet_b's train
// shapes on an H100 80GB HBM3 at 700 W it took 1.00 ms of device time a
// call, this layout 0.30 ms.) ga, gx and gy are per-lane partial sums
// reduced across the warp with shuffles: they are deterministic.
// - staged (msda_bwd_kernel), where one level's bf16 map and an fp32 gv
//   partial of the head fit in shared memory (6 * D * S + 2 KB * D bytes:
//   D <= 28 at S = 1024; dinounet_b's D = 24): one block per (b, head, query
//   slice), the slices chosen so that the grid is about one block per SM
//   (4 slices of 1344 queries for dinounet_b's 32 heads on 132 SMs). The
//   block stages the map as bf16 [S][D] (48 KB for dinounet_b) beside an
//   fp32 [S][D] partial of gv (96 KB), walks its slice in chunks of 512
//   queries whose g columns it stages as [q][D] (48 KB; 192 KB in all), and
//   then adds the non-zero entries of its partial into global gv with fp32
//   atomicAdd.
// - global (msda_bwd_global_kernel), every other head: dinounet_l's D = 32
//   and the 7B's D = 128 at S = 1024, any S, several levels, an fp32 map. A
//   pre-pass writes a token-major copy (B, M, S, D) of the map, the warps
//   gather from it through L2 (__ldg; the whole value tensor of a train step
//   is at most 8 MB, B 2 x M 16 x D 128 x S 1024 bf16, well inside the 50 MB
//   L2) and add into a token-major fp32 gv (B, M, S, D) in device memory
//   with atomicAdd, as the reference CUDA col2im does; a post-pass
//   transposes it into gv. One block per (b, head, 64-query chunk) stages
//   its chunk's g columns as [q][D]. Cutting a head into channel slices
//   across blocks instead would keep a slice of the map in shared memory,
//   but ga, gx and gy would then need a sum across blocks; the whole head in
//   one warp keeps them warp sums.
// In both gv depends on the order in which warps and blocks arrive, at fp32
// rounding. Queries past Lq touch nothing. gv (staged) and the token-major gv
// (global) must arrive zeroed: the kernels add into them.

#include "msda_common.cuh"

#include <math.h>

namespace {

using msda::Levels;
using msda::to_float;

constexpr int kThreads = 512;   // 16 warps, one query each at a time
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;     // queries whose g columns are staged at once
constexpr int kMaxPoints = 16;  // per level
constexpr int kThreadsG = 256;  // the global instance: 8 warps
constexpr int kWarpsG = kThreadsG / 32;
constexpr int kChunkG = 64;     // its queries a block

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

// v_sd, gv_sd: the token-major (B, M, S, D) map and gradient
template <int CH, typename T>
__global__ void __launch_bounds__(kThreadsG)
msda_bwd_global_kernel(const T* __restrict__ v_sd, const float* __restrict__ xs,
                       const float* __restrict__ ys, const float* __restrict__ aw,
                       const float* __restrict__ g, float* __restrict__ gv_sd,
                       float* __restrict__ ga, float* __restrict__ gx,
                       float* __restrict__ gy, int M, int D, int S, Levels lv, int P,
                       int Lq) {
  extern __shared__ float g_s[];  // [kChunkG][D]
  const size_t bm = (size_t)blockIdx.z * M + blockIdx.y;
  const int q0 = blockIdx.x * kChunkG;
  const int n = min(kChunkG, Lq - q0);
  const float* g_g = g + bm * D * Lq + q0;
  for (int i = threadIdx.x; i < D * kChunkG; i += kThreadsG) {
    const int d = i / kChunkG;
    const int j = i - d * kChunkG;
    if (j < n) g_s[j * D + d] = g_g[(size_t)d * Lq + j];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row0 = bm * lv.n * P * Lq;
  for (int j = warp; j < n; j += kWarpsG) {
    const int q = q0 + j;
    float gq[CH];
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int d = lane + 32 * k;
      gq[k] = d < D ? g_s[j * D + d] : 0.f;
    }
    for (int l = 0; l < lv.n; ++l) {
      const int H = lv.h[l];
      const int W = lv.w[l];
      const T* v_l = v_sd + (bm * S + lv.start[l]) * D;
      float* gv_l = gv_sd + (bm * S + lv.start[l]) * D;
      for (int p = 0; p < P; ++p) {
        const size_t at = row0 + (size_t)(l * P + p) * Lq + q;
        const float a = aw[at];
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
              t = fmaf(to_float(__ldg(v_l + pos + d)), gq[k], t);
              atomicAdd(gv_l + pos + d, wt * gq[k]);
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

template <int CH, typename T>
int launch_global(const void* v_sd, const void* xs, const void* ys, const void* aw,
                  const void* g, void* gv_sd, void* ga, void* gx, void* gy, int B, int M,
                  int D, int S, const Levels& lv, int P, int Lq, cudaStream_t stream) {
  const dim3 grid((Lq + kChunkG - 1) / kChunkG, M, B);
  const size_t smem = (size_t)kChunkG * D * sizeof(float);
  msda_bwd_global_kernel<CH, T><<<grid, kThreadsG, smem, stream>>>(
      static_cast<const T*>(v_sd), static_cast<const float*>(xs),
      static_cast<const float*>(ys), static_cast<const float*>(aw),
      static_cast<const float*>(g), static_cast<float*>(gv_sd),
      static_cast<float*>(ga), static_cast<float*>(gx), static_cast<float*>(gy),
      M, D, S, lv, P, Lq);
  return (int)cudaGetLastError();
}

// the global path: transpose the map, the kernel, transpose gv back
template <typename T>
int global_path(const void* value, void* v_sd, const void* xs, const void* ys,
                const void* aw, const void* g, void* gv, void* gv_sd, void* ga, void* gx,
                void* gy, int B, int M, int D, int S, const Levels& lv, int P, int Lq,
                cudaStream_t s) {
  cudaError_t err = msda::transpose<T>(value, v_sd, B * M, D, S, s);
  if (err != cudaSuccess) return (int)err;
  int r;
  if (D <= 32)
    r = launch_global<1, T>(v_sd, xs, ys, aw, g, gv_sd, ga, gx, gy, B, M, D, S, lv, P, Lq, s);
  else if (D <= 64)
    r = launch_global<2, T>(v_sd, xs, ys, aw, g, gv_sd, ga, gx, gy, B, M, D, S, lv, P, Lq, s);
  else if (D <= 96)
    r = launch_global<3, T>(v_sd, xs, ys, aw, g, gv_sd, ga, gx, gy, B, M, D, S, lv, P, Lq, s);
  else
    r = launch_global<4, T>(v_sd, xs, ys, aw, g, gv_sd, ga, gx, gy, B, M, D, S, lv, P, Lq, s);
  if (r != 0) return r;
  return (int)msda::transpose<float>(gv_sd, gv, B * M, S, D, s);
}

}  // namespace

// shapes (H_0, W_0, ..., H_{L-1}, W_{L-1}) on the host; value fp32 if
// value_fp32, else bf16. v_sd null: the staged instance (one level, a bf16
// map, D <= 64, the caller has checked that it fits; gv zeroed). Else the
// global one: v_sd (B, M, S, D) of value's type and gv_sd (B, M, S, D) fp32,
// zeroed, are the caller's scratch, and gv is written whole.
extern "C" int msda_bwd(const void* value, void* v_sd, const void* xs, const void* ys,
                        const void* aw, const void* g, void* gv, void* gv_sd, void* ga,
                        void* gx, void* gy, int B, int M, int D, const int* shapes, int L,
                        int P, int Lq, int value_fp32, void* stream) {
  Levels lv;
  int S = 0;
  if (D < 1 || D > 128 || P < 1 || P > kMaxPoints || B < 1 || M < 1 || Lq < 1 ||
      !msda::make_levels(shapes, L, &lv, &S))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v_sd == nullptr) {
    if (L != 1 || value_fp32 || D > 64) return (int)cudaErrorInvalidValue;
    if (D <= 32)
      return launch<1>(value, xs, ys, aw, g, gv, ga, gx, gy, B, M, D, lv.h[0], lv.w[0], P, Lq, s);
    return launch<2>(value, xs, ys, aw, g, gv, ga, gx, gy, B, M, D, lv.h[0], lv.w[0], P, Lq, s);
  }
  if (gv_sd == nullptr) return (int)cudaErrorInvalidValue;
  if (value_fp32)
    return global_path<float>(value, v_sd, xs, ys, aw, g, gv, gv_sd, ga, gx, gy, B, M, D, S,
                              lv, P, Lq, s);
  return global_path<__nv_bfloat16>(value, v_sd, xs, ys, aw, g, gv, gv_sd, ga, gx, gy, B, M,
                                    D, S, lv, P, Lq, s);
}
