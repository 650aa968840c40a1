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
// query and head the kernel reads L x P x 4 corners x D values and adds as
// many terms into gv (16 x 24 of each at dinounet_b's shapes), one FMA each;
// device-memory traffic is one pass over g, the coordinates and the outputs
// plus the value map. The TPU kernel built dense one-hot (S, Q) weight
// matrices for the MXU, S times the work; that is not carried over.
//
// Design (the staged instance, msda_bwd_kernel):
// 1. A block takes one (b, head, channel slice) and a contiguous range of its
//    queries, a head's queries cut into as many ranges as one wave of blocks
//    holds. It stages the slice's map once (all levels) as 16-byte cells of
//    8 bf16 or 4 fp32 channels (msda_common.cuh::stage_map). Heads of up to
//    64 channels whose cells fit a block are one slice (dinounet_b's D = 24
//    and dinounet_l's D = 32, also on a 1024^2 patch's S = 4096 at D = 24);
//    wider heads are cut into slices of up to 32 channels, as wide as fit
//    (four of the 7B's 128), as the forwards cut them; the wrapper picks the
//    width.
// 2. A lane takes one (query, 4 channels): a warp walks 32 / nu queries at a
//    time, nu = the slice's 4-channel units (6 at D = 24: 30 of 32 lanes
//    busy), the lanes of a unit on consecutive queries (their cotangents read
//    coalesced, a point's coordinates one broadcast). Per corner a lane reads
//    its unit of the cell (8 or 16 bytes) and sums its channels' products
//    with the cotangent.
// 3. gv: per corner a lane adds wt * g for its 4 channels into a token-major
//    fp32 scratch (B, M, S, Dp) by one 16-byte reduction in L2
//    (red.global.add.v4.f32: no return, no retry). The lanes of a query cover
//    its channels of one position, a row of Dp = D rounded up to 32 floats,
//    so a query's corner is one 128-byte line of reductions (the cost of
//    these reductions follows the lines they touch). A finishing kernel
//    transposes the scratch into gv (D, S). (Drafts timed slower: a
//    shared-memory partial of gv, since sm_90 has no shared fp32 add and
//    each add is a compare-and-swap loop on addresses that neighbouring
//    queries share; and 16-byte reductions into a cell-major scratch, six
//    lines a query's corner: kernel_variants.py.)
// 4. ga, gx and gy: a point's three sums over the query's nu lanes, by
//    shuffles in a fixed order (halves folded, then the first three lanes
//    each gather one sum: 5 shuffles at D = 24, not 15; unit_sums), each
//    written by its own lane in one store: no atomics, the same every run.
//    A head cut into channel slices writes each slice's sums to the caller's
//    scratch and a second kernel adds them in slice order.
// gv depends on the order in which the reductions arrive, at fp32 rounding.
// The instance needs one cell's channels of the map in shared memory (S up
// to 14528). A wider map takes the device-memory instance
// (msda_bwd_global_kernel): a pre-pass writes a token-major copy (B, M, S, D)
// of the map, one warp takes one query at a time, a lane a channel, gathers
// through L2 and adds into a token-major fp32 gv (B, M, S, D) in device
// memory with atomicAdd, as the reference CUDA col2im does, and a post-pass
// transposes it into gv. Queries past Lq touch nothing.

#include "msda_common.cuh"

namespace {

using namespace msda;

constexpr int kThreads = 512;  // 16 warps, 32 / nu queries each at a time
constexpr int kWarps = kThreads / 32;
constexpr int kThreadsG = 256;  // the device-memory instance: 8 warps
constexpr int kWarpsG = kThreadsG / 32;
constexpr int kChunkG = 64;     // its queries a block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sums of a query's three partials v[0..2] over its nu lanes (lanes
// qi + qw u, u < nu). Halves fold while three lanes or more remain; then
// each of the first three lanes gathers its value's partials from the others
// in rotation (at D = 24: 3 + 2 shuffles, not 3 x 5). On return lane u < 3
// holds the total of v[u] in v[0]; where nu < 3, lane u = 0 holds all three.
// The order of the additions is fixed: the sums are the same every run.
__device__ __forceinline__ void unit_sums(float (&v)[3], int lane, int u, int nu, int qw) {
  int c = nu;
  while ((c & 1) == 0 && c / 2 >= 3) {  // the same for the whole warp
    const int o = (c / 2) * qw;
#pragma unroll
    for (int i = 0; i < 3; ++i) v[i] += __shfl_down_sync(0xffffffffu, v[i], o);
    c /= 2;
  }
  if (c < 3) {
    if (c == 2) {
#pragma unroll
      for (int i = 0; i < 3; ++i) v[i] += __shfl_down_sync(0xffffffffu, v[i], qw);
    }
    return;
  }
  const int qi = lane - u * qw;
  float t = u == 0 ? v[0] : u == 1 ? v[1] : u == 2 ? v[2] : 0.f;
  for (int k = 1; k < c; ++k) {
    // lane u receives value u from unit (u + k) % c, which sends its value
    // (its unit - k) mod c
    const int s = (u - k + c) % c;
    const float send = s == 0 ? v[0] : s == 1 ? v[1] : s == 2 ? v[2] : 0.f;
    t += __shfl_sync(0xffffffffu, send, ((u + k) % c) * qw + qi);
  }
  v[0] = t;
}

// channels [4 u, 4 u + 4) of position pos from the staged cells ([ng][Sp]):
// half a bf16 cell, a whole fp32 one
template <typename T>
__device__ __forceinline__ void load_unit(float (&v)[4], const uint4* v_s, int Sp, int u,
                                          int pos) {
  if constexpr (sizeof(T) == 2) {
    const uint2 w = reinterpret_cast<const uint2*>(v_s + (size_t)(u >> 1) * Sp + pos)[u & 1];
    v[0] = __uint_as_float(w.x << 16);
    v[1] = __uint_as_float(w.x & 0xFFFF0000u);
    v[2] = __uint_as_float(w.y << 16);
    v[3] = __uint_as_float(w.y & 0xFFFF0000u);
  } else {
    const uint4 w = v_s[(size_t)u * Sp + pos];
    v[0] = __uint_as_float(w.x);
    v[1] = __uint_as_float(w.y);
    v[2] = __uint_as_float(w.z);
    v[3] = __uint_as_float(w.w);
  }
}

// blockIdx = (query range, head * n_slices + slice, b). gv_t: (B, M, S,
// Dp) fp32, zeroed; part: (3, n_slices, B, M, LP, Lq) when n_slices > 1
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
msda_bwd_kernel(const T* __restrict__ value, const float* __restrict__ xs,
                const float* __restrict__ ys, const float* __restrict__ aw,
                const float* __restrict__ g, float* __restrict__ gv_t, float* __restrict__ ga,
                float* __restrict__ gx, float* __restrict__ gy, float* __restrict__ part,
                int M, int D, int Dp, int sw, int n_slices, int S, Levels lv, int P, int Lq,
                int q_chunk) {
  constexpr int CC = kCell<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Sp = round8(S);
  const int m = blockIdx.y / n_slices, slice = blockIdx.y - m * n_slices;
  const int d0 = slice * sw, dc = min(sw, D - d0);
  const size_t bm = (size_t)blockIdx.z * M + m;
  uint4* v_s = reinterpret_cast<uint4*>(smem);  // [ceil(dc / CC)][Sp] cells
  stage_map(v_s, value + (bm * D + d0) * S, dc, (dc + CC - 1) / CC, S, Sp);  // ends with a barrier

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nu = (dc + 3) >> 2, qw = 32 / nu;
  const int u = lane / qw, qi = lane - u * qw;  // the lane's 4-channel unit and query
  const int c0 = 4 * u;                         // its first channel in the slice
  const int LP = lv.n * P;
  const size_t row0 = bm * LP * Lq;
  float *oa = ga, *ox = gx, *oy = gy;
  if (n_slices > 1) {  // this slice's sums, added by sum_slices_kernel
    const size_t n = (size_t)gridDim.z * M * LP * Lq;
    oa = part + slice * n;
    ox = oa + n_slices * n;
    oy = ox + n_slices * n;
  }
  const float* g_c = g + (bm * D + d0 + c0) * Lq;
  float* gv_u = gv_t + bm * S * Dp + d0 + c0;  // the lane's channels of position 0
  const int q_end = min(Lq, (int)(blockIdx.x + 1) * q_chunk);
  for (int qb = blockIdx.x * q_chunk + warp * qw; qb < q_end; qb += kWarps * qw) {
    const int q = qb + qi;
    const bool live = u < nu && q < q_end;
    float gq[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) gq[k] = live && c0 + k < dc ? g_c[(size_t)k * Lq + q] : 0.f;
    for (int l = 0; l < lv.n; ++l) {
      const int st = lv.start[l], H = lv.h[l], W = lv.w[l];
      for (int p = 0; p < P; ++p) {
        const size_t at = row0 + (size_t)(l * P + p) * Lq + q;
        float a = 0.f, x = -2.f, y = -2.f;
        if (live) {
          a = aw[at];
          x = xs[at];
          y = ys[at];
        }
        // clamping to one pixel beyond the map keeps the int conversion in
        // range and leaves every out-of-map corner out of the map
        x = fminf(fmaxf(x, -2.f), (float)W + 1.f);
        y = fminf(fmaxf(y, -2.f), (float)H + 1.f);
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const float fx = x - x0f;
        const float fy = y - y0f;
        const int x0 = (int)x0f;
        const int y0 = (int)y0f;
        float sv[3] = {0.f, 0.f, 0.f};  // the value's, d / dx's and d / dy's sums
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int dy = c >> 1;
          const int dx = c & 1;
          const int yy = y0 + dy;
          const int xx = x0 + dx;
          if (!live || yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
          const float wy = dy ? fy : 1.f - fy;
          const float wx = dx ? fx : 1.f - fx;
          const float wt = a * (wy * wx);
          const int pos = st + yy * W + xx;
          atomicAdd(reinterpret_cast<float4*>(gv_u + (size_t)pos * Dp),
                    make_float4(wt * gq[0], wt * gq[1], wt * gq[2], wt * gq[3]));
          float v[4];
          load_unit<T>(v, v_s, Sp, u, pos);
          float t = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) t = fmaf(v[k], gq[k], t);
          sv[0] = fmaf(wy * wx, t, sv[0]);
          sv[1] = fmaf(dx ? wy : -wy, t, sv[1]);
          sv[2] = fmaf(dy ? wx : -wx, t, sv[2]);
        }
        unit_sums(sv, lane, u, nu, qw);
        if (nu < 3) {
          if (live && u == 0) {
            oa[at] = sv[0];
            ox[at] = a * sv[1];
            oy[at] = a * sv[2];
          }
        } else if (live && u < 3) {  // one store: lane u writes output u
          (u == 0 ? oa : u == 1 ? ox : oy)[at] = u == 0 ? sv[0] : a * sv[0];
        }
      }
    }
  }
}

// gv (R, D, S) from the token-major scratch gv_t (R, S, Dp), through a 32 x 33
// tile in shared memory: reads and writes coalesced
__global__ void finish_kernel(const float* __restrict__ gv_t, float* __restrict__ gv, int D,
                              int Dp, int S) {
  __shared__ float tile[32][33];
  const float* in = gv_t + blockIdx.z * (size_t)S * Dp;
  float* out = gv + blockIdx.z * (size_t)D * S;
  const int s0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int s = s0 + i, c = c0 + threadIdx.x;
    if (s < S && c < D) tile[i][threadIdx.x] = in[(size_t)s * Dp + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int c = c0 + i, s = s0 + threadIdx.x;
    if (s < S && c < D) out[(size_t)c * S + s] = tile[threadIdx.x][i];
  }
}

// ga, gx, gy = the slices' sums in part (3, n_slices, n), in slice order
__global__ void sum_slices_kernel(const float* __restrict__ part, float* __restrict__ ga,
                                  float* __restrict__ gx, float* __restrict__ gy,
                                  int n_slices, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float t[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int o = 0; o < 3; ++o)
      for (int sl = 0; sl < n_slices; ++sl) t[o] += part[((size_t)o * n_slices + sl) * n + i];
    ga[i] = t[0];
    gx[i] = t[1];
    gy[i] = t[2];
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


template <typename T>
int launch(const void* value, const void* xs, const void* ys, const void* aw, const void* g,
           void* gv, void* gv_t, void* ga, void* gx, void* gy, void* part, int B, int M, int D,
           int S, const Levels& lv, int P, int Lq, int sw, cudaStream_t stream) {
  constexpr int CC = kCell<T>;
  auto kernel = msda_bwd_kernel<T>;
  const int n_slices = (D + sw - 1) / sw, Dp = (D + 31) / 32 * 32;
  const size_t smem = (size_t)((sw < D ? sw : D) + CC - 1) / CC * round8(S) * 16;
  // the attribute once a device; the blocks an SM holds once a map size
  static unsigned long long ready = 0;  // one bit a device
  cudaError_t err = set_smem_once(kernel, kSmemMax, &ready);
  if (err != cudaSuccess) return (int)err;
  static int last_smem = -1, per_sm = 0;
  if (last_smem != (int)smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    last_smem = (int)smem;
  }
  if (sm_count() < 1) return (int)cudaErrorInvalidDevice;
  const int heads = B * M;
  err = cudaMemsetAsync(gv_t, 0, (size_t)heads * S * Dp * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  const int q_chunk = query_chunk(per_sm, (long long)heads * n_slices, Lq, kThreads);
  const dim3 grid((Lq + q_chunk - 1) / q_chunk, M * n_slices, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(xs),
      static_cast<const float*>(ys), static_cast<const float*>(aw),
      static_cast<const float*>(g), static_cast<float*>(gv_t), static_cast<float*>(ga),
      static_cast<float*>(gx), static_cast<float*>(gy), static_cast<float*>(part), M, D, Dp,
      sw, n_slices, S, lv, P, Lq, q_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_kernel<<<dim3((D + 31) / 32, (S + 31) / 32, heads), dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(gv_t), static_cast<float*>(gv), D, Dp, S);
  if (n_slices > 1) {
    const size_t n = (size_t)heads * lv.n * P * Lq;
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    sum_slices_kernel<<<blocks, 256, 0, stream>>>(
        static_cast<const float*>(part), static_cast<float*>(ga), static_cast<float*>(gx),
        static_cast<float*>(gy), n_slices, n);
  }
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
// value_fp32, else bf16. v_sd null: the staged instance, in channel slices
// of sw channels (a multiple of a cell's 8 bf16 or 4 fp32 channels; sw >= D:
// the whole head) whose cells fit in shared memory; scratch: gv_t
// (B, M, S, D rounded up to 32) fp32, and part (3, n_slices, B, M, LP, Lq) fp32
// where the head has more than one slice, else null; gv is written whole.
// Else the device-memory instance: v_sd (B, M, S, D) of value's type and
// gv_sd (B, M, S, D) fp32, zeroed, are the caller's scratch, and gv is
// written whole.
extern "C" int msda_bwd(const void* value, void* v_sd, const void* xs, const void* ys,
                        const void* aw, const void* g, void* gv, void* gv_sd, void* ga,
                        void* gx, void* gy, void* gv_t, void* part, int B, int M, int D,
                        const int* shapes, int L, int P, int Lq, int value_fp32, int sw,
                        void* stream) {
  Levels lv;
  int S = 0;
  if (D < 1 || D > 128 || bad_sizes(B, M, D, P, Lq) || B > 65535 ||
      !make_levels(shapes, L, &lv, &S))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v_sd == nullptr) {
    const int CC = value_fp32 ? kCell<float> : kCell<__nv_bfloat16>;
    if (sw < CC || sw % CC != 0 || gv_t == nullptr) return (int)cudaErrorInvalidValue;
    const int n_slices = (D + sw - 1) / sw, dc = sw < D ? sw : D;
    const size_t smem = (size_t)(dc + CC - 1) / CC * round8(S) * 16;
    if (smem > (size_t)kSmemMax || M > 65535 / n_slices || (n_slices > 1) != (part != nullptr))
      return (int)cudaErrorInvalidValue;
    if (value_fp32)
      return launch<float>(value, xs, ys, aw, g, gv, gv_t, ga, gx, gy, part, B, M, D, S, lv,
                           P, Lq, sw, s);
    return launch<__nv_bfloat16>(value, xs, ys, aw, g, gv, gv_t, ga, gx, gy, part, B, M, D, S,
                                 lv, P, Lq, sw, s);
  }
  if (gv_sd == nullptr) return (int)cudaErrorInvalidValue;
  if (value_fp32)
    return global_path<float>(value, v_sd, xs, ys, aw, g, gv, gv_sd, ga, gx, gy, B, M, D, S,
                              lv, P, Lq, s);
  return global_path<__nv_bfloat16>(value, v_sd, xs, ys, aw, g, gv, gv_sd, ga, gx, gy, B, M,
                                    D, S, lv, P, Lq, s);
}
