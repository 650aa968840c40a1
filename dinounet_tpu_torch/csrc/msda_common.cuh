// Shared by the MSDA kernels (msda_fwd.cu: #1 and #6; msda_fwd_premapped.cu:
// #5; msda_bwd.cu: #7), for sm_90a: the limits, the level table, the value
// types, the staging of a head's map into 16-byte cells, the bilinear gather
// of one point from those cells, the query ranges of a wave of blocks, and
// the transpose between a head's channel-major (D, S) map and the
// token-major (S, D) copy that the device-memory instances read and write.
//
// A cell is 16 bytes: one position's 8 channels of a bf16 map or 4 of an
// fp32 one. A block stages its slice of a head's map (channels [d0, d0 +
// dc), all L levels along S) once, as [ceil(dc / CC)][Sp] cells (CC channels
// a cell, Sp = S rounded up to 8, zero past dc), so a corner's channels are
// ceil(dc / CC) 16-byte loads from shared memory, and a level is an offset
// (its start along S) into the same cells.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace msda {

constexpr int kMaxLevels = 4;
constexpr int kMaxPoints = 16;     // per level
constexpr int kSlice = 32;         // channels a slice of a wider head, at most
constexpr int kSmemMax = 232448;   // the shared memory a block may have

inline bool bad_sizes(int B, int M, int D, int P, int Lq) {
  return D < 1 || P < 1 || P > kMaxPoints || B < 1 || M < 1 || Lq < 1;
}

// level l is an h[l] x w[l] map at positions [start[l], start[l] + h[l] w[l])
// of the value's S axis
struct Levels {
  int n;
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
};

// the C interface's (H_0, W_0, H_1, W_1, ...) table -> the level table and
// S; false if L or a level is out of range
inline bool make_levels(const int* shapes, int L, Levels* lv, int* S) {
  if (shapes == nullptr || L < 1 || L > kMaxLevels) return false;
  lv->n = L;
  int s = 0;
  for (int l = 0; l < L; ++l) {
    const int h = shapes[2 * l], w = shapes[2 * l + 1];
    if (h < 1 || w < 1) return false;
    lv->h[l] = h;
    lv->w[l] = w;
    lv->start[l] = s;
    s += h * w;
  }
  *S = s;
  return true;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// channels a 16-byte cell holds
template <typename T>
constexpr int kCell = 16 / (int)sizeof(T);

__host__ __device__ inline int round8(int S) { return (S + 7) & ~7; }

// a bf16 slice's channel rows v_g[c * S + s] (c < dc) into shared memory as
// [ng][Sp] cells of 8 channels (zero past dc). A warp takes four 8 x 8 tiles
// (8 channels x 8 positions) at a time: lane l loads the 4-byte pair of
// positions 2 (l % 4) of channel row l / 4 of each (the fragment of an 8 x 8
// matrix, rows = channels; a row's 16 bytes from 4 lanes, coalesced), and one
// stmatrix.trans stores the four tiles transposed: a stored row is one
// position's 8 channels, one cell, and a tile's 8 rows are 8 consecutive
// cells, so the stores meet no bank conflict and the transpose takes no
// registers beyond the fragment. Ends with a barrier.
__device__ __forceinline__ void stage_map(uint4* __restrict__ v_s,
                                          const __nv_bfloat16* __restrict__ v_g, int dc,
                                          int ng, int S, int Sp) {
  int done = 0;  // 8 x 8 tiles staged by stmatrix
  // 4-byte loads: channel rows of a multiple of 8 positions from a 4-byte
  // aligned map (a contiguous view may start at an odd element)
  if ((S & 7) == 0 && (reinterpret_cast<uintptr_t>(v_g) & 3) == 0) {
    const int s8 = S >> 3, tiles = ng * s8;
    const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(v_s));
    done = tiles & ~3;
    for (int t0 = 4 * (threadIdx.x >> 5); t0 < done; t0 += 4 * nwarps) {
      uint32_t r[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int t = t0 + m, g = t / s8, s0 = (t - g * s8) * 8, c = 8 * g + lane / 4;
        r[m] = c < dc ? __ldg(reinterpret_cast<const uint32_t*>(v_g + (size_t)c * S + s0) +
                              lane % 4)
                      : 0u;
      }
      const int t = t0 + lane / 8, g = t / s8, s0 = (t - g * s8) * 8;
      stsm_x4_trans(base + (uint32_t)(((size_t)g * Sp + s0 + lane % 8) * 16), r);
    }
  }
  // the rest (S not a multiple of 8, a map at an odd element, or the last
  // tiles): element by element
  __nv_bfloat16* v_e = reinterpret_cast<__nv_bfloat16*>(v_s);
  for (int i = done * 64 + threadIdx.x; i < ng * S * 8; i += blockDim.x) {
    const int e = i & 7, cell = i >> 3;
    const int g = cell / S, s = cell - g * S;
    const int c = 8 * g + e;
    v_e[((size_t)g * Sp + s) * 8 + e] = c < dc ? v_g[(size_t)c * S + s] : __float2bfloat16(0.f);
  }
  __syncthreads();
}

// an fp32 slice as [ng][Sp] cells of 4 channels: a thread a cell, its four
// channel rows read coalesced across the warp (consecutive positions), one
// 16-byte store (consecutive cells: no bank conflict). stmatrix moves 16-bit
// elements only, and this map comes only from the reference-layout entry.
// Ends with a barrier.
__device__ __forceinline__ void stage_map(uint4* __restrict__ v_s,
                                          const float* __restrict__ v_g, int dc, int ng,
                                          int S, int Sp) {
  for (int i = threadIdx.x; i < ng * S; i += blockDim.x) {
    const int g = i / S, s = i - g * S;
    float f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * g + k;
      f[k] = c < dc ? __ldg(v_g + (size_t)c * S + s) : 0.f;
    }
    v_s[(size_t)g * Sp + s] = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                                         __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __syncthreads();
}

// a cell's channels as fp32
template <typename T>
__device__ __forceinline__ void unpack_cell(float (&v)[kCell<T>], const uint4& u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __uint_as_float(w[k]);
  }
}

// acc[k] += wt * channel k of a cell
template <typename T>
__device__ __forceinline__ void fma_cell(float* acc, const uint4& u, float wt) {
  constexpr int CC = kCell<T>;
  float v[CC];
  unpack_cell<T>(v, u);
#pragma unroll
  for (int k = 0; k < CC; ++k) acc[k] = fmaf(wt, v[k], acc[k]);
}

// acc += w_p * bilinear(map, x, y) over the slice's channels, for one point
// on an H x W level: the staged cells v_s (offset by the level's start), or
// (kGlobal) the token-major copy's rows vt + pos * D (offset likewise; 16-byte
// loads where D and the slice start allow)
template <int NG, bool kGlobal, typename T>
__device__ __forceinline__ void gather_point(float (&acc)[kCell<T> * NG],
                                             const uint4* __restrict__ v_s,
                                             const T* __restrict__ vt, int D, int dc, int ng,
                                             int Sp, int H, int W, float x, float y,
                                             float w_p) {
  constexpr int CC = kCell<T>;
  // clamping to one pixel beyond the map keeps the int conversion in range
  // and leaves every out-of-map corner out of the map
  x = fminf(fmaxf(x, -2.f), (float)W + 1.f);
  y = fminf(fmaxf(y, -2.f), (float)H + 1.f);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float fx = x - x0f;
  const float fy = y - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int dy = c >> 1;
    const int dx = c & 1;
    const int yy = y0 + dy;
    const int xx = x0 + dx;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
    const float wy = dy ? fy : 1.f - fy;
    const float wx = dx ? fx : 1.f - fx;
    const float wt = w_p * (wy * wx);
    const int pos = yy * W + xx;
    if (kGlobal) {
      const T* vp = vt + (size_t)pos * D;
      if (D % CC == 0) {
#pragma unroll
        for (int g = 0; g < NG; ++g)
          if (g < ng) fma_cell<T>(acc + CC * g, __ldg(reinterpret_cast<const uint4*>(vp) + g), wt);
      } else {
#pragma unroll
        for (int d = 0; d < CC * NG; ++d)
          if (d < dc) acc[d] = fmaf(wt, to_float(__ldg(vp + d)), acc[d]);
      }
    } else {
      const uint4* cell = v_s + pos;
#pragma unroll
      for (int g = 0; g < NG; ++g)
        if (g < ng) fma_cell<T>(acc + CC * g, cell[(size_t)g * Sp], wt);
    }
  }
}

// the queries a block walks: each of `groups` (b, head, slice) groups' Lq
// queries cut into as many ranges as one wave of blocks holds (per_sm blocks
// an SM), each at least `threads` queries
inline int query_chunk(int per_sm, long long groups, int Lq, int threads) {
  const int sms = sm_count();
  const long long room = (long long)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  long long ranges = room / groups;
  const long long most = (Lq + threads - 1) / threads;
  if (ranges > most) ranges = most;
  if (ranges < 1) ranges = 1;
  return (int)((Lq + ranges - 1) / ranges);
}

// (R, rows, cols) -> (R, cols, rows), through a 32 x 33 fp32 tile in shared
// memory (exact for bf16 and fp32): reads and writes are coalesced
template <typename T>
__global__ void transpose_kernel(const T* __restrict__ in, T* __restrict__ out,
                                 int rows, int cols) {
  __shared__ float tile[32][33];
  const size_t plane = (size_t)rows * cols;
  in += blockIdx.z * plane;
  out += blockIdx.z * plane;
  const int r0 = blockIdx.y * 32;
  const int c0 = blockIdx.x * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int r = r0 + i;
    const int c = c0 + threadIdx.x;
    if (r < rows && c < cols) tile[i][threadIdx.x] = to_float(in[(size_t)r * cols + c]);
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int c = c0 + i;
    const int r = r0 + threadIdx.x;
    if (r < rows && c < cols) out[(size_t)c * rows + r] = from_float<T>(tile[threadIdx.x][i]);
  }
}

template <typename T>
inline cudaError_t transpose(const void* in, void* out, int R, int rows, int cols,
                             cudaStream_t stream) {
  const dim3 grid((cols + 31) / 32, (rows + 31) / 32, R);
  transpose_kernel<T><<<grid, dim3(32, 8), 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), rows, cols);
  return cudaGetLastError();
}

}  // namespace msda
