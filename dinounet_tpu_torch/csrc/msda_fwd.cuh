// The MSDA forward's first design, for sm_90a, which msda_fwd_premapped.cu
// (#5, the prep done outside) runs: the block's channel slice, where it reads
// the value map (staged in shared memory or gathered from a token-major copy
// in device memory, the template flag kGlobal), the bilinear sample of one
// point into the slice's fp32 accumulators, and the store. msda_fwd.cu (#1
// and #6, the fused prep) takes only kMaxPoints, kSlice and bad_sizes; its
// header says how its redesign stages and gathers.

#pragma once

#include "msda_common.cuh"

#include <math.h>

namespace msda {

constexpr int kQueries = 256;   // threads per block, one query each
constexpr int kMaxPoints = 16;  // per level
constexpr int kSlice = 32;      // channels a block of a wider head

// the block's channel slice: blockIdx.y = head * n_slices + slice when
// kSliced (channels [d0, d0 + dc), dc <= DMAX), else the head (all D)
template <int DMAX, bool kSliced>
struct Slice {
  int m, d0, dc;
  __device__ Slice(int D, int n_slices) {
    m = kSliced ? blockIdx.y / n_slices : blockIdx.y;
    d0 = kSliced ? (blockIdx.y - m * n_slices) * DMAX : 0;
    dc = kSliced ? (D - d0 < DMAX ? D - d0 : DMAX) : D;
  }
};

// where the block reads its slice of head bm's map: position s's channels
// at the result + s * ld. Staged: copied from value (B, M, D, S) into
// shared memory v_s as [S][dc]; global: value is the token-major copy
// (B, M, S, D)
template <bool kGlobal, typename T>
__device__ __forceinline__ const T* slice_map(const T* value, T* v_s, size_t bm,
                                              int D, int S, int d0, int dc, int* ld) {
  if (kGlobal) {
    *ld = D;
    return value + bm * S * D + d0;
  }
  const T* v_g = value + (bm * D + d0) * S;
  for (int i = threadIdx.x; i < dc * S; i += blockDim.x) {
    const int d = i / S;
    const int s = i - d * S;
    v_s[s * dc + d] = v_g[i];
  }
  __syncthreads();
  *ld = dc;
  return v_s;
}

// acc[d] += w_p * bilinear(map, x, y)[d] over the slice's dc channels, for
// one point on an H x W map
template <int DMAX, bool kGlobal, typename T>
__device__ __forceinline__ void sample(float (&acc)[DMAX], const T* v, int ld, int dc,
                                       int H, int W, float x, float y, float w_p) {
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
    const T* vp = v + (yy * W + xx) * ld;
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
      if (d < dc) acc[d] = fmaf(wt, to_float(kGlobal ? __ldg(vp + d) : vp[d]), acc[d]);
    }
  }
}

template <int DMAX, typename T>
__device__ __forceinline__ void store(const float (&acc)[DMAX], T* o, int dc, int Lq) {
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    if (d < dc) o[(size_t)d * Lq] = from_float<T>(acc[d]);
  }
}

// grid and shared memory of one instance: blocks of kQueries queries x
// (head, channel slice) x batch
template <int DMAX, bool kSliced, bool kGlobal>
struct Plan {
  int n_slices;
  size_t smem;
  dim3 grid;
  Plan(int B, int M, int D, int S, int Lq, size_t elem) {
    n_slices = kSliced ? (D + DMAX - 1) / DMAX : 1;
    smem = kGlobal ? 0 : (size_t)(kSliced ? DMAX : D) * S * elem;
    grid = dim3((Lq + kQueries - 1) / kQueries, M * n_slices, B);
  }
};

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

inline bool bad_sizes(int B, int M, int D, int P, int Lq) {
  return D < 1 || P < 1 || P > kMaxPoints || B < 1 || M < 1 || Lq < 1;
}

}  // namespace msda
