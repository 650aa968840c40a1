// Shared by the MSDA kernels (msda_fwd.cu, msda_bwd.cu), for sm_90a: the
// level table, the value types, and the transpose between a head's
// channel-major (D, S) map and the token-major (S, D) copy that the
// global-gather instances read and write.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace msda {

constexpr int kMaxLevels = 4;

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
