// Multi-scale deformable attention forward with the prep done outside, for
// sm_90a.
//
// Replaces the TPU kernel dinounet_tpu/ops/msda_pallas.py::_fwd_kernel,
// called by ms_deform_attn_pallas_premapped (the adapter's path under
// DINOUNET_TPU_MSDA_PREP=xla, and the forward of the reference-layout
// ms_deform_attn_pallas). Same function, in the same layouts:
//   value  (B, M, D, S) bf16 or fp32   L levels concatenated along S
//   xs, ys (B, M, L*P, Lq) fp32        pixel coordinates (align_corners=False)
//                                      of point p of level l in row l*P + p
//   aw     (B, M, L*P, Lq) fp32        point weights
//   out    (B, M, D, Lq)               sum over levels and points of
//                                      aw * bilinear(level map, x, y), in the
//                                      value's type, accumulated in fp32
// with zero padding outside each H_l x W_l map. Up to 4 levels, P <= 16
// points a level, any D and S.
//
// What bounds it and how it is laid out: as the fused-prep kernels
// (msda_fwd.cu, #1), whose gather loop it is with the prep taken out. One
// block per (b, head, channel slice, 256-query tile), a thread per query
// with the slice's fp32 accumulators in registers; the thread reads its
// point's fp32 coordinates and weight (coalesced across the warp) and
// samples it from its level of the map. The map (all levels) is staged in
// shared memory where the slice fits, else gathered from a token-major copy
// in device memory through L2 (msda_fwd.cuh). Coordinates far off the map
// are clamped to one pixel beyond it before the int conversion, and queries
// past Lq are masked, so the caller pads nothing. Whole heads up to 32
// channels and 32-channel slices above, per value type and read path.

#include "msda_fwd.cuh"

namespace {

using namespace msda;

template <int DMAX, bool kSliced, bool kGlobal, typename T>
__global__ void __launch_bounds__(kQueries)
msda_fwd_premapped_kernel(const T* __restrict__ value, const float* __restrict__ xs,
                          const float* __restrict__ ys, const float* __restrict__ aw,
                          T* __restrict__ out, int M, int D, int n_slices, int S,
                          Levels lv, int P, int Lq) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Slice<DMAX, kSliced> sl(D, n_slices);
  const size_t bm = (size_t)blockIdx.z * M + sl.m;
  int ld;
  const T* v = slice_map<kGlobal>(value, reinterpret_cast<T*>(smem), bm, D, S, sl.d0,
                                  sl.dc, &ld);

  const int q = blockIdx.x * kQueries + threadIdx.x;
  if (q >= Lq) return;
  const size_t at = bm * lv.n * P * Lq + q;
  float acc[DMAX];
#pragma unroll
  for (int d = 0; d < DMAX; ++d) acc[d] = 0.f;
  for (int l = 0; l < lv.n; ++l) {
    const T* v_l = v + lv.start[l] * ld;
    for (int p = 0; p < P; ++p) {
      const size_t r = at + (size_t)(l * P + p) * Lq;
      sample<DMAX, kGlobal>(acc, v_l, ld, sl.dc, lv.h[l], lv.w[l], xs[r], ys[r], aw[r]);
    }
  }
  store(acc, out + (bm * D + sl.d0) * Lq + q, sl.dc, Lq);
}

template <int DMAX, bool kSliced, bool kGlobal, typename T>
int launch(const void* value, const void* xs, const void* ys, const void* aw, void* out,
           int B, int M, int D, int S, const Levels& lv, int P, int Lq,
           cudaStream_t stream) {
  const Plan<DMAX, kSliced, kGlobal> pl(B, M, D, S, Lq, sizeof(T));
  auto kernel = msda_fwd_premapped_kernel<DMAX, kSliced, kGlobal, T>;
  cudaError_t err = allow_smem(kernel, pl.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<pl.grid, kQueries, pl.smem, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(xs),
      static_cast<const float*>(ys), static_cast<const float*>(aw),
      static_cast<T*>(out), M, D, pl.n_slices, S, lv, P, Lq);
  return (int)cudaGetLastError();
}

// scratch null: the staged instance, else the global one over the
// token-major copy that scratch (B, M, S, D) of T receives
template <typename T>
int entry(const void* value, void* scratch, const void* xs, const void* ys,
          const void* aw, void* out, int B, int M, int D, const int* shapes, int L,
          int P, int Lq, cudaStream_t s) {
  Levels lv;
  int S = 0;
  if (!make_levels(shapes, L, &lv, &S)) return (int)cudaErrorInvalidValue;
  if (scratch == nullptr) {
    if (D <= 32)
      return launch<32, false, false, T>(value, xs, ys, aw, out, B, M, D, S, lv, P, Lq, s);
    return launch<kSlice, true, false, T>(value, xs, ys, aw, out, B, M, D, S, lv, P, Lq, s);
  }
  cudaError_t err = transpose<T>(value, scratch, B * M, D, S, s);
  if (err != cudaSuccess) return (int)err;
  if (D <= 32)
    return launch<32, false, true, T>(scratch, xs, ys, aw, out, B, M, D, S, lv, P, Lq, s);
  return launch<kSlice, true, true, T>(scratch, xs, ys, aw, out, B, M, D, S, lv, P, Lq, s);
}

}  // namespace

// shapes (H_0, W_0, ..., H_{L-1}, W_{L-1}) on the host; value and out fp32
// if value_fp32, else bf16; scratch (B, M, S, D) of value's type or null
extern "C" int msda_fwd_premapped(const void* value, void* scratch, const void* xs,
                                  const void* ys, const void* aw, void* out, int B,
                                  int M, int D, const int* shapes, int L, int P, int Lq,
                                  int value_fp32, void* stream) {
  if (bad_sizes(B, M, D, P, Lq)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_fp32)
    return entry<float>(value, scratch, xs, ys, aw, out, B, M, D, shapes, L, P, Lq, s);
  return entry<__nv_bfloat16>(value, scratch, xs, ys, aw, out, B, M, D, shapes, L, P, Lq, s);
}
