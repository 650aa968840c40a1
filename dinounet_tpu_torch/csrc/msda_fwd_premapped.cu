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
// What bounds it on an H100: gathers, as for the fused-prep forward
// (msda_fwd.cu, #1), whose loop this is with the prep taken out: a block
// stages its (b, head, channel slice)'s map once, all levels, as 16-byte
// cells (8 bf16 or 4 fp32 channels at one position; msda_common.cuh) and
// walks a contiguous range of the head's queries, one thread a query at a
// time, a head's queries cut into as many ranges as one wave of blocks
// holds. A thread reads its point's fp32 coordinates and weight (coalesced
// across the warp: consecutive queries), takes a level as an offset into the
// staged cells, reads a corner's channels as 16-byte loads into fp32
// accumulators in registers, and stores its query's channels (coalesced).
// Whole heads of up to 64 bf16 or 32 fp32 channels are one slice; wider
// heads, and maps whose whole head would not fit, are cut into slices of up
// to 32 channels across blocks, as wide as fit (16 at a 1024^2 patch's S =
// 4096). Only a map of which not even one cell's channels fit (bf16 S above
// 14528, fp32 likewise) takes the global instance: a pre-pass writes a
// token-major copy (B, M, S, D) of the map (the caller's scratch) and the
// gathers read it through L2. Coordinates far off the map are clamped to one
// pixel beyond it before the int conversion, and queries past Lq are
// masked, so the caller pads nothing.

#include "msda_common.cuh"

namespace {

using namespace msda;

constexpr int kThreads = 512;  // one query a thread at a time

// NG cells a thread at most; kSliced: blockIdx.y = head * n_slices + slice,
// channels [slice * sw, slice * sw + sw); kGlobal: value is the token-major
// copy (B, M, S, D). Up to 32 accumulators: two blocks an SM
template <int NG, bool kSliced, bool kGlobal, typename T>
__global__ void __launch_bounds__(kThreads, kCell<T> * NG <= 32 ? 2 : 1)
msda_fwd_premapped_kernel(const T* __restrict__ value, const float* __restrict__ xs,
                          const float* __restrict__ ys, const float* __restrict__ aw,
                          T* __restrict__ out, int M, int D, int sw, int n_slices, int S,
                          Levels lv, int P, int Lq, int q_chunk) {
  constexpr int CC = kCell<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* v_s = reinterpret_cast<uint4*>(smem);
  const int Sp = round8(S);
  const int m = kSliced ? blockIdx.y / n_slices : blockIdx.y;
  const int d0 = kSliced ? (blockIdx.y - m * n_slices) * sw : 0;
  const int dc = kSliced ? min(sw, D - d0) : D;
  const int ng = (dc + CC - 1) / CC;
  const size_t bm = (size_t)blockIdx.z * M + m;
  const T* vt = value + bm * S * D + d0;  // kGlobal: the token-major rows
  if (!kGlobal) stage_map(v_s, value + (bm * D + d0) * S, dc, ng, S, Sp);

  const int LP = lv.n * P;
  const int q1 = min(Lq, (int)(blockIdx.x + 1) * q_chunk);
  for (int q = blockIdx.x * q_chunk + threadIdx.x; q < q1; q += blockDim.x) {
    const size_t at = bm * LP * Lq + q;
    float acc[CC * NG];
#pragma unroll
    for (int d = 0; d < CC * NG; ++d) acc[d] = 0.f;
    for (int l = 0; l < lv.n; ++l) {
      const int st = lv.start[l], H = lv.h[l], W = lv.w[l];
      for (int p = 0; p < P; ++p) {
        const size_t r = at + (size_t)(l * P + p) * Lq;
        gather_point<NG, kGlobal, T>(acc, v_s + st, vt + (size_t)st * D, D, dc, ng, Sp, H,
                                     W, xs[r], ys[r], aw[r]);
      }
    }
    T* o = out + (bm * D + d0) * Lq + q;
#pragma unroll
    for (int d = 0; d < CC * NG; ++d)
      if (d < dc) o[(size_t)d * Lq] = from_float<T>(acc[d]);
  }
}

// sw: the channels a block (the whole head where not kSliced)
template <int NG, bool kSliced, bool kGlobal, typename T>
int launch(const void* value, const void* xs, const void* ys, const void* aw, void* out,
           int B, int M, int D, int S, const Levels& lv, int P, int Lq, int sw,
           cudaStream_t stream) {
  constexpr int CC = kCell<T>;
  auto kernel = msda_fwd_premapped_kernel<NG, kSliced, kGlobal, T>;
  const int n_slices = kSliced ? (D + sw - 1) / sw : 1;
  const size_t smem = kGlobal ? 0 : (size_t)((sw + CC - 1) / CC) * round8(S) * 16;
  // the attribute once a device; the blocks an SM holds once an instance and
  // map size
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
  const int q_chunk = query_chunk(per_sm, (long long)B * M * n_slices, Lq, kThreads);
  const dim3 grid((Lq + q_chunk - 1) / q_chunk, M * n_slices, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(xs),
      static_cast<const float*>(ys), static_cast<const float*>(aw), static_cast<T*>(out), M,
      D, sw, n_slices, S, lv, P, Lq, q_chunk);
  return (int)cudaGetLastError();
}

// the whole head, by width: bf16 up to 64 channels (NG 2, 3, 4, 8 cells of
// 8), fp32 up to 32 (NG 4, 6, 8 cells of 4)
template <typename T>
int launch_whole(const void* value, const void* xs, const void* ys, const void* aw,
                 void* out, int B, int M, int D, int S, const Levels& lv, int P, int Lq,
                 cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    if (D <= 16)
      return launch<2, false, false, T>(value, xs, ys, aw, out, B, M, D, S, lv, P, Lq, D, s);
    if (D <= 24)
      return launch<3, false, false, T>(value, xs, ys, aw, out, B, M, D, S, lv, P, Lq, D, s);
    if (D <= 32)
      return launch<4, false, false, T>(value, xs, ys, aw, out, B, M, D, S, lv, P, Lq, D, s);
    return launch<8, false, false, T>(value, xs, ys, aw, out, B, M, D, S, lv, P, Lq, D, s);
  } else {
    if (D <= 16)
      return launch<4, false, false, T>(value, xs, ys, aw, out, B, M, D, S, lv, P, Lq, D, s);
    if (D <= 24)
      return launch<6, false, false, T>(value, xs, ys, aw, out, B, M, D, S, lv, P, Lq, D, s);
    return launch<8, false, false, T>(value, xs, ys, aw, out, B, M, D, S, lv, P, Lq, D, s);
  }
}

// scratch null: a staged instance (the whole head where it fits in shared
// memory, else slices of up to 32 channels as wide as fit), else the global
// one over the token-major copy that scratch (B, M, S, D) of T receives
template <typename T>
int entry(const void* value, void* scratch, const void* xs, const void* ys,
          const void* aw, void* out, int B, int M, int D, const int* shapes, int L,
          int P, int Lq, cudaStream_t s) {
  constexpr int CC = kCell<T>;
  constexpr int NS = kSlice / CC;  // cells of a full slice
  Levels lv;
  int S = 0;
  if (!make_levels(shapes, L, &lv, &S) || M > 65535 / ((D + CC - 1) / CC) || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (scratch != nullptr) {
    cudaError_t err = transpose<T>(value, scratch, B * M, D, S, s);
    if (err != cudaSuccess) return (int)err;
    return launch<NS, true, true, T>(scratch, xs, ys, aw, out, B, M, D, S, lv, P, Lq, kSlice,
                                     s);
  }
  const long long fit = kSmemMax / (16LL * round8(S)) * CC;  // channels whose cells fit
  if (fit < CC) return (int)cudaErrorInvalidValue;           // the caller owes a scratch
  const int dcc = (D + CC - 1) / CC * CC;
  if (dcc <= fit && D <= (sizeof(T) == 2 ? 64 : 32))
    return launch_whole<T>(value, xs, ys, aw, out, B, M, D, S, lv, P, Lq, s);
  // slices as even as the widest that fits allows, each a multiple of CC
  const int widest = (int)(fit < kSlice ? fit : kSlice);
  const int n_slices = (D + widest - 1) / widest;
  const int sw = ((D + n_slices - 1) / n_slices + CC - 1) / CC * CC;
  return launch<NS, true, false, T>(value, xs, ys, aw, out, B, M, D, S, lv, P, Lq, sw, s);
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
