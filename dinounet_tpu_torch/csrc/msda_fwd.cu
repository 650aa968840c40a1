// Multi-scale deformable attention forward with fused prep, for sm_90a: two
// TPU kernels of dinounet_tpu/ops/msda_pallas.py, over the same layouts.
//
//   #1 _fwd_kernel_fused (body _fused_core), ms_deform_attn_pallas_premapped_fused:
//     value  (B, M, D, S) bf16      one head's D x S value map per (b, m)
//     off    (B, M, 2P, Lq) bf16    raw offsets, rows 2p / 2p+1 = x / y
//     logits (B, M, P, Lq) bf16     pre-softmax point logits
//     base   (2P, Lq) fp32          reference point * map size - 0.5
//     out    (B, M, D, Lq) bf16     out[:, q] = sum_p softmax_p * bilinear(v, x_p, y_p)
//   #6 _fwd_kernel_fused_merged, ms_deform_attn_pallas_premapped_fused_merged:
//     #1 with off and logits read from one packed (B, M, 3P, Lq) bf16 buffer,
//     rows [0, 2P) the offsets and [2P, 3P) the logits of each head (a row
//     stride and a base pointer: the template flag kMerged)
// with zero padding outside the H x W map (grid_sample, align_corners=False).
// One level (the adapter samples the one ViT patch grid), P <= 16, any D and
// S. The third forward, #5 (the prep done outside, several levels), is
// msda_fwd_premapped.cu; the pieces all three share are msda_fwd.cuh.
//
// What bounds it on an H100: gathers. Each query reads 4 corners x P points x D
// channels at data-dependent positions -- 4 * 4 * 24 values per query per head
// at dinounet_b shapes -- and does one FMA per value read, far below the
// tensor-core roofline and, from device memory, scattered 2-byte reads. The
// TPU kernels turned the gather into a dense one-hot matrix on the MXU because
// a TPU has no fast gather; that multiplies the work by S and is not carried
// over. Here one block takes one (b, head, channel slice, 256-query tile);
// each thread owns one query, keeps the slice's fp32 accumulators in
// registers, takes the P-way softmax in fp32 and writes its output column
// with stores that are coalesced across the warp. The value map is read one
// of two ways, each its own template instance (kGlobal), so the common one
// keeps its registers:
// - staged: the block copies its slice of the head's map into shared memory
//   as [S][dc] and every gather hits shared memory. A head of D <= 64
//   channels is one slice (24 x 1024 bf16 = 48 KB for dinounet_b). A wider
//   head -- dinounet_7b's adapter has D = 2048 / 16 = 128 -- would need 256
//   KB (over the 227 KB a block may have) and D registers of accumulators a
//   thread, so it is cut into 32-channel slices across blocks: 64 KB of map
//   a block at S = 1024 (three blocks an SM), 32 accumulators a thread, and
//   each slice's block recomputes its queries' coordinates and softmax (a few
//   dozen FLOPs against the 4 * P * 32 FMAs it gathers). The map is re-read
//   from L2 by each of the ceil(Lq / 256) query tiles of a head.
// - global: where the slice does not fit (S above 232448 / (2 * dc): a patch
//   over 960^2 at D = 32 or 128, over 1104^2 at D = 24), a pre-pass writes a
//   token-major copy (B, M, S, D) of the map (the caller's scratch) and the
//   gathers read a corner's dc channels as one contiguous run from it,
//   through L2 (a head's map is at most 2 MB bf16 at a 1024^2 patch and D =
//   128; a tile batch's whole value tensor fits the 50 MB L2 up to there).
// The slice arithmetic costs registers (one block less an SM at D = 24, 29 %
// slower), so whole heads and sliced heads are separate instances too. #1
// staged keeps whole heads of up to 16, 32 and 64 channels and unrolls its
// loop over the points; the other instances (#1 global, #6) take whole heads
// up to 32 channels and slices above, and keep the point loop rolled, which
// keeps the build short.

#include "msda_fwd.cuh"

namespace {

using namespace msda;

template <int DMAX, bool kSliced, bool kGlobal, bool kMerged>
__global__ void __launch_bounds__(kQueries)
msda_fwd_fused_kernel(const __nv_bfloat16* __restrict__ value,
                      const __nv_bfloat16* __restrict__ off,
                      const __nv_bfloat16* __restrict__ logits,
                      const float* __restrict__ base,
                      __nv_bfloat16* __restrict__ out,
                      int M, int D, int n_slices, int H, int W, int P, int Lq) {
  // #1 staged unrolls its point loops; the other instances keep them
  // rolled, which keeps the build short (the softmax weights then live in
  // local memory)
  constexpr int kUnroll = kGlobal || kMerged ? 1 : kMaxPoints;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = H * W;
  const Slice<DMAX, kSliced> sl(D, n_slices);
  const size_t bm = (size_t)blockIdx.z * M + sl.m;
  int ld;
  const __nv_bfloat16* v = slice_map<kGlobal>(
      value, reinterpret_cast<__nv_bfloat16*>(smem), bm, D, S, sl.d0, sl.dc, &ld);

  const int q = blockIdx.x * kQueries + threadIdx.x;
  if (q >= Lq) return;  // ragged tail of the query axis
  // #6: off is the packed buffer, each head's logits 2P rows after its offsets
  const __nv_bfloat16* off_q = off + bm * (kMerged ? 3 : 2) * P * Lq + q;
  const __nv_bfloat16* lg_q = kMerged ? off_q + (size_t)2 * P * Lq : logits + bm * P * Lq + q;

  float a[kMaxPoints];
  float mx = -INFINITY;
#pragma unroll kUnroll
  for (int p = 0; p < kMaxPoints; ++p) {
    if (p < P) {
      a[p] = __bfloat162float(lg_q[(size_t)p * Lq]);
      mx = fmaxf(mx, a[p]);
    }
  }
  float sum = 0.f;
#pragma unroll kUnroll
  for (int p = 0; p < kMaxPoints; ++p) {
    if (p < P) {
      a[p] = expf(a[p] - mx);
      sum += a[p];
    }
  }

  float acc[DMAX];
#pragma unroll
  for (int d = 0; d < DMAX; ++d) acc[d] = 0.f;
#pragma unroll kUnroll
  for (int p = 0; p < kMaxPoints; ++p) {
    if (p < P) {
      const float x = __bfloat162float(off_q[(size_t)(2 * p) * Lq]) + base[(size_t)(2 * p) * Lq + q];
      const float y = __bfloat162float(off_q[(size_t)(2 * p + 1) * Lq]) + base[(size_t)(2 * p + 1) * Lq + q];
      sample<DMAX, kGlobal>(acc, v, ld, sl.dc, H, W, x, y, a[p] / sum);
    }
  }
  store(acc, out + (bm * D + sl.d0) * Lq + q, sl.dc, Lq);
}

template <int DMAX, bool kSliced, bool kGlobal, bool kMerged>
int launch(const void* value, const void* off, const void* logits, const void* base,
           void* out, int B, int M, int D, int H, int W, int P, int Lq,
           cudaStream_t stream) {
  const Plan<DMAX, kSliced, kGlobal> pl(B, M, D, H * W, Lq, sizeof(__nv_bfloat16));
  auto kernel = msda_fwd_fused_kernel<DMAX, kSliced, kGlobal, kMerged>;
  cudaError_t err = allow_smem(kernel, pl.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<pl.grid, kQueries, pl.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(value),
      static_cast<const __nv_bfloat16*>(off),
      static_cast<const __nv_bfloat16*>(logits),
      static_cast<const float*>(base), static_cast<__nv_bfloat16*>(out),
      M, D, pl.n_slices, H, W, P, Lq);
  return (int)cudaGetLastError();
}

// the instance for D (see the header)
template <bool kGlobal, bool kMerged>
int dispatch(const void* value, const void* off, const void* logits, const void* base,
             void* out, int B, int M, int D, int H, int W, int P, int Lq,
             cudaStream_t s) {
  if constexpr (!kGlobal && !kMerged) {
    if (D <= 16)
      return launch<16, false, false, false>(value, off, logits, base, out, B, M, D, H, W, P, Lq, s);
    if (D > 32 && D <= kMaxWhole)
      return launch<kMaxWhole, false, false, false>(value, off, logits, base, out, B, M, D, H, W, P, Lq, s);
  }
  if (D <= 32)
    return launch<32, false, kGlobal, kMerged>(value, off, logits, base, out, B, M, D, H, W, P, Lq, s);
  return launch<kSlice, true, kGlobal, kMerged>(value, off, logits, base, out, B, M, D, H, W, P, Lq, s);
}

// scratch null: the staged instance, else the global one over the
// token-major copy that scratch (B, M, S, D) bf16 receives
template <bool kMerged>
int entry(const void* value, void* scratch, const void* off, const void* logits,
          const void* base, void* out, int B, int M, int D, int H, int W, int P, int Lq,
          void* stream) {
  if (bad_sizes(B, M, D, P, Lq) || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch == nullptr)
    return dispatch<false, kMerged>(value, off, logits, base, out, B, M, D, H, W, P, Lq, s);
  cudaError_t err = transpose<__nv_bfloat16>(value, scratch, B * M, D, H * W, s);
  if (err != cudaSuccess) return (int)err;
  return dispatch<true, kMerged>(scratch, off, logits, base, out, B, M, D, H, W, P, Lq, s);
}

}  // namespace

// #1: value, off, logits bf16, base fp32 -> out bf16
extern "C" int msda_fwd_fused(const void* value, void* scratch, const void* off,
                              const void* logits, const void* base, void* out,
                              int B, int M, int D, int H, int W, int P, int Lq,
                              void* stream) {
  return entry<false>(value, scratch, off, logits, base, out, B, M, D, H, W, P, Lq, stream);
}

// #6: value, packed bf16, base fp32 -> out bf16
extern "C" int msda_fwd_merged(const void* value, void* scratch, const void* packed,
                               const void* base, void* out, int B, int M, int D, int H,
                               int W, int P, int Lq, void* stream) {
  return entry<true>(value, scratch, packed, nullptr, base, out, B, M, D, H, W, P, Lq,
                     stream);
}
