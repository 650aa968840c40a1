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
// msda_fwd_premapped.cu, on the same staging and gather loop
// (msda_common.cuh).
//
// What bounds it on an H100: gathers. Each query reads 4 corners x P points x D
// channels at data-dependent positions -- 4 * 4 * 24 values per query per head
// at dinounet_b shapes, 528 MB of corner reads a tile batch -- and does one
// FMA per value read, far below the tensor-core roofline. The TPU kernels
// turned the gather into a dense one-hot matrix on the MXU because a TPU has
// no fast gather; that multiplies the work by S and is not carried over. The
// corners come from shared memory (128 bytes a clock an SM: ~18 us for the
// 528 MB on 132 SMs), the map staged there once per block; HBM moves the
// offsets, logits and output, ~50 MB (~15 us).
//
// Design:
// 1. A block takes one (b, head, channel slice) and a contiguous range of its
//    queries, one thread a query at a time, and walks the range; the host
//    splits a head's queries into as many ranges as one wave of blocks
//    holds (the occupancy calculator's blocks an SM times the SMs, over the
//    heads), so a head's map is staged a few times in all (twice at
//    dinounet_b's D = 24, tile batch 8), not once per 256 queries. 512
//    threads a block, at most 64 registers a thread where a thread keeps up
//    to 32 accumulators (two blocks an SM): the gathers are latency-bound,
//    and more resident warps hide more of it (kernel_variants.py).
// 2. Staging: the slice's map is copied into shared memory once, as 16-byte
//    cells of 8 channels at one position ([channel group][S rounded up to 8]
//    cells), by stmatrix.trans (msda_common.cuh::stage_map).
// 3. Gathers: a corner's channels are ceil(dc / 8) 16-byte loads, each
//    unpacked to 8 fp32 and accumulated by FMA into the thread's fp32
//    accumulators, after the query's coordinate prep and fp32 P-way softmax
//    (msda_common.cuh::gather_point).
// 4. Stores: a thread writes its query's dc channels, 2 bytes each, coalesced
//    across the warp (consecutive queries).
// Heads of up to 64 channels are one slice (64 channels x S = 1024: 128 KB).
// Wider heads -- dinounet_7b's adapter has D = 2048 / 16 = 128 -- and maps
// whose whole head would not fit (a 1024^2 patch: S = 4096) are cut into
// slices of up to 32 channels across blocks, as wide as fit (16 channels at
// S = 4096), each slice recomputing its queries' coordinates and softmax (a
// few dozen FLOPs against the 4 P dc FMAs it gathers). Only a map of which
// not even 8 channels fit (S above 14528: a patch over 1920^2) takes the
// global instance: a pre-pass writes a token-major copy (B, M, S, D) of the
// map (the caller's scratch) and the gathers read a corner's channels from
// it through L2, 16 bytes at a time where D allows. #1's whole-head
// instances unroll the point loop; the others (the slices, the global
// instance, #6) keep it rolled, which keeps the build short.

#include <stdint.h>

#include "msda_common.cuh"

namespace {

using namespace msda;

constexpr int kThreads = 512;       // the most threads a block: one query a thread at a time

// one instance: NG 8-channel groups a thread at most; kSliced: blockIdx.y =
// head * n_slices + slice, channels [slice * sw, slice * sw + sw); kGlobal:
// value is the token-major copy (B, M, S, D)
template <int NG, bool kSliced, bool kGlobal, bool kMerged>
__global__ void __launch_bounds__(kThreads, NG <= 4 ? 2 : 1)
msda_fwd_fused_kernel(const __nv_bfloat16* __restrict__ value,
                      const __nv_bfloat16* __restrict__ off,
                      const __nv_bfloat16* __restrict__ logits,
                      const float* __restrict__ base,
                      __nv_bfloat16* __restrict__ out,
                      int M, int D, int sw, int n_slices, int H, int W, int P, int Lq,
                      int q_chunk) {
  // #1's whole heads unroll their point loops; the other instances keep them
  // rolled, which keeps the build short (the softmax weights then live in
  // local memory)
  constexpr int kUnroll = kGlobal || kMerged || kSliced ? 1 : kMaxPoints;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* v_s = reinterpret_cast<uint4*>(smem);
  const int S = H * W, Sp = (S + 7) & ~7;
  const int m = kSliced ? blockIdx.y / n_slices : blockIdx.y;
  const int d0 = kSliced ? (blockIdx.y - m * n_slices) * sw : 0;
  const int dc = kSliced ? min(sw, D - d0) : D;
  const int ng = (dc + 7) >> 3;
  const size_t bm = (size_t)blockIdx.z * M + m;
  const __nv_bfloat16* vt = value + bm * S * D + d0;  // kGlobal: the token-major rows
  if (!kGlobal) stage_map(v_s, value + (bm * D + d0) * S, dc, ng, S, Sp);

  const int q1 = min(Lq, (int)(blockIdx.x + 1) * q_chunk);
  for (int q = blockIdx.x * q_chunk + threadIdx.x; q < q1; q += blockDim.x) {
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

    float acc[8 * NG];
#pragma unroll
    for (int d = 0; d < 8 * NG; ++d) acc[d] = 0.f;
#pragma unroll kUnroll
    for (int p = 0; p < kMaxPoints; ++p) {
      if (p < P) {
        const float x =
            __bfloat162float(off_q[(size_t)(2 * p) * Lq]) + base[(size_t)(2 * p) * Lq + q];
        const float y = __bfloat162float(off_q[(size_t)(2 * p + 1) * Lq]) +
                        base[(size_t)(2 * p + 1) * Lq + q];
        gather_point<NG, kGlobal, __nv_bfloat16>(acc, v_s, vt, D, dc, ng, Sp, H, W, x, y,
                                                 a[p] / sum);
      }
    }
    __nv_bfloat16* o = out + (bm * D + d0) * Lq + q;
#pragma unroll
    for (int d = 0; d < 8 * NG; ++d)
      if (d < dc) o[(size_t)d * Lq] = __float2bfloat16(acc[d]);
  }
}

// sw: the channels a block (the whole head where not kSliced)
template <int NG, bool kSliced, bool kGlobal, bool kMerged>
int launch(const void* value, const void* off, const void* logits, const void* base,
           void* out, int B, int M, int D, int H, int W, int P, int Lq, int sw,
           cudaStream_t stream) {
  auto kernel = msda_fwd_fused_kernel<NG, kSliced, kGlobal, kMerged>;
  const int S = H * W;
  const int n_slices = kSliced ? (D + sw - 1) / sw : 1;
  const size_t smem = kGlobal ? 0 : (size_t)((sw + 7) / 8) * ((S + 7) & ~7) * 16;
  const int threads = kThreads;
  // the attribute once a device; the blocks an SM holds once an instance and
  // map size
  static unsigned long long ready = 0;  // one bit a device
  cudaError_t err = set_smem_once(kernel, kSmemMax, &ready);
  if (err != cudaSuccess) return (int)err;
  static int last_smem = -1, per_sm = 0;  // per_sm of `threads`
  if (last_smem != (int)smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return (int)err;
    last_smem = (int)smem;
  }
  if (sm_count() < 1) return (int)cudaErrorInvalidDevice;
  const int q_chunk = query_chunk(per_sm, (long long)B * M * n_slices, Lq, threads);
  const dim3 grid((Lq + q_chunk - 1) / q_chunk, M * n_slices, B);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(value), static_cast<const __nv_bfloat16*>(off),
      static_cast<const __nv_bfloat16*>(logits), static_cast<const float*>(base),
      static_cast<__nv_bfloat16*>(out), M, D, sw, n_slices, H, W, P, Lq, q_chunk);
  return (int)cudaGetLastError();
}

// scratch null: a staged instance (the whole head where it fits in shared
// memory, else slices of up to 32 channels as wide as fit), else the global
// one over the token-major copy that scratch (B, M, S, D) bf16 receives
template <bool kMerged>
int entry(const void* value, void* scratch, const void* off, const void* logits,
          const void* base, void* out, int B, int M, int D, int H, int W, int P, int Lq,
          void* stream) {
  if (bad_sizes(B, M, D, P, Lq) || H < 1 || W < 1 || M > 65535 / ((D + 7) / 8) ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long S = (long long)H * W;
  if (scratch != nullptr) {
    cudaError_t err = transpose<__nv_bfloat16>(value, scratch, B * M, D, H * W, s);
    if (err != cudaSuccess) return (int)err;
    return launch<kSlice / 8, true, true, kMerged>(scratch, off, logits, base, out, B, M, D,
                                                      H, W, P, Lq, kSlice, s);
  }
  const long long fit = kSmemMax / (16 * ((S + 7) & ~7)) * 8;  // channels whose cells fit
  if (fit < 8) return (int)cudaErrorInvalidValue;  // the caller owes a scratch
  const int d8 = (D + 7) / 8 * 8;
  if (d8 <= fit && D <= (kMerged ? 32 : 64)) {
    if (kMerged || (D > 24 && D <= 32))
      return launch<4, false, false, kMerged>(value, off, logits, base, out, B, M, D, H, W, P,
                                              Lq, D, s);
    if constexpr (!kMerged) {
      if (D <= 16)
        return launch<2, false, false, false>(value, off, logits, base, out, B, M, D, H, W, P,
                                              Lq, D, s);
      if (D <= 24)
        return launch<3, false, false, false>(value, off, logits, base, out, B, M, D, H, W, P,
                                              Lq, D, s);
      return launch<8, false, false, false>(value, off, logits, base, out, B, M, D, H, W, P,
                                            Lq, D, s);
    }
  }
  // slices as even as the widest that fits allows, each a multiple of 8
  const int widest = (int)(fit < kSlice ? fit : kSlice);
  const int n_slices = (D + widest - 1) / widest;
  const int sw = ((D + n_slices - 1) / n_slices + 7) / 8 * 8;
  return launch<kSlice / 8, true, false, kMerged>(value, off, logits, base, out, B, M, D, H,
                                                     W, P, Lq, sw, s);
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
