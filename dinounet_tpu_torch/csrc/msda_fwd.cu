// Multi-scale deformable attention forward with fused prep, for sm_90a.
//
// Replaces the TPU kernel dinounet_tpu/ops/msda_pallas.py::_fwd_kernel_fused
// (body _fused_core), called by ms_deform_attn_pallas_premapped_fused. Same
// function, in the same layouts:
//   value  (B, M, D, S) bf16      one head's D x S value map per (b, m)
//   off    (B, M, 2P, Lq) bf16    raw offsets, rows 2p / 2p+1 = x / y
//   logits (B, M, P, Lq) bf16     pre-softmax point logits
//   base   (2P, Lq) fp32          reference point * map size - 0.5
//   out    (B, M, D, Lq) bf16     out[:, q] = sum_p softmax_p * bilinear(v, x_p, y_p)
// with zero padding outside the H x W map (grid_sample, align_corners=False).
// One level only (L = 1), D <= 64, P <= 16.
//
// What bounds it on an H100: gathers. Each query reads 4 corners x P points x D
// channels at data-dependent positions -- 4 * 4 * 24 values per query per head
// at dinounet_b shapes -- and does one FMA per value read, far below the
// tensor-core roofline and, from device memory, scattered 2-byte reads. The
// TPU kernel turned the gather into a dense one-hot matrix on the MXU because
// a TPU has no fast gather; that multiplies the work by S and is not carried
// over. Here one block takes one (b, head, 256-query tile) and stages the
// head's whole D x S value map in shared memory (24 x 1024 bf16 = 48 KB for
// dinounet_b), so every gather hits shared memory; each thread owns one query,
// keeps its D fp32 accumulators in registers, takes the P-way softmax in fp32
// and writes its output column with stores that are coalesced across the warp.
// Offsets, logits and outputs stream through once. The value map is re-read
// from L2 by each of the ceil(Lq / 256) query tiles of a head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kQueries = 256;   // threads per block, one query each
constexpr int kMaxPoints = 16;

template <int DMAX>
__global__ void __launch_bounds__(kQueries)
msda_fwd_kernel(const __nv_bfloat16* __restrict__ value,
                const __nv_bfloat16* __restrict__ off,
                const __nv_bfloat16* __restrict__ logits,
                const float* __restrict__ base,
                __nv_bfloat16* __restrict__ out,
                int M, int D, int H, int W, int P, int Lq) {
  extern __shared__ __nv_bfloat16 v_s[];  // [S][D]: one position's channels adjacent
  const int S = H * W;
  const size_t bm = (size_t)blockIdx.z * M + blockIdx.y;
  const __nv_bfloat16* v_g = value + bm * D * S;
  for (int i = threadIdx.x; i < D * S; i += blockDim.x) {
    const int d = i / S;
    const int s = i - d * S;
    v_s[s * D + d] = v_g[i];
  }
  __syncthreads();

  const int q = blockIdx.x * kQueries + threadIdx.x;
  if (q >= Lq) return;  // ragged tail of the query axis
  const __nv_bfloat16* off_q = off + bm * 2 * P * Lq + q;
  const __nv_bfloat16* lg_q = logits + bm * P * Lq + q;

  float a[kMaxPoints];
  float mx = -INFINITY;
#pragma unroll
  for (int p = 0; p < kMaxPoints; ++p) {
    if (p < P) {
      a[p] = __bfloat162float(lg_q[(size_t)p * Lq]);
      mx = fmaxf(mx, a[p]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int p = 0; p < kMaxPoints; ++p) {
    if (p < P) {
      a[p] = expf(a[p] - mx);
      sum += a[p];
    }
  }

  float acc[DMAX];
#pragma unroll
  for (int d = 0; d < DMAX; ++d) acc[d] = 0.f;

#pragma unroll
  for (int p = 0; p < kMaxPoints; ++p) {
    if (p < P) {
      const float w_p = a[p] / sum;
      // clamping to one pixel beyond the map keeps the int conversion in
      // range and leaves every out-of-map corner out of the map
      float x = __bfloat162float(off_q[(size_t)(2 * p) * Lq]) + base[(size_t)(2 * p) * Lq + q];
      float y = __bfloat162float(off_q[(size_t)(2 * p + 1) * Lq]) + base[(size_t)(2 * p + 1) * Lq + q];
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
        const __nv_bfloat16* vp = v_s + (yy * W + xx) * D;
#pragma unroll
        for (int d = 0; d < DMAX; ++d) {
          if (d < D) acc[d] = fmaf(wt, __bfloat162float(vp[d]), acc[d]);
        }
      }
    }
  }

  __nv_bfloat16* o = out + bm * D * Lq + q;
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    if (d < D) o[(size_t)d * Lq] = __float2bfloat16(acc[d]);
  }
}

template <int DMAX>
int launch(const void* value, const void* off, const void* logits,
           const void* base, void* out, int B, int M, int D, int H, int W,
           int P, int Lq, cudaStream_t stream) {
  const size_t smem = (size_t)D * H * W * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      msda_fwd_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + kQueries - 1) / kQueries, M, B);
  msda_fwd_kernel<DMAX><<<grid, kQueries, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(value),
      static_cast<const __nv_bfloat16*>(off),
      static_cast<const __nv_bfloat16*>(logits),
      static_cast<const float*>(base), static_cast<__nv_bfloat16*>(out),
      M, D, H, W, P, Lq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int msda_fwd_fused(const void* value, const void* off,
                              const void* logits, const void* base, void* out,
                              int B, int M, int D, int H, int W, int P, int Lq,
                              void* stream) {
  if (D < 1 || D > 64 || P < 1 || P > kMaxPoints || B < 1 || M < 1 || Lq < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch<16>(value, off, logits, base, out, B, M, D, H, W, P, Lq, s);
  if (D <= 32) return launch<32>(value, off, logits, base, out, B, M, D, H, W, P, Lq, s);
  return launch<64>(value, off, logits, base, out, B, M, D, H, W, P, Lq, s);
}
