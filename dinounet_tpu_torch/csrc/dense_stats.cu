// Dense projection + bias + LayerScale residual + next-LayerNorm row statistics,
// for sm_90a.
//
// Replaces two TPU kernels of dinounet_tpu/ops/dense_stats_pallas.py:
//   _cm_kernel (called by dense_cm_residual_stats): the activation arrives
//     channel-major, h (B, K, N) -- the attention and MSDA output projections;
//   _kernel (called by dense_residual_stats): h row-major, (B, N, K), with an
//     optional exact-erf GELU prologue -- ViT fc2 and ConvFFN fc2.
// Both compute, with the weight wt (D, K) bf16 (nn.Linear's layout: the JAX
// signature's w (K, D) transposed) and b, gamma (D,) fp32:
//   out = res + bf16(gamma) * (bf16(h^T w or h w) + bf16(b))   all in bf16
//   mu  = mean(out), var = max(mean(out^2) - mu^2, 0)          fp32, per row
// rounding at the points the TPU kernel's _reference / _cm_reference do: the
// fp32 accumulator to bf16, then each add and multiply rounded to bf16. The
// statistics describe the stored bf16 rows. The GELU rounds gelu(fp32(h)) to
// bf16 before the product; erff is exact here (the TPU kernel's
// Abramowitz-Stegun erf existed only because Mosaic has no erf).
//
// What bounds it on an H100: the products are (M x K) x (K x D) with M = B N
// tokens (N = 1029 or 5376), K in {192, 384, 768, 1024, 2048, 3072} and
// D = 768 or 4096. At K >= 768 they are compute-bound (the ViT fc2 at B 8:
// 38.8 GFLOP, 0.039 ms at 989 TFLOP/s), at K = 192 or 384 the bytes of h,
// res and out bound them. A 64 x 256 tile reads 40 KB through L2 a 64-deep
// K step for 2.1 MFLOP, which L2's bandwidth holds to roughly a third of the
// tensor cores' rate.
//
// Design (the shape of Hopper's GEMMs, with the epilogue and the statistics
// fused):
// 1. A block owns 64 whole output rows and walks all of D in passes of 256
//    features (128 a consumer warpgroup), so it sums each stored row's
//    values and squares itself: no second pass reads out back, no atomics,
//    the same sums in the same order on every run.
// 2. A producer warpgroup fills a ring of kStages stages, each the A rows
//    and the weight rows of one 64-deep K step, in the 128-byte swizzle the
//    wgmma descriptors read. Where the layout allows (row pitch a multiple of
//    16 bytes: every model shape but one) one thread starts TMA copies, over
//    a 2-D map of h (B N, K) or of the weight (D, K), or a 3-D map of a
//    channel-major h (B, K, N), with the ragged edges zero-filled by the
//    copy. Elsewhere (the attention projection's N = 1029, whose channel
//    rows start 2058 bytes apart; K not a multiple of 8) the 128 producer
//    threads load each row's aligned 16-byte windows, shift them to the
//    row's offset and store the swizzled chunks themselves.
// 3. Two consumer warpgroups run wgmma m64n128k16 with both operands in
//    shared memory and the fp32 accumulators in registers. The weight is the
//    K-major B operand; a row-major h the K-major A operand; a channel-major
//    h the transposed (M-major) A operand, read as it arrives. One K step's
//    products stay in flight while the next stage is awaited.
// 4. The epilogue of a pass adds bias, multiplies by LayerScale (bf16
//    roundings) in registers and stages a warpgroup's 64 x 128 tile in
//    shared memory; then each thread requests the residual of its 8 rows as
//    16-byte vectors, adds the staged runs, stores out as 16-byte vectors
//    and adds the rounded values to its rows' sums. The sums meet across 16
//    lanes by shuffles and across the two warpgroups in shared memory.
// 5. The GELU runs once per element of h, in a pre-pass that writes
//    bf16(gelu(h)) to a scratch the GEMM then reads (in the GEMM's A load
//    it would run once per pass: 3 times at D = 768, 16 at D = 4096).
// Timed against this in kernel_ab.py (PERF.md section 6): 128-row blocks
// (half the blocks: the ViT fc2's 8232 rows fill 65 SMs), and clusters of 2
// or 4 blocks sharing each weight tile by TMA multicast with the residual
// in and the output out by TMA; both were slower at the path's shapes.

#include <math.h>
#include <string.h>

#include "hopper_common.cuh"

namespace {

constexpr int kStages = 4;     // ring stages
constexpr int kKStep = 64;     // K a stage: one 128-byte swizzled row
constexpr int kRows = 64;      // output rows a block
constexpr int kCols = 256;     // features a pass, 128 a consumer warpgroup
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr uint32_t kABytes = kRows * 128;
constexpr uint32_t kWBytes = kCols * 128;
constexpr uint32_t kStageBytes = kABytes + kWBytes;
constexpr int kLdS = 128 + 8;  // staging pitch (bf16): [64 rows][128 features]
constexpr uint32_t kStagingBytes = 64 * kLdS * 2;  // a warpgroup's
// shared-memory plan (byte offsets from a 1024-byte-aligned base)
constexpr uint32_t kOffStaging = kStages * kStageBytes;
constexpr uint32_t kOffStats = kOffStaging + 2 * kStagingBytes;  // [2][64 rows][2] fp32
constexpr uint32_t kOffBars = kOffStats + 2 * 64 * 2 * 4;        // full, then empty, a stage
constexpr uint32_t kSmemBytes = kOffBars + 16 * kStages + 1024;   // + alignment

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float gelu_exact(float x) {
  return x * 0.5f * (1.f + erff(x * 0.70710678118654752f));
}

// the 8 bf16 starting `s` elements (0..7) into the 16 of (lo, hi)
__device__ __forceinline__ uint4 shift8(uint4 lo, uint4 hi, int s) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = s >> 1;
  uint32_t x[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    uint32_t v = w[i];
    v = q == 1 ? w[i + 1] : v;
    v = q == 2 ? w[i + 2] : v;
    v = q == 3 ? w[i + 3] : v;
    x[i] = v;
  }
  if (s & 1)
    return make_uint4(__funnelshift_r(x[0], x[1], 16), __funnelshift_r(x[1], x[2], 16),
                      __funnelshift_r(x[2], x[3], 16), __funnelshift_r(x[3], x[4], 16));
  return make_uint4(x[0], x[1], x[2], x[3]);
}

// 8 consecutive bf16 from any 2-byte-aligned address, zero past the first
// `valid` (>= 1): the aligned 16-byte windows around them, shifted. A window
// holding one valid element lies in the tensor's allocation.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int valid) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const int s = (int)((addr >> 1) & 7);
  const uint4* a = reinterpret_cast<const uint4*>(addr - 2 * s);
  const uint4 lo = __ldg(a);
  const uint4 hi = s > 0 && valid > 8 - s ? __ldg(a + 1) : make_uint4(0u, 0u, 0u, 0u);
  uint4 v = shift8(lo, hi, s);
  if (valid < 8) {
    uint32_t* e = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (2 * i >= valid) e[i] = 0u;
      else if (2 * i + 1 >= valid) e[i] &= 0xFFFFu;
    }
  }
  return v;
}

// kRowsT rows of one 64-element K step (or 64 tokens) into a 128-byte
// swizzled tile at `dst`, by the 128 producer threads: row r's first element
// at src + r * pitch; rows from `rows_valid` and elements from `cols_valid`
// on are zeros. Every load of a thread is issued before its first store.
template <int kRowsT>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, size_t pitch,
                                          int rows_valid, int cols_valid, int tid) {
  constexpr int kPer = kRowsT * 8 / 128;  // 16-byte chunks a thread
  uint4 v[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + 128 * u, r = i >> 3, c = i & 7;
    const int valid = r < rows_valid ? min(8, cols_valid - 8 * c) : 0;
    v[u] = valid > 0 ? load8(src + r * pitch + 8 * c, valid) : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + 128 * u, r = i >> 3, c = i & 7;
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     dst + r * 128 + ((c ^ (r & 7)) << 4)),
                 "r"(v[u].x), "r"(v[u].y), "r"(v[u].z), "r"(v[u].w)
                 : "memory");
  }
}

// bf16(gelu(h)) of n elements; 8 a thread where the rows allow 16-byte access
__global__ void gelu_prepass_kernel(const __nv_bfloat16* __restrict__ h,
                                    __nv_bfloat16* __restrict__ y, size_t n, int vec) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t t0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    for (size_t i = t0; i < n / 8; i += stride) {
      uint4 v = reinterpret_cast<const uint4*>(h)[i];
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16(gelu_exact(__bfloat162float(e[u])));
      reinterpret_cast<uint4*>(y)[i] = v;
    }
  } else {
    for (size_t i = t0; i < n; i += stride)
      y[i] = __float2bfloat16(gelu_exact(__bfloat162float(h[i])));
  }
}


struct Args {
  const __nv_bfloat16* h;   // A: h, or bf16(gelu(h)) from the pre-pass
  const __nv_bfloat16* wt;  // (D, K)
  const float* bias;
  const float* gamma;
  const __nv_bfloat16* res;  // (B N, D)
  __nv_bfloat16* out;        // (B N, D)
  float* mu;                 // (B N)
  float* var;
  int B, N, K, D;
  int a_tma, w_tma;  // operand through its tensor map, else the producer's loads
  int vec;           // res and out rows start 16-byte aligned
};

// grid (row tiles, 1) row-major, (token tiles, B) channel-major
template <bool kCM>
__global__ void __launch_bounds__(kThreads, 1)
dense_stats_kernel(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap w_map, const Args p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t full = base + kOffBars, empty = full + 8 * kStages;
  // the block's rows: rows r0.. of the (B N) rows, or tokens r0.. of image b
  const int b = kCM ? (int)blockIdx.y : 0;
  const int r0 = blockIdx.x * kRows;
  const int rows_valid = min(kRows, (kCM ? p.N : p.B * p.N) - r0);
  const size_t out_row0 = (size_t)b * p.N + r0;
  const int ktiles = (p.K + kKStep - 1) / kKStep;
  const int passes = (p.D + kCols - 1) / kCols;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 128);   // every producer thread
      mbar_init(empty + 8 * s, 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    for (int it = 0; it < ktiles * passes; ++it) {
      const int s = it % kStages;
      const int pass = it / ktiles;
      const int k0 = (it - pass * ktiles) * kKStep, d0 = pass * kCols;
      mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
      const uint32_t a_dst = base + s * kStageBytes, w_dst = a_dst + kABytes;
      if (!p.a_tma) {
        if (kCM)  // rows: channels k0.., 64 tokens r0.. of each
          load_tile<64>(a_dst, p.h + ((size_t)b * p.K + k0) * p.N + r0, p.N, p.K - k0,
                        p.N - r0, tid);
        else  // rows: tokens r0.., 64 channels k0.. of each
          load_tile<64>(a_dst, p.h + (size_t)r0 * p.K + k0, p.K, rows_valid, p.K - k0, tid);
      }
      if (!p.w_tma)
        load_tile<kCols>(w_dst, p.wt + (size_t)d0 * p.K + k0, p.K, p.D - d0, p.K - k0, tid);
      if (!p.a_tma || !p.w_tma) fence_proxy_async();
      const uint32_t bar = full + 8 * s;
      if (tid == 0) {
        mbar_expect_tx(bar, (p.a_tma ? kABytes : 0u) + (p.w_tma ? kWBytes : 0u));
        if (p.a_tma) {
          if (kCM)
            tma_load_3d(a_dst, &a_map, r0, k0, b, bar);
          else
            tma_load(a_dst, &a_map, k0, r0, bar);
        }
        if (p.w_tma) {
#pragma unroll
          for (int j = 0; j < kCols / 128; ++j)
            tma_load(w_dst + j * 128 * 128, &w_map, k0, d0 + 128 * j, bar);
        }
      } else {
        mbar_arrive(bar);
      }
    }
    return;
  }

  const int cw = wg - 1, warp = tid / 32, lane = tid % 32;
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(sbase + kOffStaging + cw * kStagingBytes);
  const int ar = warp * 16 + lane / 4;  // accumulator rows ar and ar + 8
  const int vq = tid % 16, rq = tid / 16;  // epilogue: 16-byte run vq of rows rq + 8 i
  float acc[64];
  float s1[8], s2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s1[i] = s2[i] = 0.f;

  int it = 0;
  for (int pass = 0; pass < passes; ++pass) {
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const uint32_t a_tile = base + s * kStageBytes;
      const uint32_t w_tile = a_tile + kABytes + cw * 128 * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKStep / 16; ++kk) {
        // K-major A: 16 channels are 32 bytes into each row; M-major A (the
        // channel-major h): 16 channels are 16 rows of 64 tokens
        const uint64_t ad = kCM ? sw128_desc(a_tile + kk * 16 * 128, kABytes, 1024)
                                : sw128_desc(a_tile + kk * 32, 16, 1024);
        wgmma_ss_n128<kCM ? 1 : 0>(acc, ad, sw128_desc(w_tile + kk * 32, 16, 1024),
                                   kt > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: free its stage
      if (kt > 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + 8 * ((it - 1) % kStages));

    // bias and LayerScale on the accumulators: acc[4 j + 2 h + {0, 1}] is
    // row ar + 8 h, features 8 j + 2 (lane % 4) + {0, 1} of the warpgroup's 128
    const int d_base = pass * kCols + 128 * cw;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const int d = d_base + c;
      const float bb0 = d < p.D ? bf16_round(p.bias[d]) : 0.f;
      const float bb1 = d + 1 < p.D ? bf16_round(p.bias[d + 1]) : 0.f;
      const float gg0 = d < p.D ? bf16_round(p.gamma[d]) : 0.f;
      const float gg1 = d + 1 < p.D ? bf16_round(p.gamma[d + 1]) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float y0 = bf16_round(bf16_round(acc[4 * j + 2 * h]) + bb0);
        const float y1 = bf16_round(bf16_round(acc[4 * j + 2 * h + 1]) + bb1);
        *reinterpret_cast<__nv_bfloat162*>(st + (ar + 8 * h) * kLdS + c) =
            __floats2bfloat162_rn(y0 * gg0, y1 * gg1);
      }
    }
    named_barrier(1 + cw, 128);
    // + residual, stored; the stored values summed per row. The residual's
    // 16-byte vectors of all 8 rows are requested before the first is used
    const int col = d_base + 8 * vq;
    uint4 rv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rq + 8 * i;
      rv[i] = p.vec && r < rows_valid && col < p.D
                  ? __ldg(reinterpret_cast<const uint4*>(p.res + (out_row0 + r) * p.D + col))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rq + 8 * i;
      if (r < rows_valid && col < p.D) {
        const size_t o = (out_row0 + r) * p.D + col;
        const uint4 lv = *reinterpret_cast<const uint4*>(st + r * kLdS + 8 * vq);
        const __nv_bfloat16* l8 = reinterpret_cast<const __nv_bfloat16*>(&lv);
        if (p.vec) {
          __nv_bfloat16* r8 = reinterpret_cast<__nv_bfloat16*>(&rv[i]);
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            r8[u] = __float2bfloat16(__bfloat162float(r8[u]) + __bfloat162float(l8[u]));
            const float f = __bfloat162float(r8[u]);
            s1[i] += f;
            s2[i] += f * f;
          }
          *reinterpret_cast<uint4*>(p.out + o) = rv[i];
        } else {
          for (int u = 0; u < 8 && col + u < p.D; ++u) {
            const __nv_bfloat16 ov =
                __float2bfloat16(__bfloat162float(p.res[o + u]) + __bfloat162float(l8[u]));
            p.out[o + u] = ov;
            const float f = __bfloat162float(ov);
            s1[i] += f;
            s2[i] += f * f;
          }
        }
      }
    }
    named_barrier(1 + cw, 128);  // the staging tile is free for the next pass
  }

  // row sums: 16 lanes a row, then the block's two warpgroups
  float* stats = reinterpret_cast<float*>(sbase + kOffStats);  // [2][64 rows][2]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], off);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], off);
    }
    if (vq == 0) {
      stats[(cw * 64 + rq + 8 * i) * 2] = s1[i];
      stats[(cw * 64 + rq + 8 * i) * 2 + 1] = s2[i];
    }
  }
  named_barrier(3, 256);
  if (cw == 0 && tid < rows_valid) {
    const float S1 = stats[2 * tid] + stats[2 * (64 + tid)];
    const float S2 = stats[2 * tid + 1] + stats[2 * (64 + tid) + 1];
    const float m = S1 / p.D;
    p.mu[out_row0 + tid] = m;
    p.var[out_row0 + tid] = fmaxf(S2 / p.D - m * m, 0.f);
  }
}

template <bool kCM>
int launch(const Args& p, cudaStream_t stream) {
  CUtensorMap a_map, w_map;
  memset(&a_map, 0, sizeof(a_map));
  memset(&w_map, 0, sizeof(w_map));
  const cuuint64_t bf = sizeof(__nv_bfloat16);
  if (p.a_tma) {
    int err;
    if (kCM) {  // (B, K, N): boxes of 64 tokens x 64 channels of one image
      const cuuint64_t dims[3] = {(cuuint64_t)p.N, (cuuint64_t)p.K, (cuuint64_t)p.B};
      const cuuint64_t strides[2] = {p.N * bf, (cuuint64_t)p.K * p.N * bf};
      const cuuint32_t box[3] = {64, 64, 1};
      err = bf16_sw128_map(&a_map, p.h, 3, dims, strides, box);
    } else {  // (B N, K): boxes of 64 rows x 64 channels
      const cuuint64_t dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.B * p.N};
      const cuuint64_t strides[1] = {p.K * bf};
      const cuuint32_t box[2] = {64, 64};
      err = bf16_sw128_map(&a_map, p.h, 2, dims, strides, box);
    }
    if (err != 0) return err;
  }
  if (p.w_tma) {  // (D, K): boxes of 128 features x 64 channels
    const cuuint64_t dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.D};
    const cuuint64_t strides[1] = {p.K * bf};
    const cuuint32_t box[2] = {64, 128};
    const int err = bf16_sw128_map(&w_map, p.wt, 2, dims, strides, box);
    if (err != 0) return err;
  }
  static unsigned long long ready = 0;  // one bit a device
  const cudaError_t err = set_smem_once(dense_stats_kernel<kCM>, (int)kSmemBytes, &ready);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((kCM ? p.N : p.B * p.N) + kRows - 1) / kRows;
  dense_stats_kernel<kCM>
      <<<dim3(tiles, kCM ? p.B : 1), kThreads, kSmemBytes, stream>>>(a_map, w_map, p);
  return (int)cudaGetLastError();
}

}  // namespace

// h (B, N, K) row-major or (B, K, N) channel-major, wt (D, K), b and gamma
// (D,) fp32, res and out (B, N, D), mu and var (B, N) fp32; with gelu (row-
// major only) scratch is (B, N, K) bf16 for gelu(h), else unused.
extern "C" int dense_residual_stats(const void* h, const void* wt, const void* b,
                                    const void* res, const void* gamma, void* out,
                                    void* mu, void* var, void* scratch, int B, int N,
                                    int K, int D, int channel_major, int gelu,
                                    void* stream) {
  if (B < 1 || N < 1 || K < 1 || D < 1 || (gelu && (channel_major || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(h);
  if (gelu) {
    const size_t n = (size_t)B * N * K;
    const int vec = n % 8 == 0 && aligned16(h) && aligned16(scratch);
    const size_t items = vec ? n / 8 : n;
    const int blocks = (int)((items + 255) / 256 < 8192 ? (items + 255) / 256 : 8192);
    gelu_prepass_kernel<<<blocks, 256, 0, s>>>(a, static_cast<__nv_bfloat16*>(scratch), n, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    a = static_cast<const __nv_bfloat16*>(scratch);
  }
  Args p;
  p.h = a;
  p.wt = static_cast<const __nv_bfloat16*>(wt);
  p.bias = static_cast<const float*>(b);
  p.gamma = static_cast<const float*>(gamma);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.mu = static_cast<float*>(mu);
  p.var = static_cast<float*>(var);
  p.B = B;
  p.N = N;
  p.K = K;
  p.D = D;
  // a tensor map needs a 16-byte-aligned base and row pitch
  p.a_tma = (channel_major ? N % 8 == 0 : K % 8 == 0) && aligned16(a);
  p.w_tma = K % 8 == 0 && aligned16(wt);
  p.vec = D % 8 == 0 && aligned16(res) && aligned16(out);
  return channel_major ? launch<true>(p, s) : launch<false>(p, s);
}
