// Fused RoPE + multi-head self-attention over the Dh-major layout, for sm_90a.
//
// Replaces the TPU kernel dinounet_tpu/ops/attention_pallas.py::_kernel_pm_dmaj,
// called by fused_rope_attention_premapped_dmaj. Same function and layouts:
//   qkv   (B, 3, M, Dh, N) bf16   the QKV projection, tokens minor
//   sin_t (Dh, N) fp32            RoPE sin with rotate-half's sign folded in
//   cos_t (Dh, N) fp32            (identity columns -- sin 0, cos 1 -- for the
//                                 prefix tokens)
//   out   (B, M, Dh, N) bf16      softmax(q k^T / sqrt(Dh)) v, channel-major
// RoPE runs in fp32: r[d] = x[d] cos[d] + x[(d + Dh/2) % Dh] sin_t[d]; q is
// scaled by Dh^-1/2 before its bf16 rounding. Scores accumulate in fp32 on the
// tensor cores, probabilities are rounded to bf16 for the PV product, and the
// output is divided by the fp32 sum of those rounded probabilities. Dh is 64
// or 128. Forward only: the backbone is frozen.
//
// What bounds it on an H100: at dinounet_b shapes (N = 1029 tokens, Dh = 64) a
// head does 2 * 2 * N^2 * Dh = 0.27 GFLOP on 0.4 MB of q/k/v, about 650
// FLOP/byte, so it is compute-bound once the score matrix stays on chip. The
// TPU kernel held a head's whole N x N score matrix in VMEM; a Hopper SM has
// 227 KB of shared memory, so this kernel is flash-style instead: one block
// takes one (b, head, 64-query tile), loops over 64-key tiles with an online
// softmax (running row max and row sum, the output rescaled in shared memory
// as the max moves), and never writes scores to device memory. Each key tile
// is read by every query tile of its head, so the RoPE rotation is not redone
// there: a pre-pass (rope_prep_kernel) writes rotated-and-scaled q, rotated k
// and v once into a scratch buffer zero-padded to a multiple of 64 tokens,
// and the main kernel's tile loads become 16-byte copies, the next key tile's
// prefetched into registers while the current one is multiplied. The
// products run on the tensor cores through WMMA (bf16 x bf16 -> fp32,
// 16 x 16 x 16), four warps each owning 16 query rows; all tiles keep the
// Dh-major layout in shared memory and the fragments read them column- or
// row-major as each product needs. The score and PV buffers, and the q and
// probability tiles, share shared memory (63 KB a block at Dh = 64, 3 blocks
// an SM). Keys past N are masked with -inf; query rows past N are computed on
// zeros and not stored. wgmma, TMA and register-resident outputs are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>

using namespace nvcuda;

namespace {

constexpr int kTile = 64;        // queries per block and keys per step
constexpr int kWarps = 4;        // each owns 16 query rows
constexpr int kThreads = 32 * kWarps;
constexpr int kLdH = kTile + 8;  // bf16 tile row pitch (elements)
constexpr int kLdS = kTile + 4;  // fp32 score tile row pitch

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int DH>
struct Smem {
  static constexpr int kLdO = DH + 4;
  // the q tile lives only until its fragments are loaded; p reuses it
  static constexpr size_t qp = 0;
  static constexpr size_t k = qp + sizeof(__nv_bfloat16) * cmax(DH, kTile) * kLdH;
  static constexpr size_t v = k + sizeof(__nv_bfloat16) * DH * kLdH;
  // scores, then (after every warp has read them) this step's p v
  static constexpr size_t st = v + sizeof(__nv_bfloat16) * DH * kLdH;
  static constexpr size_t o = st + sizeof(float) * kTile * cmax(kLdS, kLdO);
  static constexpr size_t stats = o + sizeof(float) * kTile * kLdO;
  static constexpr size_t bytes = stats + sizeof(float) * 3 * kTile;
};

// scratch (3, B, M, Dh, Npad): rotated and scaled q, rotated k, v; zero past N
__global__ void rope_prep_kernel(const __nv_bfloat16* __restrict__ qkv,
                                 const float* __restrict__ sin_t,
                                 const float* __restrict__ cos_t,
                                 __nv_bfloat16* __restrict__ scratch, int B,
                                 int M, int DH, int N, int Npad, float scale) {
  const size_t total = (size_t)3 * B * M * DH * Npad;
  const int half = DH / 2;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int n = (int)(i % Npad);
    size_t r = i / Npad;
    const int d = (int)(r % DH);
    r /= DH;
    const int m = (int)(r % M);
    r /= M;
    const int b = (int)(r % B);
    const int which = (int)(r / B);  // 0 q, 1 k, 2 v
    float y = 0.f;
    if (n < N) {
      const __nv_bfloat16* x = qkv + (((size_t)b * 3 + which) * M + m) * DH * N;
      const float xv = __bfloat162float(x[(size_t)d * N + n]);
      if (which == 2) {
        y = xv;
      } else {
        const int dp = d < half ? d + half : d - half;
        const float xp = __bfloat162float(x[(size_t)dp * N + n]);
        y = xv * cos_t[(size_t)d * N + n] + xp * sin_t[(size_t)d * N + n];
        if (which == 0) y *= scale;
      }
    }
    scratch[i] = __float2bfloat16(y);
  }
}

// A (DH, kTile) slab as 16-byte vectors: kVec per thread
template <int DH>
struct TileRegs {
  static constexpr int kVec = DH * kTile / 8 / kThreads;
  uint4 r[kVec];

  __device__ void load(const __nv_bfloat16* g, int n0, int Npad) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int d = idx / 8;
      const int c = (idx % 8) * 8;
      r[i] = *reinterpret_cast<const uint4*>(g + (size_t)d * Npad + n0 + c);
    }
  }
  __device__ void store(__nv_bfloat16* s) const {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int d = idx / 8;
      const int c = (idx % 8) * 8;
      *reinterpret_cast<uint4*>(s + d * kLdH + c) = r[i];
    }
  }
};

template <int DH>
__global__ void __launch_bounds__(kThreads)
rope_attention_kernel(const __nv_bfloat16* __restrict__ scratch,
                      __nv_bfloat16* __restrict__ out, int B, int M, int N,
                      int Npad) {
  using L = Smem<DH>;
  constexpr int kLdO = L::kLdO;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qp_s = reinterpret_cast<__nv_bfloat16*>(smem + L::qp);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::k);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + L::v);
  float* st_s = reinterpret_cast<float*>(smem + L::st);
  float* o_s = reinterpret_cast<float*>(smem + L::o);
  float* m_s = reinterpret_cast<float*>(smem + L::stats);
  float* l_s = m_s + kTile;
  float* a_s = l_s + kTile;

  const int b = blockIdx.z;
  const int m = blockIdx.y;
  const int n0 = blockIdx.x * kTile;
  const size_t plane = (size_t)DH * Npad;
  const __nv_bfloat16* q_g = scratch + ((size_t)(0 * B + b) * M + m) * plane;
  const __nv_bfloat16* k_g = scratch + ((size_t)(1 * B + b) * M + m) * plane;
  const __nv_bfloat16* v_g = scratch + ((size_t)(2 * B + b) * M + m) * plane;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;

  TileRegs<DH> kr, vr;
  {
    TileRegs<DH> qr;
    qr.load(q_g, n0, Npad);
    qr.store(qp_s);
  }
  kr.load(k_g, 0, Npad);
  vr.load(v_g, 0, Npad);
  for (int i = threadIdx.x; i < kTile * kLdO; i += kThreads) o_s[i] = 0.f;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  kr.store(k_s);
  vr.store(v_s);
  __syncthreads();

  // this warp's q rows, as DH/16 column-major A fragments (q is [d][query])
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> qa[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], qp_s + kk * 16 * kLdH + row0, kLdH);
  __syncthreads();  // qp_s is the probability tile from here on
  __nv_bfloat16* p_s = qp_s;

  for (int k0 = 0; k0 < N; k0 += kTile) {
    const bool more = k0 + kTile < N;
    if (more) {  // next key tile in flight while this one is multiplied
      kr.load(k_g, k0 + kTile, Npad);
      vr.load(v_g, k0 + kTile, Npad);
    }

    // scores: 16 query rows x 64 keys per warp
#pragma unroll
    for (int kb = 0; kb < kTile / 16; ++kb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> kf;
        wmma::load_matrix_sync(kf, k_s + kk * 16 * kLdH + kb * 16, kLdH);
        wmma::mma_sync(acc, qa[kk], kf, acc);
      }
      wmma::store_matrix_sync(st_s + row0 * kLdS + kb * 16, acc, kLdS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this key tile, one row at a time, two keys a lane
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r;
      float s0 = st_s[row * kLdS + lane];
      float s1 = st_s[row * kLdS + lane + 32];
      if (k0 + lane >= N) s0 = -INFINITY;
      if (k0 + lane + 32 >= N) s1 = -INFINITY;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, mx);  // finite: key k0 < N is valid
      const __nv_bfloat16 p0 = __float2bfloat16(__expf(s0 - m_new));
      const __nv_bfloat16 p1 = __float2bfloat16(__expf(s1 - m_new));
      p_s[row * kLdH + lane] = p0;
      p_s[row * kLdH + lane + 32] = p1;
      float sum = __bfloat162float(p0) + __bfloat162float(p1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);  // 0 on the first tile
        a_s[row] = alpha;
        l_s[row] = l_s[row] * alpha + sum;
        m_s[row] = m_new;
      }
    }
    __syncthreads();  // every warp's scores are read: st_s takes p v

    // t = p v for this warp's rows (v_s is [d][key]: column-major B)
#pragma unroll
    for (int db = 0; db < DH / 16; ++db) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kb = 0; kb < kTile / 16; ++kb) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> vf;
        wmma::load_matrix_sync(pf, p_s + row0 * kLdH + kb * 16, kLdH);
        wmma::load_matrix_sync(vf, v_s + db * 16 * kLdH + kb * 16, kLdH);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(st_s + row0 * kLdO + db * 16, acc, kLdO,
                              wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = lane; i < 16 * DH; i += 32) {
      const int row = row0 + i / DH;
      const int d = i % DH;
      o_s[row * kLdO + d] = o_s[row * kLdO + d] * a_s[row] + st_s[row * kLdO + d];
    }
    __syncthreads();  // k_s, v_s and st_s are free
    if (more) {
      kr.store(k_s);
      vr.store(v_s);
      __syncthreads();
    }
  }

  __nv_bfloat16* o_g = out + ((size_t)b * M + m) * DH * N;
  for (int i = threadIdx.x; i < DH * kTile; i += kThreads) {
    const int d = i / kTile;
    const int j = i - d * kTile;
    const int n = n0 + j;
    if (n < N) o_g[(size_t)d * N + n] = __float2bfloat16(o_s[j * kLdO + d] / l_s[j]);
  }
}

template <int DH>
int launch(const void* qkv, const void* sin_t, const void* cos_t, void* scratch,
           void* out, int B, int M, int N, float scale, cudaStream_t stream) {
  const int Npad = (N + kTile - 1) / kTile * kTile;
  const size_t total = (size_t)3 * B * M * DH * Npad;
  const int prep_blocks = (int)((total + 255) / 256 < 8192 ? (total + 255) / 256 : 8192);
  rope_prep_kernel<<<prep_blocks, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(sin_t),
      static_cast<const float*>(cos_t), static_cast<__nv_bfloat16*>(scratch), B,
      M, DH, N, Npad, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = Smem<DH>::bytes;
  err = cudaFuncSetAttribute(rope_attention_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Npad / kTile, M, B);
  rope_attention_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(scratch), static_cast<__nv_bfloat16*>(out),
      B, M, N, Npad);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: (3, B, M, Dh, ceil(N / 64) * 64) bf16, allocated by the caller
extern "C" int rope_attention_dmaj(const void* qkv, const void* sin_t,
                                   const void* cos_t, void* scratch, void* out,
                                   int B, int M, int Dh, int N, float scale,
                                   void* stream) {
  if (B < 1 || M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 64) return launch<64>(qkv, sin_t, cos_t, scratch, out, B, M, N, scale, s);
  if (Dh == 128) return launch<128>(qkv, sin_t, cos_t, scratch, out, B, M, N, scale, s);
  return (int)cudaErrorInvalidValue;
}
