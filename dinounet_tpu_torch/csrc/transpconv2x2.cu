// Transposed 2x2 convolution with stride 2 (exact x2 upsampling) with an
// optional InstanceNorm-apply + leaky ReLU prologue, for sm_90a.
//
// Replaces the TPU kernel dinounet_tpu/ops/decoder_tail_pallas.py
// _transpconv_kernel (called by transpconv2x2_cm). Channel-major (B, C, H, W):
//   x'[b, ci, j, x]            = bf16(leaky(x * s[b, ci] + t[b, ci]))  (or x)
//   y[b, c, 2j + p, 2x + q]    = bf16(sum_ci x'[b, ci, j, x] w[ci, c, p, q] + b[c])
// with w in torch's ConvTranspose2d layout (Cin, Cout, 2, 2): (p, q) index the
// taps directly (the JAX wrapper's spatial flip belongs to flax's layout).
// The Pallas body's uint32 bit-packing of the column interleave exists only
// because Mosaic cannot lower the lane interleave; here the GEMM's column
// order puts each (q = 0, 1) pair in one accumulator pair.
//
// What bounds it on an H100: a per-pixel GEMM, M = input pixels, N = 4 Cout,
// K = Cin, with Cin = 2 Cout or Cout on the path: 8 Cout FLOP per input byte
// and ~Cin / 4 per output byte, below the card's ridge (295 FLOP a byte in
// bf16) at every path shape, so HBM bounds it, and the output (4x the
// input's pixels) is most of the bytes:
//   decoder 256^2, 64 -> 32      0.060 ms (bytes)    upsample 256^2, 32 -> 32  0.050 ms
//   decoder 128^2, 128 -> 64     0.030 ms            upsample 32^2, 256 -> 256 0.0066 ms
//   decoder 64^2, 256 -> 128     0.015 ms
// (tile batch 8). At the small maps the weight (256 and 512 KB) is read from
// L2 by every block that works on it, and the launch itself is a few us.
//
// Design (a persistent wgmma GEMM that reads its input once):
// 1. A work item is 128 consecutive pixels of one image's flattened (row,
//    column) plane, so narrow maps fill their tiles too, and a group of the
//    N passes; one block an SM walks the items strided by the grid. Where
//    the pixel tiles are fewer than the SMs (the 32^2 upsampling: 64 tiles),
//    a tile's passes are split into groups across blocks so the card fills.
// 2. A producer warpgroup stages the tile's A operand once, all of K, in
//    128-byte-swizzled 64 x 64 boxes (a ring of two tiles where they fit, so
//    the next tile's load runs under this one's products and stores):
//    - channel-major planes (the models' maps): one thread's TMA copies over
//      a 3-D map (pixels, channels, images), pixels innermost: rows of 64
//      pixels, one row a channel -- the M-major (transposed) A operand, read
//      as it arrives;
//    - channels-last maps: the same over (channels, pixels, images): rows of
//      64 channels, one row a pixel -- the K-major operand;
//    - any other strides: the 128 producer threads load a pixel's 8 channels
//      each and store the swizzled K-major chunks themselves.
//    The prologue, where given, is applied once per element by the producer
//    threads to the staged tile in place (an M-major row is one channel, so
//    one (s, t) a row), after the TMA box arrives and before the consumers
//    are let in. The zero fill past the map is left as it is: padding
//    pixels' outputs are never stored, and padding channels (Cin < 64 in a
//    box) are never multiplied.
// 3. The weight, packed once per weight version by the wrapper as (Npad, Cin)
//    bf16 (row n = 4 c + 2 p + q: the GEMM's columns in (c, p, q) order, q
//    innermost, padded with zero rows to a multiple of the pass width), comes
//    in 64-deep x NB-wide TMA boxes: held resident for the whole walk where
//    all of it fits (Cout <= 64 at Cin <= 128), else streamed through a ring
//    of two stages in the order the consumers use it (from L2).
// 4. Two consumer warpgroups, one 64-pixel panel each, run wgmma
//    m64nNBk16 (NB = 128 at Cout <= 32, else 256) over all of K a pass, the
//    fp32 accumulators in registers.
// 5. The epilogue adds the fp32 bias, rounds once to bf16 and stages 64 GEMM
//    columns (16 channels) at a time in shared memory, the accumulator
//    fragment's 8 x 8 blocks stored transposed by stmatrix: a row of 64
//    pixels a column. Each thread then reads a channel's q = 0 and q = 1
//    rows over 8 pixels, interleaves them (the (q = 0, 1) pair of a pixel is
//    one bf16x2 word) and stores the 32 bytes of output row 2j + p as two
//    16-byte stores (where W is a multiple of 8; else one 4-byte word a
//    pixel), so both p rows of a channel go out as contiguous runs.
// Templated on NB (128, 256) and on A's major-ness.

#include <string.h>

#include "hopper_common.cuh"

namespace {

constexpr int kM = 128;                // input pixels a tile: two 64-pixel panels
constexpr int kKc = 64;                // input channels a chunk (one swizzled row)
constexpr int kThreads = 384;          // producer + two consumer warpgroups
constexpr uint32_t kBoxBytes = 64 * 128;           // a 64 x 64 bf16 box
constexpr uint32_t kChunkBytes = 2 * kBoxBytes;    // a chunk of A: two panels
constexpr int kRound = 64;             // GEMM columns (16 channels) staged at a time
constexpr int kStPitch = 64 + 8;       // staging row (bf16): 64 pixels of one column
constexpr uint32_t kStagingBytes = kRound * kStPitch * 2;  // a consumer warpgroup's
constexpr int kMaxCout = 512;
constexpr int kMaxCin = 512;
constexpr int kMaxStages = 8;
constexpr uint32_t kBiasBytes = kMaxCout * 4;
constexpr uint32_t kBarBytes = 256;
constexpr uint32_t kFixedBytes = 2 * kStagingBytes + kBiasBytes + kBarBytes + 1024;
constexpr uint32_t kSmemMax = 232448;

enum Mode { kModeCM = 0, kModeCL = 1, kModeLoads = 2 };

struct Args {
  const __nv_bfloat16* x;
  long long sx[4];  // (b, c, h, w) strides, elements
  const float* bias;
  const float* ps;  // (B, Cin) or null: no prologue
  const float* pt;
  float slope;
  __nv_bfloat16* y;  // (B, Cout, 2H, 2W), contiguous
  int B, Cin, H, W, Cout, P;
  int mode;
  int kchunks, passes, groups, ppg;
  int tiles_per_image, items;
  int a_slots, b_stages, resident;
  uint32_t a_slot_bytes, a_off, b_off, st_off, bias_off, bar_off;
  int vec;  // 16-byte output stores (W a multiple of 8)
};

struct Item {
  int b, p0, pass0, pass1;
};

__device__ __forceinline__ Item item_at(const Args& a, int i) {
  const int tile = i / a.groups, g = i - tile * a.groups;
  const int b = tile / a.tiles_per_image;
  const int pass0 = g * a.ppg;
  return {b, (tile - b * a.tiles_per_image) * kM, pass0, min(a.passes, pass0 + a.ppg)};
}

__device__ __forceinline__ float leaky(float x, float s, float t, float slope) {
  const float v = fmaf(x, s, t);
  return v >= 0.f ? v : v * slope;
}

// the prologue on one bf16 pair (both values of channel (s, t), or the low
// value with (s0, t0) and the high one with (s1, t1))
__device__ __forceinline__ uint32_t prologue2(uint32_t w, float s0, float t0, float s1, float t1,
                                              float slope) {
  return pack2(leaky(__uint_as_float(w << 16), s0, t0, slope),
               leaky(__uint_as_float(w & 0xFFFF0000u), s1, t1, slope));
}

template <int NB, int kTransA>
__global__ void __launch_bounds__(kThreads, 1)
transpconv2x2_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w, const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw0);
  const uint32_t bars = base + a.bar_off;
  const uint32_t a_full = bars, a_empty = a_full + 16, a_raw = a_empty + 16;
  const uint32_t b_full = a_raw + 16, b_empty = b_full + 8 * kMaxStages;
  const uint32_t stage_bytes = NB * 128;
  const bool pro = a.ps != nullptr;
  // the producer threads write the staged tile themselves (the prologue on a
  // TMA box, or every element by loads), else the TMA copy completes it
  const bool by_threads = pro || a.mode == kModeLoads;
  const int step = gridDim.x;
  const int nmine = (a.items - (int)blockIdx.x + step - 1) / step;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.a_slots; ++s) {
      mbar_init(a_full + 8 * s, by_threads ? 128 : 1);
      mbar_init(a_empty + 8 * s, 256);  // every consumer thread
      mbar_init(a_raw + 8 * s, 1);
    }
    for (int s = 0; s < a.b_stages; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float* bias_s = reinterpret_cast<float*>(sbase + a.bias_off);
  for (int i = threadIdx.x; i < a.passes * NB / 4; i += kThreads)
    bias_s[i] = i < a.Cout ? a.bias[i] : 0.f;
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<40>();
    if (a.resident && tid == 0) {  // the whole weight, once
      for (int s = 0; s < a.b_stages; ++s) {
        mbar_expect_tx(b_full + 8 * s, stage_bytes);
        tma_load(base + a.b_off + s * stage_bytes, &map_w, (s % a.kchunks) * kKc,
                 (s / a.kchunks) * NB, b_full + 8 * s);
      }
    }
    int it = 0;  // weight chunks streamed so far
    for (int k = 0; k < nmine; ++k) {
      const Item t = item_at(a, (int)blockIdx.x + k * step);
      const int slot = k % a.a_slots;
      const uint32_t stile = base + a.a_off + slot * a.a_slot_bytes;
      mbar_wait(a_empty + 8 * slot, ((k / a.a_slots) & 1) ^ 1);
      if (a.mode != kModeLoads) {
        if (tid == 0) {
          const uint32_t bar = (pro ? a_raw : a_full) + 8 * slot;
          mbar_expect_tx(bar, a.kchunks * kChunkBytes);
          for (int c = 0; c < a.kchunks; ++c)
            for (int panel = 0; panel < 2; ++panel) {
              const uint32_t dst = stile + c * kChunkBytes + panel * kBoxBytes;
              if (kTransA)
                tma_load_3d(dst, &map_x, t.p0 + 64 * panel, c * kKc, t.b, bar);
              else
                tma_load_3d(dst, &map_x, c * kKc, t.p0 + 64 * panel, t.b, bar);
            }
        }
        if (pro) {  // the prologue on the staged tile, in place
          mbar_wait(a_raw + 8 * slot, (k / a.a_slots) & 1);
          const float* ps = a.ps + (size_t)t.b * a.Cin;
          const float* pt = a.pt + (size_t)t.b * a.Cin;
          for (int v = tid; v < a.kchunks * 1024; v += 128) {
            const int row = (v >> 3) & 63, chunk = v >> 10;
            uint4* p16 = reinterpret_cast<uint4*>(sbase + (stile - base) + v * 16);
            if (kTransA) {  // a row is one channel's 64 pixels
              const int ch = chunk * kKc + row;
              if (ch >= a.Cin) continue;
              const float s = __ldg(ps + ch), tt = __ldg(pt + ch);
              uint4 w = *p16;
              w.x = prologue2(w.x, s, tt, s, tt, a.slope);
              w.y = prologue2(w.y, s, tt, s, tt, a.slope);
              w.z = prologue2(w.z, s, tt, s, tt, a.slope);
              w.w = prologue2(w.w, s, tt, s, tt, a.slope);
              *p16 = w;
            } else {  // a row is one pixel; 16-byte chunk v % 8 holds group (v % 8) ^ (row % 8)
              const int ch = chunk * kKc + 8 * ((v & 7) ^ (row & 7));
              if (ch >= a.Cin) continue;
              float s[8], tt[8];
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                s[e] = __ldg(ps + ch + e);
                tt[e] = __ldg(pt + ch + e);
              }
              uint4 w = *p16;
              w.x = prologue2(w.x, s[0], tt[0], s[1], tt[1], a.slope);
              w.y = prologue2(w.y, s[2], tt[2], s[3], tt[3], a.slope);
              w.z = prologue2(w.z, s[4], tt[4], s[5], tt[5], a.slope);
              w.w = prologue2(w.w, s[6], tt[6], s[7], tt[7], a.slope);
              *p16 = w;
            }
          }
          fence_proxy_async();
          mbar_arrive(a_full + 8 * slot);
        }
      } else {  // any strides: 8 loads a pixel into the swizzled K-major chunks
        const __nv_bfloat16* xb = a.x + (long long)t.b * a.sx[0];
        for (int v = tid; v < a.kchunks * 1024; v += 128) {
          const int row = (v >> 3) & 63, panel = (v >> 9) & 1, chunk = v >> 10;
          const int ch = chunk * kKc + 8 * ((v & 7) ^ (row & 7));
          const int px = t.p0 + 64 * panel + row;
          uint4 o = make_uint4(0u, 0u, 0u, 0u);
          if (px < a.P && ch < a.Cin) {
            const int j = px / a.W, xx = px - j * a.W;
            const __nv_bfloat16* src = xb + ch * a.sx[1] + j * a.sx[2] + xx * a.sx[3];
            float f[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              f[e] = __bfloat162float(src[e * a.sx[1]]);
              if (pro) f[e] = leaky(f[e], __ldg(a.ps + (size_t)t.b * a.Cin + ch + e),
                                    __ldg(a.pt + (size_t)t.b * a.Cin + ch + e), a.slope);
            }
            o = make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                           pack2(f[6], f[7]));
          }
          *reinterpret_cast<uint4*>(sbase + (stile - base) + v * 16) = o;
        }
        fence_proxy_async();
        mbar_arrive(a_full + 8 * slot);
      }
      if (!a.resident && tid == 0) {  // this item's weight chunks, in use order
        for (int pass = t.pass0; pass < t.pass1; ++pass)
          for (int c = 0; c < a.kchunks; ++c, ++it) {
            const int s = it % a.b_stages;
            mbar_wait(b_empty + 8 * s, ((it / a.b_stages) & 1) ^ 1);
            mbar_expect_tx(b_full + 8 * s, stage_bytes);
            tma_load(base + a.b_off + s * stage_bytes, &map_w, c * kKc, pass * NB, b_full + 8 * s);
          }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns pixels [64 cw, 64 cw + 64) of each tile
  setmaxnreg_inc<232>();
  const int cw = wg - 1, warp = tid / 32, lane = tid % 32;
  const uint32_t st_u32 = base + a.st_off + cw * kStagingBytes;
  const unsigned char* st_ptr = sbase + a.st_off + cw * kStagingBytes;
  const size_t Ho = 2 * (size_t)a.H, Wo = 2 * (size_t)a.W;
  float acc[NB / 2];
  int it = 0;
  for (int k = 0; k < nmine; ++k) {
    const Item t = item_at(a, (int)blockIdx.x + k * step);
    const int slot = k % a.a_slots;
    mbar_wait(a_full + 8 * slot, (k / a.a_slots) & 1);
    const uint32_t a_panel = base + a.a_off + slot * a.a_slot_bytes + cw * kBoxBytes;
    for (int pass = t.pass0; pass < t.pass1; ++pass) {
      for (int c = 0; c < a.kchunks; ++c) {
        int s;
        if (a.resident) {
          s = pass * a.kchunks + c;
          if (k == 0) mbar_wait(b_full + 8 * s, 0);
        } else {
          s = it % a.b_stages;
          mbar_wait(b_full + 8 * s, (it / a.b_stages) & 1);
        }
        const uint32_t a_chunk = a_panel + c * kChunkBytes;
        const uint32_t w_tile = base + a.b_off + s * stage_bytes;
        const int ksteps = min(kKc, a.Cin - c * kKc) / 16;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKc / 16; ++kk) {
          if (kk < ksteps) {
            // M-major A: 16 channels are 16 rows of 64 pixels; K-major A: 16
            // channels are 32 bytes into each pixel's row
            const uint64_t ad = kTransA ? sw128_desc(a_chunk + kk * 16 * 128, kBoxBytes, 1024)
                                        : sw128_desc(a_chunk + kk * 32, 16, 1024);
            wgmma_ss<kTransA>(acc, ad, sw128_desc(w_tile + kk * 32, 16, 1024), c > 0 || kk > 0);
          }
        }
        wgmma_commit();
        if (!a.resident) {
          wgmma_wait<1>();  // the previous chunk's products are done: free its stage
          if (c > 0) mbar_arrive(b_empty + 8 * ((it - 1) % a.b_stages));
          ++it;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (!a.resident) mbar_arrive(b_empty + 8 * ((it - 1) % a.b_stages));
      if (pass + 1 == t.pass1) mbar_arrive(a_empty + 8 * slot);  // A no longer read

      // epilogue: acc[4 j + 2 h + e] is pixel 16 warp + lane / 4 + 8 h of the
      // panel, GEMM column 8 j + 2 (lane % 4) + e of the pass: channel
      // 2 j + (lane % 4) / 2, tap row p = lane % 2, q = e
      const int c_pass = pass * (NB / 4);
#pragma unroll
      for (int round = 0; round < NB / kRound; ++round) {
        named_barrier(2 + cw, 128);  // the staging tile is free
#pragma unroll
        for (int jj = 0; jj < kRound / 8; jj += 2) {
          const int j = round * (kRound / 8) + jj;
          uint32_t r[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float bc = bias_s[c_pass + 2 * (j + m / 2) + (lane % 4) / 2];
            r[m] = pack2(acc[4 * (j + m / 2) + 2 * (m % 2)] + bc,
                         acc[4 * (j + m / 2) + 2 * (m % 2) + 1] + bc);
          }
          const int m = lane / 8;
          stsm_x4_trans(st_u32 + ((8 * (jj + m / 2) + lane % 8) * kStPitch + 16 * warp +
                                  8 * (m % 2)) * 2, r);
        }
        named_barrier(2 + cw, 128);
        // a thread: channel cl, tap row p, 8 pixels from 8 pg of the panel
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = tid + 128 * i, pg = e % 8, p = (e / 8) % 2, cl = e / 16;
          const int ch = c_pass + round * (kRound / 4) + cl;
          const int px = t.p0 + 64 * cw + 8 * pg;
          if (ch >= a.Cout || px >= a.P) continue;
          const int col = 4 * cl + 2 * p;  // staging rows col (q = 0) and col + 1 (q = 1)
          const uint4 q0 = *reinterpret_cast<const uint4*>(st_ptr + (col * kStPitch + 8 * pg) * 2);
          const uint4 q1 =
              *reinterpret_cast<const uint4*>(st_ptr + ((col + 1) * kStPitch + 8 * pg) * 2);
          const uint32_t o[8] = {__byte_perm(q0.x, q1.x, 0x5410), __byte_perm(q0.x, q1.x, 0x7632),
                                 __byte_perm(q0.y, q1.y, 0x5410), __byte_perm(q0.y, q1.y, 0x7632),
                                 __byte_perm(q0.z, q1.z, 0x5410), __byte_perm(q0.z, q1.z, 0x7632),
                                 __byte_perm(q0.w, q1.w, 0x5410), __byte_perm(q0.w, q1.w, 0x7632)};
          __nv_bfloat16* yc = a.y + ((size_t)t.b * a.Cout + ch) * Ho * Wo;
          if (a.vec) {  // 8 pixels of one input row: 32 bytes of output row 2 j + p
            const int j = px / a.W, xx = px - j * a.W;
            uint4* dst = reinterpret_cast<uint4*>(yc + (2 * j + p) * Wo + 2 * xx);
            dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
            dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
          } else {
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              if (px + u < a.P) {
                const int j = (px + u) / a.W, xx = px + u - j * a.W;
                *reinterpret_cast<uint32_t*>(yc + (2 * j + p) * Wo + 2 * xx) = o[u];
              }
            }
          }
        }
      }
    }
  }
}

// a 3-D (inner, outer, images) map of the input read in 64 x 64 boxes with
// the 128-byte swizzle; strides in bytes; 0 or a cudaError_t
int input_map(CUtensorMap* map, const void* x, cuuint64_t inner, cuuint64_t outer, int B,
              cuuint64_t outer_stride, cuuint64_t image_stride) {
  const cuuint64_t dims[3] = {inner, outer, (cuuint64_t)B};
  const cuuint64_t strides[2] = {outer_stride, image_stride};
  const cuuint32_t box[3] = {64, 64, 1};
  return bf16_sw128_map(map, x, 3, dims, strides, box);
}

template <int NB, int kTransA>
int launch(Args a, const void* w, int npad, cudaStream_t stream) {
  CUtensorMap mx, mw;
  memset(&mx, 0, sizeof(mx));
  memset(&mw, 0, sizeof(mw));
  const long long* st = a.sx;
  if (a.mode != kModeLoads) {
    // the image stride of a single image is never used; any legal one does
    const bool cm = a.mode == kModeCM;
    const cuuint64_t inner = cm ? a.P : a.Cin, outer = cm ? a.Cin : a.P;
    const cuuint64_t outer_stride = (cuuint64_t)(cm ? st[1] : st[3]) * 2;
    const cuuint64_t image_stride = a.B > 1 ? (cuuint64_t)st[0] * 2 : outer_stride * outer;
    const int err = input_map(&mx, a.x, inner, outer, a.B, outer_stride, image_stride);
    if (err != 0) return err;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)a.Cin, (cuuint64_t)npad};
    const cuuint64_t strides[1] = {(cuuint64_t)a.Cin * 2};
    const cuuint32_t box[2] = {64, NB};
    const int err = bf16_sw128_map(&mw, w, 2, dims, strides, box);
    if (err != 0) return err;
  }
  static unsigned long long ready = 0;  // one bit a device
  const cudaError_t err = set_smem_once(transpconv2x2_kernel<NB, kTransA>, (int)kSmemMax, &ready);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;

  // the plan: pass groups so that the items fill the card, then the A ring
  // and the weight (resident where all of it fits, else a ring of stages)
  a.kchunks = (a.Cin + kKc - 1) / kKc;
  a.passes = npad / NB;
  a.tiles_per_image = (a.P + kM - 1) / kM;
  const long long tiles = (long long)a.B * a.tiles_per_image;
  int want = tiles >= sms ? 1 : (int)((sms + tiles - 1) / tiles);
  if (want > a.passes) want = a.passes;
  a.ppg = (a.passes + want - 1) / want;
  a.groups = (a.passes + a.ppg - 1) / a.ppg;
  if (tiles * a.groups > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  a.items = (int)(tiles * a.groups);
  a.a_slot_bytes = a.kchunks * kChunkBytes;
  const uint32_t stage = NB * 128, room = kSmemMax - kFixedBytes;
  const int chunks = a.passes * a.kchunks;
  a.resident = a.groups == 1 && chunks <= kMaxStages && a.a_slot_bytes + chunks * stage <= room;
  if (a.resident) {
    a.b_stages = chunks;
    a.a_slots = 2 * a.a_slot_bytes + chunks * stage <= room ? 2 : 1;
  } else {
    a.a_slots = 2 * a.a_slot_bytes + 2 * stage <= room ? 2 : 1;
    a.b_stages = (int)((room - a.a_slots * a.a_slot_bytes) / stage);
    if (a.b_stages > 4) a.b_stages = 4;
    if (a.b_stages < 2) return (int)cudaErrorInvalidValue;
  }
  a.a_off = 0;
  a.b_off = a.a_slots * a.a_slot_bytes;
  a.st_off = a.b_off + a.b_stages * stage;
  a.bias_off = a.st_off + 2 * kStagingBytes;
  a.bar_off = a.bias_off + kBiasBytes;
  const uint32_t total = a.bar_off + kBarBytes + 1024;
  const int grid = a.items < sms ? a.items : sms;
  transpconv2x2_kernel<NB, kTransA><<<grid, kThreads, total, stream>>>(mx, mw, a);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, Cin, H, W) bf16 through its (b, c, h, w) strides; w the packed weight
// (npad, Cin) bf16 (row 4 c + 2 p + q = w[:, c, p, q], zero rows past 4 Cout;
// npad a multiple of 128 if 4 Cout <= 128, else of 256); bias (Cout,) fp32; s
// and t (B, Cin) fp32 or null; y (B, Cout, 2H, 2W) bf16, contiguous
extern "C" int transpconv2x2(const void* x, int sxb, int sxc, int sxh, int sxw, const void* w,
                             int npad, const void* bias, const void* ps, const void* pt,
                             float slope, void* y, int B, int Cin, int H, int W, int Cout,
                             void* stream) {
  const int nb = 4 * Cout <= 128 ? 128 : 256;
  if (B < 1 || H < 1 || W < 1 || Cin < 16 || Cin % 16 || Cin > kMaxCin || Cout < 4 ||
      Cout % 4 || Cout > kMaxCout || npad % nb || npad < 4 * Cout || (long long)H * W > 0x7FFFFFFF ||
      !aligned16(w) || (ps == nullptr) != (pt == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  memset(&a, 0, sizeof(a));
  a.x = static_cast<const __nv_bfloat16*>(x);
  const long long sx[4] = {sxb, sxc, sxh, sxw};
  for (int i = 0; i < 4; ++i) a.sx[i] = sx[i];
  a.bias = static_cast<const float*>(bias);
  a.ps = static_cast<const float*>(ps);
  a.pt = static_cast<const float*>(pt);
  a.slope = slope;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.B = B;
  a.Cin = Cin;
  a.H = H;
  a.W = W;
  a.Cout = Cout;
  a.P = H * W;
  // TMA takes 16-byte-aligned bases and strides; rows must follow each
  // other so that a channel's (or a pixel's) plane is one run
  const bool base_ok = aligned16(x) && (B == 1 || (sxb > 0 && sxb % 8 == 0));
  const bool cm = base_ok && sxw == 1 && (H == 1 || sxh == W) && sxc > 0 && sxc % 8 == 0;
  const bool cl = base_ok && sxc == 1 && sxw > 0 && sxw % 8 == 0 && (H == 1 || sxh == (long long)W * sxw);
  a.mode = cm ? kModeCM : cl ? kModeCL : kModeLoads;
  a.vec = W % 8 == 0 && aligned16(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb == 128)
    return cm ? launch<128, 1>(a, w, npad, s) : launch<128, 0>(a, w, npad, s);
  return cm ? launch<256, 1>(a, w, npad, s) : launch<256, 0>(a, w, npad, s);
}
