// 3x3 SAME convolution with an InstanceNorm/BatchNorm-apply prologue and an
// InstanceNorm-statistics epilogue, over one or two inputs, for sm_90a.
//
// Replaces two TPU kernels:
//   dinounet_tpu/ops/decoder_tail_pallas.py _conv_kernel / _conv_kernel_merged
//     (called by conv3x3_cm): channel-major (B, C, H, W) maps;
//   dinounet_tpu/ops/conv_hwbc_pallas.py _conv_kernel (called by conv3x3_hwbc):
//     (H, W, B, C) maps, conv0's two inputs [transpconv_out, skip].
// Both compute, per output pixel (b, h, w) and output channel co,
//   x'  = bf16(leaky(x * s[b, ci] + t[b, ci]))      (no prologue: x' = x)
//   x'  = 0 outside the image                       (padding AFTER the prologue:
//                                                    leaky(0 * s + t) != 0)
//   y   = bf16(sum_{dy, dx, ci} x'[ci, h+dy-1, w+dx-1] w[dy, dx, ci, co] + b[co])
//   sum[b, co] += y, ssq[b, co] += y * y             (of the rounded bf16 y)
// The Pallas bodies' row stripes, 8-row halo windows, lane merges and edge
// masks exist for Mosaic's (8, 128) tiling; none of that is carried over.
// One kernel serves both layouts: it reads the inputs and writes the output
// through the (b, c, h, w) strides it is given, so an (H, W, B, C) view of an
// NCHW map needs no transpose, and the two-input form runs its reduction
// over x's channels, then x2's, so the concatenation never exists.
//
// What bounds it on an H100 (the serve routes' convs at batch 8; bound =
// max(bytes each input read once and the output written once / 3.35 TB/s,
// FLOP / 989 TFLOP/s)):
//   decoder conv0 512^2, 32 + 32 -> 32   0.120 ms (bytes)
//   decoder conv1 512^2, 32 -> 32        0.080 ms (bytes)
//   decoder conv0 256^2, 64 + 64 -> 64   0.078 ms (operations)
//   decoder conv1 256^2, 64 -> 64        0.040 ms (bytes; SPM stem2 / stem3 too)
//   decoder conv0 128^2, 128 + 128 -> 128  0.078 ms (operations)
//   decoder conv1 128^2, 128 -> 128      0.039 ms (operations)
// Inside the SM, shared memory comes first: every tap reads its A operand
// from the staged tile again (at Cout 32 a 64 x 16 x 32 product reads 3 KB,
// more than the 128 bytes a clock shared memory gives at the tensor cores'
// rate), and the staging itself (the TMA box in, the transposed tile out)
// and the epilogue pass through it too. Timed alone at conv0 512^2 the TMA
// loads, the loader's transform and the products each take about 0.14 ms
// and the epilogue 0.09 (kernel_variants.py's conv_*_only variants); they
// overlap only in part, so the kernel takes about twice its bound.
//
// Design: an implicit GEMM on wgmma (M = output pixels, N = Cout, K = 9 Cin).
// 1. A block walks tiles of 4 output rows x 128 columns of one image (2 x 128
//    at Cout 128, so that the accumulators fit; a persistent grid, one block
//    an SM, tiles strided by the grid so that the blocks running together
//    work on neighbouring rows and share their halo rows in L2). Each of two
//    consumer warpgroups owns half the tile's 64-pixel row segments; its
//    accumulators stay in registers over the whole reduction.
// 2. The reduction runs over chunks of 16 input channels. For each chunk a
//    loader warpgroup stages the (rows + 2) x 130 halo tile in wgmma's
//    no-swizzle K-major layout: for each group of 8 channels the halo pixels
//    one after another, 16 bytes each. The A operand of tap (dy, dx) for the
//    segment at (r, c0) is then the same tile read through a descriptor
//    whose start moves 16 bytes a column and 130 * 16 bytes a row
//    (SBO 128: 8 pixels; LBO: one channel group), so the nine taps are nine
//    m64nCoutk16 products over one staged tile, with no im2col copy.
// 3. Where the input's strides allow (W innermost, rows, channels and images
//    16-byte multiples), one thread brings each chunk's raw (16, rows + 2,
//    144) box of the channel-major map in by TMA (4-D map over (w, h, c, b),
//    out-of-image positions zero-filled) into a ring of two raw stages; the
//    loader warpgroup then turns it into the staged tile: it reads two
//    pixels of 8 channels (8 4-byte loads), applies the prologue in fp32,
//    rounds to bf16, zeroes what lies outside the image (the fill comes
//    before the prologue, and leaky(0 * s + t) != 0) and stores two 16-byte
//    pixels. That is the transpose a channel-major map needs in any case.
//    Elsewhere (W 37 or 130, an (H, W, B, C) buffer with C innermost) the
//    loader reads the 8 channels of a pixel through the strides itself.
// 4. The weight, packed by the wrapper into the B operand's no-swizzle
//    K-major layout (Cin / 8, 9, Cout, 8), comes a chunk's 9 x 16 x Cout
//    slice at a time with the staged tile it multiplies (one bulk copy, from
//    L2: 9 KB a chunk at Cout 32, 37 KB at Cout 128). The whole weight kept
//    in shared memory for a block's walk, where it fits, timed no faster.
// 5. The epilogue adds the fp32 bias, rounds once to bf16 and stages a
//    segment's (channel, pixel) tile in shared memory, the accumulator
//    fragment's 8 x 8 blocks stored transposed by stmatrix; each thread then
//    stores 8 pixels of one channel (16 bytes where W and y's strides allow,
//    else element by element), sums the stored values and their squares for
//    its channels over the block's tiles of one image, and adds them to the
//    (B, Cout) fp32 sums with one atomic a warp and channel when the image
//    changes (the C entry zeroes the sums by one memset first). The
//    atomics' order changes from run to run, so the sums agree with a
//    sequential sum to fp32 rounding.
// Templated on Cout (16, 32, 64, 128).

#include <string.h>

#include "hopper_common.cuh"

namespace {

constexpr int kKc = 16;             // input channels a chunk: one k16 step of each tap
constexpr int kTileW = 128;         // output columns a tile: two 64-pixel segments
constexpr int kHaloW = kTileW + 2;  // staged columns
constexpr int kRawW = kTileW + 16;  // TMA box columns from max(w0 - 8, 0)
constexpr int kPairs = kHaloW / 2 + 1;  // column pairs (2q - 1, 2q) covering a staged row
constexpr int kRawStages = 2;       // ring of raw TMA boxes
constexpr int kStages = 3;          // ring of staged tiles (and streamed weight chunks)
constexpr int kThreads = 384;       // loader warpgroup + two consumer warpgroups
constexpr int kOutPitch = 64 + 8;   // output staging row (bf16): 64 pixels of one channel
constexpr bool kPersistent = true;  // one block an SM walking tiles, else one tile a block
constexpr uint32_t kSmemMax = 232448;

template <int kCout>
struct Plan {
  static constexpr int kRows = kCout <= 64 ? 4 : 2;  // output rows a tile
  static constexpr int kHaloRows = kRows + 2;
  static constexpr int kSegs = kRows;  // 64-pixel segments a consumer warpgroup
  static constexpr uint32_t kRawBytes = kKc * kHaloRows * kRawW * 2;
  static constexpr uint32_t kGroupBytes = kHaloRows * kHaloW * 16;  // 8 channels of the halo
  static constexpr uint32_t kStagedBytes = (kKc / 8) * kGroupBytes;
  static constexpr uint32_t kWChunkBytes = 9 * kKc * kCout * 2;
  static constexpr int kCoRound = kCout < 64 ? kCout : 64;  // channels a staging round
  static constexpr uint32_t kOutBytes = 2 * kCoRound * kOutPitch * 2;
};

// shared-memory plan, byte offsets from a 1024-byte-aligned base
struct Smem {
  uint32_t raw, staged, stage, out, bias, bars, total;
};

template <int kCout>
__host__ __device__ constexpr Smem smem_plan() {
  using P = Plan<kCout>;
  Smem s{};
  s.raw = 0;
  s.staged = kRawStages * P::kRawBytes;
  s.stage = P::kStagedBytes + P::kWChunkBytes;  // a staged tile and its weight slice
  s.out = s.staged + kStages * s.stage;
  s.bias = s.out + P::kOutBytes;
  s.bars = s.bias + 512;
  s.total = s.bars + 128 + 1024;
  return s;
}

// d (64 x N fp32) = a (64 x 16) b (16 x N) [+ d], both operands K-major in
// shared memory
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
  }
};

// no-swizzle wgmma descriptor: start address, leading byte offset (between
// the two 8-deep halves of a 16-deep K step) and stride byte offset (between
// 8-row groups), all multiples of 16 bytes
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32;
}

// a box of a 4-D tensor map at (c0 innermost, .., c3) into shared memory
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) from global memory into shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// announce bytes a copy will deliver, without arriving
__device__ __forceinline__ void mbar_expect_tx_only(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// four 8 x 8 bf16 blocks of a fragment stored transposed: lane l gives
// the address of row l % 8 of block l / 8
__device__ __forceinline__ void stsm_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

__device__ __forceinline__ float prologue(float x, float s, float t, float slope) {
  const float v = fmaf(x, s, t);
  return v >= 0.f ? v : v * slope;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* x2;
  int c1, c2;
  long long sx[4], s2[4];  // (b, c, h, w) strides, elements
  const __nv_bfloat16* w;  // packed (Cin / 8, 9, Cout, 8)
  const float* bias;       // (Cout,)
  const float* ps;         // (B, Cin) or null: no prologue
  const float* pt;
  float slope;
  __nv_bfloat16* y;
  long long sy[4];
  float* sum;  // (B, Cout) or null: no statistics
  float* ssq;
  int B, H, W;
  int tma;       // both inputs through their tensor maps, else the loader's own loads
  int vec_out;   // y's rows take 16-byte stores
  int tiles_w, tiles_h, ntiles;
};

struct Tile {
  int b, h0, w0;
};

template <int kRows>
__device__ __forceinline__ Tile tile_at(const Args& a, int t) {
  const int tw = t % a.tiles_w;
  const int rest = t / a.tiles_w;
  return {rest / a.tiles_h, (rest % a.tiles_h) * kRows, tw * kTileW};
}

template <int kCout>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_x2, const __grid_constant__ Args a) {
  using P = Plan<kCout>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw0);
  const int cin = a.c1 + a.c2;
  const Smem sm = smem_plan<kCout>();
  const uint32_t raw_full = base + sm.bars;
  const uint32_t full = raw_full + 8 * kRawStages, empty = full + 8 * kStages;
  const int nch = cin / kKc;
  const int step = gridDim.x;
  const int nmine = (a.ntiles - (int)blockIdx.x + step - 1) / step;
  const int total = nmine * nch;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRawStages; ++s) mbar_init(raw_full + 8 * s, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 128);   // every loader thread
      mbar_init(empty + 8 * s, 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float* bias_s = reinterpret_cast<float*>(sbase + sm.bias);
  if (threadIdx.x >= 128 && threadIdx.x - 128 < kCout) bias_s[threadIdx.x - 128] = a.bias[threadIdx.x - 128];
  __syncthreads();

  if (wg == 0) {  // loader
    setmaxnreg_dec<96>();
    // thread 0 keeps the raw boxes of the next kRawStages iterations in
    // flight (iteration it: tile it / nch of the walk, chunk it % nch)
    if (a.tma && tid == 0) {
      for (int it = 0; it < kRawStages && it < total; ++it) {
        const Tile tl = tile_at<P::kRows>(a, (int)blockIdx.x + (it / nch) * step);
        const int ch = (it % nch) * kKc;
        const uint32_t dst = base + sm.raw + it * P::kRawBytes, bar = raw_full + 8 * it;
        mbar_expect_tx(bar, P::kRawBytes);
        if (ch < a.c1)
          tma_load_4d(dst, &map_x, max(tl.w0 - 8, 0), max(tl.h0 - 1, 0), ch, tl.b, bar);
        else
          tma_load_4d(dst, &map_x2, max(tl.w0 - 8, 0), max(tl.h0 - 1, 0), ch - a.c1, tl.b, bar);
      }
    }
    const int gl = tid / 64, lt = tid % 64;  // this thread's 8-channel group of a chunk
    const bool pro = a.ps != nullptr;
    // the prologue's (s, t) of this thread's 8 channels, one iteration ahead
    float s[8], t[8], sn[8], tn[8];
    auto fetch_st = [&](int it, float (&fs)[8], float (&ft)[8]) {
      if (!pro || it >= total) return;
      const Tile tl = tile_at<P::kRows>(a, (int)blockIdx.x + (it / nch) * step);
      const size_t o = (size_t)tl.b * cin + (it % nch) * kKc + gl * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        fs[j] = __ldg(a.ps + o + j);
        ft[j] = __ldg(a.pt + o + j);
      }
    };
    fetch_st(0, sn, tn);
    for (int it = 0; it < total; ++it) {
      const Tile tl = tile_at<P::kRows>(a, (int)blockIdx.x + (it / nch) * step);
      const int c = it % nch, ss = it % kStages;
      const uint32_t stage = base + sm.staged + ss * sm.stage;
      const int ch0 = c * kKc + gl * 8;  // index in the concatenated channels
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j] = sn[j];
        t[j] = tn[j];
      }
      fetch_st(it + 1, sn, tn);
      mbar_wait(empty + 8 * ss, ((it / kStages) & 1) ^ 1);
      if (tid == 0) {
        mbar_expect_tx_only(full + 8 * ss, P::kWChunkBytes);
        bulk_load(stage + P::kStagedBytes, a.w + (size_t)c * (P::kWChunkBytes / 2),
                  P::kWChunkBytes, full + 8 * ss);
      }
      const uint32_t dst = stage + gl * P::kGroupBytes;
      uint4* __restrict__ stg = reinterpret_cast<uint4*>(sbase + (dst - base));
      if (a.tma) {
        const int rs = it % kRawStages;
        mbar_wait(raw_full + 8 * rs, (it / kRawStages) & 1);
        const uint32_t* __restrict__ raw = reinterpret_cast<const uint32_t*>(
            sbase + sm.raw + rs * P::kRawBytes + gl * 8 * P::kHaloRows * kRawW * 2);
        // the box starts at row max(h0 - 1, 0), column max(w0 - 8, 0): halo
        // row hr is box row hr - dr, halo column hc box column hc + dc
        const int dr = tl.h0 > 0 ? 0 : 1, dc = tl.w0 > 0 ? 7 : -1;
#pragma unroll 2
        for (int i = lt; i < P::kHaloRows * kPairs; i += 64) {
          const int hr = i / kPairs, q = i - hr * kPairs;
          const int rr = hr - dr, rc = 2 * q - 1 + dc;  // box row and column of (hr, 2q - 1)
          // halo columns 2q - 1 and 2q; what the box does not hold lies
          // outside the image
          // (rc is even: one 4-byte word holds both columns of a channel;
          // the channels' words lie a constant apart)
          const bool in_box = rr >= 0 && rc >= 0;
          const uint32_t* __restrict__ px = raw + (in_box ? (uint32_t)(rr * kRawW + rc) / 2 : 0u);
          uint32_t v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = in_box ? px[j * (P::kHaloRows * kRawW / 2)] : 0u;
          uint4 o0, o1;
          if (pro) {
            const int hh = tl.h0 - 1 + hr, ww = tl.w0 - 2 + 2 * q;
            const bool rv = hh >= 0 && hh < a.H;
            // all 16 values computed, then masked: a branch a value would
            // serialise the loader's dependent chains
            const uint32_t m0 = rv && ww >= 0 && ww < a.W ? ~0u : 0u;
            const uint32_t m1 = rv && ww + 1 >= 0 && ww + 1 < a.W ? ~0u : 0u;
            uint32_t lo[4], hi[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const uint32_t e0 = v[2 * k], e1 = v[2 * k + 1];
              lo[k] = m0 & pack2(prologue(__uint_as_float(e0 << 16), s[2 * k], t[2 * k], a.slope),
                                 prologue(__uint_as_float(e1 << 16), s[2 * k + 1], t[2 * k + 1],
                                          a.slope));
              hi[k] = m1 & pack2(prologue(__uint_as_float(e0 & 0xFFFF0000u), s[2 * k], t[2 * k],
                                          a.slope),
                                 prologue(__uint_as_float(e1 & 0xFFFF0000u), s[2 * k + 1],
                                          t[2 * k + 1], a.slope));
            }
            o0 = make_uint4(lo[0], lo[1], lo[2], lo[3]);
            o1 = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          } else {  // the box's zero fill is the padding
            o0 = make_uint4(__byte_perm(v[0], v[1], 0x5410), __byte_perm(v[2], v[3], 0x5410),
                            __byte_perm(v[4], v[5], 0x5410), __byte_perm(v[6], v[7], 0x5410));
            o1 = make_uint4(__byte_perm(v[0], v[1], 0x7632), __byte_perm(v[2], v[3], 0x7632),
                            __byte_perm(v[4], v[5], 0x7632), __byte_perm(v[6], v[7], 0x7632));
          }
          if (q > 0) stg[hr * kHaloW + 2 * q - 1] = o0;
          if (q < kPairs - 1) stg[hr * kHaloW + 2 * q] = o1;
        }
      } else {  // any strides: 8 loads a pixel
        const bool first = ch0 < a.c1;
        const long long* st = first ? a.sx : a.s2;
        const __nv_bfloat16* src = (first ? a.x : a.x2) + tl.b * st[0] +
                                   (long long)(first ? ch0 : ch0 - a.c1) * st[1];
        for (int i = lt; i < P::kHaloRows * kHaloW; i += 64) {
          const int hr = i / kHaloW, hc = i - hr * kHaloW;
          const int hh = tl.h0 - 1 + hr, ww = tl.w0 - 1 + hc;
          uint4 o = make_uint4(0u, 0u, 0u, 0u);  // the padding, after the prologue
          if (hh >= 0 && hh < a.H && ww >= 0 && ww < a.W) {
            const __nv_bfloat16* px = src + hh * st[2] + ww * st[3];
            float f[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              f[j] = __bfloat162float(px[j * st[1]]);
              if (pro) f[j] = prologue(f[j], s[j], t[j], a.slope);
            }
            o = make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                           pack2(f[6], f[7]));
          }
          stg[i] = o;
        }
      }
      fence_proxy_async();
      mbar_arrive(full + 8 * ss);
      if (a.tma) {
        named_barrier(1, 128);  // every loader thread is done with the raw stage
        const int nx = it + kRawStages;
        if (tid == 0 && nx < total) {
          const Tile tn = tile_at<P::kRows>(a, (int)blockIdx.x + (nx / nch) * step);
          const int ch = (nx % nch) * kKc;
          const uint32_t dst = base + sm.raw + (nx % kRawStages) * P::kRawBytes;
          const uint32_t bar = raw_full + 8 * (nx % kRawStages);
          mbar_expect_tx(bar, P::kRawBytes);
          if (ch < a.c1)
            tma_load_4d(dst, &map_x, max(tn.w0 - 8, 0), max(tn.h0 - 1, 0), ch, tn.b, bar);
          else
            tma_load_4d(dst, &map_x2, max(tn.w0 - 8, 0), max(tn.h0 - 1, 0), ch - a.c1, tn.b, bar);
        }
      }
    }
    return;
  }

  // consumers
  setmaxnreg_inc<200>();
  const int cw = wg - 1, warp = tid / 32, lane = tid % 32;
  constexpr int kStat = kCout / 16;  // channels whose sums a thread keeps
  constexpr int kPerRound = P::kCoRound / 16;
  float acc[P::kSegs][kCout / 2];
  float st_s[kStat], st_q[kStat];
#pragma unroll
  for (int i = 0; i < kStat; ++i) st_s[i] = st_q[i] = 0.f;
  __nv_bfloat16* ost =
      reinterpret_cast<__nv_bfloat16*>(sbase + sm.out) + cw * P::kCoRound * kOutPitch;
  const uint32_t ost_u32 = smem_u32(ost);
  int it = 0;
  for (int k = 0; k < nmine; ++k) {
    const int tix = (int)blockIdx.x + k * step;
    const Tile tl = tile_at<P::kRows>(a, tix);
    for (int c = 0; c < nch; ++c, ++it) {
      const int ss = it % kStages;
      mbar_wait(full + 8 * ss, (it / kStages) & 1);
      const uint32_t stage = base + sm.staged + ss * sm.stage;
      const uint32_t wch = stage + P::kStagedBytes;
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        const uint64_t bd = plain_desc(wch + tap * kCout * 16, 9 * kCout * 16, 128);
#pragma unroll
        for (int sg = 0; sg < P::kSegs; ++sg) {
          const int seg = cw * P::kSegs + sg, r = seg / 2, hs = seg % 2;
          const uint64_t ad =
              plain_desc(stage + ((r + ky) * kHaloW + hs * 64 + kx) * 16, P::kGroupBytes, 128);
          Wgmma<kCout>::run(acc[sg], ad, bd, c > 0 || tap > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products are done: free its stage
      if (c > 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int sg = 0; sg < P::kSegs; ++sg) fence_regs(acc[sg]);
    mbar_arrive(empty + 8 * ((it - 1) % kStages));

    // epilogue: acc[sg][4 j + 2 h + e] is pixel 16 warp + lane / 4 + 8 h of
    // the segment, channel 8 j + 2 (lane % 4) + e
#pragma unroll
    for (int sg = 0; sg < P::kSegs; ++sg) {
      const int seg = cw * P::kSegs + sg, r = seg / 2, hs = seg % 2;
      const int row = tl.h0 + r, col0 = tl.w0 + hs * 64;
#pragma unroll
      for (int round = 0; round < kCout / P::kCoRound; ++round) {
        named_barrier(2 + cw, 128);  // the staging tile is free
        // the fragment's 8 x 8 (pixel, channel) blocks (j, h), biased and
        // rounded, go out transposed by stmatrix: rows of 8 pixels of one
        // channel; lane l addresses row l % 8 of block l / 8
#pragma unroll
        for (int jj = 0; jj < P::kCoRound / 8; jj += 2) {
          const int j = round * (P::kCoRound / 8) + jj;
          uint32_t r[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float* bc = bias_s + 8 * (j + m / 2) + 2 * (lane % 4);
            r[m] = pack2(acc[sg][4 * (j + m / 2) + 2 * (m % 2)] + bc[0],
                         acc[sg][4 * (j + m / 2) + 2 * (m % 2) + 1] + bc[1]);
          }
          const int m = lane / 8;
          stsm_x4_trans(ost_u32 + ((8 * (jj + m / 2) + lane % 8) * kOutPitch + 16 * warp +
                                   8 * (m % 2)) * 2, r);
        }
        named_barrier(2 + cw, 128);
        // 8 pixels of one channel a thread: channels tid / 8 + 16 q
#pragma unroll
        for (int q = 0; q < kPerRound; ++q) {
          const int col8 = tid % 8, co_l = tid / 8 + 16 * q;
          const int co = round * P::kCoRound + co_l;
          const int colx = col0 + 8 * col8;
          const int nv = row < a.H ? min(max(a.W - colx, 0), 8) : 0;
          if (nv > 0) {
            uint4 v;
            asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                         : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                         : "r"(ost_u32 + (co_l * kOutPitch + 8 * col8) * 2));
            const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&v);
            __nv_bfloat16* dstp = a.y + tl.b * a.sy[0] + co * a.sy[1] + row * a.sy[2] + colx * a.sy[3];
            float s1 = 0.f, s2 = 0.f;
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              if (u < nv) {
                const float f = __bfloat162float(e8[u]);
                s1 += f;
                s2 += f * f;
              }
            }
            st_s[round * kPerRound + q] += s1;
            st_q[round * kPerRound + q] += s2;
            if (a.vec_out && nv == 8) {
              *reinterpret_cast<uint4*>(dstp) = v;
            } else {
#pragma unroll
              for (int u = 0; u < 8; ++u)
                if (u < nv) dstp[u * a.sy[3]] = e8[u];
            }
          }
        }
      }
    }
    // the statistics, once the walk leaves this image
    if (a.sum != nullptr &&
        (k + 1 == nmine || tile_at<P::kRows>(a, tix + step).b != tl.b)) {
#pragma unroll
      for (int i = 0; i < kStat; ++i) {
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) {
          st_s[i] += __shfl_xor_sync(0xffffffffu, st_s[i], off);
          st_q[i] += __shfl_xor_sync(0xffffffffu, st_q[i], off);
        }
        if (lane % 8 == 0) {
          const int co = (i / kPerRound) * P::kCoRound + tid / 8 + 16 * (i % kPerRound);
          atomicAdd(a.sum + tl.b * kCout + co, st_s[i]);
          atomicAdd(a.ssq + tl.b * kCout + co, st_q[i]);
        }
        st_s[i] = st_q[i] = 0.f;
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// a 4-D (w, h, c, b) map of a channel-major input, read in (kRawW, rows, 16,
// 1) boxes without swizzle; 0 or a cudaError_t
int input_map(CUtensorMap* map, const void* x, const long long* st, int C, int B, int H, int W,
              int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)C, (cuuint64_t)B};
  const cuuint64_t sb = B > 1 ? (cuuint64_t)st[0] * 2 : (cuuint64_t)st[1] * 2 * C;
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2, sb};
  const cuuint32_t box[4] = {(cuuint32_t)kRawW, (cuuint32_t)rows, (cuuint32_t)kKc, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                            strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// TMA takes an input whose W is innermost and whose other strides and base
// are 16-byte multiples
bool tma_ok(const void* p, const long long* st, int B) {
  return p != nullptr && aligned16(p) && st[3] == 1 && st[2] > 0 && st[1] > 0 &&
         st[2] % 8 == 0 && st[1] % 8 == 0 && (B == 1 || (st[0] > 0 && st[0] % 8 == 0));
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int& n = count[dev & 63];
  if (n == 0 && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    n = 0;
  return n;
}

template <int kCout>
int launch(Args a, cudaStream_t stream) {
  using P = Plan<kCout>;
  const Smem sm = smem_plan<kCout>();
  static_assert(smem_plan<kCout>().total <= kSmemMax, "shared-memory plan");
  a.tiles_w = (a.W + kTileW - 1) / kTileW;
  a.tiles_h = (a.H + P::kRows - 1) / P::kRows;
  const long long ntiles = (long long)a.B * a.tiles_w * a.tiles_h;
  if (ntiles > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  a.ntiles = (int)ntiles;
  CUtensorMap mx, m2;
  memset(&mx, 0, sizeof(mx));
  memset(&m2, 0, sizeof(m2));
  if (a.tma) {
    int err = input_map(&mx, a.x, a.sx, a.c1, a.B, a.H, a.W, P::kHaloRows);
    if (err != 0) return err;
    if (a.c2 > 0) {
      err = input_map(&m2, a.x2, a.s2, a.c2, a.B, a.H, a.W, P::kHaloRows);
      if (err != 0) return err;
    }
  }
  static unsigned long long ready = 0;  // one bit a device
  const cudaError_t err = set_smem_once(conv3x3_kernel<kCout>, (int)kSmemMax, &ready);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  if (a.sum != nullptr) {  // the sums start at zero: one memset where ssq follows sum
    const size_t n = (size_t)a.B * kCout;
    const bool joint = a.ssq == a.sum + n;
    cudaError_t e = cudaMemsetAsync(a.sum, 0, (joint ? 2 : 1) * n * sizeof(float), stream);
    if (e == cudaSuccess && !joint) e = cudaMemsetAsync(a.ssq, 0, n * sizeof(float), stream);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = kPersistent && a.ntiles > sms ? sms : a.ntiles;
  conv3x3_kernel<kCout><<<grid, kThreads, sm.total, stream>>>(mx, m2, a);
  return (int)cudaGetLastError();
}

}  // namespace

// x, x2 (B, C1 / C2, H, W) through their (b, c, h, w) strides, w the packed
// weight (Cin / 8, 9, Cout, 8) bf16, bias (Cout,) fp32, s and t (B, Cin) fp32
// or null, y (B, Cout, H, W) through its strides, sum and ssq (B, Cout) fp32
// (zeroed here before the launch; null: no statistics)
extern "C" int conv3x3_stats(const void* x, const void* x2, int c1, int c2,
                             int sxb, int sxc, int sxh, int sxw,
                             int s2b, int s2c, int s2h, int s2w,
                             const void* w, const void* bias, const void* ps,
                             const void* pt, float slope, void* y,
                             int syb, int syc, int syh, int syw,
                             void* sum, void* ssq, int B, int H, int W, int cout,
                             void* stream) {
  if (B < 1 || H < 1 || W < 1 || c1 < kKc || c1 % kKc || c2 < 0 || c2 % kKc ||
      (c2 > 0 && x2 == nullptr) || !aligned16(w) || (sum == nullptr) != (ssq == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  memset(&a, 0, sizeof(a));
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.x2 = static_cast<const __nv_bfloat16*>(x2);
  a.c1 = c1;
  a.c2 = c2;
  const long long sx[4] = {sxb, sxc, sxh, sxw}, s2[4] = {s2b, s2c, s2h, s2w};
  const long long sy[4] = {syb, syc, syh, syw};
  for (int i = 0; i < 4; ++i) {
    a.sx[i] = sx[i];
    a.s2[i] = s2[i];
    a.sy[i] = sy[i];
  }
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.ps = static_cast<const float*>(ps);
  a.pt = static_cast<const float*>(pt);
  a.slope = slope;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.sum = static_cast<float*>(sum);
  a.ssq = static_cast<float*>(ssq);
  a.B = B;
  a.H = H;
  a.W = W;
  a.tma = tma_ok(x, a.sx, B) && (c2 == 0 || tma_ok(x2, a.s2, B));
  a.vec_out = syw == 1 && aligned16(y) && syh % 8 == 0 && syc % 8 == 0 &&
              (B == 1 || syb % 8 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 16: return launch<16>(a, s);
    case 32: return launch<32>(a, s);
    case 64: return launch<64>(a, s);
    case 128: return launch<128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
