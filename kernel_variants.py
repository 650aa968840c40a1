"""Times variants of a kernel source against the sources as they stand, on one
card: the int8 GEMM (csrc/int8_gemm.cuh, through dense_q8.cu and
qkv_q8_dmaj.cu) and the 3x3 conv (csrc/conv3x3_stats.cu).

    python3 kernel_variants.py [variant ...]

A variant is a copy of dinounet_tpu_torch/csrc/ under build/variants/<name>/
with the edits of VARIANTS applied; only its family's sources are compiled,
with _build.NVCC_FLAGS, into a small library that the port's wrappers then
call in place of the full build ("current" and "conv_current" are the
sources unedited). Each named variant runs in its own process, in the order
given, so that `current split_features split_features current` times two
builds in turns on one card.

int8 variants print one JSON line each: whether #10 dense_q8 and #13
qkv_q8_dmaj equal their plain versions bit for bit at the path shapes (tile
batch 8 of 1029 tokens, C 768: fc1 D 3072, qkv 3C 2304) and at an edge shape
(3 images of 65 / 129 tokens), and, at the path shapes (and fc1's at D 2304,
and #11's ViT fc2 with the GELU, K 3072), the quantize pass's and the GEMM's
device time a call (torch.profiler over 20 calls) and the device time of one
call of 50 back to back (CUDA events). "no_stores" is for timing only: its
#13 output is wrong.

conv variants print one JSON line each: whether conv3x3_cm agrees with its
plain version (KERNEL_TOLERANCES, the statistics' means within
STATS_TOLERANCE) at the seven path shapes of serve_cm (tile batch 8) and at
edge shapes, and at each path shape the conv kernel's device time a call
(torch.profiler over 20 calls) and the device time of one call of 50 back
to back (CUDA events). A variant that faults prints its error. The
conv_*_only variants keep one phase of the kernel (the TMA loads, the
loader's transform, the products, the epilogue) and its barriers, for
timing only: their outputs are wrong.

msda_bwd variants (#7, csrc/msda_bwd.cu) print one JSON line each: whether
the backward agrees with its plain version (KERNEL_TOLERANCES) at its four
train shapes (batch 2, 16 heads, 4 points: dinounet_b's D 24 and
dinounet_l's D 32 on the 32 x 32 map, 5376 queries; the 7B's D 128; a
1024^2 patch's 64 x 64 map at D 24, 21504 queries) and at edge shapes,
whether ga, gx and gy of two calls are bit-equal, and at each train shape
the device time a call by kernel and of one call of 50 back to back. A
variant may name a checkout (its third field, e.g. build/parent, a `git
archive` of the parent commit): its sources are edited and its package's
wrappers called, so that the parent's phases are timed in the same call as
the change's. The *_only and no_* variants are for timing only.

msda_premapped variants (#5, csrc/msda_fwd_premapped.cu) print whether the
prepped-input forward agrees with its plain version at its path shapes
(tile batch 8, 16 heads, 4 points a level: D 24 over the 32 x 32 map and
over two levels, the 7B's D 128, D 32 on the 1024^2 patch, D 24 on an fp32
map) and edge shapes, and the device time a call by kernel at the path
shapes.

seg variants (#15, csrc/seg_head.cu) print whether the seg head agrees with
its plain version at its path shape (tile batch 8, 32 channels at 512^2 to
3 classes, and to 14) and at edge shapes (element loads, every class-count
instance, 512 channels, an input at an odd element), and at the path
shapes the device time a call of every launch the wrapper makes (the
parent's weight casts too), one call of 50 back to back, the wrapper's
event time and the kernel's rate in TB/s. seg_tma_ring is the design
timed against the committed one, seg_staged_stores the logits staged in
shared memory for whole-sector stores; the *_only, loads_prologue and
no_stores variants time phases; the seg_parent* variants the parent's
kernel (a checkout under build/parent).
"""
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "dinounet_tpu_torch" / "csrc"
OUT = ROOT / "build" / "variants"
# family -> (sources compiled, C functions bound)
FAMILIES = {
    "int8": (("dense_q8.cu", "qkv_q8_dmaj.cu"), ("dense_q8", "quantize_act", "qkv_q8_dmaj")),
    "conv": (("conv3x3_stats.cu",), ("conv3x3_stats",)),
    "transpconv": (("transpconv2x2.cu",), ("transpconv2x2",)),
    "msda": (("msda_fwd.cu",), ("msda_fwd_fused", "msda_fwd_merged")),
    "msda_bwd": (("msda_bwd.cu",), ("msda_bwd",)),
    "msda_premapped": (("msda_fwd_premapped.cu",), ("msda_fwd_premapped",)),
    "seg": (("seg_head.cu",), ("seg_head",)),
}
_CONV = "conv3x3_stats.cu"
# edits of conv3x3_stats.cu that take one phase out (for timing the others)
_NO_TMA = [
    ('      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "\n'
     '      "[%0], [%1, {%2, %3, %4, %5}], [%6];\\n" ::"r"(dst),\n'
     '      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)\n'
     '      : "memory");', '      "" ::: "memory");'),
    ("mbar_expect_tx(bar, P::kRawBytes);", "mbar_arrive(bar);")]
_NO_TRANSFORM = [("        for (int i = lt; i < P::kHaloRows * kPairs; i += 64) {",
                  "        for (int i = lt; i < 0; i += 64) {")]
_NO_WGMMA = [("          Wgmma<kCout>::run(acc[sg], ad, bd, c > 0 || tap > 0);",
              "          if (c < 0) Wgmma<kCout>::run(acc[sg], ad, bd, c > 0 || tap > 0);")]
_NO_EPILOGUE = [("    for (int sg = 0; sg < P::kSegs; ++sg) {\n"
                 "      const int seg = cw * P::kSegs + sg, r = seg / 2, hs = seg % 2;\n"
                 "      const int row",
                 "    for (int sg = 0; sg < (tix < 0 ? P::kSegs : 0); ++sg) {\n"
                 "      const int seg = cw * P::kSegs + sg, r = seg / 2, hs = seg % 2;\n"
                 "      const int row")]


def _wgmma_rs(n: int) -> str:
    """wgmma m64n<n>k16 with A from registers (four b32 a thread), B by
    descriptor, as C++ text."""
    d = n // 2
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(d))
    regs = ", ".join(f"%{i}" for i in range(d))
    return (f"template <>\nstruct WgmmaRS<{n}> {{\n"
            f"  static __device__ __forceinline__ void run(float (&d)[{d}], const uint32_t (&a)[4],"
            f" uint64_t b, int acc) {{\n"
            f'    asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{d + 5}, 0;\\n"\n'
            f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{{regs}}}, '
            f'{{%{d}, %{d + 1}, %{d + 2}, %{d + 3}}}, %{d + 4}, p, 1, 1, 0;\\n}}\\n"\n'
            f'        : {outs}\n'
            f'        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));\n'
            f"  }}\n}};\n")


# the A operand by ldmatrix: lane l gives the row address of pixel
# 16 warp + l % 8 + 8 ((l / 8) % 2) of channel group l / 16
_A_LDMATRIX = [
    ("// no-swizzle wgmma descriptor:",
     "template <int N>\nstruct WgmmaRS;\n" + "".join(_wgmma_rs(n) for n in (16, 32, 64, 128))
     + "__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {\n"
       '  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\\n"\n'
       '               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));\n}\n\n'
       "// no-swizzle wgmma descriptor:"),
    ("          const uint64_t ad =\n"
     "              plain_desc(stage + ((r + ky) * kHaloW + hs * 64 + kx) * 16, P::kGroupBytes, 128);\n"
     "          Wgmma<kCout>::run(acc[sg], ad, bd, c > 0 || tap > 0);",
     "          uint32_t af[4];\n"
     "          ldsm_x4(af, stage + (lane / 16) * P::kGroupBytes +\n"
     "                          ((r + ky) * kHaloW + hs * 64 + kx + 16 * warp + lane % 8 +\n"
     "                           8 * ((lane / 8) % 2)) * 16);\n"
     "          wgmma_fence();\n"
     "          WgmmaRS<kCout>::run(acc[sg], af, bd, c > 0 || tap > 0);")]

_MSDA, _MC = "msda_fwd.cu", "msda_common.cuh"
_TC, _HC = "transpconv2x2.cu", "hopper_common.cuh"
# the transposed conv's prologue applied by the consumers in registers: the
# M-major A tile read by ldmatrix.trans (lane l gives the row address of
# channel row l % 8 of 8 x 8 block l / 8: pixels 16 warp + 8 (l / 8 % 2),
# channels 8 (l / 16) of the k step, through the 128-byte swizzle),
# leaky(x s + t) on the fragment, wgmma with A from registers; the producer
# leaves the TMA box as it is (channel-major inputs; the others as committed)
_TC_PROLOGUE_IN_REGISTERS = [
    ("__device__ __forceinline__ float leaky(",
     "template <int N>\nstruct WgmmaRS;\n" + "".join(_wgmma_rs(n) for n in (128, 256))
     + "__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {\n"
       '  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\\n"\n'
       '               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));\n}\n\n'
       "__device__ __forceinline__ float leaky("),
    ("  const bool by_threads = pro || a.mode == kModeLoads;",
     "  const bool by_threads = (pro && !kTransA) || a.mode == kModeLoads;"),
    ("          const uint32_t bar = (pro ? a_raw : a_full) + 8 * slot;",
     "          const uint32_t bar = (pro && !kTransA ? a_raw : a_full) + 8 * slot;"),
    ("        if (pro) {  // the prologue on the staged tile, in place",
     "        if (pro && !kTransA) {  // the prologue on the staged tile, in place"),
    ("            const uint64_t ad = kTransA ? sw128_desc(a_chunk + kk * 16 * 128, kBoxBytes, 1024)\n"
     "                                        : sw128_desc(a_chunk + kk * 32, 16, 1024);\n"
     "            wgmma_ss<kTransA>(acc, ad, sw128_desc(w_tile + kk * 32, 16, 1024), c > 0 || kk > 0);",
     "            if (kTransA && pro) {\n"
     "              uint32_t af[4];\n"
     "              const int i4 = lane / 8, kr = kk * 16 + 8 * (i4 >> 1) + lane % 8;\n"
     "              ldsm_x4_trans(af, a_chunk + kr * 128 + (((2 * warp + (i4 & 1)) ^ (kr & 7)) * 16));\n"
     "              const int k0 = c * kKc + kk * 16 + 2 * (lane % 4);\n"
     "              const float* ps = a.ps + (size_t)t.b * a.Cin + k0;\n"
     "              const float* pt = a.pt + (size_t)t.b * a.Cin + k0;\n"
     "              const float s0 = __ldg(ps), s1 = __ldg(ps + 1), s8 = __ldg(ps + 8), s9 = __ldg(ps + 9);\n"
     "              const float t0 = __ldg(pt), t1 = __ldg(pt + 1), t8 = __ldg(pt + 8), t9 = __ldg(pt + 9);\n"
     "              af[0] = prologue2(af[0], s0, t0, s1, t1, a.slope);\n"
     "              af[1] = prologue2(af[1], s0, t0, s1, t1, a.slope);\n"
     "              af[2] = prologue2(af[2], s8, t8, s9, t9, a.slope);\n"
     "              af[3] = prologue2(af[3], s8, t8, s9, t9, a.slope);\n"
     "              wgmma_fence();\n"
     "              WgmmaRS<NB>::run(acc, af, sw128_desc(w_tile + kk * 32, 16, 1024), c > 0 || kk > 0);\n"
     "            } else {\n"
     "            const uint64_t ad = kTransA ? sw128_desc(a_chunk + kk * 16 * 128, kBoxBytes, 1024)\n"
     "                                        : sw128_desc(a_chunk + kk * 32, 16, 1024);\n"
     "            wgmma_ss<kTransA>(acc, ad, sw128_desc(w_tile + kk * 32, 16, 1024), c > 0 || kk > 0);\n"
     "            }"),
]
# edits of the MSDA forward that take phases out (for timing the others)
_MSDA_BY_ELEMENTS = [("  if ((S & 7) == 0 && (reinterpret_cast<uintptr_t>(v_g) & 3) == 0) {",
                      "  if (false) {")]
_MSDA_NO_STAGING = _MSDA_BY_ELEMENTS + [(
    "  for (int i = done * 64 + threadIdx.x; i < ng * S * 8; i += blockDim.x) {",
    "  for (int i = done * 64 + threadIdx.x; i < 0; i += blockDim.x) {")]
_MSDA_GATHER = ("        gather_point<NG, kGlobal, __nv_bfloat16>(acc, v_s, vt, D, dc, ng, Sp, H, W, x, y,\n"
                "                                                 a[p] / sum);")
_MSDA_STORE = "    __nv_bfloat16* o = out + (bm * D + d0) * Lq + q;"
_MSDA_FOLD = ("    float fold = 0.f;\n#pragma unroll\n    for (int d = 0; d < 8 * NG; ++d) "
              "fold += acc[d];\n    if (fold != 1234.5f) continue;\n" + _MSDA_STORE)
_MSDA_STAGING_ONLY = [(
    "  if (!kGlobal) stage_map(v_s, value + (bm * D + d0) * S, dc, ng, S, Sp);",
    "  if (!kGlobal) stage_map(v_s, value + (bm * D + d0) * S, dc, ng, S, Sp);\n"
    "  if (v_s[threadIdx.x & 7].x == 12345u) out[0] = value[0];\n  return;")]
_MSDA_PREP_ONLY = [(_MSDA_GATHER, "        acc[0] += x + y + a[p] / sum;"),
                   (_MSDA_STORE, _MSDA_FOLD)]
_MSDA_NO_STORES = [(_MSDA_STORE, _MSDA_FOLD)]
_MSDA_NO_GATHERS = [(_MSDA_GATHER, "")]
# edits of the parent's MSDA backward (csrc/msda_bwd.cu before its redesign:
# the shared-memory instance msda_bwd_kernel, the device-memory instance
# msda_bwd_global_kernel) that take phases out, for timing the others
_BWD = "msda_bwd.cu"
_PB_MAP_STAGING = ("  for (int i = threadIdx.x; i < D * S; i += kThreads) {\n"
                   "    const int d = i / S;\n    const int s = i - d * S;\n"
                   "    v_s[s * D + d] = v_g[i];")
_PB_WALK = "  const int lane = threadIdx.x & 31;\n  const int warp = threadIdx.x >> 5;\n  const int q_begin"
_PB_G_STAGING = "    for (int i = threadIdx.x; i < D * n; i += kThreads) {"
_PB_QUERIES = "    for (int j = warp; j < n; j += kWarps) {"
_PB_FLUSH = ("  for (int i = threadIdx.x; i < D * S; i += kThreads) {\n"
             "    const int d = i / S;\n    const int s = i - d * S;\n"
             "    const float t = gv_s[s * D + d];")
_PB_GATHERS = [("              t = fmaf(__bfloat162float(v_s[pos + d]), gq[k], t);", ""),
               ("              t = fmaf(to_float(__ldg(v_l + pos + d)), gq[k], t);", "")]
_PB_SCATTER = [("              atomicAdd(gv_s + pos + d, wt * gq[k]);", ""),
               ("              atomicAdd(gv_l + pos + d, wt * gq[k]);", "")]
_PB_NO_QUERIES = [(_PB_QUERIES, "    for (int j = warp; j < (n < 0 ? n : 0); j += kWarps) {")]
_PB_NO_FLUSH = [(_PB_FLUSH, "  if (g_s[threadIdx.x] == 12345.f) gv[0] = 1.f;\n"
                 + _PB_FLUSH.replace("i < D * S", "i < 0"))]
_PB_MAP_STAGING_ONLY = [(_PB_WALK, "  __syncthreads();\n  if (gv_s[threadIdx.x] == 12345.f) "
                         "gv[0] = __bfloat162float(v_s[threadIdx.x]);\n  return;\n" + _PB_WALK)]
_PB_G_STAGING_ONLY = ([(_PB_MAP_STAGING, _PB_MAP_STAGING.replace("i < D * S", "i < 0"))]
                      + _PB_NO_QUERIES + _PB_NO_FLUSH)
_PB_FLUSH_ONLY = [(_PB_MAP_STAGING + "\n    gv_s[i] = 0.f;",
                   _PB_MAP_STAGING + "\n    gv_s[i] = 1.f;"),
                  (_PB_G_STAGING, _PB_G_STAGING.replace("i < D * n", "i < 0"))] + _PB_NO_QUERIES
# edits of the MSDA backward as it stands, for design variants and for timing
# one phase (the *_only and no_* variants: outputs wrong)
_B_SCATTER = ("          atomicAdd(reinterpret_cast<float4*>(gv_u + (size_t)pos * Dp),\n"
              "                    make_float4(wt * gq[0], wt * gq[1], wt * gq[2], wt * gq[3]));")
_B_GATHER = "          load_unit<T>(v, v_s, Sp, u, pos);"
_B_WALK = "  for (int qb = blockIdx.x * q_chunk + warp * qw; qb < q_end; qb += kWarps * qw) {"
_B_STAGED = "  stage_map(v_s, value + (bm * D + d0) * S, dc, (dc + CC - 1) / CC, S, Sp);  // ends with a barrier"
_B_NO_GATHERS = [(_B_GATHER, "#pragma unroll\n          for (int k = 0; k < 4; ++k) v[k] = 0.f;")]
_B_NO_SCATTER = [(_B_SCATTER, "          if (wt == 12345.f) gv_u[pos] = 1.f;")]
_B_NO_WALK = [(_B_WALK, _B_WALK.replace("qb < q_end;", "qb < (q_end < 0 ? q_end : 0);"))]
_B_STAGING_ONLY = [(_B_STAGED, _B_STAGED + "\n  if (v_s[0].x == 12345u + threadIdx.x) gv_t[0] = 1.f;\n"
                    "  return;")]
_B_SPREAD = [(_B_WALK + "\n    const int q = qb + qi;",
              "  const int q0 = blockIdx.x * q_chunk;\n"
              "  const int n_sw = (q_end - q0 + kWarps * qw - 1) / (kWarps * qw);\n"
              "  for (int t = 0; t < n_sw; ++t) {\n"
              "    const int q = q0 + (warp * qw + qi) * n_sw + t;")]
# edits of the transposed conv that take one phase out: the input's TMA
# boxes, the producer's prologue pass, the products, the epilogue
_TC_NO_TMA = [
    ('      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "\n'
     '      "[%0], [%1, {%2, %3, %4}], [%5];\\n" ::"r"(dst),\n'
     '      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)\n'
     '      : "memory");', '      "" ::: "memory");'),
]
_TC_NO_TMA_TX = [("          mbar_expect_tx(bar, a.kchunks * kChunkBytes);",
                  "          mbar_arrive(bar);")]
_TC_NO_TRANSFORM = [("          const float* pt = a.pt + (size_t)t.b * a.Cin;\n"
                     "          for (int v = tid; v < a.kchunks * 1024; v += 128) {",
                     "          const float* pt = a.pt + (size_t)t.b * a.Cin;\n"
                     "          for (int v = tid; v < 0; v += 128) {")]
_TC_NO_MMA = [("            wgmma_ss<kTransA>(acc, ad,", "            if (c < 0) wgmma_ss<kTransA>(acc, ad,")]
_TC_NO_EPILOGUE = [("      for (int round = 0; round < NB / kRound; ++round) {",
                    "      for (int round = 0; round < (pass < 0 ? NB / kRound : 0); ++round) {")]

_SEG = "seg_head.cu"
# edits of the parent's seg head (csrc/seg_head.cu before its redesign: 4
# pixels a thread, 8-byte loads, a runtime C loop) that take phases out
_PS_PROLOGUE = ("    const float s = s_s[c], t = t_s[c];\n#pragma unroll\n"
                "    for (int i = 0; i < kPix; ++i) {\n      float a = fmaf(v[i], s, t);\n"
                "      a = a >= 0.f ? a : a * slope;\n"
                "      v[i] = __bfloat162float(__float2bfloat16(a));\n    }\n")
_PS_PRODUCTS = ("#pragma unroll\n    for (int k = 0; k < kK; ++k) {\n"
                "      const float wk = w_s[c * kK + k];\n#pragma unroll\n"
                "      for (int i = 0; i < kPix; ++i) acc[k][i] = fmaf(v[i], wk, acc[k][i]);\n"
                "    }\n")
_PS_FOLD_IN = "#pragma unroll\n    for (int i = 0; i < kPix; ++i) acc[0][i] += v[i];\n"
_PS_STORES = "#pragma unroll\n  for (int k = 0; k < kK; ++k) {\n    if (k >= K) break;"
_PS_NO_STORES = [(_PS_STORES, "  float fold = 0.f;\n#pragma unroll\n  for (int k = 0; k < kK; ++k)\n"
                  "#pragma unroll\n    for (int i = 0; i < kPix; ++i) fold += acc[k][i];\n"
                  "  if (fold != 1234.5f) return;\n" + _PS_STORES)]
_PS_NO_LOADS = [("  for (int c = 0; c < C; ++c) {", "  for (int c = 0; c < (C < 0 ? C : 0); ++c) {")]

# edits of the seg head as it stands: phases taken out (for timing the
# others; outputs wrong) and design variants
_S_ACT = ("            lo[i] = act(__uint_as_float(v << 16), sti[i], slope);\n"
          "            hi[i] = act(__uint_as_float(v & 0xffff0000u), sti[i], slope);\n")
_S_PACK = ("          const uint32_t a[4] = {pack2(lo[0], lo[1]), pack2(hi[0], hi[1]), "
           "pack2(lo[2], lo[3]),\n                                 pack2(hi[2], hi[3])};\n")
_S_MMA = ("#pragma unroll\n"
          "          for (int nt = 0; nt < kNT; ++nt) mma16816(acc[nt][m], a, bf[nt]);\n")
_S_STAGE = "    // the group's 8 pixels of classes 8 nt + 2q + {0, 1}\n"
_S_NO_STORES = [(_S_STAGE,
                 "    float fold = 0.f;\n#pragma unroll\n    for (int nt = 0; nt < kNT; ++nt)\n"
                 "#pragma unroll\n      for (int m = 0; m < 4; ++m)\n#pragma unroll\n"
                 "        for (int j = 0; j < 4; ++j) fold += acc[nt][m][j];\n"
                 "    if (fold != 1234.5f) continue;\n" + _S_STAGE)]
_S_LOADS_ONLY = [(_S_ACT, "            lo[i] = __uint_as_float(v);\n            hi[i] = 0.f;\n"),
                 (_S_PACK + _S_MMA, "          acc[0][m][0] += lo[0] + lo[1] + lo[2] + lo[3];\n")
                 ] + _S_NO_STORES
_S_LOADS_PROLOGUE = [(_S_MMA, "          acc[0][m][0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3]);\n")
                     ] + _S_NO_STORES
_S_STORES_ONLY = [("    for (int c0 = 0; c0 < C; c0 += 16 * kChunks) {",
                   "    for (int c0 = 0; c0 < (C < 0 ? C : 0); c0 += 16 * kChunks) {")]
# a warp's logits staged in shared memory ([warps][K][68] floats), each
# class's 64 pixels then stored as 16 lanes' 16-byte stores (whole 32-byte
# sectors a store; the committed fragments fill half of each sector a store)
_S_STAGED_STORES = [
    ("constexpr int kMaxC = 512;",
     "constexpr int kStride = kWarpPix + 4;\nconstexpr int kMaxC = 512;"),
    ("  float2* st = reinterpret_cast<float2*>(wf + nchunk * kNT * 32);  // [16 nchunk] (s, t)\n",
     "  float2* st = reinterpret_cast<float2*>(wf + nchunk * kNT * 32);  // [16 nchunk] (s, t)\n"
     "  float* out_s = reinterpret_cast<float*>(st + nchunk * 16);\n"),
    ("    const bool live = p0 < HW;\n",
     "    const bool live = p0 < HW;\n    float* os = out_s + warp * K * kStride;\n"),
    ("""    if (!live) continue;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = nt * 8 + 2 * q + j;
        if (k >= K) continue;
        const float bk = b_s[k];
        float v[8];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          v[2 * m] = acc[nt][m][j] + bk;
          v[2 * m + 1] = acc[nt][m][2 + j] + bk;
        }
        float* o = out + ((size_t)b * K + k) * HW + p0;
        if (kVec) {
          reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
          reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (p0 + i < HW) o[i] = v[i];
        }
      }
  }
}""", """#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = nt * 8 + 2 * q + j;
        if (k >= K) continue;
#pragma unroll
        for (int m = 0; m < 4; ++m)
          *reinterpret_cast<float2*>(os + k * kStride + g * 8 + 2 * m) =
              make_float2(acc[nt][m][j], acc[nt][m][2 + j]);
      }
    __syncwarp();
    const int pix = u * kWarpPix + 4 * (lane % 16);
    for (int k = lane / 16; k < K; k += 2) {
      float4 v = *reinterpret_cast<const float4*>(os + k * kStride + 4 * (lane % 16));
      const float bk = b_s[k];
      v = make_float4(v.x + bk, v.y + bk, v.z + bk, v.w + bk);
      float* o = out + ((size_t)b * K + k) * HW + pix;
      if (kVec) {
        if (pix < HW) *reinterpret_cast<float4*>(o) = v;
      } else {
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (pix + i < HW) o[i] = e[i];
      }
    }
    __syncwarp();
  }
}"""),
    ("""  constexpr int kMaxBytes = (kMaxC / 16) * kNT * 32 * 8 + kMaxC * 8;
  const int bytes = ((C + 15) / 16) * (kNT * 32 * 8 + 16 * 8);
  const auto kernel = seg_head_kernel<kNT, kVec>;
  static int per_sm = 0;  // resident blocks an SM, looked up once
  if (per_sm == 0) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kMaxBytes);
    if (err != cudaSuccess) return (int)err;
  }""", """  constexpr int kMaxBytes =
      (kMaxC / 16) * kNT * 32 * 8 + kMaxC * 8 + kWarps * 8 * kNT * kStride * 4;
  const int bytes = ((C + 15) / 16) * (kNT * 32 * 8 + 16 * 8) + kWarps * K * kStride * 4;
  const auto kernel = seg_head_kernel<kNT, kVec>;
  static unsigned long long smem_ready = 0;
  cudaError_t err = set_smem_once(kernel, kMaxBytes, &smem_ready);
  if (err != cudaSuccess) return (int)err;
  static int per_sm = 0;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kMaxBytes);
    if (err != cudaSuccess) return (int)err;
  }"""),
]
# design (b): a persistent block an SM, one producer thread keeping a ring of
# up to 40 tiles (64 pixels x C channels, one box of a 3-D tensor map over
# (pixels, channels, images), 128-byte swizzle) in flight, 8 consumer warps
# each taking a whole tile with the committed loop's lane layout, prologue
# and products (its fragments read from the staged tile, the coefficients
# through the read-only cache) and staged stores; where
# it does not apply (more than 16 classes or 128 channels, C not a multiple
# of 16, unaligned) the committed kernel runs
_SEG_TMA_CODE = r"""
constexpr int kConsumers = 8;  // consumer warps; one more produces
constexpr int kRingMax = 48;
constexpr int kTmaStride = kWarpPix + 4;  // a class row of staged logits

template <int kNT>
__global__ void __launch_bounds__(32 * (kConsumers + 1), 1)
seg_head_tma_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ w,
                    const float* __restrict__ bias, const float* __restrict__ ps,
                    const float* __restrict__ pt, float slope, float* __restrict__ out,
                    int C, int HW, int K, int ring, int tiles_per_image, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u = smem_u32(smem_raw);
  const uint32_t ring_u = (raw_u + 1023u) & ~1023u;  // the swizzle's 1024-byte alignment
  const unsigned char* ring_p = smem_raw + (ring_u - raw_u);
  const int stage_bytes = C * 128, nchunk = C / 16;
  uint2* wf = reinterpret_cast<uint2*>(smem_raw + (ring_u - raw_u) + ring * stage_bytes);
  float* out_s = reinterpret_cast<float*>(wf + nchunk * kNT * 32);  // [consumers][K][stride]
  const uint32_t full = smem_u32(out_s + kConsumers * K * kTmaStride);
  const uint32_t empty = full + 8 * kRingMax;
  __shared__ float b_s[8 * kNT];
  for (int i = threadIdx.x; i < nchunk * kNT * 32; i += blockDim.x) {
    const int l = i % 32, nt = (i / 32) % kNT, c = (i / (32 * kNT)) * 16 + 2 * (l % 4);
    const int n = nt * 8 + l / 4;
    float v[4];
    for (int j = 0; j < 4; ++j) v[j] = n < K ? w[(c + (j & 1) + 8 * (j >> 1)) * K + n] : 0.f;
    wf[i] = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  }
  for (int k = threadIdx.x; k < 8 * kNT; k += blockDim.x) b_s[k] = k < K ? bias[k] : 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < ring; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int n = tiles > (int)blockIdx.x ? (tiles - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;
  if (warp == kConsumers) {
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        const int slot = i % ring;
        if (i >= ring) mbar_wait(empty + 8 * slot, (uint32_t)((i / ring - 1) & 1));
        const int tile = blockIdx.x + i * gridDim.x, b = tile / tiles_per_image;
        mbar_expect_tx(full + 8 * slot, stage_bytes);
        tma_load_3d(ring_u + slot * stage_bytes, &map, (tile - b * tiles_per_image) * 64, 0, b,
                    full + 8 * slot);
      }
    }
    return;
  }
  for (int i = warp; i < n; i += kConsumers) {
    const int slot = i % ring;
    mbar_wait(full + 8 * slot, (uint32_t)((i / ring) & 1));
    const int tile = blockIdx.x + i * gridDim.x, b = tile / tiles_per_image;
    const int p0 = (tile - b * tiles_per_image) * 64 + g * 8;
    const unsigned char* stg = ring_p + slot * stage_bytes;
    float acc[kNT][4][4];
    for (int nt = 0; nt < kNT; ++nt)
      for (int m = 0; m < 4; ++m)
        for (int j = 0; j < 4; ++j) acc[nt][m][j] = 0.f;
    for (int cb = 0; cb < C; cb += 16) {
      uint4 raw[4];
      float2 sti[4];
#pragma unroll
      for (int i2 = 0; i2 < 4; ++i2) {
        const int c = cb + 2 * q + (i2 & 1) + 8 * (i2 >> 1);
        raw[i2] = *reinterpret_cast<const uint4*>(stg + c * 128 + ((g ^ (c & 7)) * 16));
        sti[i2] = make_float2(__ldg(ps + (size_t)b * C + c), __ldg(pt + (size_t)b * C + c));
      }
      uint2 bf[kNT];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) bf[nt] = wf[((cb / 16) * kNT + nt) * 32 + lane];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float lo[4], hi[4];
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2) {
          const uint32_t v = word(raw[i2], m);
          lo[i2] = act(__uint_as_float(v << 16), sti[i2], slope);
          hi[i2] = act(__uint_as_float(v & 0xffff0000u), sti[i2], slope);
        }
        const uint32_t a[4] = {pack2(lo[0], lo[1]), pack2(hi[0], hi[1]), pack2(lo[2], lo[3]),
                               pack2(hi[2], hi[3])};
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma16816(acc[nt][m], a, bf[nt]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);
    // the committed kernel's staged stores
    float* os = out_s + warp * K * kTmaStride;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = nt * 8 + 2 * q + j;
        if (k >= K) continue;
#pragma unroll
        for (int m = 0; m < 4; ++m)
          *reinterpret_cast<float2*>(os + k * kTmaStride + g * 8 + 2 * m) =
              make_float2(acc[nt][m][j], acc[nt][m][2 + j]);
      }
    __syncwarp();
    const int pix = p0 - g * 8 + 4 * (lane % 16);
    for (int k = lane / 16; k < K; k += 2) {
      float4 v = *reinterpret_cast<const float4*>(os + k * kTmaStride + 4 * (lane % 16));
      const float bk = b_s[k];
      if (pix < HW)
        *reinterpret_cast<float4*>(out + ((size_t)b * K + k) * HW + pix) =
            make_float4(v.x + bk, v.y + bk, v.z + bk, v.w + bk);
    }
    __syncwarp();
  }
}

template <int kNT>
int launch_tma(const void* x, const void* w, const void* bias, const void* ps, const void* pt,
               float slope, void* out, int B, int C, int HW, int K, cudaStream_t stream) {
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)HW, (cuuint64_t)C, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)HW * 2, (cuuint64_t)C * HW * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)C, 1};
  int err = bf16_sw128_map(&map, x, 3, dims, strides, box);
  if (err != 0) return err;
  const int stage = C * 128;
  const int ring = (160 * 1024) / stage < kRingMax ? (160 * 1024) / stage : kRingMax;
  const int bytes = 1024 + ring * stage + (C / 16) * kNT * 256 +
                    kConsumers * K * kTmaStride * 4 + 16 * kRingMax;
  static unsigned long long ready = 0;
  cudaError_t e = set_smem_once(seg_head_tma_kernel<kNT>, 220 * 1024, &ready);
  if (e != cudaSuccess) return (int)e;
  const int tpi = (HW + 63) / 64, tiles = B * tpi;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  seg_head_tma_kernel<kNT><<<grid, 32 * (kConsumers + 1), bytes, stream>>>(
      map, static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(ps), static_cast<const float*>(pt), slope,
      static_cast<float*>(out), C, HW, K, ring, tpi, tiles);
  return (int)cudaGetLastError();
}

}  // namespace
"""
_SEG_TMA_RING = [
    ("\n}  // namespace\n", _SEG_TMA_CODE),
    ("  cudaStream_t s = static_cast<cudaStream_t>(stream);\n",
     "  cudaStream_t s = static_cast<cudaStream_t>(stream);\n"
     "  if (K <= 16 && C <= 128 && C % 16 == 0 && HW % 8 == 0 && aligned16(x) && "
     "aligned16(out)) {\n"
     "    if (K <= 8) return launch_tma<1>(x, w, bias, ps, pt, slope, out, B, C, HW, K, s);\n"
     "    return launch_tma<2>(x, w, bias, ps, pt, slope, out, B, C, HW, K, s);\n"
     "  }\n")]

# name -> (family, {file: [(old, new), ...]})
VARIANTS = {
    "current": ("int8", {}),
    # the statistics' layout for #10 / #13: 64-row blocks, the warpgroups
    # splitting each pass's features (one wave of 129 blocks walking all of D)
    "split_features": ("int8", {
        "dense_q8.cu": [("launch_gemm<q8::kPlain, q8::kSplitRows>",
                         "launch_gemm<q8::kPlain, q8::kSplitFeatures>")],
        "qkv_q8_dmaj.cu": [("launch_gemm<kTokenColumns, kSplitRows>",
                            "launch_gemm<kTokenColumns, kSplitFeatures>")]}),
    # #10 on a 2-D grid (one 256-feature pass a block), #13 on pass groups
    "swap_grids": ("int8", {"int8_gemm.cuh": [
        ("int groups = kEpi == kTokenColumns ? passes : 1;",
         "int groups = kEpi == kPlain ? passes : 1;"),
        ("  if (kEpi == kPlain) {\n    const int sms = sm_count();",
         "  if (kEpi == kTokenColumns) {\n    const int sms = sm_count();")]}),
    "no_setmaxnreg": ("int8", {"int8_gemm.cuh": [
        ("    if constexpr (P::kHalves == 2) setmaxnreg_dec<24>();\n", ""),
        ("  if constexpr (P::kHalves == 2) setmaxnreg_inc<240>();\n", "")]}),
    "regs_40_232": ("int8", {"int8_gemm.cuh": [("setmaxnreg_dec<24>()", "setmaxnreg_dec<40>()"),
                                               ("setmaxnreg_inc<240>()", "setmaxnreg_inc<232>()")]}),
    "no_stores": ("int8", {"int8_gemm.cuh": [
        ("    *reinterpret_cast<uint4*>(out + row0 + (long long)c * N + first) =\n"
         "        *reinterpret_cast<const uint4*>(st + c * kColPitch + 8 * j);\n", ""),
        ("    out[row0 + (long long)c * N + k] = st[c * kColPitch + k + m];\n", "")]}),
    "conv_current": ("conv", {}),
    # every input read by the loader's own loads through the strides, no TMA
    "conv_thread_loads": ("conv", {_CONV: [
        ("  a.tma = tma_ok(x, a.sx, B) && (c2 == 0 || tma_ok(x2, a.s2, B));",
         "  a.tma = 0;")]}),
    # the output stored element by element (no 16-byte stores)
    "conv_scalar_stores": ("conv", {_CONV: [
        ("  a.vec_out = syw == 1", "  a.vec_out = 0 && syw == 1")]}),
    # tiles of 2 output rows at every Cout (4 at Cout <= 64 as committed)
    "conv_rows2": ("conv", {_CONV: [
        ("static constexpr int kRows = kCout <= 64 ? 4 : 2;",
         "static constexpr int kRows = 2;")]}),
    # one tile a block on a grid of every tile (no persistent walk)
    "conv_one_tile_a_block": ("conv", {_CONV: [
        ("constexpr bool kPersistent = true;", "constexpr bool kPersistent = false;")]}),
    # four halo pixel pairs in flight a loader thread (two as committed)
    "conv_loader_unroll4": ("conv", {_CONV: [
        ("#pragma unroll 2\n        for (int i = lt; i < P::kHaloRows * kPairs; i += 64) {",
         "#pragma unroll 4\n        for (int i = lt; i < P::kHaloRows * kPairs; i += 64) {")]}),
    # a ring of two staged tiles (three as committed)
    "conv_stages2": ("conv", {_CONV: [("constexpr int kStages = 3;", "constexpr int kStages = 2;")]}),
    # the A operand from registers (ldmatrix, one row address a lane, so
    # the tap's shift is free there too) instead of a shifted descriptor
    "conv_a_ldmatrix": ("conv", {_CONV: _A_LDMATRIX}),
    # timing only (outputs wrong): one phase of the kernel alone, the
    # others' barriers kept
    "conv_tma_only": ("conv", {_CONV: _NO_TRANSFORM + _NO_WGMMA + _NO_EPILOGUE}),
    "conv_transform_only": ("conv", {_CONV: _NO_TMA + _NO_WGMMA + _NO_EPILOGUE}),
    "conv_wgmma_only": ("conv", {_CONV: _NO_TMA + _NO_TRANSFORM + _NO_EPILOGUE}),
    "conv_epilogue_only": ("conv", {_CONV: _NO_TMA + _NO_TRANSFORM + _NO_WGMMA}),
    "transpconv_current": ("transpconv", {}),
    # the output stored a 4-byte word a pixel from the staging (no 16-byte rows)
    "transpconv_word_stores": ("transpconv", {_TC: [
        ("  a.vec = W % 8 == 0 && aligned16(y);", "  a.vec = 0;")]}),
    # the prologue applied in registers by the consumers (A by ldmatrix.trans
    # and wgmma from registers) instead of by the producer on the staged tile
    "transpconv_prologue_in_registers": ("transpconv", {_TC: _TC_PROLOGUE_IN_REGISTERS}),
    # no pass groups across blocks at the small maps
    "transpconv_no_split": ("transpconv", {_TC: [
        ("  int want = tiles >= sms ? 1 : (int)((sms + tiles - 1) / tiles);", "  int want = 1;")]}),
    # one staged input tile a block (two where they fit, as committed)
    "transpconv_one_slot": ("transpconv", {_TC: [
        ("    a.a_slots = 2 * a.a_slot_bytes + chunks * stage <= room ? 2 : 1;",
         "    a.a_slots = 1;"),
        ("    a.a_slots = 2 * a.a_slot_bytes + 2 * stage <= room ? 2 : 1;", "    a.a_slots = 1;")]}),
    # timing only (outputs wrong): one phase of the kernel alone, the
    # others' barriers kept
    "transpconv_tma_only": ("transpconv", {_TC: _TC_NO_TRANSFORM + _TC_NO_MMA + _TC_NO_EPILOGUE}),
    "transpconv_transform_only": ("transpconv", {_TC: _TC_NO_TMA_TX + _TC_NO_MMA + _TC_NO_EPILOGUE,
                                                 _HC: _TC_NO_TMA}),
    "transpconv_mma_only": ("transpconv", {_TC: _TC_NO_TMA_TX + _TC_NO_TRANSFORM + _TC_NO_EPILOGUE,
                                           _HC: _TC_NO_TMA}),
    "transpconv_epilogue_only": ("transpconv", {_TC: _TC_NO_TMA_TX + _TC_NO_TRANSFORM + _TC_NO_MMA,
                                                _HC: _TC_NO_TMA}),
    "msda_current": ("msda", {}),
    # 256 threads a block (512 as committed)
    "msda_threads_256": ("msda", {_MSDA: [("  const int threads = kThreads;",
                                           "  const int threads = 256;")]}),
    # no register cap (64 a thread where a thread keeps up to 32 accumulators,
    # as committed)
    "msda_regs_uncapped": ("msda", {_MSDA: [("__launch_bounds__(kThreads, NG <= 4 ? 2 : 1)",
                                             "__launch_bounds__(kThreads)")]}),
    # the point loop rolled in every instance (#1's whole heads unroll it)
    "msda_points_rolled": ("msda", {_MSDA: [(
        "  constexpr int kUnroll = kGlobal || kMerged || kSliced ? 1 : kMaxPoints;",
        "  constexpr int kUnroll = 1;")]}),
    # one query range a head: the map staged once a head, fewer blocks
    "msda_one_range_a_head": ("msda", {_MC: [
        ("  long long ranges = room / groups;", "  long long ranges = 1;")]}),
    # two waves of query ranges (more, shorter ranges: more staging)
    "msda_two_waves": ("msda", {_MC: [
        ("  long long ranges = room / groups;", "  long long ranges = 2 * room / groups;")]}),
    # the staging element by element (2-byte loads and stores) instead of by
    # stmatrix
    "msda_staging_by_elements": ("msda", {_MC: _MSDA_BY_ELEMENTS}),
    # timing only (outputs wrong): the forward's phases
    "msda_no_staging": ("msda", {_MC: _MSDA_NO_STAGING}),
    "msda_staging_only": ("msda", {_MSDA: _MSDA_STAGING_ONLY}),
    "msda_prep_only": ("msda", {_MC: _MSDA_NO_STAGING, _MSDA: _MSDA_PREP_ONLY}),
    "msda_prep_gathers": ("msda", {_MC: _MSDA_NO_STAGING, _MSDA: _MSDA_NO_STORES}),
    "msda_stores_only": ("msda", {_MC: _MSDA_NO_STAGING, _MSDA: _MSDA_NO_GATHERS}),
    # the parent's MSDA backward (a checkout of the parent commit under
    # build/parent) and its phases, timing only: the map staged and nothing
    # else; the cotangent's chunks staged and nothing else; no shared-memory
    # scatter (gathers, sums, staging, a flush of zeros); no gathers (the
    # scatter, staging, flush); staging and the partial's flush alone. The
    # device-memory instance's pre- and post-pass show as their own kernels
    "msda_bwd_current": ("msda_bwd", {}),
    # one block an SM (its registers uncapped; two where they fit as
    # committed, 64 registers a thread)
    "msda_bwd_one_block_an_sm": ("msda_bwd", {_BWD: [("__launch_bounds__(kThreads, 2)",
                                                      "__launch_bounds__(kThreads, 1)")]}),
    # one query range a (b, head, slice): fewer, longer blocks
    "msda_bwd_one_range": ("msda_bwd", {_BWD: [(
        "  const int q_chunk = query_chunk(per_sm, (long long)heads * n_slices, Lq, kThreads);",
        "  const int q_chunk = Lq;")]}),
    # a warp's queries spread over the block's range instead of consecutive
    # (consecutive queries sample neighbouring pixels: their reductions meet
    # on one address)
    "msda_bwd_spread": ("msda_bwd", {_BWD: _B_SPREAD}),
    # timing only: the staging alone; the walk without the scatter's
    # reductions; without the gathers; the memset, staging and finishing
    # kernel without the walk
    "msda_bwd_staging_only": ("msda_bwd", {_BWD: _B_STAGING_ONLY}),
    "msda_bwd_no_scatter": ("msda_bwd", {_BWD: _B_NO_SCATTER}),
    "msda_bwd_no_gathers": ("msda_bwd", {_BWD: _B_NO_GATHERS}),
    "msda_bwd_no_walk": ("msda_bwd", {_BWD: _B_NO_WALK}),
    "msda_premapped_current": ("msda_premapped", {}),
    "msda_premapped_parent": ("msda_premapped", {}, "build/parent"),
    # 256 threads a block (512 as committed)
    "msda_premapped_threads_256": ("msda_premapped", {"msda_fwd_premapped.cu": [
        ("constexpr int kThreads = 512;", "constexpr int kThreads = 256;")]}),
    "msda_bwd_parent": ("msda_bwd", {}, "build/parent"),
    "msda_bwd_parent_map_staging_only": ("msda_bwd", {_BWD: _PB_MAP_STAGING_ONLY},
                                         "build/parent"),
    "msda_bwd_parent_g_staging_only": ("msda_bwd", {_BWD: _PB_G_STAGING_ONLY}, "build/parent"),
    "msda_bwd_parent_no_scatter": ("msda_bwd", {_BWD: _PB_SCATTER}, "build/parent"),
    "msda_bwd_parent_no_gathers": ("msda_bwd", {_BWD: _PB_GATHERS}, "build/parent"),
    "msda_bwd_parent_flush_only": ("msda_bwd", {_BWD: _PB_FLUSH_ONLY}, "build/parent"),
    # the parent's seg head and its phases: the loads alone, the loads and
    # the prologue, the whole kernel without its stores, the stores alone
    "seg_parent": ("seg", {}, "build/parent"),
    "seg_parent_loads_only": ("seg", {_SEG: [(_PS_PROLOGUE + _PS_PRODUCTS, _PS_FOLD_IN)]
                                      + _PS_NO_STORES}, "build/parent"),
    "seg_parent_loads_prologue": ("seg", {_SEG: [(_PS_PRODUCTS, _PS_FOLD_IN)] + _PS_NO_STORES},
                                  "build/parent"),
    "seg_parent_no_stores": ("seg", {_SEG: _PS_NO_STORES}, "build/parent"),
    "seg_parent_stores_only": ("seg", {_SEG: _PS_NO_LOADS}, "build/parent"),
    "seg_current": ("seg", {}),
    "seg_loads_only": ("seg", {_SEG: _S_LOADS_ONLY}),
    "seg_loads_prologue": ("seg", {_SEG: _S_LOADS_PROLOGUE}),
    "seg_no_stores": ("seg", {_SEG: _S_NO_STORES}),
    "seg_stores_only": ("seg", {_SEG: _S_STORES_ONLY}),
    "seg_staged_stores": ("seg", {_SEG: _S_STAGED_STORES}),
    # design (b), the TMA ring (see _SEG_TMA_CODE)
    "seg_tma_ring": ("seg", {_SEG: _SEG_TMA_RING}),
    # the input through the read-only cache (__ldg) in place of the
    # streaming loads (__ldcs)
    "seg_ldg_loads": ("seg", {_SEG: [(
        "  if (kVec) return __ldcs(reinterpret_cast<const uint4*>(p));",
        "  if (kVec) return __ldg(reinterpret_cast<const uint4*>(p));")]}),
    # three blocks an SM (at most 85 registers a thread) in place of two
    "seg_three_blocks": ("seg", {_SEG: [("__launch_bounds__(kThreads, 2)",
                                         "__launch_bounds__(kThreads, 3)")]}),
    # one and four 16-channel chunks' loads issued together (two committed)
    "seg_chunks1": ("seg", {_SEG: [("constexpr int kChunks = 2;", "constexpr int kChunks = 1;")]}),
    "seg_chunks4": ("seg", {_SEG: [("constexpr int kChunks = 2;", "constexpr int kChunks = 4;")]}),
    # the leaky ReLU as max(a, a * slope) (equal for slopes in [0, 1]; the
    # committed select holds for any slope)
    "seg_max_leaky": ("seg", {_SEG: [("  return a >= 0.f ? a : a * slope;",
                                      "  return fmaxf(a, a * slope);")]}),
    # a block per 8 warp units, in as many waves as that takes (the
    # committed grid is one wave of resident blocks)
    "seg_waves": ("seg", {_SEG: [("  int per_image = sms * per_sm / B;",
                                  "  int per_image = (units + kWarps - 1) / kWarps;")]}),
}


def _checkout(name: str) -> Path:
    """The checkout whose sources and wrappers a variant edits and calls."""
    entry = VARIANTS[name]
    return ROOT / entry[2] if len(entry) > 2 else ROOT


def build(names) -> None:
    sys.path.insert(0, str(ROOT))
    from dinounet_tpu_torch.ops import _build

    jobs = []
    for name in names:
        family, edits_by_file = VARIANTS[name][:2]
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_checkout(name) / "dinounet_tpu_torch" / "csrc", d)
        for fname, edits in edits_by_file.items():
            text = (d / fname).read_text()
            for old, new in edits:
                if old not in text:
                    raise ValueError(f"variant {name}: {fname} has no {old!r}")
                text = text.replace(old, new)
            (d / fname).write_text(text)
        jobs += [(d, src) for src in FAMILIES[family][0]]

    def nvcc(job):
        d, src = job
        return job, subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
                                    str(d / (src + ".o")), str(d / src)],
                                   capture_output=True, text=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        for (d, src), p in pool.map(nvcc, jobs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {d.name}/{src}:\n{p.stdout}{p.stderr}")
            for entry in (p.stdout + p.stderr).split("Compiling entry function '")[1:]:
                kernel = entry.split("'", 1)[0]
                if "gemm" in kernel or "conv3x3" in kernel or "transpconv" in kernel or \
                        "msda" in kernel or "seg_head" in kernel:
                    regs = re.search(r"Used (\d+) registers", entry)
                    spill = re.search(r"(\d+) bytes spill stores", entry)
                    inst = re.search(r"kernelILi(\d+)E", kernel)
                    print(f"[build] {d.name} {src}"
                          f"{' Cout ' + inst.group(1) if inst and 'conv' in kernel else ''}: "
                          f"{regs.group(1) if regs else '?'} registers, "
                          f"{spill.group(1) if spill else '?'} B spilled", flush=True)
    for name in names:
        d = OUT / name
        subprocess.run([_build._nvcc(), "-shared", "-o", str(d / "lib.so"),
                        *(str(d / (src + ".o")) for src in FAMILIES[VARIANTS[name][0]][0])],
                       check=True)
    print(f"[build] {len(names)} variants in {time.perf_counter() - t0:.1f} s", flush=True)


def _load(name: str) -> None:
    """Bind the variant's library in place of the full build."""
    from dinounet_tpu_torch.ops import _build

    family = VARIANTS[name][0]
    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    for fn in FAMILIES[family][1]:
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    _build._lib = lib


def _device_ms(fn, match) -> dict:
    """Device time of the kernels whose name contains `match`, a call (the
    profiler over 20 calls), and one call of 50 back to back (CUDA events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    kernel = sum(e.self_device_time_total for e in prof.key_averages()
                 if match in e.key) / 1e3 / 20
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(50):
        fn()
    b.record()
    b.synchronize()
    return {"kernel_ms": kernel, "back_to_back_ms": a.elapsed_time(b) / 50}


def run_int8(name: str) -> dict:
    import torch

    from dinounet_tpu_torch.ops import dense_q8 as q8
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"variant": name}
    calls = {}
    for tag, (B, N, K, D) in {"fc1": (8, 1029, 768, 3072), "qkv": (8, 1029, 768, 2304),
                              "fc1_d2304": (8, 1029, 768, 2304), "fc1_edge": (3, 65, 200, 136),
                              "qkv_edge": (3, 129, 200, 600),
                              "fc2": (8, 1029, 3072, 768)}.items():
        h = torch.randn((B, N, K), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((D, K), generator=g, device=dev) * K ** -0.5).t()
        b = torch.randn((D,), generator=g, device=dev) * 0.1
        if tag == "fc2":  # #11 with the GELU (within their tolerance, not bit-equal)
            res = torch.randn((B, N, D), generator=g, device=dev).to(torch.bfloat16)
            gamma = torch.randn((D,), generator=g, device=dev) * 0.5
            calls[tag] = lambda h=h, w=w, b=b, r=res, gm=gamma: q8.dense_q8_residual_stats(
                h, w, b, r, gm, "gelu")
            continue
        if tag.startswith("qkv"):
            M = D // (3 * 64) if D % 192 == 0 else 4
            fn = lambda h=h, w=w, b=b, M=M: q8.qkv_q8_dmaj(h, w, b, M, w.shape[1] // (3 * M))
            plain = lambda h=h, w=w, b=b, M=M: q8.qkv_q8_dmaj_plain(h, w, b, M,
                                                                  w.shape[1] // (3 * M))
        else:
            fn = lambda h=h, w=w, b=b: q8.dense_q8(h, w, b)
            plain = lambda h=h, w=w, b=b: q8.dense_q8_plain(h, w, b)
        got, want = fn(), plain()
        torch.cuda.synchronize()
        out[f"{tag}_equal"] = bool(torch.equal(got, want))
        calls[tag] = fn
    for tag in ("fc1", "qkv", "fc1_d2304", "fc2"):
        fn = calls[tag]
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                part = "pass" if "quant_" in e.key else "gemm" if "gemm" in e.key else "other"
                out[f"{tag}_{part}_ms"] = e.self_device_time_total / 1e3 / 20
        a, b_ = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(50):
            fn()
        b_.record()
        b_.synchronize()
        out[f"{tag}_back_to_back_ms"] = a.elapsed_time(b_) / 50
    return out


# conv3x3_cm at the serve_cm path shapes: (tag, C1, C2, H = W, Cout, prologue, slope, stats)
CONV_PATH = (("conv0_512", 32, 32, 512, 32, False, 0.01, True),
             ("conv1_512", 32, 0, 512, 32, True, 0.01, True),
             ("conv0_256", 64, 64, 256, 64, False, 0.01, True),
             ("conv1_256", 64, 0, 256, 64, True, 0.01, True),
             ("conv0_128", 128, 128, 128, 128, False, 0.01, True),
             ("conv1_128", 128, 0, 128, 128, True, 0.01, True),
             ("spm_256", 64, 0, 256, 64, True, 0.0, False))
# and edges: (B, C1, C2, H, W, Cout, prologue, slope, stats)
CONV_EDGES = ((2, 16, 0, 9, 37, 16, False, 0.01, True), (2, 32, 16, 12, 130, 32, True, 0.01, True),
              (1, 64, 64, 20, 64, 128, False, 0.01, True), (3, 64, 0, 17, 256, 64, True, 0.0, False),
              (3, 32, 16, 7, 200, 32, True, 0.01, True), (2, 256, 0, 11, 129, 128, True, 0.01, True))


def run_conv(name: str) -> dict:
    import torch

    from dinounet_tpu_torch.ops.decoder_tail import conv3x3_cm, conv3x3_cm_plain
    from dinounet_tpu_torch.ops.kernel_check import (KERNEL_TOLERANCES, STATS_TOLERANCE,
                                                     max_excess)

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"variant": name}

    def case(B, C1, C2, H, W, Cout, pro, slope, stats):
        x = torch.randn((B, C1, H, W), generator=g, device=dev).to(torch.bfloat16)
        x2 = (torch.randn((B, C2, H, W), generator=g, device=dev).to(torch.bfloat16)
              if C2 else None)
        w = torch.randn((Cout, C1 + C2, 3, 3), generator=g, device=dev) * (9 * (C1 + C2)) ** -0.5
        b = torch.randn((Cout,), generator=g, device=dev) * 0.1
        p = ((torch.rand((B, C1 + C2), generator=g, device=dev) + 0.5),
             torch.randn((B, C1 + C2), generator=g, device=dev) * 0.3) if pro else None
        fn = lambda: conv3x3_cm(x, w, b, p, slope, stats, x2)
        got, want = fn(), conv3x3_cm_plain(x, w, b, p, slope, stats, x2)
        torch.cuda.synchronize()
        got = got if stats else (got,)
        want = want if stats else (want,)
        n = H * W
        excess = max([max_excess(got[0], want[0], KERNEL_TOLERANCES["conv3x3_cm"])]
                     + [max_excess(a / n, c / n, STATS_TOLERANCE)
                        for a, c in zip(got[1:], want[1:])])
        return fn, excess <= 0

    ok = True
    for tag, *edge in [(t, 8, C1, C2, H, H, Cout, pro, slope, stats)
                       for t, C1, C2, H, Cout, pro, slope, stats in CONV_PATH] + [
            (f"edge_{i}", *e) for i, e in enumerate(CONV_EDGES)]:
        try:  # a shape the variant refuses or a fault: reported, the others still run
            fn, good = case(*edge)
            ok = ok and good
            if not tag.startswith("edge"):
                out[tag] = _device_ms(fn, "conv3x3")
        except Exception as e:
            ok = False
            out[tag] = {"error": str(e).splitlines()[0]}
    out["agrees"] = ok
    return out


def _kernels_ms(fn) -> dict:
    """Device time a call by kernel (the profiler over 20 calls), and one
    call of 50 back to back (CUDA events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            k = e.key.replace("(anonymous namespace)::", "").replace("void ", "")
            k = k.replace("msda::", "").split("(")[0][:60]
            out[k] = out.get(k, 0.0) + e.self_device_time_total / 1e3 / 20
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(50):
        fn()
    b.record()
    b.synchronize()
    out["back_to_back_ms"] = a.elapsed_time(b) / 50
    return out


# transpconv2x2_cm at the serve_cm path shapes: (tag, Cin, Cout, H = W, prologue)
TRANSPCONV_PATH = (("dec_256", 64, 32, 256, True), ("dec_128", 128, 64, 128, True),
                   ("dec_64", 256, 128, 64, False), ("up_256", 32, 32, 256, False),
                   ("up_32", 256, 256, 32, False))
# and edges: (B, Cin, Cout, H, W, prologue, channels-last)
TRANSPCONV_EDGES = ((2, 16, 4, 5, 7, False, False), (3, 64, 32, 11, 13, True, False),
                    (2, 128, 64, 12, 24, True, True), (1, 256, 256, 8, 16, False, False),
                    (1, 512, 16, 4, 8, True, False), (2, 48, 12, 9, 1, True, False))


def run_transpconv(name: str) -> dict:
    import torch

    from dinounet_tpu_torch.ops.decoder_tail import transpconv2x2_cm, transpconv2x2_cm_plain
    from dinounet_tpu_torch.ops.kernel_check import KERNEL_TOLERANCES, max_excess

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"variant": name}
    ok = True
    cases = [(t, 8, Cin, Cout, H, H, pro, False) for t, Cin, Cout, H, pro in TRANSPCONV_PATH]
    cases += [(f"edge_{i}", *e) for i, e in enumerate(TRANSPCONV_EDGES)]
    for tag, B, Cin, Cout, H, W, pro, cl in cases:
        try:
            x = torch.randn((B, Cin, H, W), generator=g, device=dev).to(torch.bfloat16)
            if cl:
                x = x.contiguous(memory_format=torch.channels_last)
            w = torch.randn((Cin, Cout, 2, 2), generator=g, device=dev) * Cin ** -0.5
            b = torch.randn((Cout,), generator=g, device=dev) * 0.1
            p = ((torch.rand((B, Cin), generator=g, device=dev) + 0.5,
                  torch.randn((B, Cin), generator=g, device=dev) * 0.3) if pro else None)
            fn = lambda: transpconv2x2_cm(x, w, b, p)
            got, want = fn(), transpconv2x2_cm_plain(x, w, b, p)
            torch.cuda.synchronize()
            ok = ok and max_excess(got, want, KERNEL_TOLERANCES["transpconv2x2_cm"]) <= 0
            if not tag.startswith("edge"):
                out[tag] = _kernels_ms(fn)
        except Exception as e:
            ok = False
            out[tag] = {"error": str(e).splitlines()[0]}
    out["agrees"] = ok
    return out


def run_msda(name: str) -> dict:
    import torch

    from dinounet_tpu_torch.ops.kernel_check import KERNEL_TOLERANCES, max_excess
    from dinounet_tpu_torch.ops.msda import (ms_deform_attn_premapped_fused_merged_plain,
                                             ms_deform_attn_premapped_fused_plain)
    from dinounet_tpu_torch.ops.msda_kernel import (ms_deform_attn_premapped_fused,
                                                    ms_deform_attn_premapped_fused_merged)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"variant": name}
    ok = True
    # (tag, B, M, D, map side, P, Lq, merged): dinounet_b's D 24, the 7B's D
    # 128 (32-channel slices), a 1024^2 patch (S 4096: the token-major copy),
    # the merged buffer (#6) at D 24; then edges, not timed
    cases = (("d24", 8, 16, 24, 32, 4, 5376, False), ("d128", 8, 16, 128, 32, 4, 5376, False),
             ("patch1024_d32", 8, 16, 32, 64, 4, 21504, False),
             ("merged_d24", 8, 16, 24, 32, 4, 5376, True),
             ("edge_0", 2, 3, 8, 5, 1, 37, False), ("edge_1", 1, 4, 64, 16, 16, 777, True),
             ("edge_2", 3, 2, 100, 9, 7, 99, False), ("edge_3", 1, 2, 64, 64, 4, 300, False))
    for tag, B, M, D, side, P, Lq, merged in cases:
        try:
            v = torch.randn((B, M, D, side * side), generator=g, device=dev).to(torch.bfloat16)
            off = (torch.randn((B, M, 2 * P, Lq), generator=g, device=dev) * 2).to(torch.bfloat16)
            lg = torch.randn((B, M, P, Lq), generator=g, device=dev).to(torch.bfloat16)
            base = torch.rand((2 * P, Lq), generator=g, device=dev) * (side + 2) - 1.5
            shapes = ((side, side),)
            if merged:
                packed = torch.cat([off, lg], dim=2)
                fn = lambda: ms_deform_attn_premapped_fused_merged(v, shapes, packed, base)
                want = ms_deform_attn_premapped_fused_merged_plain(v, shapes, packed, base)
                tol = KERNEL_TOLERANCES["msda_fwd_merged"]
            else:
                fn = lambda: ms_deform_attn_premapped_fused(v, shapes, off, lg, base)
                want = ms_deform_attn_premapped_fused_plain(v, shapes, off, lg, base)
                tol = KERNEL_TOLERANCES["msda_fwd"]
            got = fn()
            torch.cuda.synchronize()
            ok = ok and max_excess(got, want, tol) <= 0
            if not tag.startswith("edge"):
                out[tag] = _kernels_ms(fn)
        except Exception as e:
            ok = False
            out[tag] = {"error": str(e).splitlines()[0]}
    out["agrees"] = ok
    return out


# the MSDA backward's train shapes (batch 2, 16 heads, 4 points): (tag, D,
# map side, Lq); then edges (B, M, D, map side, P, Lq), not timed
BWD_PATH = (("b_d24", 24, 32, 5376), ("l_d32", 32, 32, 5376), ("7b_d128", 128, 32, 5376),
            ("patch1024_d24", 24, 64, 21504))
BWD_EDGES = ((2, 3, 8, 5, 4, 37), (1, 2, 33, 6, 3, 700), (1, 2, 100, 7, 2, 65),
             (1, 2, 40, 64, 4, 300))


def run_msda_bwd(name: str) -> dict:
    import torch

    from dinounet_tpu_torch.ops.kernel_check import KERNEL_TOLERANCES, max_excess
    from dinounet_tpu_torch.ops.msda import (ms_deform_attn_premapped_backward_plain,
                                             premapped_fused_prep)
    from dinounet_tpu_torch.ops.msda_kernel import ms_deform_attn_premapped_backward

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"variant": name}
    ok = det = True
    cases = [(t, 2, 16, D, side, 4, Lq) for t, D, side, Lq in BWD_PATH]
    cases += [(f"edge_{i}", *e) for i, e in enumerate(BWD_EDGES)]
    for tag, B, M, D, side, P, Lq in cases:
        try:
            v = torch.randn((B, M, D, side * side), generator=g, device=dev).to(torch.bfloat16)
            off = (torch.randn((B, M, 2 * P, Lq), generator=g, device=dev) * 2).to(torch.bfloat16)
            lg = torch.randn((B, M, P, Lq), generator=g, device=dev).to(torch.bfloat16)
            base = torch.rand((2 * P, Lq), generator=g, device=dev) * (side + 2) - 1.5
            xs, ys, aw = (t.contiguous() for t in premapped_fused_prep(off, lg, base))
            cot = torch.randn((B, M, D, Lq), generator=g, device=dev)
            shapes = ((side, side),)
            fn = lambda: ms_deform_attn_premapped_backward(v, shapes, xs, ys, aw, cot)
            got, again = fn(), fn()
            want = ms_deform_attn_premapped_backward_plain(v, shapes, xs, ys, aw, cot)
            torch.cuda.synchronize()
            ok = ok and all(max_excess(a, b, KERNEL_TOLERANCES["msda_bwd"]) <= 0
                            for a, b in zip(got, want))
            det = det and all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))
            del got, again, want
            if not tag.startswith("edge"):
                out[tag] = _kernels_ms(fn)
        except Exception as e:
            ok = False
            out[tag] = {"error": str(e).splitlines()[0]}
    out["agrees"] = ok
    out["ga_gx_gy_bit_equal_twice"] = det
    return out


# #5 at its path shapes: (tag, B, M, D, levels, P, Lq, fp32 map); then edges
PREMAPPED_PATH = (("d24", 8, 16, 24, ((32, 32),), 4, 5376, False),
                  ("l2_d24", 8, 16, 24, ((32, 32), (16, 16)), 4, 5376, False),
                  ("d128", 8, 16, 128, ((32, 32),), 4, 5376, False),
                  ("patch1024_d32", 8, 16, 32, ((64, 64),), 4, 21504, False),
                  ("fp32_d24", 8, 16, 24, ((32, 32),), 4, 5376, True),
                  ("edge_0", 2, 3, 8, ((5, 7),), 4, 37, False),
                  ("edge_1", 1, 2, 40, ((9, 11), (4, 5), (2, 3), (1, 1)), 3, 130, True),
                  ("edge_2", 1, 2, 20, ((130, 128),), 2, 100, False))


def run_msda_premapped(name: str) -> dict:
    import torch

    from dinounet_tpu_torch.ops.kernel_check import KERNEL_TOLERANCES, max_excess
    from dinounet_tpu_torch.ops.msda import ms_deform_attn_premapped_plain
    from dinounet_tpu_torch.ops.msda_kernel import ms_deform_attn_premapped

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"variant": name}
    ok = True
    for tag, B, M, D, shapes, P, Lq, fp32 in PREMAPPED_PATH:
        try:
            S, L = sum(h * w for h, w in shapes), len(shapes)
            v = torch.randn((B, M, D, S), generator=g, device=dev)
            v = v if fp32 else v.to(torch.bfloat16)
            xs = torch.rand((B, M, L * P, Lq), generator=g, device=dev)
            ys = torch.rand((B, M, L * P, Lq), generator=g, device=dev)
            for lvl, (h, w) in enumerate(shapes):  # past every edge of its level
                xs[:, :, lvl * P:(lvl + 1) * P] = xs[:, :, lvl * P:(lvl + 1) * P] * (w + 4) - 2.5
                ys[:, :, lvl * P:(lvl + 1) * P] = ys[:, :, lvl * P:(lvl + 1) * P] * (h + 4) - 2.5
            aw = torch.softmax(torch.randn((B, M, L * P, Lq), generator=g, device=dev), dim=2)
            fn = lambda: ms_deform_attn_premapped(v, shapes, xs, ys, aw)
            got, want = fn(), ms_deform_attn_premapped_plain(v, shapes, xs, ys, aw)
            torch.cuda.synchronize()
            tol = (1e-5, 1e-5) if fp32 else KERNEL_TOLERANCES["msda_fwd_premapped"]
            ok = ok and max_excess(got, want, tol) <= 0
            del got, want
            if not tag.startswith("edge"):
                out[tag] = _kernels_ms(fn)
        except Exception as e:
            ok = False
            out[tag] = {"error": str(e).splitlines()[0]}
    out["agrees"] = ok
    return out


# seg_head_cm at the serve_cm path shape (8, 32, 512, 512), 3 classes, and at
# 14 (a multi-organ class count): (tag, K)
SEG_PATH = (("k3", 3), ("k14", 14))
# and edges: (B, C, H, W, K, input at an odd element): H * W not a multiple
# of 4, a multiple of 4 but not of 8, each class-count instance, 512
# channels at 32 classes, an input one element into its buffer
SEG_EDGES = ((2, 16, 7, 9, 3, False), (2, 32, 6, 10, 3, False), (2, 32, 16, 128, 5, False),
             (1, 64, 8, 40, 14, False), (1, 16, 4, 4, 32, False), (1, 512, 8, 16, 32, False),
             (2, 32, 16, 16, 3, True))


def run_seg(name: str) -> dict:
    """#15 at its path shapes: agreement, the wrapper's event time (median
    of 50 synchronised calls), device time a call by kernel (every launch
    of the wrapper, casts included) and back to back, the kernel's rate;
    then the edges. The parent's kernel takes an odd-offset input as an
    8-byte-aligned one and faults, so its variants skip that case."""
    import torch

    from dinounet_tpu_torch.ops.decoder_tail import seg_head_cm, seg_head_cm_plain
    from dinounet_tpu_torch.ops.kernel_check import KERNEL_TOLERANCES, max_excess, median_ms

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"variant": name}
    ok = True

    def case(B, C, H, W, K, odd):
        x = torch.randn((B, C, H, W), generator=g, device=dev).to(torch.bfloat16)
        if odd:
            x = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape).copy_(x)
        w = torch.randn((K, C, 1, 1), generator=g, device=dev) * C ** -0.5
        b = torch.randn((K,), generator=g, device=dev) * 0.1
        p = (torch.rand((B, C), generator=g, device=dev) + 0.5,
             torch.randn((B, C), generator=g, device=dev) * 0.3)
        return x, w, b, p

    parent = len(VARIANTS[name]) > 2
    cases = [(t, 8, 32, 512, 512, K, False) for t, K in SEG_PATH]
    cases += [(f"edge_{i}", *e) for i, e in enumerate(SEG_EDGES) if not (parent and e[-1])]
    for tag, B, C, H, W, K, odd in cases:
        try:
            x, w, b, p = case(B, C, H, W, K, odd)
            fn = lambda: seg_head_cm(x, w, b, p)
            got, want = fn(), seg_head_cm_plain(x, w, b, p)
            torch.cuda.synchronize()
            ok = ok and max_excess(got, want, KERNEL_TOLERANCES["seg_head_cm"]) <= 0
            del got, want
            if not tag.startswith("edge"):
                r = _kernels_ms(fn)
                r["event_median_ms"] = median_ms(fn, iters=50)
                kernel = sum(v for k, v in r.items() if "seg_head" in k)
                r["kernel_tb_s"] = (x.numel() * 2 + B * K * H * W * 4) / kernel / 1e9
                out[tag] = r
        except Exception as e:
            ok = False
            out[tag] = {"error": str(e).splitlines()[0]}
    out["agrees"] = ok
    return out


def run(name: str) -> None:
    sys.path.insert(0, str(_checkout(name)))
    _load(name)
    family = VARIANTS[name][0]
    runner = {"int8": run_int8, "conv": run_conv, "transpconv": run_transpconv,
              "msda": run_msda, "msda_bwd": run_msda_bwd,
              "msda_premapped": run_msda_premapped, "seg": run_seg}[family]
    print(json.dumps(runner(name)), flush=True)


def main(names) -> None:
    names = names or ["current"]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    build(list(dict.fromkeys(names)))
    for name in names:
        subprocess.run([sys.executable, __file__, "--run", name], check=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--run"]:
        run(sys.argv[2])
    else:
        main(sys.argv[1:])
