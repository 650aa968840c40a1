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
        ("  if (kEpi == kPlain) {\n    int dev = 0, sms = 0;",
         "  if (kEpi == kTokenColumns) {\n    int dev = 0, sms = 0;")]}),
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
}


def build(names) -> None:
    sys.path.insert(0, str(ROOT))
    from dinounet_tpu_torch.ops import _build

    jobs = []
    for name in names:
        family, edits_by_file = VARIANTS[name]
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
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
                if "gemm" in kernel or "conv3x3" in kernel:
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


def run(name: str) -> None:
    sys.path.insert(0, str(ROOT))
    _load(name)
    family = VARIANTS[name][0]
    print(json.dumps(run_int8(name) if family == "int8" else run_conv(name)), flush=True)


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
