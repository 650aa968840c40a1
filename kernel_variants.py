"""Times variants of the int8 GEMM (csrc/int8_gemm.cuh) against the sources as
they stand, on one card.

    python3 kernel_variants.py [variant ...]

A variant is a copy of dinounet_tpu_torch/csrc/ under build/variants/<name>/
with the edits of VARIANTS applied; only the two int8 sources (dense_q8.cu,
qkv_q8_dmaj.cu) are compiled, with _build.NVCC_FLAGS, into a small library
that the port's wrappers then call in place of the full build ("current" is
the sources unedited). Each named variant runs in its own process, in the
order given, so that `current split_features split_features current` times
two builds in turns on one card. For each run one JSON line: whether #10
dense_q8 and #13 qkv_q8_dmaj equal their plain versions bit for bit at the
path shapes (tile batch 8 of 1029 tokens, C 768: fc1 D 3072, qkv 3C 2304)
and at an edge shape (3 images of 65 / 129 tokens), and, at the path shapes
(and fc1's at D 2304, and #11's ViT fc2 with the GELU, K 3072), the quantize
pass's and the GEMM's device time a call (torch.profiler over 20 calls) and
the device time of one call of 50 back to back (CUDA events). "no_stores" is
for timing only: its #13 output is wrong.
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
SOURCES = ("dense_q8.cu", "qkv_q8_dmaj.cu")

# name -> {file: [(old, new), ...]}
VARIANTS = {
    "current": {},
    # the statistics' layout for #10 / #13: 64-row blocks, the warpgroups
    # splitting each pass's features (one wave of 129 blocks walking all of D)
    "split_features": {
        "dense_q8.cu": [("launch_gemm<q8::kPlain, q8::kSplitRows>",
                         "launch_gemm<q8::kPlain, q8::kSplitFeatures>")],
        "qkv_q8_dmaj.cu": [("launch_gemm<kTokenColumns, kSplitRows>",
                            "launch_gemm<kTokenColumns, kSplitFeatures>")]},
    # #10 on a 2-D grid (one 256-feature pass a block), #13 on pass groups
    "swap_grids": {"int8_gemm.cuh": [
        ("int groups = kEpi == kTokenColumns ? passes : 1;",
         "int groups = kEpi == kPlain ? passes : 1;"),
        ("  if (kEpi == kPlain) {\n    int dev = 0, sms = 0;",
         "  if (kEpi == kTokenColumns) {\n    int dev = 0, sms = 0;")]},
    "no_setmaxnreg": {"int8_gemm.cuh": [
        ("    if constexpr (P::kHalves == 2) setmaxnreg_dec<24>();\n", ""),
        ("  if constexpr (P::kHalves == 2) setmaxnreg_inc<240>();\n", "")]},
    "regs_40_232": {"int8_gemm.cuh": [("setmaxnreg_dec<24>()", "setmaxnreg_dec<40>()"),
                                      ("setmaxnreg_inc<240>()", "setmaxnreg_inc<232>()")]},
    "no_stores": {"int8_gemm.cuh": [
        ("    *reinterpret_cast<uint4*>(out + row0 + (long long)c * N + first) =\n"
         "        *reinterpret_cast<const uint4*>(st + c * kColPitch + 8 * j);\n", ""),
        ("    out[row0 + (long long)c * N + k] = st[c * kColPitch + k + m];\n", "")]},
}


def build(names) -> None:
    sys.path.insert(0, str(ROOT))
    from dinounet_tpu_torch.ops import _build

    jobs = []
    for name in names:
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        for fname, edits in VARIANTS[name].items():
            text = (d / fname).read_text()
            for old, new in edits:
                if old not in text:
                    raise ValueError(f"variant {name}: {fname} has no {old!r}")
                text = text.replace(old, new)
            (d / fname).write_text(text)
        jobs += [(d, src) for src in SOURCES]

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
            for entry in p.stdout.split("Compiling entry function '")[1:]:
                if "gemm" in entry.split("'", 1)[0]:
                    regs = re.search(r"Used (\d+) registers", entry)
                    spill = re.search(r"(\d+) bytes spill stores", entry)
                    print(f"[build] {d.name} {src}: {regs.group(1) if regs else '?'} "
                          f"registers, {spill.group(1) if spill else '?'} B spilled", flush=True)
    for name in names:
        d = OUT / name
        subprocess.run([_build._nvcc(), "-shared", "-o", str(d / "lib.so"),
                        *(str(d / (src + ".o")) for src in SOURCES)], check=True)
    print(f"[build] {len(names)} variants in {time.perf_counter() - t0:.1f} s", flush=True)


def run(name: str) -> None:
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dinounet_tpu_torch.ops import _build
    from dinounet_tpu_torch.ops import dense_q8 as q8

    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    for fn in ("dense_q8", "quantize_act", "qkv_q8_dmaj"):
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    _build._lib = lib
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
    print(json.dumps(out), flush=True)


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
