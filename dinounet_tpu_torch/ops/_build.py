"""Builds and loads the port's CUDA kernels; reads and resets their launch counts.

The kernels under ``dinounet_tpu_torch/csrc/`` are compiled on first use by
``nvcc``, one process per source started together (each one's seconds
head its part of ``ptxas.log``), and linked into one
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so the build takes seconds). The library goes
to ``build/dinounet_tpu_torch/<hash>/`` at the repository root, keyed by a
hash of the sources and the flags, so an edited source rebuilds and an
unchanged one loads what is there. Nothing here runs at import time: the CPU
tests import every module on a machine without ``nvcc``.

Each kernel's wrapper keeps its own launch count, a plain integer attribute
``launches`` that it raises by one where it launches the kernel;
``launch_counts`` and ``reset_launch_counts`` read and clear them together.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "dinounet_tpu_torch"
SOURCES = ("msda_fwd.cu", "msda_fwd_premapped.cu", "msda_bwd.cu", "rope_attention.cu",
           "dense_stats.cu", "conv3x3_stats.cu", "transpconv2x2.cu", "seg_head.cu",
           "dense_q8.cu", "qkv_q8_dmaj.cu")
HEADERS = ("hopper_common.cuh", "int8_gemm.cuh", "msda_common.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures: every pointer and the stream as c_void_p, sizes as c_int, a
# level table (H_0, W_0, H_1, W_1, ...) as a pointer to host ints.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LEVELS = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # value, scratch, off, logits, base, out, B, M, D, H, W, P, Lq, stream
    "msda_fwd_fused": [_P] * 6 + [_I] * 7 + [_P],
    # value, scratch, packed, base, out, B, M, D, H, W, P, Lq, stream
    "msda_fwd_merged": [_P] * 5 + [_I] * 7 + [_P],
    # value, scratch, xs, ys, aw, out, B, M, D, shapes, L, P, Lq, value_fp32, stream
    "msda_fwd_premapped": [_P] * 6 + [_I] * 3 + [_LEVELS] + [_I] * 4 + [_P],
    # value, v_scratch, xs, ys, aw, g, gv, gv_scratch, ga, gx, gy, gv_rows,
    # part, B, M, D, shapes, L, P, Lq, value_fp32, slice width, stream
    "msda_bwd": [_P] * 13 + [_I] * 3 + [_LEVELS] + [_I] * 5 + [_P],
    # qkv, sin, cos ((N, Dh) fp32, or both null), scratch, out, B, M, Dh, N,
    # scale, stream (the three layouts)
    "rope_attention_dmaj": [_P] * 5 + [_I] * 4 + [ctypes.c_float, _P],
    "rope_attention_rowmajor": [_P] * 5 + [_I] * 4 + [ctypes.c_float, _P],
    "rope_attention_ndh": [_P] * 5 + [_I] * 4 + [ctypes.c_float, _P],
    # h, wt (D, K), b, res, gamma, out, mu, var, scratch (gelu(h) or null), B, N,
    # K, D, channel_major, gelu, stream
    "dense_residual_stats": [_P] * 9 + [_I] * 6 + [_P],
    # h, wt (D, K), out (fp32), scratch (gelu(h) or null), B, N, K, D,
    # channel_major, gelu, stream
    "dense_partial": [_P] * 4 + [_I] * 6 + [_P],
    # acc (fp32), b, res, gamma, out, mu, var, rows, D, stream
    "post_reduce_stats": [_P] * 7 + [_I] * 2 + [_P],
    # x, x2, c1, c2, x strides (b, c, h, w), x2 strides, packed w, bias, s, t,
    # slope, y, y strides, sum, ssq, B, H, W, Cout, stream
    "conv3x3_stats": [_P] * 2 + [_I] * 10 + [_P] * 4 + [_F, _P] + [_I] * 4
                     + [_P] * 2 + [_I] * 4 + [_P],
    # x, x strides (b, c, h, w), packed w, npad, bias, s, t, slope, y, B, Cin, H,
    # W, Cout, stream
    "transpconv2x2": [_P] + [_I] * 4 + [_P, _I] + [_P] * 3 + [_F, _P] + [_I] * 5 + [_P],
    # x, w, bias, s, t, slope, out, B, C, HW, K, stream
    "seg_head": [_P] * 5 + [_F, _P] + [_I] * 4 + [_P],
    # h, wq (D, Kpad), ws, b, res, gamma, xq, a, out, mu, var, B, N, K, D,
    # channel_major, gelu, residual, stream
    "dense_q8": [_P] * 11 + [_I] * 7 + [_P],
    # h, amax (the given maxima, or null), xq, a, B, N, K, channel_major, gelu,
    # stream
    "quantize_act": [_P] * 4 + [_I] * 5 + [_P],
    # h, amax, B, N, K, channel_major, gelu, stream
    "quantize_amax": [_P] * 2 + [_I] * 5 + [_P],
    # h, wq (D, Kpad), amax, xq, a, acc (int32), B, N, K, D, channel_major, gelu,
    # stream
    "dense_q8_partial": [_P] * 6 + [_I] * 6 + [_P],
    # acc (int32), a, ws, b, res, gamma, out, mu, var, rows, D, stream
    "post_reduce_q8_stats": [_P] * 9 + [_I] * 2 + [_P],
    # x, wq (3C, Cpad), ws, bias, xq, a, out, B, N, C, D3, stream
    "qkv_q8_dmaj": [_P] * 7 + [_I] * 4 + [_P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
            "built on first use on a machine with the CUDA toolkit")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _source_hash() / "libdinounet_kernels.so"


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile into a private directory and rename the library: concurrent
    # builds never load a half-written one
    work = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        objs = [work / (Path(s).stem + ".o") for s in SOURCES]

        def nvcc(source, obj):
            t0 = time.perf_counter()
            p = subprocess.run([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                                str(CSRC / source)], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
            return p, time.perf_counter() - t0

        with ThreadPoolExecutor(len(SOURCES)) as pool:
            runs = list(pool.map(nvcc, SOURCES, objs))
        logs = []
        for s, (p, secs) in zip(SOURCES, runs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s} ({p.returncode}):\n{p.stdout}")
            logs.append(f"== {s}: nvcc {secs:.1f} s\n{p.stdout}")
        lib_tmp = work / out.name
        link = subprocess.run([_nvcc(), "-shared", "-o", str(lib_tmp),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        (out.parent / "ptxas.log").write_text("".join(logs))
        os.replace(lib_tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def lib() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            handle = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_host_libs = {}


def host_compiler() -> str:
    """The host C++ compiler: $CXX, else ``c++`` on the PATH."""
    found = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not found:
        raise RuntimeError("no host C++ compiler ($CXX, c++ or g++ on the PATH): "
                           "the host libraries are built on first use")
    return found


def host_library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update((CSRC / source).read_bytes())
    return BUILD_ROOT / "host" / h.hexdigest()[:16] / f"lib{Path(source).stem}.so"


def host_library(source: str) -> ctypes.CDLL:
    """A host C++ source of ``csrc/`` (no CUDA), built on first call by the
    host compiler into ``build/dinounet_tpu_torch/host/<hash>/`` and loaded
    with ``ctypes``. A failed build raises with the compiler's output."""
    with _lock:
        if source not in _host_libs:
            out = host_library_path(source)
            if not out.exists():
                out.parent.mkdir(parents=True, exist_ok=True)
                work = Path(tempfile.mkdtemp(dir=out.parent))
                try:
                    p = subprocess.run([host_compiler(), *HOST_FLAGS, "-o",
                                        str(work / out.name), str(CSRC / source)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
                    if p.returncode != 0:
                        raise RuntimeError(f"{host_compiler()} failed on {source} "
                                           f"({p.returncode}):\n{p.stdout}")
                    os.replace(work / out.name, out)
                finally:
                    shutil.rmtree(work, ignore_errors=True)
            _host_libs[source] = ctypes.CDLL(str(out))
    return _host_libs[source]


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")


def check_inputs(op: str, device, **specs) -> None:
    """Raise unless every ``name=(tensor, dtype, shape)`` is a contiguous
    tensor of that dtype and shape on ``device`` — what a kernel takes."""
    for name, (t, dtype, shape) in specs.items():
        if (t.device != device or t.dtype != dtype
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError(
                f"{op}: {name} must be a contiguous {dtype} tensor of shape "
                f"{tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} "
                f"on {t.device} (contiguous={t.is_contiguous()})")


def levels(spatial_shapes):
    """The level table of the MSDA entries: (H_0, W_0, H_1, W_1, ...) as a
    ctypes int array."""
    flat = [int(n) for hw in spatial_shapes for n in hw]
    return (ctypes.c_int * len(flat))(*flat)


def cached_on_storage(w, attr: str, make, *extra):
    """``make()``, computed once and kept under ``attr`` on the tensor that
    owns w's storage (``w._base`` for a view such as a Linear weight's
    ``.t()``, else w). The entry is tied to that tensor's version counter,
    data pointer, dtype and device, to w's shape, strides and offset, and to
    ``extra``, so an in-place update (``copy_``, ``fill_``,
    ``load_state_dict``) or a new ``.data`` makes it again. An inference
    tensor keeps no version counter: ``make()`` runs on every call."""
    base = w if w._base is None else w._base
    if base.is_inference():
        return make()
    key = (base._version, base.data_ptr(), base.dtype, base.device, tuple(w.shape),
           w.stride(), w.storage_offset(), *extra)
    entry = getattr(base, attr, None)
    if entry is None or entry[0] != key:
        entry = (key, make())
        setattr(base, attr, entry)
    return entry[1]


def stream_of(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def _wrappers():
    from dinounet_tpu_torch.ops.attention import (fused_rope_attention,
                                                  fused_rope_attention_premapped,
                                                  fused_rope_attention_premapped_dmaj)
    from dinounet_tpu_torch.ops.conv_hwbc import conv3x3_hwbc
    from dinounet_tpu_torch.ops.decoder_tail import (conv3x3_cm, seg_head_cm,
                                                     transpconv2x2_cm)
    from dinounet_tpu_torch.ops.dense_q8 import (act_amax, dense_cm_q8_partial,
                                                 dense_cm_q8_residual_stats, dense_q8,
                                                 dense_q8_partial, dense_q8_residual_stats,
                                                 post_reduce_q8_residual_stats, qkv_q8_dmaj)
    from dinounet_tpu_torch.ops.dense_stats import (dense_cm_partial,
                                                    dense_cm_residual_stats,
                                                    dense_residual_partial,
                                                    dense_residual_stats,
                                                    post_reduce_residual_stats)
    from dinounet_tpu_torch.ops.msda_kernel import (
        ms_deform_attn_premapped, ms_deform_attn_premapped_backward,
        ms_deform_attn_premapped_fused, ms_deform_attn_premapped_fused_merged)

    return {
        "rope_attention": fused_rope_attention_premapped_dmaj,
        "rope_attention_rm": fused_rope_attention,
        "dense_cm_stats": dense_cm_residual_stats,
        "dense_rm_stats": dense_residual_stats,
        "msda_fwd": ms_deform_attn_premapped_fused,
        "msda_bwd": ms_deform_attn_premapped_backward,
        "msda_fwd_premapped": ms_deform_attn_premapped,
        "msda_fwd_merged": ms_deform_attn_premapped_fused_merged,
        "rope_attention_ndh": fused_rope_attention_premapped,
        "conv3x3_cm": conv3x3_cm,
        "transpconv2x2_cm": transpconv2x2_cm,
        "seg_head_cm": seg_head_cm,
        "conv3x3_hwbc": conv3x3_hwbc,
        "qkv_q8_dmaj": qkv_q8_dmaj,
        "dense_q8": dense_q8,
        "dense_q8_stats": dense_q8_residual_stats,
        "dense_cm_q8_stats": dense_cm_q8_residual_stats,
        "dense_cm_partial": dense_cm_partial,
        "dense_rm_partial": dense_residual_partial,
        "post_reduce_stats": post_reduce_residual_stats,
        "act_amax": act_amax,
        "dense_q8_partial": dense_q8_partial,
        "dense_cm_q8_partial": dense_cm_q8_partial,
        "post_reduce_q8_stats": post_reduce_q8_residual_stats,
    }


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
