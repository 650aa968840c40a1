"""What every cell shares: finding a cell's files by name, the environment a
run gives the program, module timers and counters, the device trace's
reduction to busy time, idle gaps and kernel families, the per-layer
metrics' discovery, the check against the JAX packages, and the result line.

A cell is found by its name in ``BENCHMARK.json``: its configuration is the
file that entry names, its traffic ``<bench>/traffic/<traffic>.json``, its
correctness limits ``<bench>/checks/<cell>.json``, and each per-layer metric
``<bench>/metrics/<metric>.py``, where ``<bench>`` is the first of ``paths``.
So a later change adds a configuration, a mix, a cell or a metric as new
files and edits none.
"""

import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "dinounet_tpu")
# kernel families by name, the first match wins: cuDNN's conv names before
# the GEMM names that some of its kernels share
FAMILIES = (("port attention", ("rope_attention", "rope_prep")),
            ("port MSDA", ("msda_",)),
            ("port convs", ("conv3x3_kernel", "transpconv2x2_kernel", "seg_head")),
            ("port dense", ("dense_stats_kernel", "gelu_prepass", "post_reduce", "q8_gemm",
                            "quant_rows", "quant_cm", "qkv_q8")),
            ("cuDNN conv", ("fprop", "dgrad", "wgrad", "cudnn", "conv2d", "convolve",
                            "xmma", "implicit_convolve")),
            ("cuBLAS GEMM", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
            ("PyTorch convs and pools", ("depthwise", "max_pool", "im2col", "col2im")),
            ("copies", ("copy", "Copy", "Memcpy", "Memset", "memcpy", "memset")))


NAME_CHARS = 160  # a kernel's name in the breakdown, cut after its template's head


def family(kernel: Optional[str]) -> str:
    if kernel is None:
        return "start"
    for name, keys in FAMILIES:
        if any(k in kernel for k in keys):
            return name
    return "elementwise"


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic, checks
    and per-layer metrics."""

    def __init__(self, root: Path, workload: str):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)
        self.bench = self.root / self.spec["paths"][0]
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.name = workload
        self.workload = cells[workload]
        entry = {c["name"]: c for c in self.spec["configs"]}[self.workload["config"]]
        with open(self.root / entry["file"]) as f:
            self.cfg = json.load(f)
        with open(self.bench / "traffic" / f"{self.workload['traffic']}.json") as f:
            self.mix = json.load(f)
        with open(self.bench / "checks" / f"{workload}.json") as f:
            self.limits = json.load(f)
        self.chips = int(self.workload["chips"])

    def end_to_end(self) -> List[dict]:
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> List[dict]:
        moved = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in moved)]

    def reader(self, metric: str):
        path = self.bench / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"bench_metric_{len(sys.modules)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def program_env(root: Path, cfg: dict) -> None:
    """The program's environment: its caches at fixed paths in the checkout,
    its data under TMPDIR, no JAX pulled in by a library, the configuration's
    route settings and no other."""
    build = Path(root) / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for k in [k for k in os.environ if k.startswith("DINOUNET_TPU_")]:
        del os.environ[k]
    os.environ.update({k: str(v) for k, v in cfg.get("env", {}).items()})


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among `names` (default: the modules
    loaded), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class ModuleTimer:
    """CUDA events around every call of a module, from forward pre- and
    post-hooks; `ms()` reads them after a synchronize."""

    def __init__(self, module, torch):
        self.torch, self.pairs = torch, []
        self.handles = [module.register_forward_pre_hook(self._pre),
                        module.register_forward_hook(self._post)]

    def _pre(self, *_):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        self.pairs.append([e, None])

    def _post(self, *_):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        self.pairs[-1][1] = e

    def ms(self) -> List[float]:
        return [a.elapsed_time(b) for a, b in self.pairs if b is not None]

    def remove(self):
        for h in self.handles:
            h.remove()


class SlotCounter:
    """Calls and batch slots the network is given, from a forward pre-hook."""

    def __init__(self, module):
        self.calls = self.slots = 0
        self.handle = module.register_forward_pre_hook(self._pre)

    def _pre(self, _module, args):
        self.calls += 1
        self.slots += int(args[0].shape[0])

    def remove(self):
        self.handle.remove()


class Capture:
    """The first argument and the output tensors of a module's calls while
    `armed`, copied to the host as the calls are issued: into pinned memory
    without a synchronize from a device, so that capturing inside a
    measured window costs the copies alone. Read `calls` [(input, [output
    tensors])] after a synchronize."""

    def __init__(self, module, torch):
        self.torch, self.armed, self.calls = torch, False, []
        self.handle = module.register_forward_hook(self._post)

    def _host(self, t):
        buf = self.torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        return buf.copy_(t, non_blocking=True)

    def _post(self, _module, args, out):
        if self.armed:
            outs = out if isinstance(out, (list, tuple)) else [out]
            self.calls.append((self._host(args[0]), [
                self._host(o[0] if isinstance(o, (list, tuple)) else o) for o in outs]))

    def remove(self):
        self.handle.remove()


def reduce_trace(path: str, window_s: float, top: int = 10) -> dict:
    """Reduce a device-only profiler trace of a window of `window_s` seconds
    on the host's clock (synchronized at both ends): the device's busy
    seconds (the union of its kernels, copies and sets), device seconds by
    kernel, and the longest idle gaps between device operations, each named
    by the families of the operations on its two sides. (A trace of the
    host's operations too would name the gaps by host ranges, but its cost
    stretches the window and inflates the idle share.)"""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not device:
        raise RuntimeError("the trace holds no device operation")
    kernels: Dict[str, List[float]] = {}
    busy, cursor, prev, gaps = 0.0, device[0][0], None, []
    for a, b, name in device:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (b - a) / 1e6
        k[1] += 1
        if a > cursor:
            gaps.append((a - cursor, f"{family(prev)} -> {family(name)}"))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
            prev = name
    gaps.sort(key=lambda g: -g[0])
    return {"busy_s": busy / 1e6, "window_s": window_s,
            "kernels": {n: (v[0], v[1]) for n, v in kernels.items()},
            "device_ops": [[n[:NAME_CHARS], v[0]] for n, v in
                           sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]],
            "idle_gaps": [[name, g / 1e6] for g, name in gaps[:top]]}


def profiled(fn, torch) -> dict:
    """Run fn() under a device-only profiler between two synchronizes and
    reduce its trace (``reduce_trace``)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = now()
        fn()
        torch.cuda.synchronize()
        window_s = now() - t
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return reduce_trace(path, window_s)
    finally:
        os.remove(path)


def family_seconds(kernels: Dict[str, tuple]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, (secs, _n) in kernels.items():
        f = family(name)
        out[f] = out.get(f, 0.0) + secs
    return out


def quantile(values: List[float], q: float) -> float:
    """The q-quantile by linear interpolation between order statistics."""
    v = sorted(values)
    pos = q * (len(v) - 1)
    i = int(pos)
    return v[i] if i + 1 >= len(v) else v[i] + (v[i + 1] - v[i]) * (pos - i)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: Dict[str, tuple], breakdown: Optional[dict] = None) -> str:
    """The contract's last line: the checks last, each number beside its limit."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return json.dumps(out)


def now() -> float:
    return time.perf_counter()
