"""elementwise_ms.predict: profiler device ms a tile-batch forward in the
kernels outside every counted family of ``harness.FAMILIES`` (the port's
kernels, cuDNN, cuBLAS, PyTorch's convs and pools, copies): PyTorch's
elementwise, reduction and norm kernels, the sliding window's accumulation
among them. Layer: kernels (PyTorch's elementwise, reduction and norm
kernels); moves ``predict.mpx_per_s``."""

import harness


def read(ctx):
    prof = ctx.get("profile") if ctx.get("kind") == "cases" else None
    if not prof or not prof.get("calls"):
        return None
    secs = harness.family_seconds(prof["kernels"]).get("elementwise", 0.0)
    return 1e3 * secs / prof["calls"]
