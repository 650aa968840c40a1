"""gemm_roofline.predict: the least time of the model's dense products in
the profiled cycles (each max(FLOPs / 989e12, bytes / 3.35e12), from the
configuration's shapes at the forward's tile batch) over the device time of
the kernels that carry them: the port's dense kernels and cuBLAS's, by the
names below, cuDNN's conv names excluded first. Layer: kernels (``csrc/``,
cuBLAS); moves ``predict.mpx_per_s``."""

CONV = ("fprop", "dgrad", "wgrad", "cudnn", "conv2d", "convolve", "implicit_convolve")
DENSE = ("dense_stats_kernel", "gelu_prepass", "post_reduce", "nvjet", "gemm", "cutlass")


def dense_seconds(kernels):
    return sum(s for name, (s, _n) in kernels.items()
               if not any(c in name for c in CONV) and any(d in name for d in DENSE))


def read(ctx):
    prof = ctx.get("profile") if ctx.get("kind") == "cases" else None
    if not prof:
        return None
    secs = dense_seconds(prof["kernels"])
    return None if secs <= 0 else 100.0 * prof["dense_bound_s"] / secs
