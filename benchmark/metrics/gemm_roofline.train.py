"""gemm_roofline.train: as ``gemm_roofline.predict`` over the profiled
train steps: the forward products and the trainable ones' two gradient
products. Layer: kernels (``csrc/``, cuBLAS); moves
``train.patches_per_s``."""

CONV = ("fprop", "dgrad", "wgrad", "cudnn", "conv2d", "convolve", "implicit_convolve")
DENSE = ("dense_stats_kernel", "gelu_prepass", "post_reduce", "nvjet", "gemm", "cutlass")


def read(ctx):
    prof = ctx.get("profile") if ctx.get("kind") == "train" else None
    if not prof:
        return None
    secs = sum(s for name, (s, _n) in prof["kernels"].items()
               if not any(c in name for c in CONV) and any(d in name for d in DENSE))
    return None if secs <= 0 else 100.0 * prof["dense_bound_s"] / secs
