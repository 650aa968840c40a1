"""How a kernel is held against its plain version on the card.

A kernel output ``got`` agrees with the plain output ``want`` where
|got - want| <= atol + rtol * |want| everywhere. The bounds per kernel, and
why each is what it is:

- ``msda_fwd``: both accumulate in fp32 in another order and round the result
  to bf16 (2^-8 relative); outputs are O(1) weighted means of the value map.
- ``msda_bwd``: all four outputs are fp32 from the same fp32 coordinates and
  bf16 values; they differ only in summation order (gv sums a few hundred
  corner terms per position, in an order the kernel's atomics change from run
  to run; ga, gx, gy sum 4 corners x D channels). fp32 rounding of such sums
  stays near 1e-5 of their terms' magnitude (O(1) here); 1e-3 still catches
  a wrong corner, weight or sign, which moves outputs by O(0.1).
- ``rope_attention``: the kernel's online softmax rounds exp(s - running max)
  to bf16 where the plain version rounds exp(s - row max), so probabilities
  differ by up to a bf16 rounding (0.4%) each, on top of the bf16 output.
- ``dense_rm_stats`` / ``dense_cm_stats``: the fp32 accumulator is rounded to
  bf16 and then four bf16 ops follow; one accumulation-order difference can
  move the output by a bf16 ulp of the residual stream (|out| up to ~4 here,
  an ulp 0.016), and the statistics follow the stored rows.
- ``conv3x3_cm`` / ``conv3x3_hwbc`` / ``transpconv2x2_cm`` (the bf16 map):
  both sum the same exact products of bf16 values in fp32, in another order,
  add the fp32 bias and round once, and the kernel applies the prologue with
  one fused multiply-add where the plain version rounds twice; each can move
  a stored value by one bf16 ulp (2^-8 relative, 0.03 at |y| = 8).
- The conv statistics are compared as means over the H * W pixels
  (``STATS_TOLERANCE``): the kernel adds per-block partial sums with fp32
  atomics in an order that changes from run to run, and ulp flips of single
  pixels move a mean by ~1e-6; 1e-3 still catches a sum taken over the wrong
  pixels or channels, which moves a mean by O(0.1).
- ``seg_head_cm``: fp32 logits from exact products; the prologue's fused
  multiply-add can flip the bf16 rounding of an activation (one ulp, ~4e-3 of
  it), which moves a logit by ~1e-3 at these weights.
"""

from typing import Callable, Dict, Tuple

import torch

KERNEL_TOLERANCES: Dict[str, Tuple[float, float]] = {  # (atol, rtol)
    "msda_fwd": (1e-2, 1e-2),
    "msda_bwd": (1e-3, 1e-3),
    "rope_attention": (2e-2, 2e-2),
    "dense_rm_stats": (2e-2, 1e-2),
    "dense_cm_stats": (2e-2, 1e-2),
    "conv3x3_cm": (2e-2, 1e-2),
    "conv3x3_hwbc": (2e-2, 1e-2),
    "transpconv2x2_cm": (2e-2, 1e-2),
    "seg_head_cm": (1e-2, 1e-2),
}
STATS_TOLERANCE: Tuple[float, float] = (1e-3, 1e-3)


def max_excess(got: torch.Tensor, want: torch.Tensor,
               tol: Tuple[float, float]) -> float:
    """max(|got - want| - (atol + rtol |want|)): <= 0 where they agree."""
    if got.shape != want.shape:
        raise ValueError(f"shapes differ: {tuple(got.shape)} vs {tuple(want.shape)}")
    atol, rtol = tol
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    return float(((g - w).abs() - (atol + rtol * w.abs())).max())


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def median_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in milliseconds, by CUDA events around each
    call (each call is one synchronised sample)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]
