"""How a kernel is held against its plain version on the card.

A kernel output ``got`` agrees with the plain output ``want`` where
|got - want| <= atol + rtol * |want| everywhere. The bounds per kernel, and
why each is what it is:

- ``msda_fwd`` / ``msda_fwd_merged`` / ``msda_fwd_premapped`` (a bf16 map):
  both accumulate in fp32 in another order and round the result to bf16
  (2^-8 relative); outputs are O(1) weighted means of the value map. Over an
  fp32 map the premapped kernel's output is fp32, within 1e-5.
- ``msda_bwd``: all four outputs are fp32 from the same fp32 coordinates and
  values; they differ only in summation order (gv sums a few hundred corner
  terms per position, in an order the kernel's atomics change from run to
  run -- the shared-memory instance's block partials and the global
  instance's adds into device memory alike; ga, gx, gy sum 4 corners x D
  channels). fp32 rounding of such sums stays near 1e-5 of their terms'
  magnitude (O(1) here); 1e-3 still catches a wrong corner, weight, level or
  sign, which moves outputs by O(0.1).
- ``rope_attention`` / ``rope_attention_rm`` / ``rope_attention_ndh`` (the
  three layouts, one flash loop):
  the kernel's online softmax rounds exp(s - running max) to bf16 where the
  plain version rounds exp(s - row max), so probabilities differ by up to a
  bf16 rounding (0.4%) each, on top of the bf16 output.
- ``dense_rm_stats`` / ``dense_cm_stats``: the fp32 accumulator is rounded to
  bf16 and then four bf16 ops follow; one accumulation-order difference can
  move the output by a bf16 ulp of the residual stream (|out| up to ~4 here,
  an ulp 0.016), and the statistics follow the stored rows.
- ``dense_cm_partial`` / ``dense_rm_partial`` (the row-parallel mode: the
  fp32 product itself): the same exact products of bf16 values summed in
  fp32 in another order (~1e-6 of the O(1) outputs); with the GELU, an erf
  an ulp apart can flip one activation's bf16 rounding, which moves an
  output by that activation's ulp times its weight (~1e-4 here); 2e-3
  catches a dropped K step or a misplaced tile, which moves outputs by
  O(0.1).
- ``post_reduce_stats``: the same bf16 roundings of the same values as the
  plain version, so the output is equal bit for bit (checked as such); the
  statistics sum the stored rows in another order (~1e-6).
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
- ``seg_head_cm``: fp32 logits from exact products, summed by the tensor
  cores' fp32 accumulation in another order; the prologue's fused
  multiply-add can flip the bf16 rounding of an activation (one ulp, ~4e-3 of
  it), which moves a logit by ~1e-3 at these weights.
- ``qkv_q8_dmaj`` / ``dense_q8`` / ``dense_q8_stats`` / ``dense_cm_q8_stats``
  (the int8 ops): the int8 levels come from the same IEEE divisions and
  half-to-even roundings, the int32 sums are exact in any order, and the
  kernels' rescale and epilogue round where the plain versions do (no FMA
  contraction), so the outputs agree bit for bit (max abs error 0 at every
  path shape on an H100) and the statistics, sums of the stored rows in
  another order, within ~4e-7. What can still move an output: a GELU value
  whose fp32 erf differs by an ulp between the kernel's build and
  PyTorch's can cross a bf16 edge and move that element by one int8 level,
  which moves the output by under one bf16 ulp (2^-7 relative at most).
  Bound atol 1e-5 + rtol 2^-7: a wrong scale, a dropped K step or a
  misplaced tile moves outputs by O(0.1).
- ``act_amax`` (the quantize pass's first mode: each token's max|act(h)|):
  the maximum of the same bf16 values, equal to the plain version's without
  the GELU; with it, a value whose erf differs by an ulp can cross a bf16
  edge, which moves a maximum by one bf16 ulp (2^-7 relative at most).
- ``dense_cm_q8_partial`` (#12's row-parallel mode): the same levels at the
  same given scales and an exact int32 sum: equal (the int32 product and the
  per-token scales, checked as such). ``dense_q8_partial`` (#11's, with the
  GELU): the scales are equal; an erf an ulp apart can move a GELU value
  across a bf16 edge and its level by one, which moves that token's int32
  sums by the weight's level there (at most 127); 512 allows four such
  flips in a row, where a wrong scale or a dropped K step moves them by
  O(1e4). Its GEMM alone is held exactly: equal to torch._int_mm on the
  kernel's own levels.
- ``post_reduce_q8_stats`` (the int8 mode's epilogue on the summed int32
  product): the same roundings as the plain version, so the output is
  equal bit for bit (checked as such); the statistics sum the stored rows
  in another order than PyTorch's mean (~1e-6), in the order of the whole
  op's kernel, whose statistics they equal.
"""

from typing import Callable, Dict, Tuple

import torch

KERNEL_TOLERANCES: Dict[str, Tuple[float, float]] = {  # (atol, rtol)
    "msda_fwd": (1e-2, 1e-2),
    "msda_fwd_merged": (1e-2, 1e-2),
    "msda_fwd_premapped": (1e-2, 1e-2),
    "msda_bwd": (1e-3, 1e-3),
    "rope_attention": (2e-2, 2e-2),
    "rope_attention_rm": (2e-2, 2e-2),
    "rope_attention_ndh": (2e-2, 2e-2),
    "dense_rm_stats": (2e-2, 1e-2),
    "dense_cm_stats": (2e-2, 1e-2),
    "dense_cm_partial": (2e-3, 1e-3),
    "dense_rm_partial": (2e-3, 1e-3),
    "post_reduce_stats": (1e-4, 1e-4),
    "conv3x3_cm": (2e-2, 1e-2),
    "conv3x3_hwbc": (2e-2, 1e-2),
    "transpconv2x2_cm": (2e-2, 1e-2),
    "seg_head_cm": (1e-2, 1e-2),
    "qkv_q8_dmaj": (1e-5, 2.0 ** -7),
    "dense_q8": (1e-5, 2.0 ** -7),
    "dense_q8_stats": (1e-5, 2.0 ** -7),
    "dense_cm_q8_stats": (1e-5, 2.0 ** -7),
    "act_amax": (0.0, 2.0 ** -7),
    "dense_q8_partial": (512.0, 0.0),
    "dense_cm_q8_partial": (0.0, 0.0),
    "post_reduce_q8_stats": (1e-4, 1e-4),
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
