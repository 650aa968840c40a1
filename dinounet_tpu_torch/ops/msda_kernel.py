"""Multi-scale deformable attention with fused prep — CUDA kernel wrappers.

Forward: replaces the TPU kernel ``dinounet_tpu/ops/msda_pallas.py::
_fwd_kernel_fused`` (body ``_fused_core``), reached through
``ms_deform_attn_pallas_premapped_fused``; the kernel is
``dinounet_tpu_torch/csrc/msda_fwd.cu``. Backward: replaces ``_bwd_kernel``
(via ``_backward_premapped``); the kernel is ``csrc/msda_bwd.cu``. Each
kernel's header says what bounds it on an H100 and how it is laid out. The
functions are the ones ``ops/msda.py`` computes in plain PyTorch: those plain
versions run for tensors on the CPU, the kernels for tensors on a CUDA device,
and any other device raises.

``ms_deform_attn_premapped_fused`` is differentiable with respect to value,
offsets and logits (an ``autograd.Function``, the JAX package's custom VJP):
its backward recomputes the prep from the saved inputs, runs the backward
kernel (or plain backward), and chain-rules the point softmax,
g_logits = s * (g_s - sum_p g_s * s), as ``_premapped_fused_bwd`` does. The
base grid is built from constant reference points and gets no gradient.

The kernels take a single level (L = 1: the adapter samples the one ViT patch
grid) and at most 16 points, and up to ``MAX_D`` = 128 channels per head
(dinounet_7b's adapter heads; above 64 the forward kernel splits a head
into 32-channel slices across blocks). The backward also needs a head's
whole value map and gradient in shared memory (``MAX_SMEM``: 28
channels at S = 1024). The forward takes
bf16 value / offsets / logits and an fp32 base grid and returns bf16; the
backward takes the bf16 value map and fp32 coordinates, weights and cotangent
and returns fp32 gradients.
"""

from typing import Sequence, Tuple

import torch

from dinounet_tpu_torch.ops import _build
from dinounet_tpu_torch.ops.msda import (ms_deform_attn_premapped_backward_plain,
                                         ms_deform_attn_premapped_fused_plain,
                                         premapped_fused_prep)

MAX_D = 128
MAX_POINTS = 16
# the shared memory a block may have (227 KB). The forward block stages one
# head's bf16 value map, or a 32-channel slice of a head wider than 64
# channels; the backward block keeps the head's bf16 value map and an fp32
# gv partial (6 bytes per position and channel) and stages 512 queries'
# fp32 cotangents (2 KB per channel)
MAX_SMEM = 232448


def _single_level(op: str, value_t, spatial_shapes, P: int):
    if len(spatial_shapes) != 1:
        raise ValueError(f"{op}: the kernel samples one level; got "
                         f"{len(spatial_shapes)}")
    (H, W), = spatial_shapes
    D, S = value_t.shape[2], value_t.shape[3]
    if S != H * W or not 0 < D <= MAX_D or not 0 < P <= MAX_POINTS:
        raise ValueError(f"{op} takes S == H*W, D <= {MAX_D} and "
                         f"P <= {MAX_POINTS}; got S={S}, H*W={H * W}, D={D}, "
                         f"P={P}")
    return H, W


def _forward(value_t, spatial_shapes, off, logits, base) -> torch.Tensor:
    if value_t.device.type == "cpu":
        return ms_deform_attn_premapped_fused_plain(
            value_t, spatial_shapes, off, logits, base)
    if value_t.device.type != "cuda":
        raise ValueError(f"no MSDA kernel for device {value_t.device}")
    B, M, D, S = value_t.shape
    P, Lq = logits.shape[2], logits.shape[3]
    H, W = _single_level("ms_deform_attn_premapped_fused", value_t,
                         spatial_shapes, P)
    smem = 2 * (D if D <= 64 else 32) * S
    if smem > MAX_SMEM:
        raise ValueError(f"MSDA forward kernel: a {D} x {S} head needs {smem} "
                         f"bytes of shared memory a block, over {MAX_SMEM}")
    bf16 = torch.bfloat16
    _build.check_inputs(
        "ms_deform_attn_premapped_fused", value_t.device,
        value_t=(value_t, bf16, (B, M, D, S)),
        off=(off, bf16, (B, M, 2 * P, Lq)),
        logits=(logits, bf16, (B, M, P, Lq)),
        base=(base, torch.float32, (2 * P, Lq)))
    out = torch.empty((B, M, D, Lq), dtype=bf16, device=value_t.device)
    err = _build.lib().msda_fwd_fused(
        value_t.data_ptr(), off.data_ptr(), logits.data_ptr(),
        base.data_ptr(), out.data_ptr(), B, M, D, H, W, P, Lq,
        _build.stream_of(value_t.device))
    _build.check(err, "msda_fwd_fused")
    ms_deform_attn_premapped_fused.launches += 1
    return out


def ms_deform_attn_premapped_backward(
        value_t: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
        xs: torch.Tensor, ys: torch.Tensor, aw: torch.Tensor,
        g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """value_t (B, M, D, S); xs, ys, aw (B, M, P, Lq) fp32; g (B, M, D, Lq)
    fp32 -> fp32 (gv, ga, gx, gy). See ops/msda.py."""
    if value_t.device.type == "cpu":
        return ms_deform_attn_premapped_backward_plain(
            value_t, spatial_shapes, xs, ys, aw, g)
    if value_t.device.type != "cuda":
        raise ValueError(f"no MSDA backward kernel for device {value_t.device}")
    B, M, D, S = value_t.shape
    P, Lq = xs.shape[2], xs.shape[3]
    H, W = _single_level("ms_deform_attn_premapped_backward", value_t,
                         spatial_shapes, P)
    smem = 6 * D * S + 2048 * D
    if smem > MAX_SMEM:
        raise ValueError(f"MSDA backward kernel: a {D} x {S} head needs "
                         f"{smem} bytes of shared memory, over {MAX_SMEM}")
    f32 = torch.float32
    lane = (B, M, P, Lq)
    _build.check_inputs(
        "ms_deform_attn_premapped_backward", value_t.device,
        value_t=(value_t, torch.bfloat16, (B, M, D, S)),
        xs=(xs, f32, lane), ys=(ys, f32, lane), aw=(aw, f32, lane),
        g=(g, f32, (B, M, D, Lq)))
    gv = torch.zeros((B, M, D, S), dtype=f32, device=value_t.device)
    ga, gx, gy = (torch.empty(lane, dtype=f32, device=value_t.device)
                  for _ in range(3))
    err = _build.lib().msda_bwd(
        value_t.data_ptr(), xs.data_ptr(), ys.data_ptr(), aw.data_ptr(),
        g.data_ptr(), gv.data_ptr(), ga.data_ptr(), gx.data_ptr(),
        gy.data_ptr(), B, M, D, H, W, P, Lq, _build.stream_of(value_t.device))
    _build.check(err, "msda_bwd")
    ms_deform_attn_premapped_backward.launches += 1
    return gv, ga, gx, gy


class _MSDAFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value_t, off, logits, base, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value_t, off, logits, base)
        return _forward(value_t, spatial_shapes, off, logits, base)

    @staticmethod
    def backward(ctx, g):
        value_t, off, logits, base = ctx.saved_tensors
        B, M, LP, Lq = logits.shape
        xs, ys, s = premapped_fused_prep(off, logits, base)
        gv, gs, gx, gy = ms_deform_attn_premapped_backward(
            value_t, ctx.spatial_shapes, xs.contiguous(), ys.contiguous(), s,
            g.float().contiguous())
        g_logits = s * (gs - (gs * s).sum(dim=2, keepdim=True))
        g_off = torch.stack([gx, gy], dim=3).reshape(B, M, 2 * LP, Lq)
        return (gv.to(value_t.dtype), g_off.to(off.dtype),
                g_logits.to(logits.dtype), None, None)


def ms_deform_attn_premapped_fused(
        value_t: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
        off: torch.Tensor, logits: torch.Tensor,
        base: torch.Tensor) -> torch.Tensor:
    """value_t (B, M, D, S); off (B, M, 2P, Lq); logits (B, M, P, Lq);
    base (2P, Lq) fp32 -> (B, M, D, Lq). See ops/msda.py."""
    return _MSDAFused.apply(value_t, off, logits, base, tuple(spatial_shapes))


ms_deform_attn_premapped_fused.launches = 0
ms_deform_attn_premapped_backward.launches = 0
