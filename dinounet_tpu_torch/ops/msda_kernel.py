"""Multi-scale deformable attention forward with fused prep — CUDA kernel wrapper.

Replaces the TPU kernel ``dinounet_tpu/ops/msda_pallas.py::
_fwd_kernel_fused`` (body ``_fused_core``), reached through
``ms_deform_attn_pallas_premapped_fused``; the kernel is
``dinounet_tpu_torch/csrc/msda_fwd.cu``, whose header says what bounds it on
an H100 and how it is laid out. The function is the one
``ops/msda.py::ms_deform_attn_premapped_fused_plain`` computes: that plain
version runs for tensors on the CPU, the kernel for tensors on a CUDA device.

The kernel takes a single level (L = 1: the adapter samples the one ViT patch
grid), D <= 64 channels per head and at most 16 points, bf16 value / offsets /
logits and an fp32 base grid, and returns bf16.
"""

from typing import Sequence, Tuple

import torch

from dinounet_tpu_torch.ops import _build
from dinounet_tpu_torch.ops.msda import ms_deform_attn_premapped_fused_plain

MAX_D = 64
MAX_POINTS = 16


def ms_deform_attn_premapped_fused(
        value_t: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
        off: torch.Tensor, logits: torch.Tensor,
        base: torch.Tensor) -> torch.Tensor:
    """value_t (B, M, D, S); off (B, M, 2P, Lq); logits (B, M, P, Lq);
    base (2P, Lq) fp32 -> (B, M, D, Lq). See ops/msda.py."""
    if value_t.device.type == "cpu":
        return ms_deform_attn_premapped_fused_plain(
            value_t, spatial_shapes, off, logits, base)
    if value_t.device.type != "cuda":
        raise ValueError(f"no MSDA kernel for device {value_t.device}")
    if len(spatial_shapes) != 1:
        raise ValueError("the MSDA kernel samples one level; got "
                         f"{len(spatial_shapes)}")
    (H, W), = spatial_shapes
    B, M, D, S = value_t.shape
    P, Lq = logits.shape[2], logits.shape[3]
    if S != H * W or not 0 < D <= MAX_D or not 0 < P <= MAX_POINTS:
        raise ValueError(f"MSDA kernel takes S == H*W, D <= {MAX_D} and "
                         f"P <= {MAX_POINTS}; got S={S}, H*W={H * W}, D={D}, "
                         f"P={P}")
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


ms_deform_attn_premapped_fused.launches = 0
