"""3x3 decoder convolutions over (H, W, B, C) maps, with one or two inputs.

Counterpart of ``dinounet_tpu/ops/conv_hwbc_pallas.py``: ``conv3x3_hwbc``
takes its (H, W, B, C) operands, the optional InstanceNorm-apply + leaky
prologue and the conv0 form whose input is the channel concat of two maps
(the reference order [transpconv_out, skip]), and returns the rounded output
with its per-(sample, channel) sums for the next InstanceNorm.

On the TPU the layout is XLA's own physical layout of the decoder's maps, so
the transposes around the call are free. Here a model map is NCHW, and
``x.permute(2, 3, 0, 1)`` is an (H, W, B, C) view of the same buffer: the
kernel (``csrc/conv3x3_stats.cu``, shared with ``conv3x3_cm``) reads and
writes through the strides it is given, so neither direction costs a copy.
For CUDA tensors the wrapper launches it; for CPU tensors the plain version
runs. Inference-only, as in the JAX package.
"""

from typing import Optional, Tuple

import torch

from dinounet_tpu_torch.ops import _build
from dinounet_tpu_torch.ops.decoder_tail import (Prologue, _device_of,
                                                 conv3x3_cm_plain, conv3x3_launch,
                                                 instance_norm_apply_params)

# The JAX package's compile-proven Mosaic budgets, which decide where its
# route engages (conv_hwbc_pallas.py:177-184); the port copies them so that
# both packages take the route on the same shapes.
_VREG_BUDGET = 1024
_VREG_BUDGET_W512 = 512
_W_MAX = 512

# InstanceNorm (scale, shift) from the row statistics: the same function
instance_norm_prologue_params = instance_norm_apply_params


def _pick_rh(h: int, w: int = 128, b: int = 8, co: int = 32,
             cap: int = 8) -> Optional[int]:
    """The JAX kernel's row stripe: the largest divisor of h whose (M, 3*Co)
    accumulator fits its Mosaic budget, or None."""
    budget = _VREG_BUDGET_W512 if w >= 512 else _VREG_BUDGET
    tiles = (3 * co + 127) // 128
    for r in range(min(cap, h), 0, -1):
        if h % r == 0 and (r * w * b // 8) * tiles <= budget:
            return r
    return None


def hwbc_supported(shape: Tuple[int, ...]) -> bool:
    """(B, H, W, C) eligibility, as in the JAX package: 2-D maps, W a
    multiple of 128 up to 512, B a multiple of 8, a row stripe within
    budget."""
    if len(shape) != 4:
        return False
    B, H, W, C = shape
    return (W % 128 == 0 and W <= _W_MAX and B % 8 == 0 and H >= 2
            and _pick_rh(H, W, B, C) is not None)


def _nchw(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.permute(2, 3, 0, 1)


def conv3x3_hwbc_plain(x, w, b, x2=None, prologue: Prologue = None,
                       leaky_slope: float = 0.01):
    y, ssum, ssq = conv3x3_cm_plain(_nchw(x), w, b, prologue, leaky_slope, True,
                                    _nchw(x2))
    return y.permute(2, 3, 0, 1), ssum, ssq


def conv3x3_hwbc(x, w, b, x2=None, prologue: Prologue = None,
                 leaky_slope: float = 0.01):
    """3x3 SAME conv over (H, W, B, Ci) input(s). x2, when given, is
    concatenated after x along C. w: (Co, Ci_total, 3, 3); b: (Co,);
    prologue: None or (scale, shift), each (B, Ci_total) fp32, applied as
    leaky(x * scale + shift) before the conv. Returns (y (H, W, B, Co) in
    x's dtype, ssum (B, Co), ssq (B, Co)) with the sums over H * W of the
    rounded y. On the card y has the memory layout of x: an (H, W, B, C) view
    of an NCHW buffer in, the same out."""
    dev = _device_of(x, "conv3x3_hwbc")
    if dev is None:
        return conv3x3_hwbc_plain(x, w, b, x2, prologue, leaky_slope)
    H, W, B, _ = x.shape
    Co = w.shape[0]
    if _nchw(x).is_contiguous():
        y = torch.empty((B, Co, H, W), dtype=x.dtype, device=dev).permute(2, 3, 0, 1)
    else:
        y = torch.empty((H, W, B, Co), dtype=x.dtype, device=dev)
    sums = conv3x3_launch("conv3x3_hwbc", _nchw(x), _nchw(x2), w, b, prologue,
                          leaky_slope, True, _nchw(y))
    conv3x3_hwbc.launches += 1
    return y, sums[0], sums[1]


conv3x3_hwbc.launches = 0
