"""Multi-scale deformable attention, fused-prep premapped form — plain PyTorch.

The function the JAX package's ``ops/msda_pallas.py::
ms_deform_attn_pallas_premapped_fused`` computes (its prep,
``_premapped_fused_prep``, followed by the ``ms_deform_attn_core`` sampling),
in the kernel-native layouts:

    value_t (B, M, D, S)         S = sum of H_l * W_l over levels
    off     (B, M, 2*L*P, Lq)    raw offsets, rows 2r / 2r+1 = x / y of point r
    logits  (B, M, L*P, Lq)      pre-softmax attention logits
    base    (2*L*P, Lq) fp32     reference point * level size - 0.5, same rows

    x, y = f32(off) + base            (pixel coordinates, align_corners=False)
    a    = softmax over the L*P points of f32(logits)
    out[b, m, :, q] = sum_r a[r, q] * bilinear(value level of r, x[r, q], y[r, q])

with zero padding outside the map, as ``F.grid_sample(bilinear, zeros,
align_corners=False)``. Returns (B, M, D, Lq) in value_t's dtype, accumulated
in fp32. This is the CPU path of ``ops/msda_kernel.py`` and the reference the
CUDA kernel is held against.
"""

from typing import Sequence, Tuple

import torch


def _bilinear_sample(v: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     H: int, W: int) -> torch.Tensor:
    """v (B, M, D, H*W) fp32; x, y (B, M, Lq) pixel coords -> (B, M, D, Lq)."""
    D = v.shape[2]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.long()
    y0 = y0.long()
    out = None
    for dy, dx, wgt in ((0, 0, (1.0 - fy) * (1.0 - fx)),
                        (0, 1, (1.0 - fy) * fx),
                        (1, 0, fy * (1.0 - fx)),
                        (1, 1, fy * fx)):
        yy = y0 + dy
        xx = x0 + dx
        valid = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        g = torch.gather(v, 3, idx[:, :, None, :].expand(-1, -1, D, -1))
        contrib = g * torch.where(valid, wgt, 0.0)[:, :, None, :]
        out = contrib if out is None else out + contrib
    return out


def ms_deform_attn_premapped_fused_plain(
        value_t: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
        off: torch.Tensor, logits: torch.Tensor,
        base: torch.Tensor) -> torch.Tensor:
    """See the module docstring."""
    B, M, D, S = value_t.shape
    LP, Lq = logits.shape[2], logits.shape[3]
    P = LP // len(spatial_shapes)
    if S != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value has {S} positions, spatial_shapes "
                         f"{tuple(spatial_shapes)} hold a different number")
    coords = off.float() + base.float()
    xs, ys = coords[:, :, 0::2], coords[:, :, 1::2]
    attn = torch.softmax(logits.float(), dim=2)
    v = value_t.float()
    out = torch.zeros((B, M, D, Lq), dtype=torch.float32, device=v.device)
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        v_l = v[..., start:start + H * W]
        for p in range(P):
            r = lvl * P + p
            out += (_bilinear_sample(v_l, xs[:, :, r], ys[:, :, r], H, W)
                    * attn[:, :, r, None, :])
        start += H * W
    return out.to(value_t.dtype)
