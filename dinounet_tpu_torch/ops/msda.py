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
CUDA kernel is held against. It is ``premapped_fused_prep`` followed by
``ms_deform_attn_premapped_plain``, the sampling with the prep done outside
(``_forward_premapped``), which also serves the reference-layout
``ms_deform_attn_core_plain`` (``dinounet_tpu/ops/msda.py::
ms_deform_attn_core``) after ``reference_layout_prep``;
``ms_deform_attn_premapped_fused_merged_plain`` takes the offsets and logits
from one packed buffer.

``ms_deform_attn_premapped_backward_plain`` is the backward the JAX package's
``_backward_premapped`` computes from the prepped coordinates and weights
(``premapped_fused_prep``): the value gradient as an explicit scatter-add of
the four corner terms, and the weight / coordinate gradients from re-sampled
values and the separable bilinear derivatives. It is written out, not taken
from autograd of the forward, so that it is an independent oracle for the
CUDA backward kernel.
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
    return ms_deform_attn_premapped_plain(value_t, spatial_shapes,
                                          *premapped_fused_prep(off, logits, base))


def ms_deform_attn_premapped_fused_merged_plain(
        value_t: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
        packed: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """The fused function over one packed (B, M, 3*L*P, Lq) buffer
    (``msda_pallas.ms_deform_attn_pallas_premapped_fused_merged``): rows
    [0, 2LP) of each head are the raw offsets, rows [2LP, 3LP) the logits."""
    LP2 = 2 * packed.shape[2] // 3
    return ms_deform_attn_premapped_fused_plain(value_t, spatial_shapes, packed[:, :, :LP2],
                                                packed[:, :, LP2:], base)


def ms_deform_attn_premapped_plain(
        value_t: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
        xs: torch.Tensor, ys: torch.Tensor, aw: torch.Tensor) -> torch.Tensor:
    """The sampling with the prep done outside (``msda_pallas.
    _forward_premapped``): value_t (B, M, D, S); xs, ys (B, M, L*P, Lq) pixel
    coordinates and aw (B, M, L*P, Lq) point weights, fp32. Returns (B, M,
    D, Lq) in value_t's dtype, accumulated in fp32."""
    B, M, D, S = value_t.shape
    LP, Lq = xs.shape[2], xs.shape[3]
    P = LP // len(spatial_shapes)
    _check_positions(S, spatial_shapes)
    v = value_t.float()
    xs, ys, aw = xs.float(), ys.float(), aw.float()
    out = torch.zeros((B, M, D, Lq), dtype=torch.float32, device=v.device)
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        v_l = v[..., start:start + H * W]
        for p in range(P):
            r = lvl * P + p
            out += (_bilinear_sample(v_l, xs[:, :, r], ys[:, :, r], H, W)
                    * aw[:, :, r, None, :])
        start += H * W
    return out.to(value_t.dtype)


def reference_layout_prep(value: torch.Tensor,
                          spatial_shapes: Sequence[Tuple[int, int]],
                          sampling_locations: torch.Tensor,
                          attention_weights: torch.Tensor):
    """The reference layouts -> the premapped ones, as ``msda_pallas.
    _pallas_forward`` prepares them: value (B, S, M, D) -> (B, M, D, S);
    normalized locations (B, Lq, M, L, P, 2) -> fp32 pixel coordinates xs,
    ys (B, M, L*P, Lq) (loc * (W_l, H_l) - 0.5); weights (B, Lq, M, L, P)
    -> fp32 aw (B, M, L*P, Lq)."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    sizes = torch.tensor([[w, h] for (h, w) in spatial_shapes], dtype=torch.float32,
                         device=value.device)  # (L, 2) = (W_l, H_l)
    unnorm = sampling_locations.float() * sizes[:, None, :] - 0.5
    xs = unnorm[..., 0].permute(0, 2, 3, 4, 1).reshape(B, M, L * P, Lq)
    ys = unnorm[..., 1].permute(0, 2, 3, 4, 1).reshape(B, M, L * P, Lq)
    aw = attention_weights.float().permute(0, 2, 3, 4, 1).reshape(B, M, L * P, Lq)
    return value.permute(0, 2, 3, 1), xs, ys, aw


def ms_deform_attn_core_plain(value: torch.Tensor,
                              spatial_shapes: Sequence[Tuple[int, int]],
                              sampling_locations: torch.Tensor,
                              attention_weights: torch.Tensor) -> torch.Tensor:
    """The reference-layout function (``dinounet_tpu/ops/msda.py::
    ms_deform_attn_core``): value (B, S, M, D), sampling_locations
    (B, Lq, M, L, P, 2) normalized (x, y) in [0, 1], attention_weights
    (B, Lq, M, L, P) softmaxed over L*P -> (B, Lq, M*D) in value's dtype,
    accumulated in fp32."""
    B, S, M, D = value.shape
    Lq = sampling_locations.shape[1]
    v_t, xs, ys, aw = reference_layout_prep(value, spatial_shapes,
                                            sampling_locations, attention_weights)
    out = ms_deform_attn_premapped_plain(v_t, spatial_shapes, xs, ys, aw)
    return out.permute(0, 3, 1, 2).reshape(B, Lq, M * D)


def _check_positions(S: int, spatial_shapes: Sequence[Tuple[int, int]]) -> None:
    if S != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value has {S} positions, spatial_shapes "
                         f"{tuple(spatial_shapes)} hold a different number")


def premapped_fused_prep(off: torch.Tensor, logits: torch.Tensor,
                         base: torch.Tensor):
    """The fused prep in fp32 (``msda_pallas._premapped_fused_prep``):
    xs, ys = off's x / y rows + base, s = softmax of logits over the points;
    each (B, M, L*P, Lq)."""
    coords = off.float() + base.float()
    return coords[:, :, 0::2], coords[:, :, 1::2], torch.softmax(logits.float(), dim=2)


def ms_deform_attn_premapped_backward_plain(
        value_t: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
        xs: torch.Tensor, ys: torch.Tensor, aw: torch.Tensor,
        g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """value_t (B, M, D, S); xs, ys, aw (B, M, L*P, Lq) fp32 pixel coordinates
    and point weights; g (B, M, D, Lq) the output cotangent. Returns fp32
    (gv (B, M, D, S), ga, gx, gy (B, M, L*P, Lq)), coordinate gradients in
    pixel units; out-of-map corners contribute nothing."""
    B, M, D, S = value_t.shape
    LP, Lq = xs.shape[2], xs.shape[3]
    P = LP // len(spatial_shapes)
    _check_positions(S, spatial_shapes)
    v = value_t.float()
    g = g.float()
    dev = v.device
    gv = torch.zeros(B * M * D * S, dtype=torch.float32, device=dev)
    ga, gx, gy = (torch.zeros((B, M, LP, Lq), dtype=torch.float32, device=dev)
                  for _ in range(3))
    # flat index of gv[b, m, d, 0] for every (b, m, d, q)
    row = (torch.arange(B * M * D, device=dev) * S).view(B, M, D, 1)
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        v_l = v[..., start:start + H * W]
        for p in range(P):
            r = lvl * P + p
            x, y, a = xs[:, :, r].float(), ys[:, :, r].float(), aw[:, :, r].float()
            x0, y0 = torch.floor(x), torch.floor(y)
            fx, fy = x - x0, y - y0
            x0, y0 = x0.long(), y0.long()
            s_val = torch.zeros_like(x)
            s_dx = torch.zeros_like(x)
            s_dy = torch.zeros_like(x)
            for dy in (0, 1):
                wy = fy if dy else 1.0 - fy
                for dx in (0, 1):
                    wx = fx if dx else 1.0 - fx
                    yy, xx = y0 + dy, x0 + dx
                    valid = ((yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)).float()
                    idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)  # (B, M, Lq)
                    sampled = torch.gather(v_l, 3, idx[:, :, None].expand(-1, -1, D, -1))
                    dot = (sampled * g).sum(dim=2) * valid
                    s_val += wy * wx * dot
                    s_dx += (wy if dx else -wy) * dot
                    s_dy += (wx if dy else -wx) * dot
                    contrib = g * (a * wy * wx * valid)[:, :, None]
                    gv.index_add_(0, (row + start + idx[:, :, None]).reshape(-1),
                                  contrib.reshape(-1))
            ga[:, :, r] = s_val
            gx[:, :, r] = a * s_dx
            gy[:, :, r] = a * s_dy
        start += H * W
    return gv.view(B, M, D, S), ga, gx, gy
