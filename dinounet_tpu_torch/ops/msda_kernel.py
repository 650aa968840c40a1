"""Multi-scale deformable attention — CUDA kernel wrappers.

Three forward entries, each replacing a TPU kernel of
``dinounet_tpu/ops/msda_pallas.py``; the first two launch
``csrc/msda_fwd.cu``, the third ``csrc/msda_fwd_premapped.cu``:

- ``ms_deform_attn_premapped_fused``: ``_fwd_kernel_fused`` (body
  ``_fused_core``), reached through ``ms_deform_attn_pallas_premapped_fused``:
  raw bf16 offsets and logits and an fp32 base grid, the prep in the kernel;
- ``ms_deform_attn_premapped_fused_merged``: ``_fwd_kernel_fused_merged``,
  the same over one packed offsets + logits buffer;
- ``ms_deform_attn_premapped``: ``_fwd_kernel``, reached through
  ``ms_deform_attn_pallas_premapped``: fp32 pixel coordinates and weights,
  the prep done outside. It is also the forward of ``ms_deform_attn``, the
  reference-layout entry (``ms_deform_attn_pallas``).

Backward: ``ms_deform_attn_premapped_backward`` replaces ``_bwd_kernel`` (via
``_backward_premapped``); its kernel is ``csrc/msda_bwd.cu``. Each kernel's
header says what bounds it on an H100 and how it is laid out. The functions
are the ones ``ops/msda.py`` computes in plain PyTorch: those plain versions
run for tensors on the CPU, the kernels for tensors on a CUDA device, and any
other device raises.

Every entry is differentiable (an ``autograd.Function``, the JAX package's
custom VJP). The fused entries' backward recomputes the prep from the saved
inputs, runs the backward kernel (or plain backward), and chain-rules the
point softmax, g_logits = s * (g_s - sum_p g_s * s), as
``_premapped_fused_bwd`` does; the merged entry returns one concatenated
packed gradient (``_premapped_fused_merged_bwd``). The base grid is built
from constant reference points and gets no gradient. The premapped entry's
backward is the backward kernel called directly (``_premapped_bwd``), and
``ms_deform_attn`` reaches its reference-layout gradients by autograd through
the layout prep (the unnormalization's (W_l, H_l) included).

Limits. The forward kernels take any S and D; the fused entries one level,
the premapped entry up to ``MAX_LEVELS``; at most ``MAX_POINTS`` points a
level. A block stages its channel slice of a head's value map in shared
memory as 16-byte cells (8 bf16 or 4 fp32 channels at one position): heads
of up to 64 bf16 or 32 fp32 channels whole where they fit, else slices of up
to 32 channels as wide as fit;
only where not even one cell's channels fit (16 S bytes over ``MAX_SMEM``)
does the wrapper hand the kernel a token-major scratch copy to gather from.
The backward takes up to ``MAX_D`` channels a head, any S, up to
``MAX_LEVELS`` levels and a bf16 or fp32 value map: its shared-memory
instance in the channel slices of ``bwd_plan`` (a slice's map cells in
shared memory; the value gradient added into a token-major fp32 scratch; a
head of several slices adds its slices' ga, gx, gy through a second fp32
scratch), else, where not even one cell's channels fit, the instance that
gathers and scatter-adds through device memory, on token-major scratch
copies of the map and the gradient. The fused
forward takes bf16 value / offsets / logits and an fp32 base grid and returns
bf16; the premapped forward a bf16 or fp32 value map and fp32 coordinates and
weights, and returns the value's dtype; the backward returns fp32 gradients.
"""

from typing import Optional, Sequence, Tuple

import torch

from dinounet_tpu_torch.ops import _build
from dinounet_tpu_torch.ops.msda import (ms_deform_attn_premapped_backward_plain,
                                         ms_deform_attn_premapped_fused_merged_plain,
                                         ms_deform_attn_premapped_fused_plain,
                                         ms_deform_attn_premapped_plain,
                                         premapped_fused_prep, reference_layout_prep)

MAX_D = 128
MAX_POINTS = 16
MAX_LEVELS = 4
# the shared memory a block may have (227 KB): a block stages its channel
# slice of a head's value map as 16-byte cells
MAX_SMEM = 232448


def bwd_plan(D: int, S: int, elem_size: int) -> Optional[Tuple[int, int, int]]:
    """The backward kernel's shared-memory plan for a head of D channels over
    S positions of a map of `elem_size`-byte values: (slice width, slices,
    shared-memory bytes of a block). A block stages its slice as [cells][S
    rounded up to 8] 16-byte cells (csrc/msda_bwd.cu). A head of up to 64
    channels whose cells fit a block is one slice; a wider one is cut into
    slices of up to 32 channels, as even as the widest that fits allows,
    each a whole number of cells. None where not even one cell's channels
    fit (the device-memory instance)."""
    cc = 16 // elem_size
    per_cell = 16 * (-(-S // 8) * 8)
    fit = MAX_SMEM // per_cell
    if fit < 1:
        return None
    cells = -(-D // cc)
    if D > 64 or cells > fit:
        widest = min(fit, 32 // cc)
        n_slices = -(-cells // widest)
        cells = -(-cells // n_slices)
        return cells * cc, n_slices, cells * per_cell
    return cells * cc, 1, cells * per_cell


def _on_cpu(t: torch.Tensor, op: str) -> bool:
    """True for a CPU tensor (the plain version), False for a CUDA one (the
    kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no {op} kernel for device {t.device}")
    return False


def _check_shapes(op: str, value_t, spatial_shapes, LP: int, max_levels: int) -> int:
    """Raise unless the levels hold value_t's S positions and LP rows split
    into at most MAX_POINTS points a level; returns P."""
    D, S = value_t.shape[2], value_t.shape[3]
    L = len(spatial_shapes)
    P = LP // L if L else 0
    if (not 1 <= L <= max_levels or S != sum(h * w for h, w in spatial_shapes)
            or L * P != LP or not 0 < P <= MAX_POINTS or D < 1):
        raise ValueError(f"{op}: the kernel takes 1 to {max_levels} levels holding "
                         f"the S positions and at most {MAX_POINTS} points a level; got "
                         f"S={S}, levels {tuple(spatial_shapes)}, {LP} point rows")
    return P


def _fwd_scratch(value_t: torch.Tensor) -> Optional[torch.Tensor]:
    """None where a forward block can stage a slice of one head's map in
    shared memory (csrc/msda_fwd.cu and msda_fwd_premapped.cu stage slices
    as narrow as one 16-byte cell a position: 8 bf16 or 4 fp32 channels);
    else the token-major (B, M, S, D) copy the kernel writes and gathers
    from."""
    B, M, D, S = value_t.shape
    if 16 * S <= MAX_SMEM:
        return None
    return torch.empty((B, M, S, D), dtype=value_t.dtype, device=value_t.device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _forward_fused(value_t, spatial_shapes, off, logits, base, merged: bool):
    """#1 (off, logits) or #6 (off is the packed buffer, logits None)."""
    op = ("ms_deform_attn_premapped_fused_merged" if merged
          else "ms_deform_attn_premapped_fused")
    B, M, D, S = value_t.shape
    LP, Lq = off.shape[2] // (3 if merged else 2), off.shape[3]
    P = _check_shapes(op, value_t, spatial_shapes, LP, 1)
    (H, W), = spatial_shapes
    bf16 = torch.bfloat16
    specs = dict(value_t=(value_t, bf16, (B, M, D, S)),
                 base=(base, torch.float32, (2 * P, Lq)))
    if merged:
        specs["packed"] = (off, bf16, (B, M, 3 * P, Lq))
    else:
        specs.update(off=(off, bf16, (B, M, 2 * P, Lq)), logits=(logits, bf16, (B, M, P, Lq)))
    _build.check_inputs(op, value_t.device, **specs)
    out = torch.empty((B, M, D, Lq), dtype=bf16, device=value_t.device)
    scratch = _fwd_scratch(value_t)
    stream = _build.stream_of(value_t.device)
    if merged:
        err = _build.lib().msda_fwd_merged(
            value_t.data_ptr(), _ptr(scratch), off.data_ptr(), base.data_ptr(),
            out.data_ptr(), B, M, D, H, W, P, Lq, stream)
    else:
        err = _build.lib().msda_fwd_fused(
            value_t.data_ptr(), _ptr(scratch), off.data_ptr(), logits.data_ptr(),
            base.data_ptr(), out.data_ptr(), B, M, D, H, W, P, Lq, stream)
    _build.check(err, "msda_fwd_merged" if merged else "msda_fwd_fused")
    return out


def _forward_premapped(value_t, spatial_shapes, xs, ys, aw) -> torch.Tensor:
    """#5: value_t (B, M, D, S) bf16 or fp32, xs/ys/aw (B, M, L*P, Lq) fp32."""
    op = "ms_deform_attn_premapped"
    B, M, D, S = value_t.shape
    LP, Lq = xs.shape[2], xs.shape[3]
    P = _check_shapes(op, value_t, spatial_shapes, LP, MAX_LEVELS)
    dt, f32 = value_t.dtype, torch.float32
    if dt not in (torch.bfloat16, f32):
        raise ValueError(f"{op}: value_t must be bf16 or fp32, got {dt}")
    lane = (B, M, LP, Lq)
    _build.check_inputs(op, value_t.device, value_t=(value_t, dt, (B, M, D, S)),
                        xs=(xs, f32, lane), ys=(ys, f32, lane), aw=(aw, f32, lane))
    out = torch.empty((B, M, D, Lq), dtype=dt, device=value_t.device)
    scratch = _fwd_scratch(value_t)
    err = _build.lib().msda_fwd_premapped(
        value_t.data_ptr(), _ptr(scratch), xs.data_ptr(), ys.data_ptr(), aw.data_ptr(),
        out.data_ptr(), B, M, D, _build.levels(spatial_shapes), len(spatial_shapes), P,
        Lq, int(dt == f32), _build.stream_of(value_t.device))
    _build.check(err, "msda_fwd_premapped")
    return out


def ms_deform_attn_premapped_backward(
        value_t: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
        xs: torch.Tensor, ys: torch.Tensor, aw: torch.Tensor,
        g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """value_t (B, M, D, S) bf16 or fp32; xs, ys, aw (B, M, L*P, Lq) fp32;
    g (B, M, D, Lq) fp32 -> fp32 (gv, ga, gx, gy). See ops/msda.py."""
    op = "ms_deform_attn_premapped_backward"
    if _on_cpu(value_t, op):
        return ms_deform_attn_premapped_backward_plain(
            value_t, spatial_shapes, xs, ys, aw, g)
    B, M, D, S = value_t.shape
    LP, Lq = xs.shape[2], xs.shape[3]
    P = _check_shapes(op, value_t, spatial_shapes, LP, MAX_LEVELS)
    dt, f32, dev = value_t.dtype, torch.float32, value_t.device
    if dt not in (torch.bfloat16, f32) or D > MAX_D:
        raise ValueError(f"{op}: the kernel takes a bf16 or fp32 map of at most "
                         f"{MAX_D} channels a head; got {dt}, D={D}")
    lane = (B, M, LP, Lq)
    _build.check_inputs(op, dev, value_t=(value_t, dt, (B, M, D, S)),
                        xs=(xs, f32, lane), ys=(ys, f32, lane), aw=(aw, f32, lane),
                        g=(g, f32, (B, M, D, Lq)))
    gv = torch.empty((B, M, D, S), dtype=f32, device=dev)  # written whole
    plan = bwd_plan(D, S, value_t.element_size())
    v_sd = gv_sd = gv_t = part = None
    if plan is None:  # it adds into the token-major gv_sd
        v_sd = torch.empty((B, M, S, D), dtype=dt, device=dev)
        gv_sd = torch.zeros((B, M, S, D), dtype=f32, device=dev)
        width = 0
    else:  # it adds into gv_t, rows of D rounded up to 32, zeroed by the C entry
        width, n_slices, _ = plan
        gv_t = torch.empty((B, M, S, -(-D // 32) * 32), dtype=f32, device=dev)
        if n_slices > 1:  # the slices' ga, gx, gy, added in slice order
            part = torch.empty((3, n_slices) + lane, dtype=f32, device=dev)
    ga, gx, gy = (torch.empty(lane, dtype=f32, device=dev) for _ in range(3))
    err = _build.lib().msda_bwd(
        value_t.data_ptr(), _ptr(v_sd), xs.data_ptr(), ys.data_ptr(), aw.data_ptr(),
        g.data_ptr(), gv.data_ptr(), _ptr(gv_sd), ga.data_ptr(), gx.data_ptr(),
        gy.data_ptr(), _ptr(gv_t), _ptr(part), B, M, D, _build.levels(spatial_shapes),
        len(spatial_shapes), P, Lq, int(dt == f32), width, _build.stream_of(dev))
    _build.check(err, "msda_bwd")
    ms_deform_attn_premapped_backward.launches += 1
    return gv, ga, gx, gy


def _fused_grads(spatial_shapes, value_t, off, logits, base, g):
    """The fused entries' VJP: fp32 (gv, g_off, g_logits)."""
    B, M, LP, Lq = logits.shape
    xs, ys, s = premapped_fused_prep(off, logits, base)
    gv, gs, gx, gy = ms_deform_attn_premapped_backward(
        value_t, spatial_shapes, xs.contiguous(), ys.contiguous(), s,
        g.float().contiguous())
    g_logits = s * (gs - (gs * s).sum(dim=2, keepdim=True))
    g_off = torch.stack([gx, gy], dim=3).reshape(B, M, 2 * LP, Lq)
    return gv, g_off, g_logits


class _MSDAFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value_t, off, logits, base, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value_t, off, logits, base)
        if _on_cpu(value_t, "ms_deform_attn_premapped_fused"):
            return ms_deform_attn_premapped_fused_plain(
                value_t, spatial_shapes, off, logits, base)
        out = _forward_fused(value_t, spatial_shapes, off, logits, base, merged=False)
        ms_deform_attn_premapped_fused.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        value_t, off, logits, base = ctx.saved_tensors
        gv, g_off, g_logits = _fused_grads(ctx.spatial_shapes, value_t, off, logits,
                                           base, g)
        return (gv.to(value_t.dtype), g_off.to(off.dtype),
                g_logits.to(logits.dtype), None, None)


class _MSDAFusedMerged(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value_t, packed, base, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value_t, packed, base)
        if _on_cpu(value_t, "ms_deform_attn_premapped_fused_merged"):
            return ms_deform_attn_premapped_fused_merged_plain(
                value_t, spatial_shapes, packed, base)
        out = _forward_fused(value_t, spatial_shapes, packed, None, base, merged=True)
        ms_deform_attn_premapped_fused_merged.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        value_t, packed, base = ctx.saved_tensors
        LP2 = 2 * packed.shape[2] // 3
        gv, g_off, g_logits = _fused_grads(ctx.spatial_shapes, value_t,
                                           packed[:, :, :LP2], packed[:, :, LP2:], base, g)
        return (gv.to(value_t.dtype), torch.cat([g_off, g_logits], dim=2).to(packed.dtype),
                None, None)


class _MSDAPremapped(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value_t, xs, ys, aw, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value_t, xs, ys, aw)
        if _on_cpu(value_t, "ms_deform_attn_premapped"):
            return ms_deform_attn_premapped_plain(value_t, spatial_shapes, xs, ys, aw)
        out = _forward_premapped(value_t, spatial_shapes, xs, ys, aw)
        ms_deform_attn_premapped.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        value_t, xs, ys, aw = ctx.saved_tensors
        gv, ga, gx, gy = ms_deform_attn_premapped_backward(
            value_t, ctx.spatial_shapes, xs, ys, aw, g.float().contiguous())
        return gv.to(value_t.dtype), gx, gy, ga, None


def ms_deform_attn_premapped_fused(
        value_t: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
        off: torch.Tensor, logits: torch.Tensor,
        base: torch.Tensor) -> torch.Tensor:
    """value_t (B, M, D, S); off (B, M, 2P, Lq); logits (B, M, P, Lq);
    base (2P, Lq) fp32 -> (B, M, D, Lq). See ops/msda.py."""
    return _MSDAFused.apply(value_t, off, logits, base, tuple(spatial_shapes))


def ms_deform_attn_premapped_fused_merged(
        value_t: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
        packed: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """value_t (B, M, D, S); packed (B, M, 3P, Lq), each head's raw offsets
    in rows [0, 2P) and its logits in [2P, 3P); base (2P, Lq) fp32 ->
    (B, M, D, Lq)."""
    return _MSDAFusedMerged.apply(value_t, packed, base, tuple(spatial_shapes))


def ms_deform_attn_premapped(
        value_t: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
        xs: torch.Tensor, ys: torch.Tensor, aw: torch.Tensor) -> torch.Tensor:
    """value_t (B, M, D, S); xs, ys (B, M, L*P, Lq) fp32 pixel coordinates
    and aw (B, M, L*P, Lq) fp32 point weights -> (B, M, D, Lq) in value_t's
    dtype. Differentiable with respect to all four; coordinate gradients in
    pixel units."""
    return _MSDAPremapped.apply(value_t, xs, ys, aw, tuple(spatial_shapes))


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """The reference-layout entry (``msda_pallas.ms_deform_attn_pallas``):
    value (B, S, M, D), sampling_locations (B, Lq, M, L, P, 2) normalized,
    attention_weights (B, Lq, M, L, P) -> (B, Lq, M*D) in value's dtype. The
    layout prep in PyTorch (value in fp32, as the JAX package casts it), then
    the premapped entry; differentiable."""
    B, S, M, D = value.shape
    Lq = sampling_locations.shape[1]
    v_t, xs, ys, aw = reference_layout_prep(value.float(), spatial_shapes,
                                            sampling_locations, attention_weights)
    out = ms_deform_attn_premapped(v_t.contiguous(), spatial_shapes, xs.contiguous(),
                                   ys.contiguous(), aw.contiguous())
    return out.permute(0, 3, 1, 2).reshape(B, Lq, M * D).to(value.dtype)


ms_deform_attn_premapped_fused.launches = 0
ms_deform_attn_premapped_fused_merged.launches = 0
ms_deform_attn_premapped.launches = 0
ms_deform_attn_premapped_backward.launches = 0
