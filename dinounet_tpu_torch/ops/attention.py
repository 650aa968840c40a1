"""Fused RoPE + multi-head self-attention, in three layouts.

Counterparts of three functions of ``dinounet_tpu/ops/attention_pallas.py``:

- ``fused_rope_attention_premapped_dmaj``: qkv_t (B, 3, M, Dh, N) in,
  (B, M, Dh, N) out, the Dh-major layout of the stats-threaded ViT chain
  (the mlp configs). Its TPU kernel is ``_kernel_pm_dmaj``.
- ``fused_rope_attention_premapped``: qkv_t (B, 3, M, N, Dh) in, (B, M, Dh,
  N) out, the layout the same chain takes with
  ``DINOUNET_TPU_ATTN_LAYOUT=ndh``. Its TPU kernel is ``_kernel_pm``.
- ``fused_rope_attention``: qkv (B, N, 3, M, Dh) in, (B, N, M, Dh) out, the
  row-major layout of the unfused blocks (the SwiGLU ViT-7B, Dh = 128). Its
  TPU kernel is ``_kernel``.

For a CUDA tensor each wrapper launches ``csrc/rope_attention.cu`` (a pre-pass
and one flash loop for the three layouts; its header says what bounds it and
how it is built) on the model's (N, Dh) tables as they are: the kernel folds
rotate-half's sign, and for the Dh-major layout the transpose, into its
pre-pass. For a CPU tensor it runs its plain version, the same function in
plain PyTorch with the TPU kernel's rounding points: RoPE in fp32 on the
sign-folded tables, q scaled by Dh^-1/2 before its rounding to the compute
dtype, fp32 scores, exp(s - rowmax) rounded to the compute dtype, PV in
fp32, divided by the fp32 sum of the rounded probabilities (the JAX
package's ``_xla_reference*`` scale the scores instead and normalise before
PV, within the JAX suite's tolerance of the kernel, tests/test_fused_attention.py).
Any other device raises. On every device each op is differentiable with
respect to the qkv input (see ``_RopeAttention``).

``rope_attention_tiled_plain`` models step by step what the card's kernel
does (its scratch, its key tiles, its running max); nothing on the main path
calls it: the CPU tests hold it against the JAX package and the plain
versions.
"""

from typing import Optional, Tuple

import torch

from dinounet_tpu_torch.ops import _build

KERNEL_HEAD_DIMS = (64, 128)
KERNEL_TILE = 128  # the kernel's query and key tile, and the scratch's token padding


def rope_tables(sin: Optional[torch.Tensor], cos: Optional[torch.Tensor],
                N: int, Dh: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, Dh) RoPE tables -> fp32 (sin_eff, cos) (N, Dh) with rotate-half's
    sign folded into sin; identity tables when sin is None."""
    if sin is None:
        return (torch.zeros((N, Dh), dtype=torch.float32, device=device),
                torch.ones((N, Dh), dtype=torch.float32, device=device))
    half = Dh // 2
    sin_eff = torch.cat([-sin[:, :half], sin[:, half:]], dim=-1).float()
    return sin_eff.contiguous(), cos.float().contiguous()


def rope_tables_dmaj(sin: Optional[torch.Tensor], cos: Optional[torch.Tensor],
                     N: int, Dh: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tables of ``rope_tables``, transposed to (Dh, N)."""
    sin_eff, cos_f = rope_tables(sin, cos, N, Dh, device)
    return sin_eff.t().contiguous(), cos_f.t().contiguous()


def rope_attention_dmaj_plain(qkv_t: torch.Tensor, sin_eff_t: torch.Tensor,
                              cos_t: torch.Tensor) -> torch.Tensor:
    """The Dh-major op: qkv_t (B, 3, M, Dh, N), tables (Dh, N) -> (B, M,
    Dh, N) in qkv_t's dtype."""
    Dh = qkv_t.shape[3]
    cdt = qkv_t.dtype
    q, k, v = qkv_t[:, 0], qkv_t[:, 1], qkv_t[:, 2]  # (B, M, Dh, N)

    def rope(x, mul=None):
        xf = x.float()
        r = xf * cos_t + torch.roll(xf, Dh // 2, dims=-2) * sin_eff_t
        if mul is not None:
            r = r * mul
        return r.to(cdt)

    q = rope(q, Dh ** -0.5)
    k = rope(k)
    s = torch.einsum("bmdn,bmdk->bmnk", q.float(), k.float())
    e = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(cdt)
    denom = e.float().sum(dim=-1)  # (B, M, N)
    pv = torch.einsum("bmdk,bmnk->bmdn", v.float(), e.float())
    return (pv / denom[:, :, None, :]).to(cdt)


def rope_attention_ndh_plain(qkv_t: torch.Tensor, sin_eff: torch.Tensor,
                             cos: torch.Tensor) -> torch.Tensor:
    """The (N, Dh)-plane op: qkv_t (B, 3, M, N, Dh), tables (N, Dh) -> (B, M,
    Dh, N) in qkv_t's dtype."""
    Dh = qkv_t.shape[4]
    cdt = qkv_t.dtype
    q, k, v = qkv_t[:, 0], qkv_t[:, 1], qkv_t[:, 2]  # (B, M, N, Dh)

    def rope(x, mul=None):
        xf = x.float()
        r = xf * cos + torch.roll(xf, Dh // 2, dims=-1) * sin_eff
        if mul is not None:
            r = r * mul
        return r.to(cdt)

    q = rope(q, Dh ** -0.5)
    k = rope(k)
    s = torch.einsum("bmnd,bmkd->bmnk", q.float(), k.float())
    e = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(cdt)
    denom = e.float().sum(dim=-1)  # (B, M, N)
    pv = torch.einsum("bmkd,bmnk->bmdn", v.float(), e.float())
    return (pv / denom[:, :, None, :]).to(cdt)


def rope_attention_plain(qkv: torch.Tensor, sin_eff: torch.Tensor,
                         cos: torch.Tensor) -> torch.Tensor:
    """The row-major op: qkv (B, N, 3, M, Dh), tables (N, Dh) -> (B, N, M,
    Dh) in qkv's dtype."""
    Dh = qkv.shape[4]
    cdt = qkv.dtype
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, N, M, Dh)

    def rope(x, mul=None):
        xf = x.float()
        r = xf * cos[:, None] + torch.roll(xf, Dh // 2, dims=-1) * sin_eff[:, None]
        if mul is not None:
            r = r * mul
        return r.to(cdt)

    q = rope(q, Dh ** -0.5)
    k = rope(k)
    s = torch.einsum("bnmd,bkmd->bmnk", q.float(), k.float())
    e = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(cdt)
    denom = e.float().sum(dim=-1)  # (B, M, N)
    pv = torch.einsum("bmnk,bkmd->bnmd", e.float(), v.float())
    return (pv / denom.transpose(1, 2)[..., None]).to(cdt)


def rope_attention_tiled_plain(qkv: torch.Tensor, sin: Optional[torch.Tensor],
                               cos: Optional[torch.Tensor], layout: str,
                               tile: int = KERNEL_TILE) -> torch.Tensor:
    """What the kernel does, step by step, in plain PyTorch: qkv in `layout`
    ("dmaj", "ndh" or "rowmajor") and the model's (N, Dh) tables (or None)
    -> the layout's output in qkv's dtype.

    The pre-pass writes rotated-and-scaled q, rotated k and v into the
    token-major scratch (3, B, M, Npad, Dh), zero past N (Npad: N rounded up
    to `tile`), with rotate-half's sign folded in; the loop takes `tile` keys
    at a time, masks keys past N with -inf, keeps the running row max m and
    rescales the fp32 row sum and output by exp(m_old - m_new); the
    probabilities exp(s - m) are rounded to qkv's dtype and summed in fp32
    as rounded; the epilogue divides by the sum, rounds, drops the query rows
    past N and stores the layout's output."""
    B, M, N, Dh = _dims(layout, qkv)
    cdt = qkv.dtype
    npad = -(-N // tile) * tile
    # (3, B, M, N, Dh) views of q, k, v
    order = {"dmaj": (1, 0, 2, 4, 3), "ndh": (1, 0, 2, 3, 4), "rowmajor": (2, 0, 3, 1, 4)}
    x = qkv.permute(order[layout]).float()
    if sin is not None:
        sign = torch.ones(Dh, dtype=torch.float32, device=qkv.device)
        sign[:Dh // 2] = -1.0
        qk = x[:2] * cos.float() + torch.roll(x[:2], Dh // 2, dims=-1) * (sin.float() * sign)
        x = torch.cat([qk, x[2:]])
    x = torch.cat([x[:1] * Dh ** -0.5, x[1:]])
    scratch = torch.zeros((3, B, M, npad, Dh), dtype=cdt, device=qkv.device)
    scratch[:, :, :, :N] = x.to(cdt)
    q, k, v = scratch.float()
    o = torch.zeros((B, M, npad, Dh), dtype=torch.float32, device=qkv.device)
    m_run = torch.full((B, M, npad), float("-inf"), device=qkv.device)
    l_run = torch.zeros((B, M, npad), device=qkv.device)
    for k0 in range(0, N, tile):
        s = q @ k[:, :, k0:k0 + tile].transpose(-1, -2)
        s[..., N - k0:] = float("-inf")
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None]).to(cdt).float()
        l_run = l_run * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + p @ v[:, :, k0:k0 + tile]
        m_run = m_new
    res = (o / l_run[..., None]).to(cdt)[:, :, :N]  # (B, M, N, Dh)
    return (res.transpose(1, 2) if layout == "rowmajor" else res.transpose(2, 3)).contiguous()


# layout -> (the wrapper's name, the kernel entry, the plain version)
_LAYOUTS = {"dmaj": ("fused_rope_attention_premapped_dmaj", "rope_attention_dmaj",
                     rope_attention_dmaj_plain),
            "ndh": ("fused_rope_attention_premapped", "rope_attention_ndh",
                    rope_attention_ndh_plain),
            "rowmajor": ("fused_rope_attention", "rope_attention_rowmajor",
                         rope_attention_plain)}


def _dims(layout: str, qkv: torch.Tensor) -> Tuple[int, int, int, int]:
    """(B, M, N, Dh) of a qkv tensor in `layout`."""
    if layout == "rowmajor":
        B, N, _, M, Dh = qkv.shape
    elif layout == "ndh":
        B, _, M, N, Dh = qkv.shape
    else:
        B, _, M, Dh, N = qkv.shape
    return B, M, N, Dh


def _plain(layout: str, qkv: torch.Tensor, sin, cos) -> torch.Tensor:
    """The plain version of `layout` on the model's tables."""
    _, _, N, Dh = _dims(layout, qkv)
    tables = rope_tables_dmaj if layout == "dmaj" else rope_tables
    return _LAYOUTS[layout][2](qkv, *tables(sin, cos, N, Dh, qkv.device))


def _launch(layout: str, qkv: torch.Tensor, sin, cos) -> torch.Tensor:
    """One launch of the kernel entry of `layout` (the pre-pass and the loop)."""
    op, entry, _ = _LAYOUTS[layout]
    B, M, N, Dh = _dims(layout, qkv)
    if Dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{op}: the kernel takes Dh in {KERNEL_HEAD_DIMS}, got {Dh}")
    _build.check_inputs(op, qkv.device, qkv=(qkv, torch.bfloat16, tuple(qkv.shape)))
    if (sin is None) != (cos is None):
        raise ValueError(f"{op}: give both RoPE tables or neither")
    if sin is not None:  # no copy for the model's tables: fp32 and contiguous
        sin, cos = (t.float().contiguous() for t in (sin, cos))
        _build.check_inputs(op, qkv.device, sin=(sin, torch.float32, (N, Dh)),
                            cos=(cos, torch.float32, (N, Dh)))
    if any(t is not None and t.data_ptr() % 16 for t in (qkv, sin, cos)):
        raise ValueError(f"{op}: the kernel reads qkv and the tables in 16-byte "
                         "vectors; their data must start on a 16-byte boundary")
    out_shape = (B, N, M, Dh) if layout == "rowmajor" else (B, M, Dh, N)
    out = torch.empty(out_shape, dtype=torch.bfloat16, device=qkv.device)
    # rotated q, k and v token-major, zero-padded to whole 128-token tiles
    # (the kernel's pre-pass writes it; see csrc/rope_attention.cu)
    npad = -(-N // KERNEL_TILE) * KERNEL_TILE
    scratch = torch.empty((3, B, M, npad, Dh), dtype=torch.bfloat16, device=qkv.device)
    err = getattr(_build.lib(), entry)(
        qkv.data_ptr(), None if sin is None else sin.data_ptr(),
        None if cos is None else cos.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        B, M, Dh, N, Dh ** -0.5, _build.stream_of(qkv.device))
    _build.check(err, entry)
    return out


def _forward(qkv, sin, cos, layout: str) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return _plain(layout, qkv, sin, cos)
    if qkv.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {qkv.device}")
    out = _launch(layout, qkv, sin, cos)
    _WRAPPERS[layout].launches += 1
    return out


class _RopeAttention(torch.autograd.Function):
    """The kernel (or plain version) forward of a layout; the backward
    differentiates the plain version recomputed from the saved qkv, as the
    JAX package's custom VJPs differentiate their reference formulation.
    The tables (or None) are constants."""

    @staticmethod
    def forward(ctx, qkv, sin, cos, layout: str):
        ctx.layout = layout
        ctx.save_for_backward(qkv, sin, cos)
        return _forward(qkv, sin, cos, layout)

    @staticmethod
    def backward(ctx, g):
        qkv, sin, cos = ctx.saved_tensors
        leaf = qkv.detach().requires_grad_(True)
        with torch.enable_grad():
            out = _plain(ctx.layout, leaf, sin, cos)
        return torch.autograd.grad(out, leaf, g)[0], None, None, None


def fused_rope_attention_premapped_dmaj(
        qkv_t: torch.Tensor, sin: Optional[torch.Tensor],
        cos: Optional[torch.Tensor]) -> torch.Tensor:
    """qkv_t (B, 3, M, Dh, N); sin/cos (N, Dh) fp32 RoPE tables with identity
    rows for the prefix tokens, or None for no RoPE. Returns (B, M, Dh, N),
    differentiable with respect to qkv_t."""
    B, three, M, Dh, N = qkv_t.shape
    if three != 3:
        raise ValueError(f"qkv_t must be (B, 3, M, Dh, N), got {tuple(qkv_t.shape)}")
    return _RopeAttention.apply(qkv_t, sin, cos, "dmaj")


def fused_rope_attention_premapped(
        qkv_t: torch.Tensor, sin: Optional[torch.Tensor],
        cos: Optional[torch.Tensor]) -> torch.Tensor:
    """qkv_t (B, 3, M, N, Dh); sin/cos (N, Dh) fp32 RoPE tables with identity
    rows for the prefix tokens, or None for no RoPE. Returns (B, M, Dh, N),
    differentiable with respect to qkv_t."""
    B, three, M, N, Dh = qkv_t.shape
    if three != 3:
        raise ValueError(f"qkv_t must be (B, 3, M, N, Dh), got {tuple(qkv_t.shape)}")
    return _RopeAttention.apply(qkv_t, sin, cos, "ndh")


def fused_rope_attention(qkv: torch.Tensor, sin: Optional[torch.Tensor],
                         cos: Optional[torch.Tensor]) -> torch.Tensor:
    """qkv (B, N, 3, M, Dh), the fused qkv projection reshaped; sin/cos
    (N, Dh) fp32 RoPE tables with identity rows for the prefix tokens, or
    None for no RoPE. Returns (B, N, M, Dh) in qkv's dtype, differentiable
    with respect to qkv."""
    B, N, three, M, Dh = qkv.shape
    if three != 3:
        raise ValueError(f"qkv must be (B, N, 3, M, Dh), got {tuple(qkv.shape)}")
    return _RopeAttention.apply(qkv, sin, cos, "rowmajor")


_WRAPPERS = {"dmaj": fused_rope_attention_premapped_dmaj,
             "ndh": fused_rope_attention_premapped, "rowmajor": fused_rope_attention}
fused_rope_attention_premapped_dmaj.launches = 0
fused_rope_attention_premapped.launches = 0
fused_rope_attention.launches = 0
