"""Fused RoPE + multi-head self-attention over the Dh-major layout.

Counterpart of ``dinounet_tpu/ops/attention_pallas.py::
fused_rope_attention_premapped_dmaj``: qkv_t (B, 3, M, Dh, N) in, (B, M, Dh, N)
out. For a CUDA tensor the wrapper launches ``csrc/rope_attention.cu`` (which
replaces the TPU kernel ``_kernel_pm_dmaj``; its header says what bounds it
and how it is built); for a CPU tensor it runs
``rope_attention_dmaj_plain``, the same function in plain PyTorch with the TPU
kernel's rounding points. On every device the op is differentiable with
respect to qkv_t (see ``_RopeAttention``).
"""

from typing import Optional, Tuple

import torch

from dinounet_tpu_torch.ops import _build


def rope_tables_dmaj(sin: Optional[torch.Tensor], cos: Optional[torch.Tensor],
                     N: int, Dh: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, Dh) RoPE tables -> transposed (Dh, N) fp32 tables with
    rotate-half's sign folded into sin; identity tables when sin is None."""
    if sin is None:
        return (torch.zeros((Dh, N), dtype=torch.float32, device=device),
                torch.ones((Dh, N), dtype=torch.float32, device=device))
    half = Dh // 2
    sin_eff = torch.cat([-sin[:, :half], sin[:, half:]], dim=-1).float()
    return sin_eff.t().contiguous(), cos.float().t().contiguous()


def rope_attention_dmaj_plain(qkv_t: torch.Tensor, sin_eff_t: torch.Tensor,
                              cos_t: torch.Tensor) -> torch.Tensor:
    """RoPE in fp32, q scaled by Dh^-1/2 before rounding to qkv's dtype,
    fp32 scores, exp(s - rowmax) rounded to qkv's dtype, PV in fp32, divided
    by the fp32 sum of the rounded probabilities."""
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


def _forward(qkv_t: torch.Tensor, sin_eff_t: torch.Tensor,
             cos_t: torch.Tensor) -> torch.Tensor:
    B, _, M, Dh, N = qkv_t.shape
    if qkv_t.device.type == "cpu":
        return rope_attention_dmaj_plain(qkv_t, sin_eff_t, cos_t)
    if qkv_t.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {qkv_t.device}")
    if Dh not in (64, 128):
        raise ValueError(f"the attention kernel takes Dh 64 or 128, got {Dh}")
    _build.check_inputs(
        "fused_rope_attention_premapped_dmaj", qkv_t.device,
        qkv_t=(qkv_t, torch.bfloat16, (B, 3, M, Dh, N)),
        sin_eff_t=(sin_eff_t, torch.float32, (Dh, N)),
        cos_t=(cos_t, torch.float32, (Dh, N)))
    out = torch.empty((B, M, Dh, N), dtype=torch.bfloat16, device=qkv_t.device)
    # rotated q, k and v, zero-padded to whole 64-token tiles (the kernel's
    # pre-pass writes it; see csrc/rope_attention.cu)
    scratch = torch.empty((3, B, M, Dh, -(-N // 64) * 64), dtype=torch.bfloat16,
                          device=qkv_t.device)
    err = _build.lib().rope_attention_dmaj(
        qkv_t.data_ptr(), sin_eff_t.data_ptr(), cos_t.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), B, M, Dh, N, Dh ** -0.5,
        _build.stream_of(qkv_t.device))
    _build.check(err, "rope_attention_dmaj")
    fused_rope_attention_premapped_dmaj.launches += 1
    return out


class _RopeAttention(torch.autograd.Function):
    """The kernel (or plain version) forward; the backward differentiates the
    plain version recomputed from the saved qkv, as the JAX package's custom
    VJP differentiates its reference formulation. The tables are constants."""

    @staticmethod
    def forward(ctx, qkv_t, sin_eff_t, cos_t):
        ctx.save_for_backward(qkv_t, sin_eff_t, cos_t)
        return _forward(qkv_t, sin_eff_t, cos_t)

    @staticmethod
    def backward(ctx, g):
        qkv_t, sin_eff_t, cos_t = ctx.saved_tensors
        qkv = qkv_t.detach().requires_grad_(True)
        with torch.enable_grad():
            out = rope_attention_dmaj_plain(qkv, sin_eff_t, cos_t)
        return torch.autograd.grad(out, qkv, g)[0], None, None


def fused_rope_attention_premapped_dmaj(
        qkv_t: torch.Tensor, sin: Optional[torch.Tensor],
        cos: Optional[torch.Tensor]) -> torch.Tensor:
    """qkv_t (B, 3, M, Dh, N); sin/cos (N, Dh) fp32 RoPE tables with identity
    rows for the prefix tokens, or None for no RoPE. Returns (B, M, Dh, N),
    differentiable with respect to qkv_t."""
    B, three, M, Dh, N = qkv_t.shape
    if three != 3:
        raise ValueError(f"qkv_t must be (B, 3, M, Dh, N), got {tuple(qkv_t.shape)}")
    sin_eff_t, cos_t = rope_tables_dmaj(sin, cos, N, Dh, qkv_t.device)
    return _RopeAttention.apply(qkv_t, sin_eff_t, cos_t)


fused_rope_attention_premapped_dmaj.launches = 0
