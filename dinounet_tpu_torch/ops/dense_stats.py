"""Fused dense + LayerScale residual + LayerNorm row statistics.

Counterparts of ``dinounet_tpu/ops/dense_stats_pallas.py``:

    out = res + gamma * (act(h) @ w + b)     in the compute dtype
    mu, var = mean / variance of each stored out row, in fp32

``dense_residual_stats`` takes h row-major (B, N, K), with an optional
exact-erf GELU on h; ``dense_cm_residual_stats`` takes it channel-major
(B, K, N). w is (K, D) as in the JAX package, b and gamma (D,). For CUDA
tensors both launch ``csrc/dense_stats.cu`` (which replaces the TPU kernels
``_kernel`` and ``_cm_kernel``; its header says what bounds it and how it is
built), which reads the weight as ``nn.Linear`` stores it, (D, K): the
models pass ``Linear.weight.t()``, whose transpose is that storage, so a
bf16 weight reaches the kernel without a copy; for CPU tensors they run
the plain versions below, which round where the JAX package's
``_reference`` / ``_cm_reference`` round. Both are
differentiable on every device: the backward differentiates the plain
version (see ``_DenseStats``). ``row_stats`` (the entry statistics of the
chain) stays plain PyTorch on every device.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

from dinounet_tpu_torch.ops import _build

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def row_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) over the last dim in fp32, var = max(E[x^2] - mean^2, 0)."""
    xf = x.float()
    mu = xf.mean(dim=-1)
    var = torch.clamp((xf * xf).mean(dim=-1) - mu * mu, min=0.0)
    return mu, var


def _epilogue(acc, b, res, gamma, cdt) -> Stats:
    y = acc.to(cdt) + b.to(cdt)
    out = res + y * gamma.to(cdt)
    mu, var = row_stats(out)
    return out, mu, var


def dense_residual_stats_plain(h, w, b, res, gamma, apply_gelu: bool) -> Stats:
    if apply_gelu:
        h = F.gelu(h.float()).to(h.dtype)
    acc = torch.matmul(h.float(), w.to(h.dtype).float())
    return _epilogue(acc, b, res, gamma, h.dtype)


def dense_cm_residual_stats_plain(h_t, w, b, res, gamma) -> Stats:
    acc = torch.einsum("bkn,kd->bnd", h_t.float(), w.to(h_t.dtype).float())
    return _epilogue(acc, b, res, gamma, h_t.dtype)


def _as(t: torch.Tensor, dtype) -> torch.Tensor:
    """t itself where it is already contiguous and of `dtype`, else a copy."""
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def _launch(h, w, b, res, gamma, channel_major: bool, gelu: bool, op: str) -> Stats:
    if channel_major:
        B, K, N = h.shape
    else:
        B, N, K = h.shape
    D = w.shape[1]
    dev = h.device
    bf16, f32 = torch.bfloat16, torch.float32
    # the kernel reads the weight as (D, K): a bf16 Linear.weight.t() is
    # passed as the Linear's own storage, anything else copied
    wt, b, gamma = _as(w.t(), bf16), _as(b, f32), _as(gamma, f32)
    _build.check_inputs(op, dev, h=(h, bf16, h.shape), w=(wt, bf16, (D, K)),
                        b=(b, f32, (D,)), res=(res, bf16, (B, N, D)),
                        gamma=(gamma, f32, (D,)))
    out = torch.empty((B, N, D), dtype=bf16, device=dev)
    mu = torch.empty((B, N), dtype=f32, device=dev)
    var = torch.empty((B, N), dtype=f32, device=dev)
    scratch = torch.empty_like(h) if gelu else None  # gelu(h), the GEMM's A
    err = _build.lib().dense_residual_stats(
        h.data_ptr(), wt.data_ptr(), b.data_ptr(), res.data_ptr(),
        gamma.data_ptr(), out.data_ptr(), mu.data_ptr(), var.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        B, N, K, D, int(channel_major), int(gelu), _build.stream_of(dev))
    _build.check(err, op)
    return out, mu, var


def _forward(h, w, b, res, gamma, channel_major: bool, gelu: bool) -> Stats:
    if h.device.type == "cpu":
        if channel_major:
            return dense_cm_residual_stats_plain(h, w, b, res, gamma)
        return dense_residual_stats_plain(h, w, b, res, gamma, gelu)
    if h.device.type != "cuda":
        raise ValueError(f"no dense kernel for device {h.device}")
    wrapper = dense_cm_residual_stats if channel_major else dense_residual_stats
    result = _launch(h, w, b, res, gamma, channel_major, gelu, wrapper.__name__)
    wrapper.launches += 1
    return result


def grads_of_plain(ctx, plain, grads, n_inputs: int):
    """The backward of a kernel op: the gradients of `plain`, recomputed from
    the tensors the forward saved (its first `n_inputs` inputs, None where
    an input was None), for the inputs autograd asks for; None elsewhere."""
    needs = ctx.needs_input_grad[:n_inputs]
    inputs = [None if t is None else t.detach().requires_grad_(n)
              for t, n in zip(ctx.saved_tensors, needs)]
    with torch.enable_grad():
        outs = plain(*inputs)
    wanted = [t for t, n in zip(inputs, needs) if n]
    got = iter(torch.autograd.grad(outs, wanted, grads, allow_unused=True))
    return tuple(next(got) if n else None for n in needs)


class _DenseStats(torch.autograd.Function):
    """The kernel (or plain version) forward; the backward differentiates the
    plain version recomputed from the saved inputs, as the JAX package's
    custom VJP differentiates its reference formulation."""

    @staticmethod
    def forward(ctx, h, w, b, res, gamma, channel_major, gelu):
        ctx.flags = (channel_major, gelu)
        ctx.save_for_backward(h, w, b, res, gamma)
        return _forward(h, w, b, res, gamma, channel_major, gelu)

    @staticmethod
    def backward(ctx, *grads):
        channel_major, gelu = ctx.flags
        if channel_major:
            plain = dense_cm_residual_stats_plain
        else:
            plain = lambda *a: dense_residual_stats_plain(*a, gelu)
        return grads_of_plain(ctx, plain, grads, 5) + (None, None)


def dense_residual_stats(h, w, b, res, gamma, apply_gelu: bool = False) -> Stats:
    """h (B, N, K) -> (out (B, N, D), mean (B, N), var (B, N))."""
    return _DenseStats.apply(h, w, b, res, gamma, False, apply_gelu)


def dense_cm_residual_stats(h_t, w, b, res, gamma) -> Stats:
    """h_t (B, K, N) -> (out (B, N, D), mean (B, N), var (B, N))."""
    return _DenseStats.apply(h_t, w, b, res, gamma, True, False)


dense_residual_stats.launches = 0
dense_cm_residual_stats.launches = 0
