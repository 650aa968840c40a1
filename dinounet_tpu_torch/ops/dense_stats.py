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

The row-parallel mode, for a backbone block split over a model axis
(``models/vit.py``, ``parallel/sharding.py``): a rank holds the input
columns of proj / fc2, so its product is only a part of the sum and the
epilogue must wait for the all-reduce. ``dense_cm_partial`` (#3's kernel)
and ``dense_residual_partial`` (#4's, with its GELU pre-pass) run the same
GEMM on the rank's K columns and write its fp32 product (B, N, D) and
nothing else; after the fp32 all-reduce, ``post_reduce_residual_stats``
adds the bias once, multiplies by LayerScale, adds the residual at the
rounding points of ``_epilogue`` and emits the bf16 stream and the next
LayerNorm's (mean, var), in one pass (``csrc/dense_stats.cu``'s
``post_reduce_stats_kernel``). The three serve the frozen backbone, which
runs under ``no_grad``: their launches carry no gradient.
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


def dense_partial_plain(h, w, apply_gelu: bool) -> torch.Tensor:
    """The fp32 product act(h) @ w of a row-major h (B, N, K): the GEMM of
    #4, with its GELU rounded to h's dtype."""
    if apply_gelu:
        h = F.gelu(h.float()).to(h.dtype)
    return torch.matmul(h.float(), w.to(h.dtype).float())


def dense_cm_partial_plain(h_t, w) -> torch.Tensor:
    """The fp32 product of a channel-major h_t (B, K, N): #3's GEMM."""
    return torch.einsum("bkn,kd->bnd", h_t.float(), w.to(h_t.dtype).float())


def post_reduce_residual_stats_plain(acc, b, res, gamma) -> Stats:
    """The epilogue of #3 / #4 on a summed fp32 product acc (B, N, D)."""
    return _epilogue(acc, b, res, gamma, res.dtype)


def dense_residual_stats_plain(h, w, b, res, gamma, apply_gelu: bool) -> Stats:
    return _epilogue(dense_partial_plain(h, w, apply_gelu), b, res, gamma, h.dtype)


def dense_cm_residual_stats_plain(h_t, w, b, res, gamma) -> Stats:
    return _epilogue(dense_cm_partial_plain(h_t, w), b, res, gamma, h_t.dtype)


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


def _partial(h, w, channel_major: bool, gelu: bool) -> torch.Tensor:
    if h.device.type == "cpu":
        if channel_major:
            return dense_cm_partial_plain(h, w)
        return dense_partial_plain(h, w, gelu)
    if h.device.type != "cuda":
        raise ValueError(f"no dense kernel for device {h.device}")
    wrapper = dense_cm_partial if channel_major else dense_residual_partial
    B, K, N = h.shape if channel_major else (h.shape[0], h.shape[2], h.shape[1])
    D = w.shape[1]
    wt = _as(w.t(), torch.bfloat16)  # the weight as the kernel reads it, (D, K)
    _build.check_inputs(wrapper.__name__, h.device, h=(h, torch.bfloat16, h.shape),
                        w=(wt, torch.bfloat16, (D, K)))
    out = torch.empty((B, N, D), dtype=torch.float32, device=h.device)
    scratch = torch.empty_like(h) if gelu else None  # gelu(h), the GEMM's A
    err = _build.lib().dense_partial(
        h.data_ptr(), wt.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        B, N, K, D, int(channel_major), int(gelu), _build.stream_of(h.device))
    _build.check(err, wrapper.__name__)
    wrapper.launches += 1
    return out


def dense_residual_partial(h, w, apply_gelu: bool = False) -> torch.Tensor:
    """Row-parallel #4: h (B, N, K) -> act(h) @ w, (B, N, D) fp32."""
    return _partial(h, w, False, apply_gelu)


def dense_cm_partial(h_t, w) -> torch.Tensor:
    """Row-parallel #3: h_t (B, K, N) -> (B, N, D) fp32."""
    return _partial(h_t, w, True, False)


def post_reduce_residual_stats(acc, b, res, gamma) -> Stats:
    """The epilogue of the row-parallel mode on the summed acc (B, N, D)
    fp32: (res + gamma * (acc + b) rounded as ``_epilogue`` rounds, mean,
    var)."""
    if acc.device.type == "cpu":
        return post_reduce_residual_stats_plain(acc, b, res, gamma)
    if acc.device.type != "cuda":
        raise ValueError(f"no post-reduce kernel for device {acc.device}")
    op = post_reduce_residual_stats.__name__
    B, N, D = acc.shape
    dev = acc.device
    f32, bf16 = torch.float32, torch.bfloat16
    b, gamma = _as(b, f32), _as(gamma, f32)
    _build.check_inputs(op, dev, acc=(acc, f32, (B, N, D)), b=(b, f32, (D,)),
                        res=(res, bf16, (B, N, D)), gamma=(gamma, f32, (D,)))
    out = torch.empty((B, N, D), dtype=bf16, device=dev)
    mu = torch.empty((B, N), dtype=f32, device=dev)
    var = torch.empty((B, N), dtype=f32, device=dev)
    err = _build.lib().post_reduce_stats(
        acc.data_ptr(), b.data_ptr(), res.data_ptr(), gamma.data_ptr(), out.data_ptr(),
        mu.data_ptr(), var.data_ptr(), B * N, D, _build.stream_of(dev))
    _build.check(err, op)
    post_reduce_residual_stats.launches += 1
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
dense_residual_partial.launches = 0
dense_cm_partial.launches = 0
post_reduce_residual_stats.launches = 0
