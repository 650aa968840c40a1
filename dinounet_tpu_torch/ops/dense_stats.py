"""Fused dense + LayerScale residual + LayerNorm row statistics.

Counterparts of ``dinounet_tpu/ops/dense_stats_pallas.py``:

    out = res + gamma * (act(h) @ w + b)     in the compute dtype
    mu, var = mean / variance of each stored out row, in fp32

``dense_residual_stats`` takes h row-major (B, N, K), with an optional
exact-erf GELU on h; ``dense_cm_residual_stats`` takes it channel-major
(B, K, N). w is (K, D) as in the JAX package, b and gamma (D,). For CUDA
tensors both launch ``csrc/dense_stats.cu`` (which replaces the TPU kernels
``_kernel`` and ``_cm_kernel``; its header says what bounds it and how it is
built); for CPU tensors they run the plain versions below, which round where
the JAX package's ``_reference`` / ``_cm_reference`` round. ``row_stats``
(the entry statistics of the chain) stays plain PyTorch on every device.
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


def _launch(h, w, b, res, gamma, channel_major: bool, gelu: bool, op: str) -> Stats:
    if channel_major:
        B, K, N = h.shape
    else:
        B, N, K = h.shape
    D = w.shape[1]
    dev = h.device
    bf16, f32 = torch.bfloat16, torch.float32
    w = w.to(bf16).contiguous()
    b = b.to(f32).contiguous()
    gamma = gamma.to(f32).contiguous()
    _build.check_inputs(op, dev, h=(h, bf16, h.shape), w=(w, bf16, (K, D)),
                        b=(b, f32, (D,)), res=(res, bf16, (B, N, D)),
                        gamma=(gamma, f32, (D,)))
    out = torch.empty((B, N, D), dtype=bf16, device=dev)
    mu = torch.empty((B, N), dtype=f32, device=dev)
    var = torch.empty((B, N), dtype=f32, device=dev)
    err = _build.lib().dense_residual_stats(
        h.data_ptr(), w.data_ptr(), b.data_ptr(), res.data_ptr(),
        gamma.data_ptr(), out.data_ptr(), mu.data_ptr(), var.data_ptr(),
        B, N, K, D, int(channel_major), int(gelu), _build.stream_of(dev))
    _build.check(err, op)
    return out, mu, var


def dense_residual_stats(h, w, b, res, gamma, apply_gelu: bool = False) -> Stats:
    """h (B, N, K) -> (out (B, N, D), mean (B, N), var (B, N))."""
    if h.device.type == "cpu":
        return dense_residual_stats_plain(h, w, b, res, gamma, apply_gelu)
    if h.device.type != "cuda":
        raise ValueError(f"no dense kernel for device {h.device}")
    result = _launch(h, w, b, res, gamma, False, apply_gelu,
                     "dense_residual_stats")
    dense_residual_stats.launches += 1
    return result


def dense_cm_residual_stats(h_t, w, b, res, gamma) -> Stats:
    """h_t (B, K, N) -> (out (B, N, D), mean (B, N), var (B, N))."""
    if h_t.device.type == "cpu":
        return dense_cm_residual_stats_plain(h_t, w, b, res, gamma)
    if h_t.device.type != "cuda":
        raise ValueError(f"no dense kernel for device {h_t.device}")
    result = _launch(h_t, w, b, res, gamma, True, False,
                     "dense_cm_residual_stats")
    dense_cm_residual_stats.launches += 1
    return result


dense_residual_stats.launches = 0
dense_cm_residual_stats.launches = 0
