"""The fused dense + residual + statistics ops of the port held against the
JAX package's Pallas kernels themselves (interpret mode on the CPU), and the
wrapper's two weight layouts.

``dense_residual_stats_plain`` / ``dense_cm_residual_stats_plain`` (the CPU
path, and what the CUDA kernel is held to on the card) against
``dense_stats_pallas.dense_residual_stats(..., interpret=True)`` and
``dense_cm_residual_stats(..., interpret=True)`` at ragged small shapes: fp32
within 1e-5, bf16 within the tolerances ``test_torch_ops._check_dense``
holds the bf16 ops to (out rtol 0.011, mean atol 2e-3, var atol 4e-3) plus,
for the variance, rtol 4e-3: LayerScale here is 0.5 (not 0.01), so rows
reach a variance near 2, and the two sides' bf16 outputs may differ by one
ulp (2^-8 relative) at a few elements, each moving the variance by about
2 |x| 2^-8 / D. The TPU kernel's GELU uses an Abramowitz-Stegun erf (error
1.5e-7), well inside both.

The row-parallel mode (a rank's fp32 product on its K columns) and the
post-reduce pass, on K split by hand into ranks' slices and the products
summed in fp32, against the JAX ``_reference`` / ``_cm_reference`` on the
whole K: the same tolerances (the split only reorders fp32 sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinounet_tpu.ops import dense_stats_pallas as jax_dense
from dinounet_tpu_torch.ops.dense_stats import (dense_cm_partial, dense_cm_partial_plain,
                                                dense_cm_residual_stats_plain,
                                                dense_partial_plain, dense_residual_partial,
                                                dense_residual_stats,
                                                dense_residual_stats_plain,
                                                post_reduce_residual_stats,
                                                post_reduce_residual_stats_plain)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (B, N, K, D): ragged everywhere, K below and across the kernel's 64-deep
# steps, D across its 128-feature warpgroup tiles and 256-feature passes
SHAPES = [(2, 21, 40, 24), (1, 37, 19, 136), (2, 9, 72, 264)]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _inputs(seed, B, N, K, D, dtype, channel_major):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, K, N) if channel_major else (B, N, K))
    w = rng.normal(size=(K, D)) * K ** -0.5
    b = rng.normal(size=(D,)) * 0.1
    res = rng.normal(size=(B, N, D))
    gamma = rng.normal(size=(D,)) * 0.5
    tdt, jdt = DTYPES[dtype]
    f32 = np.float32
    torch_args = (torch.from_numpy(h.astype(f32)).to(tdt), torch.from_numpy(w.astype(f32)),
                  torch.from_numpy(b.astype(f32)), torch.from_numpy(res.astype(f32)).to(tdt),
                  torch.from_numpy(gamma.astype(f32)))
    jax_args = (jnp.asarray(h, jdt), jnp.asarray(w, jnp.float32), jnp.asarray(b, jnp.float32),
                jnp.asarray(res, jdt), jnp.asarray(gamma, jnp.float32))
    return torch_args, jax_args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["rm", "rm_gelu", "cm"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_the_pallas_kernel(shape, op, dtype):
    cm = op == "cm"
    targs, jargs = _inputs(11, *shape, dtype, cm)
    if cm:
        got = dense_cm_residual_stats_plain(*targs)
        want = jax_dense.dense_cm_residual_stats(*jargs, interpret=True)
    else:
        gelu = op == "rm_gelu"
        got = dense_residual_stats_plain(*targs, gelu)
        want = jax_dense.dense_residual_stats(*jargs, apply_gelu=gelu, interpret=True)
    B, N, K, D = shape
    assert got[0].shape == (B, N, D) and got[1].shape == got[2].shape == (B, N)
    assert got[0].dtype == targs[0].dtype and got[1].dtype == torch.float32
    if dtype == "float32":
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=0.011, atol=1e-5)
        np.testing.assert_allclose(_np(got[1]), _np(want[1]), atol=2e-3)
        np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=4e-3, atol=4e-3)


@pytest.mark.parametrize("gelu", [False, True])
def test_wrapper_takes_both_weight_layouts(gelu):
    """w as a contiguous (K, D) tensor and as ``Linear.weight.t()`` (the
    models' form, which the kernel reads in place): identical outputs and
    identical gradients, the weight's included."""
    B, N, K, D = 2, 13, 24, 40
    rng = np.random.default_rng(12)
    lin = torch.nn.Linear(K, D)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(rng.normal(size=(D, K)).astype(np.float32)))
    h, res = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in
              ((B, N, K), (B, N, D)))
    gamma = torch.from_numpy(rng.normal(size=(D,)).astype(np.float32))
    w_kd = lin.weight.detach().t().contiguous().requires_grad_(True)
    cot = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in
           ((B, N, D), (B, N), (B, N))]

    def run(w):
        hl = h.clone().requires_grad_(True)
        outs = dense_residual_stats(hl, w, lin.bias, res, gamma, apply_gelu=gelu)
        loss = sum((o * c).sum() for o, c in zip(outs, cot))
        grads = torch.autograd.grad(loss, [hl, w, lin.bias])
        return outs, grads

    outs_lin, grads_lin = run(lin.weight.t())
    outs_kd, grads_kd = run(w_kd)
    for a, b in zip(outs_lin, outs_kd):
        assert torch.equal(a, b)
    for a, b in zip(grads_lin, grads_kd):
        assert torch.equal(a, b)


def _split_k(h, w, n, channel_major):
    """h and w cut into n slices along K, as a row-parallel layer's ranks
    hold them (the last slice the shortest)."""
    K = w.shape[0]
    bounds = [round(K * i / n) for i in range(n + 1)]
    k_dim = 1 if channel_major else 2
    return [(h.narrow(k_dim, a, b - a), w[a:b]) for a, b in zip(bounds, bounds[1:])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_ranks", [2, 3])
@pytest.mark.parametrize("op", ["rm_gelu", "cm"])
@pytest.mark.parametrize("shape", SHAPES)
def test_row_parallel_mode_matches_reference_split_over_k(shape, op, n_ranks, dtype):
    cm = op == "cm"
    targs, jargs = _inputs(13, *shape, dtype, cm)
    h, w, b, res, gamma = targs
    acc = sum(dense_cm_partial_plain(hk, wk) if cm else dense_partial_plain(hk, wk, True)
              for hk, wk in _split_k(h, w, n_ranks, cm))
    assert acc.dtype == torch.float32 and acc.shape == res.shape
    got = post_reduce_residual_stats_plain(acc, b, res, gamma)
    ref = jax_dense._cm_reference if cm else (
        lambda *a: jax_dense._reference(*a, apply_gelu=True))
    want = ref(*jargs)
    assert got[0].dtype == res.dtype and got[1].dtype == got[2].dtype == torch.float32
    if dtype == "float32":
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w_), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=0.011, atol=1e-5)
        np.testing.assert_allclose(_np(got[1]), _np(want[1]), atol=2e-3)
        np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=4e-3, atol=4e-3)


@pytest.mark.parametrize("op", ["rm", "rm_gelu", "cm"])
def test_row_parallel_mode_on_one_rank_is_the_fused_op(op):
    """One rank's product then the post-reduce pass are the fused op, bit
    for bit, through the wrappers (the CPU path)."""
    cm = op == "cm"
    h, w, b, res, gamma = _inputs(14, 2, 21, 40, 136, "bfloat16", cm)[0]
    if cm:
        acc, want = dense_cm_partial(h, w), dense_cm_residual_stats_plain(h, w, b, res, gamma)
    else:
        gelu = op == "rm_gelu"
        acc = dense_residual_partial(h, w, apply_gelu=gelu)
        want = dense_residual_stats_plain(h, w, b, res, gamma, gelu)
    for g, w_ in zip(post_reduce_residual_stats(acc, b, res, gamma), want):
        assert torch.equal(g, w_)
