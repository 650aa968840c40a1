"""The port's plain kernel versions vs the JAX package's kernels on the CPU.

Each op of ``dinounet_tpu_torch/ops`` runs here as its plain PyTorch version
(the wrappers take it for CPU tensors) and is held against the JAX op it
ports, run as the JAX package's own tests run it: the Pallas kernel in
interpret mode, or its pure-jnp ``_reference``. Inputs come from a numpy seed.

Tolerances: fp32 inputs, 1e-5 (both sides do the same fp32 arithmetic in
another order). bf16 inputs: the JAX suite's bf16 tolerances
(tests/test_fused_dense.py) -- outputs within rtol 0.011 (under 3 bf16 ulps:
an fp32 sum taken in another order can round to a neighbouring bf16 value),
statistics within atol 2e-3 / 4e-3. Attention in bf16 also rounds exp(s - max)
to bf16 inside, so an element can move by a rounding of one probability; its
atol is 2e-3 for outputs of magnitude ~1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinounet_tpu_torch.ops import _build
from dinounet_tpu_torch.ops.attention import fused_rope_attention_premapped_dmaj
from dinounet_tpu_torch.ops.dense_stats import (dense_cm_residual_stats,
                                                dense_residual_stats, row_stats)
from dinounet_tpu_torch.ops.msda_kernel import ms_deform_attn_premapped_fused

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a torch tensor and a jax array of `dtype`."""
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(np.asarray(a, np.float32)).to(tdt), jnp.asarray(a, jdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    """CPU calls run the plain versions and never count a kernel launch."""
    _build.reset_launch_counts()
    yield
    assert all(n == 0 for n in _build.launch_counts().values())


def _msda_inputs(rng, B, M, D, Lq, shapes, P):
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    v = rng.standard_normal((B, M, D, S))
    off = rng.uniform(-2.0, 2.0, (B, M, 2 * L * P, Lq))
    logits = rng.standard_normal((B, M, L * P, Lq))
    base = np.empty((2 * L * P, Lq), np.float32)
    for lvl, (h, w) in enumerate(shapes):
        # in-range grid plus a few points off the map's edges
        bx = rng.uniform(-1.5, w + 0.5, (Lq,))
        by = rng.uniform(-1.5, h + 0.5, (Lq,))
        for p in range(P):
            base[2 * (lvl * P + p)] = bx
            base[2 * (lvl * P + p) + 1] = by
    return v, off, logits, base


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lq,shapes", [(128, ((8, 16),)),            # one level
                                       (37, ((8, 16), (4, 8)))])     # ragged, two
def test_msda_matches_pallas_interpret(dtype, Lq, shapes):
    from dinounet_tpu.ops.msda_pallas import ms_deform_attn_pallas_premapped_fused

    rng = np.random.default_rng(0)
    v, off, logits, base = _msda_inputs(rng, 2, 3, 8, Lq, shapes, P=2)
    tv, jv = _pair(v, dtype)
    toff, joff = _pair(off, dtype)
    tlg, jlg = _pair(logits, dtype)
    got = ms_deform_attn_premapped_fused(tv, shapes, toff, tlg,
                                         torch.from_numpy(base))
    want = ms_deform_attn_pallas_premapped_fused(
        jv, shapes, joff, jlg, jnp.asarray(base), True, DTYPES[dtype][1])
    assert got.dtype == tv.dtype and got.shape == (2, 3, 8, Lq)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=0.011, atol=1e-5)


def _rope_tables(N, Dh, n_prefix):
    from dinounet_tpu.models.vit import rope_sincos

    sin, cos = rope_sincos(1, N - n_prefix, Dh)
    sin = np.concatenate([np.zeros((n_prefix, Dh), np.float32), np.asarray(sin)])
    cos = np.concatenate([np.ones((n_prefix, Dh), np.float32), np.asarray(cos)])
    return sin, cos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,M,Dh,rope", [(64, 2, 64, True),
                                         (37, 2, 32, True),    # ragged
                                         (21, 1, 16, False)])  # no RoPE
def test_attention_matches_pallas_interpret(dtype, N, M, Dh, rope):
    from dinounet_tpu.ops.attention_pallas import (
        fused_rope_attention_premapped_dmaj as jax_attention)

    rng = np.random.default_rng(1)
    qkv = rng.standard_normal((2, 3, M, Dh, N))
    tq, jq = _pair(qkv, dtype)
    if rope:
        sin, cos = _rope_tables(N, Dh, 5)
        got = fused_rope_attention_premapped_dmaj(
            tq, torch.from_numpy(sin), torch.from_numpy(cos))
        want = jax_attention(jq, jnp.asarray(sin), jnp.asarray(cos),
                             interpret=True)
    else:
        got = fused_rope_attention_premapped_dmaj(tq, None, None)
        want = jax_attention(jq, None, None, interpret=True)
    assert got.dtype == tq.dtype and got.shape == (2, M, Dh, N)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=0.011, atol=2e-3)


def _dense_inputs(rng, B, N, K, D):
    return (rng.normal(size=(B, N, K)), rng.normal(size=(K, D)) * 0.1,
            rng.normal(size=(D,)) * 0.1, rng.normal(size=(B, N, D)),
            rng.normal(size=(D,)) * 0.01)


def _check_dense(dtype, got, want):
    out, mu, var = got
    rout, rmu, rvar = want
    if dtype == "float32":
        for g, r in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(r), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(out), _np(rout), rtol=0.011, atol=1e-5)
        np.testing.assert_allclose(_np(mu), _np(rmu), atol=2e-3)
        np.testing.assert_allclose(_np(var), _np(rvar), atol=4e-3)
    # the statistics describe the stored rows
    assert mu.dtype == var.dtype == torch.float32
    np.testing.assert_allclose(_np(mu), _np(out).mean(-1), atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("apply_gelu", [False, True])
@pytest.mark.parametrize("shape", [(2, 48, 64, 32), (2, 21, 40, 24)])  # 2nd ragged
def test_dense_row_major_matches_reference(dtype, apply_gelu, shape):
    from dinounet_tpu.ops.dense_stats_pallas import _reference

    h, w, b, res, g = _dense_inputs(np.random.default_rng(2), *shape)
    th, jh = _pair(h, dtype)
    tr, jr = _pair(res, dtype)
    f32 = torch.float32
    got = dense_residual_stats(th, torch.tensor(w, dtype=f32),
                               torch.tensor(b, dtype=f32), tr,
                               torch.tensor(g, dtype=f32), apply_gelu=apply_gelu)
    want = _reference(jh, jnp.asarray(w, jnp.float32), jnp.asarray(b, jnp.float32),
                      jr, jnp.asarray(g, jnp.float32), apply_gelu)
    _check_dense(dtype, got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 48, 64, 32), (2, 21, 40, 24)])
def test_dense_channel_major_matches_reference(dtype, shape):
    from dinounet_tpu.ops.dense_stats_pallas import _cm_reference

    h, w, b, res, g = _dense_inputs(np.random.default_rng(3), *shape)
    h_t = np.ascontiguousarray(np.swapaxes(h, 1, 2))  # (B, K, N)
    th, jh = _pair(h_t, dtype)
    tr, jr = _pair(res, dtype)
    f32 = torch.float32
    got = dense_cm_residual_stats(th, torch.tensor(w, dtype=f32),
                                  torch.tensor(b, dtype=f32), tr,
                                  torch.tensor(g, dtype=f32))
    want = _cm_reference(jh, jnp.asarray(w, jnp.float32),
                         jnp.asarray(b, jnp.float32), jr,
                         jnp.asarray(g, jnp.float32))
    _check_dense(dtype, got, want)


def test_row_stats_matches_jax():
    from dinounet_tpu.ops.dense_stats_pallas import row_stats as jax_row_stats

    x = np.random.default_rng(4).normal(size=(2, 13, 40)) * 3.0 + 1.0
    got = row_stats(torch.tensor(x, dtype=torch.float32))
    want = jax_row_stats(jnp.asarray(x, jnp.float32))
    for g, r in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(r), rtol=1e-5, atol=1e-5)


def test_kernel_paths_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; anything else
    goes to the kernel or raises — never a silent fallback."""
    from dinounet_tpu_torch.ops.dense_q8 import (dense_cm_q8_residual_stats, dense_q8,
                                                 dense_q8_residual_stats, qkv_q8_dmaj)

    from dinounet_tpu_torch.ops.attention import fused_rope_attention

    meta = torch.empty((1, 3, 1, 64, 8), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        fused_rope_attention_premapped_dmaj(meta, None, None)
    with pytest.raises(ValueError):
        fused_rope_attention(meta.permute(0, 4, 1, 2, 3), None, None)
    # the int8 ops: h (1, 8, 16) or h_t (1, 16, 8), w (16, 48)
    h = torch.empty((1, 8, 16), dtype=torch.bfloat16, device="meta")
    w, b = torch.empty((16, 48), device="meta"), torch.empty((48,), device="meta")
    res = torch.empty((1, 8, 48), dtype=torch.bfloat16, device="meta")
    for call in (lambda: dense_q8(h, w, b),
                 lambda: dense_q8_residual_stats(h, w, b, res, b, "gelu"),
                 lambda: dense_cm_q8_residual_stats(h.transpose(1, 2), w, b, res, b),
                 lambda: qkv_q8_dmaj(h, w, b, 2, 8)):
        with pytest.raises(ValueError):
            call()


def _grads(fn, leaves):
    """Gradients of a fixed random projection of fn's outputs."""
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator().manual_seed(5)
    loss = sum((o.float() * torch.randn(o.shape, generator=gen)).sum() for o in outs)
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("channel_major,gelu", [(False, False), (False, True),
                                                (True, False)])
def test_dense_wrapper_grads_equal_plain(channel_major, gelu):
    """The wrappers are autograd Functions whose backward differentiates the
    plain version: on the CPU the gradients are the plain version's own."""
    from dinounet_tpu_torch.ops.dense_stats import (dense_cm_residual_stats_plain,
                                                    dense_residual_stats_plain)

    h, w, b, res, g = _dense_inputs(np.random.default_rng(6), 2, 21, 40, 24)
    if channel_major:
        h = np.ascontiguousarray(np.swapaxes(h, 1, 2))
        wrapper, plain = dense_cm_residual_stats, dense_cm_residual_stats_plain
    else:
        wrapper = lambda *a: dense_residual_stats(*a, apply_gelu=gelu)
        plain = lambda *a: dense_residual_stats_plain(*a, gelu)

    def leaves():
        return [torch.tensor(a, dtype=torch.float32, requires_grad=True)
                for a in (h, w, b, res, g)]

    got = _grads(wrapper, leaves())
    want = _grads(plain, leaves())
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)


def test_attention_wrapper_grads_equal_plain():
    from dinounet_tpu_torch.ops.attention import (rope_attention_dmaj_plain,
                                                  rope_tables_dmaj)

    N, Dh = 21, 16
    sin, cos = (torch.from_numpy(t) for t in _rope_tables(N, Dh, 5))
    qkv = np.random.default_rng(7).standard_normal((2, 3, 2, Dh, N))
    tables = rope_tables_dmaj(sin, cos, N, Dh, "cpu")
    got = _grads(lambda q: fused_rope_attention_premapped_dmaj(q, sin, cos),
                 [torch.tensor(qkv, dtype=torch.float32, requires_grad=True)])
    want = _grads(lambda q: rope_attention_dmaj_plain(q, *tables),
                  [torch.tensor(qkv, dtype=torch.float32, requires_grad=True)])
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
