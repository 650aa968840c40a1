"""The port's MSDA backward vs the JAX package's, on the CPU.

``ms_deform_attn_premapped_backward_plain`` (the oracle of the CUDA backward
kernel) is held against the Pallas backward ``_backward_premapped`` run in
interpret mode, in fp32, to 1e-5: both do the same fp32 arithmetic in another
order. The gradients through the port's ``ms_deform_attn_premapped_fused``
(an autograd Function: plain forward and plain backward on the CPU) are held
against ``jax.grad`` of the JAX custom VJP, as tests/test_msda.py holds its
own: 1e-4 in fp32; in bf16 the gradients are rounded to bf16 at the end on
both sides, so an fp32 sum taken in another order may land one bf16 rounding
(2^-8 relative) away -- rtol 0.011 as the bf16 forward test, atol 1e-3 for
entries that cancel to near zero. Inputs come from a numpy seed and include
points off the map's edges and a ragged query count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinounet_tpu_torch.ops import _build
from dinounet_tpu_torch.ops.msda import (ms_deform_attn_premapped_backward_plain,
                                         premapped_fused_prep)
from dinounet_tpu_torch.ops.msda_kernel import (ms_deform_attn_premapped_backward,
                                                ms_deform_attn_premapped_fused)
from tests.test_torch_ops import DTYPES, _msda_inputs, _np, _pair


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    """CPU calls run the plain versions and never count a kernel launch."""
    _build.reset_launch_counts()
    yield
    assert all(n == 0 for n in _build.launch_counts().values())


@pytest.mark.parametrize("Lq,shapes", [(128, ((8, 16),)),           # one level
                                       (37, ((6, 8),)),             # ragged
                                       (37, ((8, 16), (4, 8)))])    # two levels
def test_plain_backward_matches_pallas_interpret(Lq, shapes):
    from dinounet_tpu.ops.msda_pallas import _backward_premapped

    rng = np.random.default_rng(10)
    B, M, D, P = 2, 3, 8, 2
    v, off, logits, base = _msda_inputs(rng, B, M, D, Lq, shapes, P)
    g = rng.standard_normal((B, M, D, Lq))
    xs, ys, aw = premapped_fused_prep(torch.tensor(off), torch.tensor(logits),
                                      torch.from_numpy(base))
    # coordinates past the map on every side reach the zero padding
    assert float(xs.min()) < -1 and float(ys.max()) > shapes[0][0]
    got = ms_deform_attn_premapped_backward(
        torch.tensor(v, dtype=torch.float32), shapes, xs, ys, aw,
        torch.tensor(g, dtype=torch.float32))
    want = _backward_premapped(
        jnp.asarray(v, jnp.float32), shapes, jnp.asarray(xs.numpy()),
        jnp.asarray(ys.numpy()), jnp.asarray(aw.numpy()),
        jnp.asarray(g, jnp.float32), True)
    for name, a, b in zip(("gv", "ga", "gx", "gy"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5, err_msg=name)


def test_plain_backward_is_the_vjp_of_the_forward():
    """The hand-written scatter agrees with autograd of the plain gather
    forward (in float64, so the comparison is exact to rounding)."""
    rng = np.random.default_rng(11)
    shapes = ((5, 7),)
    v, off, logits, base = _msda_inputs(rng, 1, 2, 4, 23, shapes, 3)
    f64 = torch.float64
    vt = torch.tensor(v, dtype=f64, requires_grad=True)
    xs, ys, aw = (a.to(f64).requires_grad_(True) for a in
                  premapped_fused_prep(torch.tensor(off), torch.tensor(logits),
                                       torch.from_numpy(base)))
    from dinounet_tpu_torch.ops.msda import _bilinear_sample

    out = sum(_bilinear_sample(vt, xs[:, :, p], ys[:, :, p], 5, 7)
              * aw[:, :, p, None, :] for p in range(3))
    g = torch.tensor(rng.standard_normal(out.shape), dtype=f64)
    want = torch.autograd.grad(out, (vt, aw, xs, ys), g)
    with torch.no_grad():
        got = ms_deform_attn_premapped_backward_plain(vt, shapes, xs, ys, aw, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lq,shapes", [(29, ((6, 8),)), (37, ((8, 16), (4, 8)))])
def test_grads_match_jax_custom_vjp(dtype, Lq, shapes):
    from dinounet_tpu.ops.msda_pallas import ms_deform_attn_pallas_premapped_fused

    rng = np.random.default_rng(12)
    v, off, logits, base = _msda_inputs(rng, 1, 2, 4, Lq, shapes, 2)
    tv, jv = _pair(v, dtype)
    toff, joff = _pair(off, dtype)
    tlg, jlg = _pair(logits, dtype)
    jdt = DTYPES[dtype][1]
    jbase = jnp.asarray(base)

    def f(v_, off_, logits_):
        out = ms_deform_attn_pallas_premapped_fused(v_, shapes, off_, logits_,
                                                    jbase, True, jdt)
        return (out ** 2).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(jv, joff, jlg)
    leaves = [t.requires_grad_(True) for t in (tv, toff, tlg)]
    out = ms_deform_attn_premapped_fused(*leaves[:1], shapes, *leaves[1:],
                                         torch.from_numpy(base))
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    for name, a, b in zip(("value", "off", "logits"), got, want):
        assert a.dtype == leaves[0].dtype, name
        if dtype == "float32":
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-4, err_msg=name)
        else:
            np.testing.assert_allclose(_np(a), _np(b), rtol=0.011, atol=1e-3, err_msg=name)


def test_base_gets_no_gradient():
    rng = np.random.default_rng(13)
    shapes = ((6, 8),)
    v, off, logits, base = _msda_inputs(rng, 1, 2, 4, 16, shapes, 2)
    tbase = torch.from_numpy(base).requires_grad_(True)
    tv = torch.tensor(v, dtype=torch.float32, requires_grad=True)
    out = ms_deform_attn_premapped_fused(tv, shapes, torch.tensor(off),
                                         torch.tensor(logits), tbase)
    out.sum().backward()
    assert tbase.grad is None and tv.grad is not None


def test_backward_refuses_other_devices():
    meta = torch.empty((1, 1, 4, 6), device="meta")
    lane = torch.empty((1, 1, 2, 5), device="meta")
    with pytest.raises(ValueError):
        ms_deform_attn_premapped_backward(meta, ((2, 3),), lane, lane, lane,
                                          torch.empty((1, 1, 4, 5), device="meta"))
