"""The (B, 3, M, N, Dh) attention layout (``DINOUNET_TPU_ATTN_LAYOUT=ndh``)
and its int8 qkv vs the JAX package's, on the CPU.

``fused_rope_attention_premapped`` runs its plain version here (CPU tensors)
and is held against the TPU kernel it ports (``_kernel_pm``, through
``_pallas_forward_pm``) in interpret mode; ``qkv_q8_premapped`` against the
JAX einsum of the same name; then the tiny DinoViT of
tests/test_torch_dense_q8.py with the layout on in both packages (JAX: its
fused chain, the Pallas kernels in interpret mode), in bf16 and in the int8
serving mode. Inputs come from numpy seeds. Tolerances: the attention as
tests/test_torch_ops.py holds the Dh-major one (fp32 1e-5; bf16 rtol 0.011,
atol 2e-3: exp(s - max) is rounded to bf16 inside, so an element can move
by a rounding of one probability); the int8 qkv bit for bit (the same IEEE
divisions, half-to-even roundings and exact int32 sums); the ViT within
the JAX package's fused-vs-unfused bound (0.05, tests/test_dense_q8.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dinounet_tpu_torch.models.vit as t_vit
from dinounet_tpu_torch.ops import _build
from dinounet_tpu_torch.ops import dense_q8 as tq8
from dinounet_tpu_torch.ops.attention import (fused_rope_attention_premapped,
                                              rope_attention_ndh_plain, rope_tables)
from tests.test_torch_dense_q8 import (KERNEL_TOL, VIT_KW, _np, _pair, int8_env,  # noqa: F401
                                       vit_case)
from tests.test_torch_ops import _rope_tables


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    """CPU calls run the plain versions and never count a kernel launch."""
    _build.reset_launch_counts()
    yield
    assert all(n == 0 for n in _build.launch_counts().values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,M,Dh,rope", [(64, 2, 64, True),
                                         (37, 2, 128, True),   # ragged, the 7B's Dh
                                         (21, 1, 64, False)])  # no RoPE
def test_ndh_attention_matches_pallas_interpret(dtype, N, M, Dh, rope):
    from dinounet_tpu.ops.attention_pallas import (
        fused_rope_attention_premapped as jax_attention)

    qkv = np.random.default_rng(40).standard_normal((2, 3, M, N, Dh))
    tq, jq = _pair(qkv, dtype)
    sin, cos = _rope_tables(N, Dh, 5) if rope else (None, None)
    got = fused_rope_attention_premapped(
        tq, *(None if t is None else torch.from_numpy(t) for t in (sin, cos)))
    want = jax_attention(jq, *(None if t is None else jnp.asarray(t) for t in (sin, cos)),
                         interpret=True)
    assert got.dtype == tq.dtype and got.shape == (2, M, Dh, N)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=0.011, atol=2e-3)


def test_ndh_wrapper_grads_equal_plain():
    """The wrapper's backward differentiates the plain version (the JAX
    custom VJP's rule): on the CPU its gradients are the plain version's."""
    N, Dh = 21, 64
    sin, cos = (torch.from_numpy(t) for t in _rope_tables(N, Dh, 5))
    qkv = np.random.default_rng(41).standard_normal((2, 3, 2, N, Dh))
    proj = torch.from_numpy(np.random.default_rng(42).standard_normal((2, 2, Dh, N)))

    def grads(fn):
        leaf = torch.tensor(qkv, dtype=torch.float32, requires_grad=True)
        return torch.autograd.grad((fn(leaf) * proj.float()).sum(), leaf)[0]

    got = grads(lambda q: fused_rope_attention_premapped(q, sin, cos))
    want = grads(lambda q: rope_attention_ndh_plain(q, *rope_tables(sin, cos, N, Dh, "cpu")))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float(got.abs().max()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_qkv_q8_premapped_matches_jax(dtype, bias):
    from dinounet_tpu.ops.dense_q8_pallas import qkv_q8_premapped as jax_qkv

    rng = np.random.default_rng(43)
    B, N, C, M = 2, 37, 64, 4
    (tx, jx) = _pair(rng.standard_normal((B, N, C)) * 2.0, dtype)
    (tw, jw) = _pair(rng.standard_normal((C, 3 * C)) * C ** -0.5, "float32")
    (tb, jb) = _pair(rng.standard_normal((3 * C,)) * 0.1, "float32")
    got = tq8.qkv_q8_premapped(tx, tw, tb if bias else None, M, C // M)
    want = jax_qkv(jx, jw, jb if bias else None, M, C // M)
    assert got.dtype == tx.dtype and got.shape == (B, 3, M, N, C // M)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.fixture
def attn_spies(monkeypatch):
    """Count the ViT's calls of the two attention layouts and the two int8
    qkv projections."""
    counts = {}
    for name in ("fused_rope_attention_premapped", "fused_rope_attention_premapped_dmaj",
                 "qkv_q8_premapped", "qkv_q8_dmaj"):
        fn = getattr(t_vit, name)

        def counted(*args, _fn=fn, _name=name):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(t_vit, name, counted)
    return counts


@pytest.mark.parametrize("int8", [False, True])
def test_vit_ndh_matches_jax(vit_case, int8_env, attn_spies, monkeypatch, int8):  # noqa: F811
    """The tiny ViT's stats-threaded chain with the ndh layout, in bf16 and
    in the int8 serving mode (int8 qkv into the ndh layout), both packages:
    every taken layer's tokens within 0.05; every block takes the ndh
    attention and, in int8, the ndh qkv."""
    jmodel, tmodel, variables, xj, xt = vit_case
    int8_env(vit="1" if int8 else "0")
    monkeypatch.setenv("DINOUNET_TPU_ATTN_LAYOUT", "ndh")
    want = jmodel.apply(variables, xj, (0, 1, 2))
    with torch.inference_mode():
        got = tmodel(xt, (0, 1, 2))
    depth = VIT_KW["depth"]
    assert attn_spies == {"fused_rope_attention_premapped": depth,
                          **({"qkv_q8_premapped": depth} if int8 else {})}
    for (gp, gc), (wp, wc) in zip(got, want):
        np.testing.assert_allclose(_np(gp), _np(wp), **KERNEL_TOL)
        np.testing.assert_allclose(_np(gc), _np(wc), **KERNEL_TOL)
