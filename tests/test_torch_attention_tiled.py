"""The attention kernel's CPU model vs the JAX package and the plain versions.

``ops/attention.py::rope_attention_tiled_plain`` computes, step by step in
plain PyTorch, what ``csrc/rope_attention.cu`` computes on the card: the
pre-pass into the token-major scratch padded to whole 128-token tiles, the
128-key tiles with a running row max, exp(s - m) rounded to the input dtype
and summed in fp32 as rounded, and the three layouts' epilogues. Held here,
on the CPU:

- against the three TPU kernels it stands for, run in interpret mode as
  tests/test_torch_ops.py runs them (``fused_rope_attention_premapped_dmaj``,
  ``fused_rope_attention_premapped``, ``fused_rope_attention``), over the
  three layouts x Dh {64, 128} x N {37, 64, 65, 130} (a ragged tile, a
  warpgroup's 64 rows, one row past them, a second ragged key tile) x RoPE
  on and off, B = M = 1 (interpret mode runs the grid step by step):
  fp32 within 1e-5 (the same fp32 function, summed
  in another order); bf16 within the JAX suite's attention tolerance, rtol
  0.011 and atol 2e-3 (exp(s - max) is rounded to bf16 inside, so an
  element can move by a rounding of one probability);
- against the port's plain versions, which round exp(s - row max) at once,
  in bf16 within ``KERNEL_TOLERANCES``: the bound the card's kernel is held
  to by ``chip_smoke.py``, and the reason given for it in
  ``ops/kernel_check.py``, shown here on the same cases at B = M = 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinounet_tpu_torch.ops import _build
from dinounet_tpu_torch.ops.attention import (rope_attention_dmaj_plain,
                                              rope_attention_ndh_plain,
                                              rope_attention_plain,
                                              rope_attention_tiled_plain, rope_tables,
                                              rope_tables_dmaj)
from dinounet_tpu_torch.ops.kernel_check import KERNEL_TOLERANCES, max_excess
from tests.test_torch_ops import _np, _pair, _rope_tables

LAYOUTS = ("dmaj", "ndh", "rowmajor")
# the canonical (B, 3, M, N, Dh) array -> each layout's qkv
TO_LAYOUT = {"dmaj": (0, 1, 2, 4, 3), "ndh": (0, 1, 2, 3, 4), "rowmajor": (0, 3, 1, 2, 4)}
KERNEL_NAME = {"dmaj": "rope_attention", "ndh": "rope_attention_ndh",
               "rowmajor": "rope_attention_rm"}
CASES = [(Dh, N, rope) for Dh in (64, 128) for N in (37, 64, 65, 130)
         for rope in (True, False)]


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    """The model and the plain versions never count a kernel launch."""
    _build.reset_launch_counts()
    yield
    assert all(n == 0 for n in _build.launch_counts().values())


def _case(layout, B, M, Dh, N, rope, seed):
    """qkv in `layout` (numpy, fp64) and the (N, Dh) tables or None."""
    qkv = np.random.default_rng(seed).standard_normal((B, 3, M, N, Dh))
    tables = _rope_tables(N, Dh, 5) if rope else (None, None)
    return np.ascontiguousarray(qkv.transpose(TO_LAYOUT[layout])), tables


def _torch_tables(tables):
    return tuple(None if t is None else torch.from_numpy(t) for t in tables)


def _jax_attention(layout):
    from dinounet_tpu.ops import attention_pallas

    return {"dmaj": attention_pallas.fused_rope_attention_premapped_dmaj,
            "ndh": attention_pallas.fused_rope_attention_premapped,
            "rowmajor": attention_pallas.fused_rope_attention}[layout]


def _out_shape(layout, B, M, Dh, N):
    return (B, N, M, Dh) if layout == "rowmajor" else (B, M, Dh, N)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh,N,rope", CASES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tiled_model_matches_pallas_interpret(layout, Dh, N, rope, dtype):
    qkv, tables = _case(layout, 1, 1, Dh, N, rope, seed=N + Dh)
    tq, jq = _pair(qkv, dtype)
    got = rope_attention_tiled_plain(tq, *_torch_tables(tables), layout)
    want = _jax_attention(layout)(
        jq, *(None if t is None else jnp.asarray(t) for t in tables), interpret=True)
    assert got.dtype == tq.dtype and got.shape == _out_shape(layout, 1, 1, Dh, N)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=0.011, atol=2e-3)


@pytest.mark.parametrize("Dh,N,rope", CASES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tiled_model_within_kernel_tolerance_of_plain(layout, Dh, N, rope):
    qkv, tables = _case(layout, 2, 2, Dh, N, rope, seed=2 * N + Dh)
    tq = torch.from_numpy(qkv).float().to(torch.bfloat16)
    sin, cos = _torch_tables(tables)
    got = rope_attention_tiled_plain(tq, sin, cos, layout)
    if layout == "dmaj":
        want = rope_attention_dmaj_plain(tq, *rope_tables_dmaj(sin, cos, N, Dh, "cpu"))
    elif layout == "ndh":
        want = rope_attention_ndh_plain(tq, *rope_tables(sin, cos, N, Dh, "cpu"))
    else:
        want = rope_attention_plain(tq, *rope_tables(sin, cos, N, Dh, "cpu"))
    assert got.shape == want.shape == _out_shape(layout, 2, 2, Dh, N)
    assert max_excess(got, want, KERNEL_TOLERANCES[KERNEL_NAME[layout]]) <= 0
