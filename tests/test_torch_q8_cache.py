"""The int8 weight cache and the kernels' quantize pass (``ops/dense_q8.py``)
vs the JAX package's quantizers, on the CPU.

The frozen weights of the int8 serving mode are quantized once and kept on
the tensor that owns the weight's storage (``quantized_weight``): the int8
levels transposed to (D, Kpad), K contiguous and padded with zeros to a
multiple of 16, and the fp32 scales. Held here: the levels and scales equal
``quantize_weight`` and ``dinounet_tpu/ops/dense_q8_pallas.py::
quantize_weight`` bit for bit, for a Linear weight's ``.t()`` view and for
a plain tensor; an in-place update quantizes again; distinct weights never
share an entry; an entry built inside ``torch.inference_mode`` serves calls
outside it. ``quantize_act_tokens`` (the plain version of the kernels'
quantize pass) equals the JAX ``quantize_act_cm`` transposed, and the JAX
row quantizer, bit for bit. Inputs come from numpy seeds.
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinounet_tpu.ops import dense_q8_pallas as jq8
from dinounet_tpu_torch.ops import _build
from dinounet_tpu_torch.ops import dense_q8 as tq8

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _weight(seed, K, D, layout, dtype="float32"):
    """A (K, D) weight: a Linear's (D, K) parameter seen through .t(), or a
    plain (K, D) tensor; and the same values as a jax (K, D) array."""
    w = np.random.default_rng(seed).standard_normal((K, D)) * 0.05
    tdt, jdt = DTYPES[dtype]
    if layout == "linear":
        param = torch.nn.Parameter(torch.from_numpy(w.T.copy()).to(tdt), requires_grad=False)
        tw = param.t()
    else:
        tw = torch.from_numpy(w).to(tdt)
    return tw, jnp.asarray(w, jdt)


def _levels(wq, K):
    """The cached (D, Kpad) levels as (K, D)."""
    return wq[:, :K].t()


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    """CPU calls run the plain versions and never count a kernel launch."""
    _build.reset_launch_counts()
    yield
    assert all(n == 0 for n in _build.launch_counts().values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["linear", "plain"])
@pytest.mark.parametrize("K,D", [(768, 2304), (37, 24), (192, 40)])
def test_cached_weight_equals_quantize_weight(layout, dtype, K, D):
    tw, jw = _weight(0, K, D, layout, dtype)
    wq, ws = tq8.quantized_weight(tw)
    assert wq.dtype == torch.int8 and wq.shape == (D, -(-K // 16) * 16)
    assert wq.is_contiguous() and ws.dtype == torch.float32 and ws.shape == (D,)
    want_q, want_s = tq8.quantize_weight(tw)
    assert torch.equal(_levels(wq, K), want_q) and torch.equal(ws, want_s.float())
    assert not wq[:, K:].any()
    jq, js = jq8.quantize_weight(jw)
    np.testing.assert_array_equal(_levels(wq, K).numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(js, np.float32))
    # the entry is kept on the tensor that owns the storage: a second call,
    # through a new view, returns the same tensors
    again = tq8.quantized_weight(tw._base.t() if layout == "linear" else tw)
    assert again[0] is wq and again[1] is ws


def test_cached_weight_in_fp32_for_quant_dense():
    """QuantDense quantizes a bf16-held matrix from its fp32 values: the
    entry computed in fp32 is its own, beside the one in the weight's dtype."""
    tw, _ = _weight(1, 64, 48, "linear", "bfloat16")
    wq32, ws32 = tq8.quantized_weight(tw, torch.float32)
    q, s = tq8.quantize_weight(tw.float())
    assert torch.equal(_levels(wq32, 64), q) and torch.equal(ws32, s)
    wq16, ws16 = tq8.quantized_weight(tw)
    q, s = tq8.quantize_weight(tw)
    assert torch.equal(_levels(wq16, 64), q) and torch.equal(ws16, s.float())


@pytest.mark.parametrize("update", ["copy_", "mul_", "load_state_dict"])
def test_in_place_update_quantizes_again(update):
    lin = torch.nn.Linear(96, 40)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(
            np.random.default_rng(2).standard_normal((40, 96)) * 0.05))
    first = tq8.quantized_weight(lin.weight.t())
    new = torch.from_numpy(np.random.default_rng(3).standard_normal((40, 96)) * 0.2).float()
    with torch.no_grad():
        if update == "copy_":
            lin.weight.copy_(new)
        elif update == "mul_":
            lin.weight.mul_(-3.0)
        else:
            lin.load_state_dict({"weight": new, "bias": lin.bias.detach().clone()})
    wq, ws = tq8.quantized_weight(lin.weight.t())
    want_q, want_s = tq8.quantize_weight(lin.weight.t())
    assert torch.equal(_levels(wq, 96), want_q) and torch.equal(ws, want_s)
    assert not torch.equal(ws, first[1])


def test_distinct_weights_never_share_an_entry():
    """Two models' equal-shaped weights each get their own levels, and a
    weight allocated where a freed one was does not inherit its entry."""
    models = [torch.nn.Linear(64, 32) for _ in range(2)]
    for seed, m in enumerate(models):
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(
                np.random.default_rng(10 + seed).standard_normal((32, 64))))
    got = [tq8.quantized_weight(m.weight.t()) for m in models]
    for m, (wq, ws) in zip(models, got):
        q, s = tq8.quantize_weight(m.weight.t())
        assert torch.equal(_levels(wq, 64), q) and torch.equal(ws, s)
    assert not torch.equal(got[0][1], got[1][1])
    for seed in range(4):  # freed and allocated again: often the same address
        w = torch.from_numpy(np.random.default_rng(20 + seed).standard_normal((64, 32)))
        wq, ws = tq8.quantized_weight(w)
        q, s = tq8.quantize_weight(w)
        assert torch.equal(_levels(wq, 64), q) and torch.equal(ws, s.float())
        del w, wq, ws
        gc.collect()


def test_entry_built_in_inference_mode_serves_outside():
    """The predictor runs inside torch.inference_mode; the cached tensors are
    ordinary ones and serve later calls outside it, autograd included."""
    lin = torch.nn.Linear(48, 24, bias=False)
    with torch.inference_mode():
        wq, ws = tq8.quantized_weight(lin.weight.t(), torch.float32)
        x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 5, 48))).float()
        inside = tq8.quant_dense(x, lin.weight, None, torch.float32)
    assert not wq.is_inference() and not ws.is_inference()
    again = tq8.quantized_weight(lin.weight.t(), torch.float32)
    assert again[0] is wq and again[1] is ws
    xg = x.clone().requires_grad_(True)
    outside = tq8.quant_dense(xg, lin.weight, None, torch.float32)
    assert torch.equal(outside.detach(), inside)
    outside.sum().backward()  # the int8 product's rounding passes no gradient to x
    assert xg.grad is not None


def test_inference_tensor_weight_is_quantized_per_call():
    """A weight made inside inference mode has no version counter to tie an
    entry to: it is quantized on every call and nothing is kept on it."""
    with torch.inference_mode():
        lin = torch.nn.Linear(40, 16)
        wq, ws = tq8.quantized_weight(lin.weight.t())
        q, s = tq8.quantize_weight(lin.weight.t())
        assert torch.equal(_levels(wq, 40), q) and torch.equal(ws, s)
        assert not hasattr(lin.weight, tq8.CACHE_ATTR)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,N", [(2, 96, 1029), (1, 37, 70), (2, 384, 64)])
def test_token_major_quantize_of_channel_major_matches_jax(dtype, B, K, N):
    h = np.random.default_rng(5).standard_normal((B, K, N)) * 3.0
    tdt, jdt = DTYPES[dtype]
    xq, a = tq8.quantize_act_tokens(torch.from_numpy(h).to(tdt), channel_major=True)
    jq, ja = jq8.quantize_act_cm(jnp.asarray(h, jdt))  # (B, K, N), (B, N, 1)
    Kpad = -(-K // 16) * 16
    assert xq.shape == (B * N, Kpad) and xq.dtype == torch.int8 and a.shape == (B * N,)
    np.testing.assert_array_equal(xq[:, :K].numpy(),
                                  np.asarray(jq).transpose(0, 2, 1).reshape(B * N, K))
    assert not xq[:, K:].any()
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja).reshape(B * N))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,K", [(2, 37, 96), (1, 21, 200)])
def test_token_major_quantize_of_row_major_matches_jax(dtype, B, N, K):
    h = np.random.default_rng(6).standard_normal((B, N, K)) * 3.0
    tdt, jdt = DTYPES[dtype]
    xq, a = tq8.quantize_act_tokens(torch.from_numpy(h).to(tdt))
    jq, ja = jq8._quant_rows(jnp.asarray(h, jdt).astype(jnp.float32))
    np.testing.assert_array_equal(xq[:, :K].numpy(), np.asarray(jq).reshape(B * N, K))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja).reshape(B * N))
    # with the GELU: the levels of the GELU rounded to the input's dtype
    xg, ag = tq8.quantize_act_tokens(torch.from_numpy(h).to(tdt), prologue="gelu")
    q, s = tq8._quantize(tq8._prologue("gelu", torch.from_numpy(h).to(tdt)), -1)
    assert torch.equal(xg[:, :K], q.reshape(B * N, K).to(torch.int8))
    assert torch.equal(ag, s.reshape(B * N))
