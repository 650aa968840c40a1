"""The int8 serving mode (``ops/dense_q8.py`` and the int8 branches of the
ViT and the adapter) vs the JAX package's, on the CPU.

The port's ops run here as their plain PyTorch versions (the wrappers take
them for CPU tensors) and are held against ``dinounet_tpu/ops/
dense_q8_pallas.py``: the Pallas kernels in interpret mode, and the pure-jnp
references. Then a tiny DinoViT, MSDeformAttn, ConvFFN and DinoUNet with the
int8 switches on in both packages, on weights carried over by
``state_dict_from_flax``. Inputs come from numpy seeds. Tolerances:

- the quantizers: bit for bit (both divide exactly and round half to even);
- against the interpret kernels, the JAX package's own kernel-vs-reference
  bound (tests/test_dense_q8.py: 0.05 on outputs, 2e-3 / 4e-3 on the
  statistics): its in-kernel GELU uses an approximate erf, and a level can
  flip where a value sits on a rounding edge;
- against the jnp references: fp32 1e-5 (the same fp32 operations; XLA may
  contract the rescale into an FMA, and its erf differs from PyTorch's by
  an fp32 ulp or two, which at these seeds moves no int8 level), bf16 one
  ulp of the output (2^-7 relative: a tie at the bf16 rounding);
- the row-parallel mode split by hand over K (each rank's maxima taken
  together, the ranks' int32 products summed, then the post-reduce pass):
  bit for bit against the port's whole op, statistics included, and the
  output against the JAX reference (fp32 with the GELU: 1e-5, XLA's erf);
  the statistics against JAX's 1e-6 (its mean sums in another order);
- the models: bounds beside each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dinounet_tpu_torch.models.adapter as t_adapter
import dinounet_tpu_torch.models.vit as t_vit
from dinounet_tpu_torch.models.convert import state_dict_from_flax
from dinounet_tpu_torch.ops import _build
from dinounet_tpu_torch.ops import dense_q8 as tq8

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
INT8_VARS = ("DINOUNET_TPU_VIT_INT8", "DINOUNET_TPU_INT8_QKV",
             "DINOUNET_TPU_INT8_ADAPTER")
KERNEL_TOL = dict(rtol=0.05, atol=0.05)  # tests/test_dense_q8.py:46,65
MU_ATOL, VAR_ATOL = 2e-3, 4e-3  # tests/test_dense_q8.py:66-68
ULP_BF16 = 2.0 ** -7  # one bf16 ulp, relative


def _pair(a: np.ndarray, dtype: str):
    """The same values as a torch tensor and a jax array of `dtype`."""
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(np.asarray(a, np.float32)).to(tdt), jnp.asarray(a, jdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_l2(got, want) -> float:
    g, w = _np(got), _np(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    """CPU calls run the plain versions and never count a kernel launch."""
    _build.reset_launch_counts()
    yield
    assert all(n == 0 for n in _build.launch_counts().values())


@pytest.fixture
def int8_env(monkeypatch):
    """Set the int8 switches (both packages read the same variables) and
    the JAX package's fused chain in interpret mode."""
    monkeypatch.setenv("DINOUNET_TPU_ATTN_IMPL", "pallas")
    monkeypatch.setenv("DINOUNET_TPU_DENSE_IMPL", "interpret")

    def set_int8(vit="1", qkv="1", adapter="0"):
        for var, v in zip(INT8_VARS, (vit, qkv, adapter)):
            monkeypatch.setenv(var, v)
    return set_int8


# ------------------------------------------------------------- quantizers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(768, 2304), (37, 24)])
def test_quantize_weight_matches_jax(dtype, shape):
    from dinounet_tpu.ops.dense_q8_pallas import quantize_weight

    w = np.random.default_rng(0).standard_normal(shape) * 0.05
    tw, jw = _pair(w, dtype)
    tq, ts = tq8.quantize_weight(tw)
    jq, js = quantize_weight(jw)
    assert tq.dtype == torch.int8 and ts.dtype == tw.dtype
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), _np(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_cm_matches_jax(dtype):
    from dinounet_tpu.ops.dense_q8_pallas import quantize_act_cm

    h = np.random.default_rng(1).standard_normal((2, 96, 1029)) * 3.0
    th, jh = _pair(h, dtype)
    tq, ta = tq8.quantize_act_cm(th)
    jq, ja = quantize_act_cm(jh)
    assert tq.dtype == torch.int8 and ta.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


# ------------------------------------------- plain versions vs the kernels


def _dense_case(seed, B, N, K, D, dtype="bfloat16", channel_major=False):
    """As tests/test_dense_q8.py draws them: (h, w, b, res, gamma), each as
    (torch, jax); h (B, K, N) when channel-major."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, K, N) if channel_major else (B, N, K))
    w = rng.standard_normal((K, D)) * 0.1
    b = rng.standard_normal((D,)) * 0.1
    res = rng.standard_normal((B, N, D))
    g = rng.standard_normal((D,)) * 0.01
    return (_pair(h, dtype), _pair(w, "float32"), _pair(b, "float32"),
            _pair(res, dtype), _pair(g, "float32"))


def _check_stats(got, want, tol):
    out, mu, var = got
    np.testing.assert_allclose(_np(out), _np(want[0]), **tol)
    np.testing.assert_allclose(_np(mu), _np(want[1]), atol=MU_ATOL)
    np.testing.assert_allclose(_np(var), _np(want[2]), atol=VAR_ATOL)
    # the statistics describe the stored rows
    assert mu.dtype == var.dtype == torch.float32
    np.testing.assert_allclose(_np(mu), _np(out).mean(-1), atol=2e-5)


ROW_SHAPES = [(2, 37, 64, 48), (1, 1029, 96, 64)]  # (B, N, K, D): N ragged


@pytest.mark.parametrize("prologue", ["none", "gelu"])
@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_dense_q8_matches_pallas_interpret(prologue, shape):
    from dinounet_tpu.ops.dense_q8_pallas import dense_q8

    (th, jh), (tw, jw), (tb, jb), _, _ = _dense_case(2, *shape)
    got = tq8.dense_q8(th, tw, tb, prologue)
    want = dense_q8(jh, jw, jb, prologue=prologue, interpret=True)
    assert got.dtype == torch.bfloat16 and got.shape == shape[:2] + shape[3:]
    np.testing.assert_allclose(_np(got), _np(want), **KERNEL_TOL)


@pytest.mark.parametrize("prologue", ["none", "gelu"])
@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_dense_q8_stats_matches_pallas_interpret(prologue, shape):
    from dinounet_tpu.ops.dense_q8_pallas import dense_q8_residual_stats

    (th, jh), (tw, jw), (tb, jb), (tr, jr), (tg, jg) = _dense_case(3, *shape)
    got = tq8.dense_q8_residual_stats(th, tw, tb, tr, tg, prologue)
    want = dense_q8_residual_stats(jh, jw, jb, jr, jg, prologue=prologue,
                                   interpret=True)
    _check_stats(got, want, KERNEL_TOL)


@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_dense_cm_q8_stats_matches_pallas_interpret(shape):
    from dinounet_tpu.ops.dense_q8_pallas import dense_cm_q8_residual_stats

    (th, jh), (tw, jw), (tb, jb), (tr, jr), (tg, jg) = _dense_case(
        4, *shape, channel_major=True)
    got = tq8.dense_cm_q8_residual_stats(th, tw, tb, tr, tg)
    want = dense_cm_q8_residual_stats(jh, jw, jb, jr, jg, interpret=True)
    _check_stats(got, want, KERNEL_TOL)


def _qkv_case(seed, B, N, C, dtype):
    """x (B, N, C), w (C, 3C) at the model's lecun scale, b (3C,)."""
    rng = np.random.default_rng(seed)
    return (_pair(rng.standard_normal((B, N, C)), dtype),
            _pair(rng.standard_normal((C, 3 * C)) * C ** -0.5, "float32"),
            _pair(rng.standard_normal((3 * C,)) * 0.1, "float32"))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("N", [37, 1029])
def test_qkv_q8_dmaj_matches_pallas_interpret(bias, N):
    from dinounet_tpu.ops.dense_q8_pallas import qkv_q8_dmaj_fused

    B, C, M = 2, 64, 4
    (tx, jx), (tw, jw), (tb, jb) = _qkv_case(5, B, N, C, "bfloat16")
    got = tq8.qkv_q8_dmaj(tx, tw, tb if bias else None, M, C // M)
    want = qkv_q8_dmaj_fused(jx, jw, jb if bias else None, M, C // M, interpret=True)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 3, M, C // M, N)
    np.testing.assert_allclose(_np(got), _np(want), **KERNEL_TOL)


# the GEMM's tile edges: B N rows that end inside a 64- or 128-token tile and
# tiles that span two images (N 65, 129 with B 3); K neither a multiple of
# 128 nor, for 40 and 200, of 16 before padding; D and 3C not a multiple of
# the 256-feature pass
EDGE_ROW_SHAPES = [(3, 65, 40, 24), (3, 129, 200, 136)]  # (B, N, K, D)
EDGE_QKV_SHAPES = [(3, 65, 40, 2), (3, 129, 200, 8)]  # (B, N, C, M)


@pytest.mark.parametrize("shape", EDGE_ROW_SHAPES)
def test_dense_q8_tile_edges_match_pallas_interpret(shape):
    """Without the GELU, bit for bit against ``_reference_q8`` (the same
    levels, exact int32 sums, (acc * a) * ws + b in fp32 rounded once to
    bf16), and within the JAX package's kernel-vs-reference bound of
    ``_q8_forward`` in interpret mode, which is not bit-equal to its own
    reference: its fused fp32 arithmetic moves outputs by fp32 ulps and a
    few levels across a rounding edge (2 of 4680 outputs off by more than
    one bf16 ulp at the first shape, 154 of 52632 at the second)."""
    from dinounet_tpu.ops.dense_q8_pallas import _q8_forward, _reference_q8

    (th, jh), (tw, jw), (tb, jb), _, _ = _dense_case(11, *shape)
    got = tq8.dense_q8(th, tw, tb)
    assert got.dtype == torch.bfloat16 and got.shape == shape[:2] + shape[3:]
    np.testing.assert_array_equal(_np(got), _np(_reference_q8(jh, jw, jb, "none")))
    want = _q8_forward(jh, jw, jb, "none", True)
    np.testing.assert_allclose(_np(got), _np(want), **KERNEL_TOL)


@pytest.mark.parametrize("shape", EDGE_QKV_SHAPES)
def test_qkv_q8_dmaj_tile_edges_match_pallas_interpret(shape):
    """The JAX package's kernel-vs-reference bound, as
    test_qkv_q8_dmaj_matches_pallas_interpret."""
    from dinounet_tpu.ops.dense_q8_pallas import qkv_q8_dmaj_fused

    B, N, C, M = shape
    (tx, jx), (tw, jw), (tb, jb) = _qkv_case(12, B, N, C, "bfloat16")
    got = tq8.qkv_q8_dmaj(tx, tw, tb, M, C // M)
    want = qkv_q8_dmaj_fused(jx, jw, jb, M, C // M, interpret=True)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 3, M, C // M, N)
    np.testing.assert_allclose(_np(got), _np(want), **KERNEL_TOL)


# --------------------------------------- plain versions vs the references


def _ref_tol(dtype):
    if dtype == "float32":
        return dict(rtol=1e-5, atol=1e-5)
    return dict(rtol=ULP_BF16, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prologue", ["none", "gelu"])
def test_dense_q8_matches_reference(dtype, prologue):
    """Same rounding points as ``_reference_q8``."""
    from dinounet_tpu.ops.dense_q8_pallas import _reference_q8

    (th, jh), (tw, jw), (tb, jb), _, _ = _dense_case(6, 2, 37, 64, 48, dtype)
    got = tq8.dense_q8(th, tw, tb, prologue)
    want = _reference_q8(jh, jw, jb, prologue)
    np.testing.assert_allclose(_np(got), _np(want), **_ref_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prologue", ["none", "gelu"])
def test_dense_q8_stats_matches_reference(dtype, prologue):
    """``_reference_q8_stats``: the output as for ``dense_q8``, the
    statistics 1e-5."""
    from dinounet_tpu.ops.dense_q8_pallas import _reference_q8_stats

    (th, jh), (tw, jw), (tb, jb), (tr, jr), (tg, jg) = _dense_case(7, 2, 37, 64, 48, dtype)
    got = tq8.dense_q8_residual_stats(th, tw, tb, tr, tg, prologue)
    want = _reference_q8_stats(jh, jw, jb, jr, jg, prologue)
    tol = _ref_tol(dtype)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **(tol if g.ndim == 3 else
                                                      dict(rtol=1e-5, atol=1e-5)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_cm_q8_stats_matches_reference(dtype):
    from dinounet_tpu.ops.dense_q8_pallas import _reference_cm_q8_stats

    (th, jh), (tw, jw), (tb, jb), (tr, jr), (tg, jg) = _dense_case(
        8, 2, 37, 64, 48, dtype, channel_major=True)
    got = tq8.dense_cm_q8_residual_stats(th, tw, tb, tr, tg)
    want = _reference_cm_q8_stats(jh, jw, jb, jr, jg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **(_ref_tol(dtype) if g.ndim == 3
                                                      else dict(rtol=1e-5, atol=1e-5)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_qkv_q8_dmaj_matches_reference(dtype, bias):
    from dinounet_tpu.ops.dense_q8_pallas import qkv_q8_premapped_dmaj

    B, N, C, M = 2, 37, 64, 4
    (tx, jx), (tw, jw), (tb, jb) = _qkv_case(9, B, N, C, dtype)
    got = tq8.qkv_q8_dmaj(tx, tw, tb if bias else None, M, C // M)
    want = qkv_q8_premapped_dmaj(jx, jw, jb if bias else None, M, C // M)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **_ref_tol(dtype))


# ------------------------------------------ the row-parallel mode (model axis)


def _split_mode(h, w, b, res, g, form: str, n: int = 2, local: bool = False):
    """The row-parallel mode on n ranks in one process: h's and w's K split
    n ways (each rank's part contiguous, as a rank holds it), the ranks'
    per-token and per-column maxima taken together (each rank's own with
    `local`), each rank's int32 product at those scales, the products
    summed, then the post-reduce pass. `local` instead rescales each rank's
    product at its own scales and sums the fp32 results: what a rank-local
    scale would give. Returns (out, mean, var) and the maxima by rank."""
    cm = form == "cm"
    prologue = "gelu" if form == "gelu" else "none"
    parts = np.array_split(np.arange(w.shape[0]), n)
    hs = [(h[:, p[0]:p[-1] + 1] if cm else h[..., p[0]:p[-1] + 1]).contiguous() for p in parts]
    ws_ = [w[p[0]:p[-1] + 1] for p in parts]
    amaxes = [tq8.act_amax(hr, cm, prologue) for hr in hs]
    wmaxes = [wr.abs().amax(0, keepdim=True) for wr in ws_]
    amax, wmax = torch.stack(amaxes).amax(0), torch.stack(wmaxes).amax(0)
    acc, scales, ys = 0, set(), 0
    for hr, wr, am, wm in zip(hs, ws_, amaxes, wmaxes):
        wq, ws = tq8.quantize_weight_dk(wr, amax=wm if local else wmax)
        if cm:
            acc_r, a = tq8.dense_cm_q8_partial(hr, wq, am if local else amax)
        else:
            acc_r, a = tq8.dense_q8_partial(hr, wq, am if local else amax, prologue)
        assert acc_r.dtype == torch.int32 and a.dtype == torch.float32
        acc = acc + acc_r
        ys = ys + acc_r.float() * a.view(*acc_r.shape[:2], 1) * ws
        scales.add(a.numpy().tobytes())
    if local:
        return tq8._residual_stats(ys + b.float(), res, g), (amaxes, wmaxes)
    assert len(scales) == 1  # every rank holds the same per-token scales
    return tq8.post_reduce_q8_residual_stats(acc, a, ws, b, res, g), (amaxes, wmaxes)


def _whole_plain(h, w, b, res, g, form):
    if form == "cm":
        return tq8.dense_cm_q8_residual_stats_plain(h, w, b, res, g)
    return tq8.dense_q8_residual_stats_plain(h, w, b, res, g, "gelu" if form == "gelu" else "none")


# (B, N, K, D): N odd, K / 2 = 36 and 100 not multiples of 16, D past no pass
SPLIT_SHAPES = [(2, 37, 72, 48), (1, 21, 200, 40)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["gelu", "none", "cm"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_row_parallel_split_matches_reference(dtype, form, shape):
    """#11's (row-major, with or without the GELU) and #12's (channel-major)
    row-parallel mode split over two ranks by hand: the JAX package's whole
    ``quantize_weight`` scales, the whole port op bit for bit (the int32
    sums are exact, the scales the whole rows'), the JAX references'
    outputs bit for bit (fp32 with the GELU: 1e-5, XLA's erf against
    PyTorch's), their statistics to 1e-6."""
    from dinounet_tpu.ops.dense_q8_pallas import (_reference_cm_q8_stats, _reference_q8_stats,
                                                  quantize_weight)

    cm = form == "cm"
    (th, jh), (tw, jw), (tb, jb), (tr, jr), (tg, jg) = _dense_case(15, *shape, dtype,
                                                                   channel_major=cm)
    got, _ = _split_mode(th, tw, tb, tr, tg, form)
    whole = _whole_plain(th, tw, tb, tr, tg, form)
    for g_, w_ in zip(got, whole):
        assert g_.dtype == w_.dtype and torch.equal(g_, w_)
    wmax = torch.stack([tw[:shape[2] // 2].abs().amax(0), tw[shape[2] // 2:].abs().amax(0)])
    _, ws = tq8.quantize_weight(tw[:shape[2] // 2], wmax.amax(0, keepdim=True))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(quantize_weight(jw)[1]))
    if cm:
        want = _reference_cm_q8_stats(jh, jw, jb, jr, jg)
    else:
        want = _reference_q8_stats(jh, jw, jb, jr, jg, form)
    if dtype == "float32" and form == "gelu":
        np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    for g_, w_ in zip(got[1:], want[1:]):
        np.testing.assert_allclose(_np(g_), _np(w_), rtol=0, atol=1e-6)


@pytest.mark.parametrize("form", ["gelu", "cm"])
def test_row_parallel_scales_are_the_whole_rows(form):
    """Every token's maximum lies in rank 0's half of K and every weight
    column's in rank 1's: the mode equals the whole op bit for bit only
    with both scales taken over the ranks. Rank-local scales (each rank's
    product rescaled at its own and the fp32 results summed) run and land
    near, but not on, the whole result."""
    cm = form == "cm"
    B, N, K, D = 2, 37, 72, 48
    (th, _), (tw, _), (tb, _), (tr, _), (tg, _) = _dense_case(16, B, N, K, D, "float32",
                                                              channel_major=cm)
    if cm:
        th[:, 3] = 8.0  # channel 3 of every token: rank 0's
    else:
        th[..., 3] = 8.0
    tw[K - 2] = 1.0  # row K - 2 of every column: rank 1's
    got, (amaxes, wmaxes) = _split_mode(th, tw, tb, tr, tg, form)
    assert torch.all(amaxes[0] > amaxes[1]) and torch.all(wmaxes[1] > wmaxes[0])
    whole = _whole_plain(th, tw, tb, tr, tg, form)
    for g_, w_ in zip(got, whole):
        assert torch.equal(g_, w_)
    local, _ = _split_mode(th, tw, tb, tr, tg, form, local=True)
    assert not torch.equal(local[0], whole[0])
    assert _rel_l2(local[0], whole[0]) < 0.05  # plausible, and wrong


def test_row_parallel_ops_raise_on_bad_inputs():
    """The mode's wrappers check the cached weight's width, the prologue and
    the channel-major pass's lack of one, as the whole ops do."""
    h = torch.zeros((1, 5, 40))
    amax = torch.ones(5)
    with pytest.raises(ValueError, match="wq"):
        tq8.dense_q8_partial(h, torch.zeros((8, 40), dtype=torch.int8), amax)
    with pytest.raises(ValueError, match="prologue"):
        tq8.dense_q8_partial(h, torch.zeros((8, 48), dtype=torch.int8), amax, "relu")
    with pytest.raises(ValueError, match="no prologue"):
        tq8.act_amax(h.transpose(1, 2), channel_major=True, prologue="gelu")


# ------------------------------------------------------------------ grads


def _grads(fn, leaves):
    """Gradients of a fixed random projection of fn's outputs."""
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator().manual_seed(5)
    loss = sum((o.float() * torch.randn(o.shape, generator=gen)).sum() for o in outs)
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("op", ["dense_q8", "dense_q8_gelu", "dense_q8_stats",
                                "dense_q8_stats_gelu", "dense_cm_q8_stats",
                                "qkv_q8_dmaj", "qkv_q8_dmaj_no_bias"])
def test_wrapper_grads_equal_plain(op):
    """The wrappers are autograd Functions whose backward differentiates the
    plain version (as the JAX custom VJPs differentiate their references):
    on the CPU the gradients are the plain version's own, and nonzero."""
    rng = np.random.default_rng(10)
    B, N, K, D, M = 2, 21, 48, 24, 2
    gelu = "gelu" if op.endswith("gelu") else "none"
    if op.startswith("qkv"):
        arrays = [rng.standard_normal((B, N, K)), rng.standard_normal((K, 3 * K)) * 0.1]
        if op == "qkv_q8_dmaj":
            arrays.append(rng.standard_normal((3 * K,)) * 0.1)
            wrapper = lambda x, w, b: tq8.qkv_q8_dmaj(x, w, b, M, K // M)
            plain = lambda x, w, b: tq8.qkv_q8_dmaj_plain(x, w, b, M, K // M)
        else:
            wrapper = lambda x, w: tq8.qkv_q8_dmaj(x, w, None, M, K // M)
            plain = lambda x, w: tq8.qkv_q8_dmaj_plain(x, w, None, M, K // M)
    else:
        cm = op == "dense_cm_q8_stats"
        arrays = [rng.standard_normal((B, K, N) if cm else (B, N, K)),
                  rng.standard_normal((K, D)) * 0.1, rng.standard_normal((D,)) * 0.1]
        if op.startswith("dense_q8_stats") or cm:
            arrays += [rng.standard_normal((B, N, D)), rng.standard_normal((D,)) * 0.5]
        if cm:
            wrapper, plain = tq8.dense_cm_q8_residual_stats, tq8.dense_cm_q8_residual_stats_plain
        elif op.startswith("dense_q8_stats"):
            wrapper = lambda *a: tq8.dense_q8_residual_stats(*a, gelu)
            plain = lambda *a: tq8.dense_q8_residual_stats_plain(*a, gelu)
        else:
            wrapper = lambda *a: tq8.dense_q8(*a, gelu)
            plain = lambda *a: tq8.dense_q8_plain(*a, gelu)

    def leaves():
        return [torch.tensor(a, dtype=torch.float32, requires_grad=True) for a in arrays]

    got, want = _grads(wrapper, leaves()), _grads(plain, leaves())
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)
    assert all(float(a.abs().max()) > 0 for a in got)


# ---------------------------------------------------------------- modules


@pytest.fixture
def spies(monkeypatch):
    """Count the port modules' calls of the int8 ops (on the CPU no kernel
    launches, so the launch counts stay 0)."""
    counts = {}

    def spy(module, name):
        fn = getattr(module, name)

        def counted(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, counted)

    for name in ("qkv_q8_dmaj", "dense_q8", "dense_q8_residual_stats",
                 "dense_cm_q8_residual_stats"):
        spy(t_vit, name)
    for name in ("dense_q8_residual_stats", "dense_cm_q8_residual_stats"):
        spy(t_adapter, name)
    return counts


def _filled(init, rng):
    """A flax variable tree with the structure of ``init()`` (traced
    abstractly: no kernel runs), filled from a numpy seed as
    tests/test_torch_models.py fills its variables, so no projection keeps a
    zero init."""
    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if name.endswith("['kernel']"):
            return noise / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        if name.endswith("['var']"):
            return rng.uniform(0.75, 1.25, leaf.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return 1.0 + 0.02 * noise
        if "level_embed" in name:
            return noise
        return (0.1 if name.endswith("['mean']") else 0.02) * noise
    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init))


def _load(module, params, top, path, prefix):
    """flax params of one submodule -> the port module, through the bridge."""
    tree = params
    for key in reversed(path):
        tree = {key: tree}
    sd = state_dict_from_flax({"params": {top: tree}})
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


VIT_KW = dict(embed_dim=64, depth=3, num_heads=2, ffn_ratio=2, patch_size=16)


@pytest.fixture(scope="module")
def vit_case():
    """TestModelPath's tiny DinoViT (tests/test_dense_q8.py:279-287) with
    noisy weights, both packages' models, and a (2, 3, 64, 64) input."""
    from dinounet_tpu.models.vit import DinoViT, ViTConfig

    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    jmodel = DinoViT(ViTConfig(**VIT_KW))
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    params = _filled(lambda: jmodel.init(jax.random.PRNGKey(0), xj, (0, 1, 2)),
                     rng)["params"]
    tmodel = _load(t_vit.DinoViT(t_vit.ViTConfig(**VIT_KW)), params, "backbone", (),
                   "encoder.dinov3_adapter.backbone.")
    return jmodel, tmodel, {"params": params}, xj, torch.from_numpy(x)


@pytest.mark.parametrize("qkv", ["1", "0"])
def test_vit_int8_matches_jax(vit_case, int8_env, spies, qkv):
    """The int8 block chain, both packages in bf16 (JAX: its fused chain, the
    Pallas kernels in interpret mode): every taken layer's tokens within
    JAX's own fused-vs-unfused int8 bound (tests/test_dense_q8.py:311-317,
    0.05); the port calls each int8 op once a block (the qkv not at all with
    DINOUNET_TPU_INT8_QKV=0)."""
    jmodel, tmodel, variables, xj, xt = vit_case
    int8_env(qkv=qkv)
    want = jmodel.apply(variables, xj, (0, 1, 2))
    with torch.inference_mode():
        got = tmodel(xt, (0, 1, 2))
    depth = VIT_KW["depth"]
    assert spies.get("qkv_q8_dmaj", 0) == depth * int(qkv)
    assert spies["dense_q8"] == spies["dense_q8_residual_stats"] == depth
    assert spies["dense_cm_q8_residual_stats"] == depth
    for (gp, gc), (wp, wc) in zip(got, want):
        np.testing.assert_allclose(_np(gp), _np(wp), **KERNEL_TOL)
        np.testing.assert_allclose(_np(gc), _np(wc), **KERNEL_TOL)


def test_vit_int8_close_to_bf16(vit_case, int8_env, spies):
    """test_dense_q8.py::TestModelPath's budget: cosine > 0.995 against the
    bf16 chain on the same weights; the int8 ops must change the output."""
    _, tmodel, _, _, xt = vit_case
    with torch.inference_mode():
        int8_env(vit="0")
        (ref, _), = tmodel(xt, (2,))
        assert spies == {}
        int8_env(vit="1")
        (q, _), = tmodel(xt, (2,))
    a, b = _np(ref).ravel(), _np(q).ravel()
    assert np.all(np.isfinite(b)) and not np.array_equal(a, b)
    assert float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))) > 0.995


def _adapter_check(got, want, bf16_out):
    """TestAdapterInt8's bounds (tests/test_dense_q8.py:417-423): out 0.05,
    mean 5e-3, var 1e-2; the int8 output differs from the bf16 one."""
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), atol=0.05, rtol=0.05)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), atol=5e-3)
    np.testing.assert_allclose(_np(got[2]), _np(want[2]), atol=1e-2)
    assert not np.array_equal(_np(got[0]), _np(bf16_out))


def test_msda_output_proj_int8_matches_jax(int8_env, spies):
    """TestAdapterInt8's MSDeformAttn setup (80 queries over an 8x8 + 4x4
    pyramid, a 6x6 value grid, 4 heads, 2 points, bf16) with
    DINOUNET_TPU_INT8_ADAPTER=1 in both packages (JAX: the gather core and
    the row-major w8a8 kernel in interpret mode; the port: the channel-major
    op, the same int8 levels)."""
    from dinounet_tpu.models.adapter import MSDeformAttn, reference_points_for_grids

    rng = np.random.default_rng(12)
    B, Lq, C = 1, 80, 64
    q, res, vals = (rng.standard_normal(s).astype(np.float32)
                    for s in ((B, Lq, C), (B, Lq, C), (B, 36, C)))
    (tq, jq), (tr, jr), (tv, jv) = (_pair(a, "bfloat16") for a in (q, res, vals))
    ref_pts = np.asarray(reference_points_for_grids([(8, 8), (4, 4)]), np.float32)
    jattn = MSDeformAttn(d_model=C, n_heads=4, n_points=2)
    params = _filled(lambda: jattn.init(jax.random.PRNGKey(0), jq, jnp.asarray(ref_pts),
                                        jv, [(6, 6)], residual=jr), rng)["params"]
    tattn = _load(t_adapter.MSDeformAttn(C, 1, 4, 2), params, "adapter",
                  ("interaction0", "extractor", "attn"),
                  "encoder.dinov3_adapter.interactions.0.extractor.attn.")
    int8_env(adapter="1")
    want = jattn.apply({"params": params}, jq, jnp.asarray(ref_pts), jv, [(6, 6)],
                       residual=jr)
    tref = torch.from_numpy(ref_pts)
    with torch.inference_mode():
        got = tattn(tq, tref, tv, [(6, 6)], tr)
        assert spies == {"dense_cm_q8_residual_stats": 1}
        int8_env(adapter="0")
        bf16_out = tattn(tq, tref, tv, [(6, 6)], tr)[0]
    _adapter_check(got, want, bf16_out)


def test_convffn_fc2_int8_matches_jax(int8_env, spies):
    """TestAdapterInt8's ConvFFN setup (64 -> 128 -> 64 over the 21n = 336
    tokens of an 8x8 grid, bf16) with DINOUNET_TPU_INT8_ADAPTER=1 in both
    packages: the GELU-prologue w8a8 fc2 with the residual and statistics."""
    from dinounet_tpu.models.adapter import ConvFFN

    rng = np.random.default_rng(13)
    B, C, H = 1, 64, 8
    n = 21 * (H * H // 4)
    (tx, jx), (tr, jr) = (_pair(rng.standard_normal((B, n, C)), "bfloat16")
                          for _ in range(2))
    jffn = ConvFFN(dim=C, hidden=2 * C)
    params = _filled(lambda: jffn.init(jax.random.PRNGKey(0), jx, H, H, residual=jr),
                     rng)["params"]
    tffn = _load(t_adapter.ConvFFN(C, 2 * C, torch.bfloat16), params, "adapter",
                 ("interaction0", "extractor", "ffn"),
                 "encoder.dinov3_adapter.interactions.0.extractor.ffn.")
    int8_env(adapter="1")
    want = jffn.apply({"params": params}, jx, H, H, residual=jr)
    with torch.inference_mode():
        got = tffn(tx, H, H, tr)
        assert spies == {"dense_q8_residual_stats": 1}
        int8_env(adapter="0")
        bf16_out = tffn(tx, H, H, tr)[0]
    _adapter_check(got, want, bf16_out)


@pytest.mark.parametrize("adapter", ["0", "1"])
def test_dinounet_int8_matches_jax(int8_env, spies, adapter):
    """A tiny DinoUNet (embed 64, depth 4, 2 heads, 4 deform heads, 64 x 64,
    batch 2) in bf16 with the int8 mode on in both packages, the same
    weights: relative L2 of the logits <= 5e-2, the bound the conv routes'
    bf16 model test uses (tests/test_torch_decoder_tail.py); the two packages
    already round at different points in the stock bf16 model."""
    from dinounet_tpu.models.dinounet import DinoUNet as JaxDinoUNet
    from dinounet_tpu.models.dinounet import DinoUNetConfig
    from dinounet_tpu.models.vit import ViTConfig

    from dinounet_tpu_torch.models.dinounet import DinoUNet
    from dinounet_tpu_torch.models.dinounet import DinoUNetConfig as TConfig

    vit = dict(embed_dim=64, depth=4, num_heads=2, ffn_ratio=2, n_storage_tokens=4,
               dtype="bfloat16")
    kw = dict(interaction_indexes=(0, 1, 2, 3), num_classes=3,
              features_per_stage=(8, 16, 32, 64), n_conv_per_stage_decoder=(2, 2, 2),
              conv_bias=True, norm="instancenorm", nonlin="leaky_relu",
              nonlin_kwargs={"negative_slope": 0.01}, fapm_rank=16, conv_inplane=8,
              deform_num_heads=4, dtype="bfloat16")
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 1, 64, 64)).astype(np.float32)
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    jmodel = JaxDinoUNet(DinoUNetConfig(vit=ViTConfig(**vit), **kw))
    variables = _filled(lambda: jmodel.init(jax.random.PRNGKey(0), xj[:1], train=False),
                        rng)
    int8_env(adapter=adapter)
    want = np.moveaxis(_np(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, xj)), -1, 1)
    model = DinoUNet(TConfig(vit=t_vit.ViTConfig(**vit), **kw))
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    n_ext = 6
    assert spies["dense_q8"] == 4
    assert spies.get("dense_cm_q8_residual_stats", 0) == 4 + n_ext * int(adapter)
    assert got.shape == (2, 3, 64, 64) and np.all(np.isfinite(got))
    assert _rel_l2(got, want) <= 5e-2
