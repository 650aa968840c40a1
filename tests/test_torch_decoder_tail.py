"""The port's inference conv routes vs the JAX package's, on the CPU.

Ops of ``ops/decoder_tail.py`` and ``ops/conv_hwbc.py`` (their plain versions,
which CPU tensors take) against the JAX package's Pallas kernels in interpret
mode, in fp32 and bf16; then the routed modules (UNetDecoder's fused chain
and HWBC stages, LearnableUpsample, SpatialPriorModule) and a tiny DinoUNet
with the routes on in both packages (``monkeypatch.setenv(..., "interpret")``
for JAX, "pallas" for the port), on weights carried over by
``state_dict_from_flax``. Inputs come from numpy seeds. Tolerances:

- fp32: both packages sum exact fp32 products in another order: 1e-4 on the
  ops, 1e-3 on whole models (InstanceNorm rescales by 1 / std).
- bf16 maps: both round the same fp32 sums once, and an order difference can
  flip that rounding by one bf16 ulp (2^-8 relative); statistics are compared
  as means over the map. Through normalisations and later convs such flips
  spread, so module and model outputs are held as relative L2 errors instead
  (bounds beside each test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dinounet_tpu_torch.models.adapter as t_adapter
import dinounet_tpu_torch.models.decoder as t_decoder
import dinounet_tpu_torch.models.layers as t_layers
from dinounet_tpu_torch.models.convert import state_dict_from_flax
from dinounet_tpu_torch.ops import conv_hwbc as t_hwbc
from dinounet_tpu_torch.ops import decoder_tail as t_tail

ROUTE_VARS = ("DINOUNET_TPU_DECODER_TAIL", "DINOUNET_TPU_SPM_CM",
              "DINOUNET_TPU_DECODER_HWBC")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (atol, rtol) on maps and on the statistics' means, by dtype
MAP_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-2)}
MEAN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 1e-3)}


def _rand(rng, shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _both(a, dtype):
    """numpy -> (jax array, torch tensor), both rounded to `dtype`."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol[0], rtol=tol[1])


def _rel_l2(got, want):
    g, w = _np(got), _np(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _conv_t(k):
    """flax conv kernel (3, 3, Ci, Co) -> torch (Co, Ci, 3, 3)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1)))


def _transp_t(k):
    """flax conv-transpose kernel (2, 2, Ci, Co) -> torch (Ci, Co, 2, 2)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(k)[::-1, ::-1].transpose(2, 3, 0, 1)))


def _prologue(rng, B, C):
    s, t = _rand(rng, (B, C), 0.2, 1.0), _rand(rng, (B, C), 0.3)
    return (jnp.asarray(s), jnp.asarray(t)), (torch.from_numpy(s), torch.from_numpy(t))


@pytest.fixture
def routes(monkeypatch):
    """Set the route variables: JAX reads "interpret", the port "pallas"."""
    def set_routes(names, port: bool):
        for var in ROUTE_VARS:
            on = var in names
            monkeypatch.setenv(var, ("pallas" if port else "interpret") if on else "jax")
    return set_routes


@pytest.fixture
def spies(monkeypatch):
    """Count the routed calls of the port's modules (on the CPU no kernel
    launches, so the launch counts stay 0)."""
    counts = {}

    def spy(module, name):
        fn = getattr(module, name)

        def counted(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, counted)

    spy(t_decoder, "decoder_chain_cm")
    spy(t_decoder, "conv3x3_hwbc")
    spy(t_layers, "transpconv2x2_cm")
    spy(t_adapter, "conv3x3_cm")
    return counts


# ------------------------------------------------------------------ ops


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["raw", "prologue", "relu_no_stats"])
def test_conv3x3_cm_matches_jax(dtype, case):
    from dinounet_tpu.ops.decoder_tail_pallas import conv3x3_cm as jax_conv

    rng = np.random.default_rng(10)
    B, Cin, H, W, Cout = 2, 16, 16, 128, 8
    xj, xt = _both(_rand(rng, (B, Cin, H, W)), dtype)
    k, b = _rand(rng, (3, 3, Cin, Cout), Cin ** -0.5 / 3), _rand(rng, (Cout,), 0.1)
    pj, pt = _prologue(rng, B, Cin) if case != "raw" else (None, None)
    slope = 0.0 if case == "relu_no_stats" else 0.01
    stats = case != "relu_no_stats"
    want = jax_conv(xj, jnp.asarray(k), jnp.asarray(b), prologue=pj, leaky_slope=slope,
                    interpret=True, stats=stats)
    got = t_tail.conv3x3_cm(xt, _conv_t(k), torch.from_numpy(b), prologue=pt,
                            leaky_slope=slope, stats=stats)
    if not stats:
        want, got = (want,), (got,)
    assert got[0].dtype == DTYPES[dtype][1] and got[0].shape == (B, Cout, H, W)
    _close(got[0], want[0], MAP_TOL[dtype])
    for g, w in zip(got[1:], want[1:]):
        _close(g / (H * W), w / (H * W), MEAN_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", [128, 32])  # 32: the JAX wrapper's narrow branch
@pytest.mark.parametrize("with_prologue", [False, True])
def test_transpconv2x2_cm_matches_jax(dtype, width, with_prologue):
    from dinounet_tpu.ops.decoder_tail_pallas import transpconv2x2_cm as jax_tc

    rng = np.random.default_rng(11)
    B, Cin, H, Cout = 2, 16, 16, 8
    xj, xt = _both(_rand(rng, (B, Cin, H, width)), dtype)
    k, b = _rand(rng, (2, 2, Cin, Cout), Cin ** -0.5), _rand(rng, (Cout,), 0.1)
    pj, pt = _prologue(rng, B, Cin) if with_prologue else (None, None)
    want = jax_tc(xj, jnp.asarray(k), jnp.asarray(b), prologue=pj, interpret=True)
    got = t_tail.transpconv2x2_cm(xt, _transp_t(k), torch.from_numpy(b), prologue=pt)
    assert got.shape == (B, Cout, 2 * H, 2 * width) and got.dtype == DTYPES[dtype][1]
    _close(got, want, MAP_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_seg_head_cm_matches_jax(dtype):
    from dinounet_tpu.ops.decoder_tail_pallas import seg_head_cm as jax_seg

    rng = np.random.default_rng(12)
    B, C, H, W, K = 2, 16, 16, 128, 3
    xj, xt = _both(_rand(rng, (B, C, H, W)), dtype)
    w, b = _rand(rng, (C, K), C ** -0.5), _rand(rng, (K,), 0.1)
    pj, pt = _prologue(rng, B, C)
    want = jax_seg(xj, jnp.asarray(w), jnp.asarray(b), pj, interpret=True)
    got = t_tail.seg_head_cm(xt, torch.from_numpy(w.T.copy())[:, :, None, None],
                             torch.from_numpy(b), pt)
    assert got.dtype == torch.float32 and got.shape == (B, K, H, W)
    # fp32 logits of the same bf16-rounded operands: only the sum order differs
    _close(got, want, (1e-4, 1e-4))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("two_inputs", [False, True])
def test_conv3x3_hwbc_matches_jax(dtype, two_inputs):
    from dinounet_tpu.ops.conv_hwbc_pallas import conv3x3_hwbc as jax_hwbc

    rng = np.random.default_rng(13)
    H, W, B, Ci, Co = 8, 128, 8, 16, 8
    ci_total = 2 * Ci if two_inputs else Ci
    xj, xt = _both(_rand(rng, (H, W, B, Ci)), dtype)
    x2j, x2t = _both(_rand(rng, (H, W, B, Ci)), dtype) if two_inputs else (None, None)
    k, b = _rand(rng, (3, 3, ci_total, Co), ci_total ** -0.5 / 3), _rand(rng, (Co,), 0.1)
    pj, pt = _prologue(rng, B, ci_total) if two_inputs else (None, None)
    want = jax_hwbc(xj, jnp.asarray(k), jnp.asarray(b), x2=x2j, prologue=pj,
                    interpret=True)
    got = t_hwbc.conv3x3_hwbc(xt, _conv_t(k), torch.from_numpy(b), x2=x2t, prologue=pt)
    assert got[0].shape == (H, W, B, Co) and got[0].dtype == DTYPES[dtype][1]
    _close(got[0], want[0], MAP_TOL[dtype])
    for g, w in zip(got[1:], want[1:]):
        _close(g / (H * W), w / (H * W), MEAN_TOL[dtype])


def test_instance_norm_params_match_jax():
    from dinounet_tpu.ops.conv_hwbc_pallas import instance_norm_prologue_params
    from dinounet_tpu.ops.decoder_tail_pallas import instance_norm_apply_params

    rng = np.random.default_rng(14)
    y = _rand(rng, (64, 4, 8), 2.0, 0.5)
    ssum, ssq = y.sum(0), (y * y).sum(0)
    g, be = _rand(rng, (8,), 0.2, 1.0), _rand(rng, (8,), 0.1)
    args = [ssum, ssq, 64, g, be]
    got = t_tail.instance_norm_apply_params(
        *[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args])
    for fn in (instance_norm_apply_params, instance_norm_prologue_params):
        want = fn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
        for gt, wt in zip(got, want):
            _close(gt, wt, (1e-6, 1e-5))
    assert t_hwbc.instance_norm_prologue_params is t_tail.instance_norm_apply_params


def _chain_case(rng, dtype):
    """Two stages: lres (2, 32, 8, 64) -> 16 channels at 16 x 128 -> 8 at
    32 x 256, three classes; flax-layout parameters and their torch forms."""
    B, K = 2, 3
    lres = _rand(rng, (B, 32, 8, 64))
    skips = [_rand(rng, (B, 16, 16, 128)), _rand(rng, (B, 8, 32, 256))]
    jax_params, torch_params, jax_seg, torch_seg = [], [], [], []
    for cin, c in ((32, 16), (16, 8)):
        kt, bt = _rand(rng, (2, 2, cin, c), cin ** -0.5), _rand(rng, (c,), 0.1)
        w0, b0 = _rand(rng, (3, 3, 2 * c, c), (18 * c) ** -0.5), _rand(rng, (c,), 0.1)
        w1, b1 = _rand(rng, (3, 3, c, c), (9 * c) ** -0.5), _rand(rng, (c,), 0.1)
        g0, be0, g1, be1 = (_rand(rng, (c,), 0.1, 1.0), _rand(rng, (c,), 0.1),
                            _rand(rng, (c,), 0.1, 1.0), _rand(rng, (c,), 0.1))
        ws, bs = _rand(rng, (c, K), c ** -0.5), _rand(rng, (K,), 0.1)
        flat = (kt, bt, w0, b0, g0, be0, w1, b1, g1, be1)
        jax_params.append(tuple(jnp.asarray(a) for a in flat))
        torch_params.append((_transp_t(kt), torch.from_numpy(bt), _conv_t(w0),
                             *(torch.from_numpy(a) for a in (b0, g0, be0)),
                             _conv_t(w1), *(torch.from_numpy(a) for a in (b1, g1, be1))))
        jax_seg.append((jnp.asarray(ws), jnp.asarray(bs)))
        torch_seg.append((torch.from_numpy(ws.T.copy())[:, :, None, None],
                          torch.from_numpy(bs)))
    lj, lt = _both(lres, dtype)
    sk = [_both(s, dtype) for s in skips]
    return ((lj, [s[0] for s in sk], jax_params, jax_seg),
            (lt, [s[1] for s in sk], torch_params, torch_seg))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("deep_supervision", [False, True])
def test_decoder_chain_cm_matches_jax(dtype, deep_supervision):
    from dinounet_tpu.ops.decoder_tail_pallas import decoder_chain_cm as jax_chain

    jargs, targs = _chain_case(np.random.default_rng(15), dtype)
    want = jax_chain(*jargs, deep_supervision, interpret=True)
    got = t_tail.decoder_chain_cm(*targs, deep_supervision)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        assert g.dtype == torch.float32
        if dtype == "float32":
            _close(g, w, (1e-3, 1e-3))
        else:
            # bf16 ulp flips of y0 / y1 pass through two InstanceNorms and
            # a conv; a wrong rounding point or prologue moves this by >0.05
            assert _rel_l2(g, w) <= 1e-2
    assert deep_supervision or got[0] is None


@pytest.mark.parametrize("dtype", DTYPES)
def test_decoder_tail_cm_matches_jax(dtype):
    """The fused tail over a concatenated input; the second stage of the
    chain case's parameters (16 -> 8 channels at 32 x 256)."""
    from dinounet_tpu.ops.decoder_tail_pallas import decoder_tail_cm as jax_tail

    rng = np.random.default_rng(16)
    jargs, targs = _chain_case(rng, dtype)
    xj, xt = _both(_rand(rng, (2, 16, 32, 256)), dtype)
    want = jax_tail(xj, *jargs[2][1][2:], *jargs[3][1], interpret=True)
    got = t_tail.decoder_tail_cm(xt, *targs[2][1][2:], *targs[3][1])
    assert got.dtype == torch.float32 and got.shape == (2, 3, 32, 256)
    if dtype == "float32":
        _close(got, want, (1e-3, 1e-3))
    else:
        assert _rel_l2(got, want) <= 1e-2  # as the chain's bf16 bound


def test_tail_and_hwbc_eligibility_match_jax():
    from dinounet_tpu.ops import conv_hwbc_pallas as jh
    from dinounet_tpu.ops import decoder_tail_pallas as jt

    for h in (4, 8, 16, 24, 40, 64, 100, 128, 512):
        for rows in (16, 32):
            assert t_tail._pick_stripe(h, rows) == jt._pick_stripe(h, rows)
    for shape in ((8, 64, 512, 512), (8, 64, 128, 128), (8, 64, 100, 512),
                  (8, 64, 512, 96), (2, 8, 64, 64)):
        assert t_tail.tail_supported(shape) == jt.tail_supported(shape)
    for shape in ((8, 128, 128, 128), (8, 256, 256, 64), (8, 512, 512, 32),
                  (8, 512, 96, 32), (6, 256, 256, 32), (8, 512, 512), (8, 1, 128, 8),
                  (16, 640, 640, 32)):
        assert t_hwbc.hwbc_supported(shape) == jh.hwbc_supported(shape)
    for args in ((512, 512, 8, 32), (256, 256, 8, 64), (128, 128, 8, 128), (7, 384, 16, 96)):
        assert t_hwbc._pick_rh(*args) == jh._pick_rh(*args)


# ------------------------------------------------------------------ modules


def _decoder_pair(features, n_classes=3, dtype="bfloat16"):
    from dinounet_tpu.models.decoder import UNetDecoder as JaxDecoder

    n = len(features)
    jdec = JaxDecoder(encoder_channels=list(features), encoder_strides=[(2, 2)] * n,
                      encoder_kernel_sizes=[(3, 3)] * n, num_classes=n_classes,
                      n_conv_per_stage=[2] * (n - 1), deep_supervision=True,
                      dtype=DTYPES[dtype][0])
    tdec = t_decoder.UNetDecoder(features, ((2, 2),) * n, ((3, 3),) * n, n_classes,
                                 (2,) * (n - 1), dtype=DTYPES[dtype][1])
    return jdec, tdec


def _noisy(tree, rng):
    """Every leaf of a flax tree plus seeded noise (no trivial init values)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * _rand(rng, a.shape), tree)


def _load(module, variables, top, prefix):
    sd = state_dict_from_flax({k: {top: v} for k, v in variables.items()})
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def _decoder_case(rng, features, shapes):
    jdec, tdec = _decoder_pair(features)
    skips = [_rand(rng, s) for s in shapes]
    jskips = [jnp.asarray(np.moveaxis(s, 1, -1), jnp.bfloat16) for s in skips]
    tskips = [torch.from_numpy(s).to(torch.bfloat16) for s in skips]
    variables = {"params": _noisy(jdec.init(jax.random.PRNGKey(0), jskips)["params"], rng)}
    _load(tdec, variables, "decoder", "decoder.")
    return jdec, tdec, variables, jskips, tskips


# decoder inputs: three stages whose last two maps the chain takes (W >= 128)
CHAIN_SHAPES = [(2, 8, 32, 256), (2, 16, 16, 128), (2, 32, 8, 64)]
# batch 8 (the HWBC kernel's B % 8 rule), W = 128 at the top stage
HWBC_SHAPES = [(8, 8, 16, 128), (8, 16, 8, 64), (8, 32, 4, 32)]


@pytest.mark.parametrize("route,shapes,calls", [
    ("DINOUNET_TPU_DECODER_TAIL", CHAIN_SHAPES, {"decoder_chain_cm": 1}),
    ("DINOUNET_TPU_DECODER_HWBC", HWBC_SHAPES, {"conv3x3_hwbc": 2}),
])
def test_decoder_route_matches_jax(routes, spies, route, shapes, calls):
    """Every deep-supervision head, the port's route against the JAX
    package's, bf16. Bound 2e-2 relative L2: bf16 ulp flips through
    InstanceNorms and up to three convs; the stock heads below the route
    differ by the packages' own rounding points (7.7e-3 measured)."""
    rng = np.random.default_rng(20)
    jdec, tdec, variables, jskips, tskips = _decoder_case(rng, (8, 16, 32), shapes)
    routes((route,), port=False)
    want = jdec.apply(variables, jskips)
    routes((route,), port=True)
    with torch.inference_mode():
        got = tdec(tskips, deep_supervision=True)
    assert spies == calls
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel_l2(g, np.moveaxis(_np(w), -1, 1)) <= 2e-2


@pytest.mark.parametrize("route,shapes", [("DINOUNET_TPU_DECODER_TAIL", CHAIN_SHAPES),
                                          ("DINOUNET_TPU_DECODER_HWBC", HWBC_SHAPES)])
def test_decoder_train_mode_takes_stock_path(routes, spies, route, shapes):
    rng = np.random.default_rng(21)
    _, tdec, _, _, tskips = _decoder_case(rng, (8, 16, 32), shapes)
    tdec.train()
    with torch.no_grad():
        routes((), port=True)
        want = tdec(tskips)
        routes((route,), port=True)
        got = tdec(tskips)
    assert spies == {}
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_decoder_ineligible_shapes_fall_back(routes, spies):
    """W = 96 (not a multiple of 128): both routes decline, in JAX as here,
    and the output is the stock one, bit for bit."""
    from dinounet_tpu.models.decoder import UNetDecoder as JaxDecoder

    rng = np.random.default_rng(22)
    shapes = [(8, 8, 96, 96), (8, 16, 48, 48)]
    _, tdec, variables, jskips, tskips = _decoder_case(rng, (8, 16), shapes)
    with torch.inference_mode():
        routes((), port=True)
        want = tdec(tskips)
        routes(ROUTE_VARS, port=True)
        got = tdec(tskips)
    assert spies == {}
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    jdec = JaxDecoder(encoder_channels=[8, 16], encoder_strides=[(2, 2)] * 2,
                      encoder_kernel_sizes=[(3, 3)] * 2, num_classes=3,
                      n_conv_per_stage=[2])
    routes(ROUTE_VARS, port=False)
    assert not jdec.bind(variables)._use_fused_chain(1, 2, jskips, False)
    x_t = jnp.zeros((8, 96, 96, 8), jnp.bfloat16)
    assert not jdec.bind(variables)._use_hwbc(1, x_t, x_t, False)


def test_learnable_upsample_route_matches_jax(routes, spies):
    """The doublings 16 -> 32 -> 64 -> 128 (the last one W = 128) through
    transpconv2x2_cm, bf16. Bound: one bf16 rounding per doubling, 3 deep."""
    from dinounet_tpu.models.layers import LearnableUpsample as JaxUp

    rng = np.random.default_rng(23)
    x = _rand(rng, (2, 16, 16, 16))
    xj = jnp.asarray(np.moveaxis(x, 1, -1), jnp.bfloat16)
    mod = JaxUp()
    variables = {"params": _noisy(mod.init(jax.random.PRNGKey(0), xj, (128, 128))["params"],
                                  rng)}
    up = _load(t_layers.LearnableUpsample(16), {"params": {"up0": variables["params"]}},
               "encoder", "encoder.ups.0.")
    routes(("DINOUNET_TPU_DECODER_TAIL",), port=False)
    want = np.moveaxis(_np(mod.apply(variables, xj, (128, 128))), -1, 1)
    routes(("DINOUNET_TPU_DECODER_TAIL",), port=True)
    with torch.inference_mode():
        got = up(torch.from_numpy(x).to(torch.bfloat16), (128, 128))
    assert spies == {"transpconv2x2_cm": 3}
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got, want) <= 1e-2
    up.train()
    with torch.no_grad():
        got_train = up(torch.from_numpy(x).to(torch.bfloat16), (128, 128))
    assert spies == {"transpconv2x2_cm": 3}  # train mode: the stock modules
    routes((), port=True)
    with torch.no_grad():
        torch.testing.assert_close(
            up(torch.from_numpy(x).to(torch.bfloat16), (128, 128)), got_train,
            rtol=0, atol=0)


def _spm_case(rng, hw, dtype):
    from dinounet_tpu.models.adapter import SpatialPriorModule as JaxSPM

    jspm = JaxSPM(inplanes=16, embed_dim=32, dtype=DTYPES[dtype][0])
    x = _rand(rng, (2, 3, hw, hw))
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    init = jspm.init(jax.random.PRNGKey(0), xj)
    variables = {"params": _noisy(init["params"], rng),
                 "batch_stats": jax.tree_util.tree_map(
                     lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(
                         np.float32), init["batch_stats"])}
    tspm = _load(t_adapter.SpatialPriorModule(16, 32, DTYPES[dtype][1]),
                 {k: {"spm": v} for k, v in variables.items()}, "adapter",
                 "encoder.dinov3_adapter.spm.")
    return jspm, tspm, variables, xj, torch.from_numpy(x)


@pytest.mark.parametrize("dtype", DTYPES)
def test_spm_route_matches_jax(routes, spies, dtype):
    """stem2/stem3 at 128 x 128 through conv3x3_cm (BatchNorm running-stats
    applies in the prologue, slope 0), against the JAX route. fp32: 1e-4;
    bf16: relative L2 1e-2 (bf16 ulp flips through four more convs)."""
    rng = np.random.default_rng(24)
    jspm, tspm, variables, xj, xt = _spm_case(rng, 256, dtype)
    routes(("DINOUNET_TPU_SPM_CM",), port=False)
    want = jspm.apply(variables, xj)
    routes(("DINOUNET_TPU_SPM_CM",), port=True)
    with torch.inference_mode():
        got = tspm(xt)
    assert spies == {"conv3x3_cm": 2}
    want = [np.moveaxis(_np(want[0]), -1, 1)] + [_np(w) for w in want[1:]]
    for g, w in zip(got, want):
        if dtype == "float32":
            _close(g, w, (1e-4, 1e-4))
        else:
            assert _rel_l2(g, w) <= 1e-2


def test_spm_train_mode_and_ineligible_shape_take_stock_path(routes, spies):
    rng = np.random.default_rng(25)
    _, tspm, _, _, xt = _spm_case(rng, 256, "float32")
    tspm.train()
    before = tspm.stem[4].running_mean.clone()
    with torch.no_grad():
        routes(("DINOUNET_TPU_SPM_CM",), port=True)
        got = tspm(xt)
        assert not torch.equal(before, tspm.stem[4].running_mean)  # stock BN ran
        routes((), port=True)
        want = tspm(xt)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    tspm.eval()
    x = xt[:, :, :192, :192]  # stem maps of W = 96
    with torch.inference_mode():
        routes(("DINOUNET_TPU_SPM_CM",), port=True)
        got = tspm(x)
        routes((), port=True)
        want = tspm(x)
    assert spies == {}
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ------------------------------------------------------------------ the slice


def _tiny_dinounet(dtype):
    from dinounet_tpu.models.dinounet import DinoUNetConfig
    from dinounet_tpu.models.vit import ViTConfig

    from dinounet_tpu_torch.models.dinounet import DinoUNetConfig as TConfig
    from dinounet_tpu_torch.models.vit import ViTConfig as TViTConfig

    vit = dict(embed_dim=64, depth=4, num_heads=2, ffn_ratio=2, n_storage_tokens=4)
    kw = dict(interaction_indexes=(0, 1, 2, 3), num_classes=3,
              features_per_stage=(16, 32, 64, 128), n_conv_per_stage_decoder=(2, 2, 2),
              conv_bias=True, norm="instancenorm", nonlin="leaky_relu",
              nonlin_kwargs={"negative_slope": 0.01}, fapm_rank=16, conv_inplane=16,
              deform_num_heads=4)
    return (DinoUNetConfig(vit=ViTConfig(**vit, dtype=dtype), dtype=dtype, **kw),
            TConfig(vit=TViTConfig(**vit, dtype=dtype), dtype=dtype, **kw))


@pytest.mark.parametrize("dtype,hw,batch,names,calls,bound", [
    # fp32, 256^2: the chain takes the 128^2 and 256^2 stages, the SPM route
    # its 128^2 stem (the upsample and HWBC routes are bf16-only)
    ("float32", 256, 2, ROUTE_VARS, {"decoder_chain_cm": 1, "conv3x3_cm": 2}, 1e-3),
    # bf16, 128^2, batch 8: the chain takes the top stage, the upsampling its
    # 3 modules' 6 doublings at heights 8..64
    ("bfloat16", 128, 8, ROUTE_VARS, {"decoder_chain_cm": 1, "transpconv2x2_cm": 6}, 5e-2),
    # bf16, batch 8, the HWBC stage alone (the chain off)
    ("bfloat16", 128, 8, ("DINOUNET_TPU_DECODER_HWBC",), {"conv3x3_hwbc": 2}, 5e-2),
])
def test_dinounet_routes_match_jax(routes, spies, dtype, hw, batch, names, calls,
                                   bound):
    """A tiny DinoUNet with the routes on, the port against the JAX package
    with the same variables. fp32: max abs error 1e-3 (relative to the
    logits' max), as tests/test_torch_models.py holds the stock model. bf16:
    relative L2 5e-2 (3.4e-2 measured); the two packages already round at
    different points in
    the stock backbone and adapter (the port's bf16 stock model is held to
    the JAX fp32 logits at 0.15), so this bounds the whole bf16 forward."""
    from dinounet_tpu.models.dinounet import DinoUNet as JaxDinoUNet

    from dinounet_tpu_torch.models.dinounet import DinoUNet

    jcfg, tcfg = _tiny_dinounet(dtype)
    rng = np.random.default_rng(26)
    x = _rand(rng, (batch, 1, hw, hw))
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    jmodel = JaxDinoUNet(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), xj[:1],
                                                train=False))

    def fill(path, leaf):  # as tests/test_torch_models.py fills its variables
        name, noise = jax.tree_util.keystr(path), _rand(rng, leaf.shape)
        if name.endswith("['kernel']"):
            return noise / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        if name.endswith("['var']"):
            return rng.uniform(0.75, 1.25, leaf.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return 1.0 + 0.02 * noise
        if "level_embed" in name:
            return noise
        return (0.1 if name.endswith("['mean']") else 0.02) * noise

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    routes(names, port=False)
    want = np.moveaxis(_np(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, xj)), -1, 1)
    model = DinoUNet(tcfg)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    routes(names, port=True)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert spies == calls
    assert got.shape == (batch, 3, hw, hw) and np.all(np.isfinite(got))
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-3 * max(1.0, np.abs(want).max())
    else:
        assert _rel_l2(got, want) <= bound
