"""The port's MSDA routes vs the JAX package's, on the CPU.

The sampling with the prep done outside (``ms_deform_attn_premapped``, TPU
kernel ``_fwd_kernel``), the reference-layout entry (``ms_deform_attn``), the
merged-projection entry (``ms_deform_attn_premapped_fused_merged``, TPU
kernel ``_fwd_kernel_fused_merged``), and ``MSDeformAttn`` and a train step
of a tiny DinoUNet under ``DINOUNET_TPU_MSDA_PREP=xla`` and
``DINOUNET_TPU_MSDA_MERGED_PROJ=1``. The port's wrappers run their plain
versions here (CPU tensors); the JAX side runs its Pallas kernels in
interpret mode, as tests/test_msda.py runs them. Inputs come from numpy
seeds, with points off every edge of the maps and ragged query counts.

Tolerances: fp32, 1e-5 on outputs (the same fp32 arithmetic in another
order) and 1e-4 on gradients (tests/test_msda.py's own: sums of a few
hundred corner terms); bf16, rtol 0.011 (under 3 bf16 ulps: an fp32 sum
taken in another order can round to a neighbouring bf16 value) with atol
1e-5 on outputs and 1e-3 on gradients (entries that cancel to near zero);
the modules and the train step as stated beside them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dinounet_tpu_torch.models.adapter as t_adapter
from dinounet_tpu_torch.models.convert import state_dict_from_flax
from dinounet_tpu_torch.ops import _build
from dinounet_tpu_torch.ops.msda import ms_deform_attn_core_plain
from dinounet_tpu_torch.ops.msda_kernel import (ms_deform_attn, ms_deform_attn_premapped,
                                                ms_deform_attn_premapped_fused_merged)
from tests.test_torch_dense_q8 import _filled, _load
from tests.test_torch_models import CFG_KW, HW, N_CLASSES, VIT_KW, variables  # noqa: F401
from tests.test_torch_ops import DTYPES, _msda_inputs, _pair

ROUTE_VARS = ("DINOUNET_TPU_MSDA_PREP", "DINOUNET_TPU_MSDA_MERGED_PROJ")
ROUTES = {"fused": ("fused", "0"), "merged": ("fused", "1"), "xla": ("xla", "0")}


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    """CPU calls run the plain versions and never count a kernel launch."""
    _build.reset_launch_counts()
    yield
    assert all(n == 0 for n in _build.launch_counts().values())


@pytest.fixture
def jax_premapped(monkeypatch):
    """The JAX adapter on its premapped path with every premapped kernel in
    interpret mode (its adapter passes interpret=False as a literal)."""
    from dinounet_tpu.ops import msda_pallas

    fwd = msda_pallas._forward_premapped
    fused = msda_pallas._forward_premapped_fused
    merged = msda_pallas._forward_premapped_fused_merged
    bwd = msda_pallas._backward_premapped
    monkeypatch.setattr(msda_pallas, "_forward_premapped",
                        lambda v, s, xs, ys, aw, interp=False, out_dtype=jnp.float32:
                        fwd(v, s, xs, ys, aw, True, out_dtype))
    monkeypatch.setattr(msda_pallas, "_forward_premapped_fused",
                        lambda v, s, off, lg, base, interp=False, out_dtype=jnp.float32:
                        fused(v, s, off, lg, base, True, out_dtype))
    monkeypatch.setattr(msda_pallas, "_forward_premapped_fused_merged",
                        lambda v, s, packed, base, interp=False, out_dtype=jnp.float32:
                        merged(v, s, packed, base, True, out_dtype))
    monkeypatch.setattr(msda_pallas, "_backward_premapped",
                        lambda v, s, xs, ys, aw, g, interp=False:
                        bwd(v, s, xs, ys, aw, g, True))
    monkeypatch.setenv("DINOUNET_TPU_MSDA_IMPL", "pallas")

    def set_route(route):
        for var, value in zip(ROUTE_VARS, ROUTES[route]):
            monkeypatch.setenv(var, value)
    return set_route


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _prepped(rng, B, M, D, Lq, shapes, P):
    """value (B, M, D, S) and fp32 pixel coordinates past every edge of
    their level, softmaxed weights (B, M, L*P, Lq)."""
    L, S = len(shapes), sum(h * w for h, w in shapes)
    v = rng.standard_normal((B, M, D, S))
    xs = np.concatenate([rng.uniform(-2.5, w + 1.5, (B, M, P, Lq)) for h, w in shapes], 2)
    ys = np.concatenate([rng.uniform(-2.5, h + 1.5, (B, M, P, Lq)) for h, w in shapes], 2)
    logits = rng.standard_normal((B, M, L * P, Lq))
    aw = np.exp(logits) / np.exp(logits).sum(2, keepdims=True)
    return v, xs.astype(np.float32), ys.astype(np.float32), aw.astype(np.float32)


def _check(got, want, dtype, grad=False):
    if dtype == "float32":
        tol = 1e-4 if grad else 1e-5
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=0.011,
                                   atol=1e-3 if grad else 1e-5)


SHAPES = [(128, ((8, 16),)),          # one level
          (37, ((8, 16),)),           # ragged
          (37, ((8, 16), (4, 8)))]    # two levels, ragged


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lq,shapes", SHAPES)
def test_premapped_matches_pallas_interpret(dtype, Lq, shapes):
    """#5's plain version vs ``_forward_premapped`` (the JAX kernel pads the
    query axis with off-map coordinates; the port masks it)."""
    from dinounet_tpu.ops.msda_pallas import _forward_premapped

    v, xs, ys, aw = _prepped(np.random.default_rng(30), 2, 3, 8, Lq, shapes, 2)
    tv, jv = _pair(v, dtype)
    got = ms_deform_attn_premapped(tv, shapes, *(torch.from_numpy(a) for a in (xs, ys, aw)))
    want = _forward_premapped(jv, shapes, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(aw),
                              True, DTYPES[dtype][1])
    assert got.dtype == tv.dtype and got.shape == (2, 3, 8, Lq)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lq,shapes", SHAPES)
def test_premapped_grads_match_jax_custom_vjp(dtype, Lq, shapes):
    """The premapped entry's backward (#7 called directly) vs ``jax.grad``
    of ``ms_deform_attn_pallas_premapped``."""
    from dinounet_tpu.ops.msda_pallas import ms_deform_attn_pallas_premapped

    v, xs, ys, aw = _prepped(np.random.default_rng(31), 1, 2, 4, Lq, shapes, 2)
    tv, jv = _pair(v, dtype)
    jdt = DTYPES[dtype][1]

    def f(v_, xs_, ys_, aw_):
        out = ms_deform_attn_pallas_premapped(v_, shapes, xs_, ys_, aw_, True, jdt)
        return (out.astype(jnp.float32) ** 2).sum()

    want = jax.grad(f, argnums=(0, 1, 2, 3))(jv, *(jnp.asarray(a) for a in (xs, ys, aw)))
    leaves = [tv.requires_grad_(True)] + [torch.from_numpy(a).requires_grad_(True)
                                          for a in (xs, ys, aw)]
    out = ms_deform_attn_premapped(leaves[0], shapes, *leaves[1:])
    got = torch.autograd.grad((out.float() ** 2).sum(), leaves)
    assert got[0].dtype == tv.dtype and got[1].dtype == torch.float32
    for name, a, b in zip(("value", "xs", "ys", "aw"), got, want):
        _check(a, b, dtype if name == "value" else "float32", grad=True)


def _reference_inputs(rng, B, Lq, M, D, shapes, P):
    """value (B, S, M, D), normalized locations (B, Lq, M, L, P, 2) a little
    past [0, 1], weights (B, Lq, M, L, P) softmaxed over L*P."""
    L, S = len(shapes), sum(h * w for h, w in shapes)
    value = rng.standard_normal((B, S, M, D)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (B, Lq, M, L, P, 2)).astype(np.float32)
    logits = rng.standard_normal((B, Lq, M, L * P))
    attn = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).reshape(B, Lq, M, L, P)
    return value, loc, attn.astype(np.float32)


@pytest.mark.parametrize("Lq,shapes", SHAPES)
def test_reference_layout_matches_jax(Lq, shapes):
    """``ms_deform_attn`` (the premapped entry behind the layout prep) and
    ``ms_deform_attn_core_plain`` vs ``ms_deform_attn_pallas`` (interpret)
    and ``ms_deform_attn_core``, fp32: forward and ``jax.grad``."""
    from dinounet_tpu.ops.msda import ms_deform_attn_core
    from dinounet_tpu.ops.msda_pallas import ms_deform_attn_pallas

    value, loc, attn = _reference_inputs(np.random.default_rng(32), 2, Lq, 3, 8, shapes, 2)
    jargs = [jnp.asarray(a) for a in (value, loc, attn)]
    want = ms_deform_attn_pallas(jargs[0], shapes, *jargs[1:], True)
    np.testing.assert_allclose(_np(ms_deform_attn_core(jargs[0], shapes, *jargs[1:])),
                               _np(want), rtol=1e-5, atol=1e-5)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (value, loc, attn)]
    got = ms_deform_attn(leaves[0], shapes, *leaves[1:])
    assert got.shape == (2, Lq, 24) and got.dtype == torch.float32
    _check(got, want, "float32")
    _check(ms_deform_attn_core_plain(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                                     torch.from_numpy(attn)), want, "float32")

    proj = np.random.default_rng(33).standard_normal(want.shape).astype(np.float32)
    g_want = jax.grad(lambda *a: (ms_deform_attn_pallas(a[0], shapes, *a[1:], True)
                                  * proj).sum(), argnums=(0, 1, 2))(*jargs)
    g_got = torch.autograd.grad((got * torch.from_numpy(proj)).sum(), leaves)
    for name, a, b in zip(("value", "loc", "attn"), g_got, g_want):
        assert a.shape == b.shape, name
        _check(a, b, "float32", grad=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lq,shapes", [(128, ((8, 16),)), (37, ((6, 8),))])
def test_merged_matches_jax(dtype, Lq, shapes):
    """The merged entry vs ``ms_deform_attn_pallas_premapped_fused_merged``
    (interpret): forward and ``jax.grad``, the packed gradient one tensor."""
    from dinounet_tpu.ops.msda_pallas import ms_deform_attn_pallas_premapped_fused_merged

    v, off, logits, base = _msda_inputs(np.random.default_rng(34), 2, 3, 8, Lq, shapes, 2)
    packed = np.concatenate([off, logits], axis=2)
    tv, jv = _pair(v, dtype)
    tp, jp = _pair(packed, dtype)
    jdt = DTYPES[dtype][1]
    jbase = jnp.asarray(base)
    want = ms_deform_attn_pallas_premapped_fused_merged(jv, shapes, jp, jbase, True, jdt)
    leaves = [tv.requires_grad_(True), tp.requires_grad_(True)]
    got = ms_deform_attn_premapped_fused_merged(leaves[0], shapes, leaves[1],
                                                torch.from_numpy(base))
    assert got.dtype == tv.dtype and got.shape == (2, 3, 8, Lq)
    _check(got, want, dtype)

    g_want = jax.grad(lambda v_, p_: (ms_deform_attn_pallas_premapped_fused_merged(
        v_, shapes, p_, jbase, True, jdt).astype(jnp.float32) ** 2).sum(),
        argnums=(0, 1))(jv, jp)
    g_got = torch.autograd.grad((got.float() ** 2).sum(), leaves)
    for a, b in zip(g_got, g_want):
        assert a.dtype == tv.dtype and a.shape == b.shape
        _check(a, b, dtype, grad=True)


# ---------------------------------------------------------------- modules


def _attn_case(dtype, residual):
    """tests/test_msda.py's MSDeformAttn setup (21 queries around an 4x4 +
    2x2 + 1x1 reference grid, a 4x4 value grid, 4 heads, 2 points): numpy
    inputs and a filled JAX variable tree."""
    from dinounet_tpu.models.adapter import MSDeformAttn, reference_points_for_grids

    rng = np.random.default_rng(35)
    B, Lq, E = 2, 21, 32
    q, tokens, res = (rng.standard_normal(s).astype(np.float32)
                      for s in ((B, Lq, E), (B, 16, E), (B, Lq, E)))
    ref = np.asarray(reference_points_for_grids([(4, 4), (2, 2), (1, 1)]), np.float32)
    jmod = MSDeformAttn(d_model=E, n_heads=4, n_points=2, ratio=0.5,
                        dtype=DTYPES[dtype][1])
    jq, jt, jr = (_pair(a, dtype)[1] for a in (q, tokens, res))
    kw = {"residual": jr} if residual else {}
    params = _filled(lambda: jmod.init(jax.random.PRNGKey(0), jq, jnp.asarray(ref), jt,
                                       [(4, 4)], **kw), rng)["params"]
    return jmod, params, (q, tokens, res, ref)


@pytest.fixture
def msda_spies(monkeypatch):
    """Count the adapter's calls of the three MSDA entries (on the CPU no
    kernel launches)."""
    counts = {}
    for name in ("ms_deform_attn_premapped_fused", "ms_deform_attn_premapped_fused_merged",
                 "ms_deform_attn_premapped"):
        fn = getattr(t_adapter, name)

        def counted(*args, _fn=fn, _name=name):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(t_adapter, name, counted)
    return counts


ENTRY = {"fused": "ms_deform_attn_premapped_fused",
         "merged": "ms_deform_attn_premapped_fused_merged",
         "xla": "ms_deform_attn_premapped"}


@pytest.mark.parametrize("route", ["fused", "merged", "xla"])
def test_msdeformattn_route_matches_jax(jax_premapped, msda_spies, route):
    """MSDeformAttn (the train path's plain output projection) in fp32 with
    the route on in both packages, the same variables carried over by
    ``state_dict_from_flax``: outputs to 2e-5 (tests/test_msda.py's bound
    between its two branches), every parameter's gradient of a fixed
    projection of the output to 1e-4 of its tensor's largest entry. The
    route's entry is the one called; the parameter tree is the same on every
    route (the merged projection interleaves the two existing weights)."""
    jax_premapped(route)
    jmod, params, (q, tokens, _, ref) = _attn_case("float32", residual=False)
    jax_premapped("fused")
    fused_tree = jax.tree_util.tree_structure(
        _filled(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(ref),
                                  jnp.asarray(tokens), [(4, 4)]), np.random.default_rng(0)))
    jax_premapped(route)
    assert jax.tree_util.tree_structure({"params": params}) == fused_tree
    tmod = _load(t_adapter.MSDeformAttn(32, 1, 4, 2, 0.5, torch.float32), params, "adapter",
                 ("interaction0", "extractor", "attn"),
                 "encoder.dinov3_adapter.interactions.0.extractor.attn.")
    proj = np.random.default_rng(36).standard_normal((2, 21, 32)).astype(np.float32)
    jargs = (jnp.asarray(q), jnp.asarray(ref), jnp.asarray(tokens), [(4, 4)])

    def loss(p):
        out = jmod.apply({"params": p}, *jargs)
        return (out * proj).sum(), out

    (_, want), g_want = jax.value_and_grad(loss, has_aux=True)(params)
    got = tmod(torch.from_numpy(q), torch.from_numpy(ref), torch.from_numpy(tokens),
               [(4, 4)])
    assert msda_spies == {ENTRY[route]: 1}
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    (got * torch.from_numpy(proj)).sum().backward()
    g_want = state_dict_from_flax({"params": {"adapter": {"interaction0": {
        "extractor": {"attn": g_want}}}}})
    prefix = "encoder.dinov3_adapter.interactions.0.extractor.attn."
    for name, p in tmod.named_parameters():
        want_g = g_want[prefix + name].numpy()
        scale = max(float(np.abs(want_g).max()), 1e-6)
        assert float(np.abs(p.grad.numpy() - want_g).max()) <= 1e-4 * scale, name


@pytest.mark.parametrize("route", ["merged", "xla"])
def test_msdeformattn_route_bf16_eval_matches_jax(jax_premapped, msda_spies, monkeypatch,
                                                  route):
    """The eval path (the fused channel-major output projection with the
    residual and statistics) in bf16 under the route, both packages (JAX:
    its dense kernel in interpret mode): the bounds of the bf16 adapter
    tests (tests/test_torch_dense_q8.py::_adapter_check): out 0.05, mean
    5e-3, var 1e-2."""
    monkeypatch.setenv("DINOUNET_TPU_DENSE_IMPL", "interpret")
    jax_premapped(route)
    jmod, params, (q, tokens, res, ref) = _attn_case("bfloat16", residual=True)
    tmod = _load(t_adapter.MSDeformAttn(32, 1, 4, 2, 0.5, torch.bfloat16), params,
                 "adapter", ("interaction0", "extractor", "attn"),
                 "encoder.dinov3_adapter.interactions.0.extractor.attn.")
    (tq, jq), (tt, jt), (tr, jr) = (_pair(a, "bfloat16") for a in (q, tokens, res))
    want = jmod.apply({"params": params}, jq, jnp.asarray(ref), jt, [(4, 4)], residual=jr)
    with torch.inference_mode():
        got = tmod(tq, torch.from_numpy(ref), tt, [(4, 4)], tr)
    assert msda_spies == {ENTRY[route]: 1}
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), atol=0.05, rtol=0.05)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), atol=5e-3)
    np.testing.assert_allclose(_np(got[2]), _np(want[2]), atol=1e-2)


def test_train_step_under_xla_prep_matches_jax(variables, jax_premapped,  # noqa: F811
                                               msda_spies, monkeypatch):
    """One train-mode step of the tiny DinoUNet of tests/test_torch_models.py
    (fp32, drop-path 0, checkpointed adapter, batch 2) with
    DINOUNET_TPU_MSDA_PREP=xla in both packages: the loss to 1e-5 and every
    trainable gradient to 2e-3 of its tensor's largest entry, floored at
    1e-4 of the model's largest gradient, as tests/test_torch_training.py
    holds the default route's step. The 6 extractors call the premapped
    entry twice each (forward and recompute). (The merged route's gradients
    are held at the module above.)"""
    route = "xla"
    from dinounet_tpu.models.dinounet import DinoUNet, DinoUNetConfig
    from dinounet_tpu.models.vit import ViTConfig
    from dinounet_tpu.training.losses import dc_and_ce_loss as jax_loss

    from dinounet_tpu_torch.models.dinounet import DinoUNet as TorchDinoUNet
    from dinounet_tpu_torch.models.dinounet import DinoUNetConfig as TorchConfig
    from dinounet_tpu_torch.models.vit import ViTConfig as TorchViTConfig
    from dinounet_tpu_torch.training.losses import dc_and_ce_loss

    jax_premapped(route)
    # the JAX backbone and junctions on their plain paths (their Pallas
    # kernels would follow the MSDA switch), as the default step's test runs
    monkeypatch.setenv("DINOUNET_TPU_ATTN_IMPL", "jax")
    monkeypatch.setenv("DINOUNET_TPU_DENSE_IMPL", "jax")
    rng = np.random.default_rng(37)
    image = rng.standard_normal((2, 1, HW, HW)).astype(np.float32)
    target = rng.integers(0, N_CLASSES, (2, HW, HW))
    kw = dict(batch_dice=True, smooth=1e-5, do_bg=False, ignore_label=None)
    jmodel = DinoUNet(DinoUNetConfig(vit=ViTConfig(**VIT_KW, dtype="float32"),
                                     dtype="float32", drop_path_rate=0.0, **CFG_KW))

    def loss_of(p):
        out, _ = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(np.moveaxis(image, 1, -1)), train=True,
                              mutable=["batch_stats"])
        return jax_loss(out, jnp.asarray(target), **kw)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_of))(variables["params"])

    cfg = TorchConfig(vit=TorchViTConfig(**VIT_KW, dtype="float32"), dtype="float32",
                      drop_path_rate=0.0, **CFG_KW)
    model = TorchDinoUNet(cfg)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    model.train()
    loss = dc_and_ce_loss(model(torch.from_numpy(image)), torch.from_numpy(target), **kw)
    loss.backward()
    assert msda_spies == {ENTRY[route]: 12}
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    grads = state_dict_from_flax({"params": want_grads})
    floor = 1e-4 * max(float(g.abs().max()) for g in grads.values())
    worst = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        want = grads[name].numpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        worst[name] = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), floor)
    assert len(worst) > 100
    assert max(worst.values()) <= 2e-3, sorted(worst.items(), key=lambda kv: -kv[1])[:5]
