"""The port's dinounet_7b serving path vs the JAX package's, on the CPU.

The 7B's layout at a small width: a SwiGLU ViT of embed 256 and 2 heads (Dh =
128, the 7B's head size; swiglu_align 64, no qkv bias) and, in the DinoUNet,
an adapter with one deformable-attention head of 256 * 0.5 = 128 channels
(the 7B adapter's D). The JAX package runs its unfused SwiGLU blocks with
its plain attention (``DINOUNET_TPU_ATTN_IMPL=jax``: ``vit.py:374`` passes no
``interpret`` to the Pallas kernel #9), and the kernels' own functions in
interpret mode. Variable trees come from ``jax.eval_shape`` of ``init``,
filled from a numpy seed (LayerScale at 0.2-scale noise, so every block's
branches count). Tolerances:

- #9 (``fused_rope_attention``) and #1 at D = 128: fp32 1e-5 (the same fp32
  arithmetic in another order); bf16 the JAX suite's (rtol 0.011 for under
  3 bf16 ulps of an fp32 sum taken in another order; attention atol 2e-3
  for a probability's rounding);
- the SwiGLU ViT in fp32: 1e-4, as ``tests/test_torch_models.py`` holds the
  mlp ViT (40 more fp32 operations a block than one op);
- the tiny 7B-layout DinoUNet in fp32: 1e-3, as the whole dinounet_b model;
- ``QuantDense``: the int8 levels equal, the bf16 output within one ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinounet_tpu_torch.models.convert import state_dict_from_flax
from dinounet_tpu_torch.models.dinounet import DinoUNet as TorchDinoUNet
from dinounet_tpu_torch.models.dinounet import DinoUNetConfig as TorchConfig
from dinounet_tpu_torch.models.vit import DinoViT as TorchDinoViT
from dinounet_tpu_torch.models.vit import ViTConfig as TorchViTConfig
from dinounet_tpu_torch.ops import _build
from dinounet_tpu_torch.ops.attention import (fused_rope_attention, rope_attention_plain,
                                              rope_tables)
from dinounet_tpu_torch.ops.dense_q8 import quant_dense, quantize_act_cm, quantize_weight
from dinounet_tpu_torch.ops.msda_kernel import ms_deform_attn_premapped_fused

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
VIT_KW = dict(embed_dim=256, depth=3, num_heads=2, ffn_ratio=3, ffn_layer="swiglu",
              swiglu_align=64, qkv_bias=False, n_storage_tokens=4)
TAKE = (0, 1, 2)
HW = 64
FEATURES = (8, 16, 32, 64)
CFG_KW = dict(interaction_indexes=(0, 1, 2, 3), num_classes=3,
              features_per_stage=FEATURES, n_conv_per_stage_decoder=(2, 2, 2),
              conv_bias=True, norm="instancenorm", nonlin="leaky_relu",
              nonlin_kwargs={"negative_slope": 0.01}, fapm_rank=16,
              conv_inplane=8, deform_num_heads=1)
BACKBONE = "encoder.dinov3_adapter.backbone."
BF16_ULP = 2.0 ** -7  # relative: one ulp of a bf16 value is at most 2^-7 of it


@pytest.fixture(autouse=True)
def _plain_attention(monkeypatch):
    """The JAX package's plain attention (no interpret flag reaches #9 from
    its model) and no int8 unless a test asks; the CPU runs no kernel."""
    monkeypatch.setenv("DINOUNET_TPU_ATTN_IMPL", "jax")
    monkeypatch.delenv("DINOUNET_TPU_VIT_INT8", raising=False)
    _build.reset_launch_counts()
    yield
    assert all(n == 0 for n in _build.launch_counts().values())


def _pair(a: np.ndarray, dtype: str):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(np.asarray(a, np.float32)).to(tdt), jnp.asarray(a, jdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _nhwc(x):
    return jnp.asarray(np.moveaxis(x, 1, -1))


def _fill(shapes, seed: int):
    """Seeded values for a JAX variable tree: kernels normal with variance
    1 / fan_in, every other leaf its init value plus noise."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if name.endswith("['kernel']"):
            return noise / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        if name.endswith("['var']"):
            return rng.uniform(0.75, 1.25, leaf.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return 1.0 + 0.02 * noise
        if "gamma" in name:
            return 0.2 * noise
        if "level_embed" in name:
            return noise
        return (0.1 if name.endswith("['mean']") else 0.02) * noise

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _rope(N: int, Dh: int, n_prefix: int = 5):
    from dinounet_tpu.models.vit import rope_sincos

    sin, cos = rope_sincos(1, N - n_prefix, Dh)
    sin = np.concatenate([np.zeros((n_prefix, Dh), np.float32), np.asarray(sin)])
    cos = np.concatenate([np.ones((n_prefix, Dh), np.float32), np.asarray(cos)])
    return sin, cos


# ------------------------------------------------------------------ kernel #9

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rope", [True, False])
def test_rowmajor_attention_matches_pallas_interpret(dtype, rope):
    from dinounet_tpu.ops.attention_pallas import fused_rope_attention as jax_attention

    B, N, M, Dh = 2, 37, 2, 128  # a ragged token count, the 7B's head size
    qkv = np.random.default_rng(1).standard_normal((B, N, 3, M, Dh))
    tq, jq = _pair(qkv, dtype)
    if rope:
        sin, cos = _rope(N, Dh)
        got = fused_rope_attention(tq, torch.from_numpy(sin), torch.from_numpy(cos))
        want = jax_attention(jq, jnp.asarray(sin), jnp.asarray(cos), interpret=True)
    else:
        got = fused_rope_attention(tq, None, None)
        want = jax_attention(jq, None, None, interpret=True)
    assert got.dtype == tq.dtype and got.shape == (B, N, M, Dh)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=0.011, atol=2e-3)


def test_rowmajor_attention_grads():
    """The wrapper's backward differentiates the plain version (on the CPU
    its gradient is the plain version's own), which equals JAX's custom VJP
    (the einsum reference's gradient) in fp32."""
    from dinounet_tpu.ops.attention_pallas import fused_rope_attention as jax_attention

    B, N, M, Dh = 1, 21, 2, 128
    qkv = np.random.default_rng(2).standard_normal((B, N, 3, M, Dh)).astype(np.float32)
    cot = np.random.default_rng(3).standard_normal((B, N, M, Dh)).astype(np.float32)
    sin, cos = _rope(N, Dh)
    ts, tc = torch.from_numpy(sin), torch.from_numpy(cos)

    def grad(fn):
        leaf = torch.tensor(qkv, requires_grad=True)
        (fn(leaf) * torch.from_numpy(cot)).sum().backward()
        return leaf.grad

    got = grad(lambda q: fused_rope_attention(q, ts, tc))
    want = grad(lambda q: rope_attention_plain(q, *rope_tables(ts, tc, N, Dh, "cpu")))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    jgrad = jax.grad(lambda q: jnp.sum(jax_attention(q, jnp.asarray(sin), jnp.asarray(cos),
                                                     interpret=True) * cot))(jnp.asarray(qkv))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- #1, D = 128

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_msda_d128_matches_pallas_interpret(dtype):
    from dinounet_tpu.ops.msda_pallas import ms_deform_attn_pallas_premapped_fused

    B, M, D, H, W, P, Lq = 1, 2, 128, 8, 8, 4, 40
    rng = np.random.default_rng(4)
    v = rng.standard_normal((B, M, D, H * W))
    off = rng.uniform(-2.0, 2.0, (B, M, 2 * P, Lq))
    logits = rng.standard_normal((B, M, P, Lq))
    base = np.empty((2 * P, Lq), np.float32)
    base[0::2] = rng.uniform(-1.5, W + 0.5, (Lq,))
    base[1::2] = rng.uniform(-1.5, H + 0.5, (Lq,))
    tv, jv = _pair(v, dtype)
    toff, joff = _pair(off, dtype)
    tlg, jlg = _pair(logits, dtype)
    got = ms_deform_attn_premapped_fused(tv, ((H, W),), toff, tlg, torch.from_numpy(base))
    want = ms_deform_attn_pallas_premapped_fused(jv, ((H, W),), joff, jlg, jnp.asarray(base),
                                                 True, DTYPES[dtype][1])
    assert got.shape == (B, M, D, Lq)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=0.011, atol=1e-5)


# ------------------------------------------------------------ the SwiGLU ViT

def _jax_vit_cfg(**kw):
    from dinounet_tpu.models.vit import ViTConfig

    return ViTConfig(**{**VIT_KW, **kw}, dtype="float32")


@pytest.fixture(scope="module")
def vit_params():
    from dinounet_tpu.models.vit import DinoViT

    x = jnp.zeros((1, HW, HW, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: DinoViT(_jax_vit_cfg()).init(
        jax.random.PRNGKey(0), x, TAKE))
    return _fill(shapes, 0)["params"]


@pytest.fixture(scope="module")
def image3():
    return np.random.default_rng(5).standard_normal((2, 3, HW, HW)).astype(np.float32)


def _port_vit(params, **kw):
    vit = TorchDinoViT(TorchViTConfig(**{**VIT_KW, **kw}, dtype="float32"))
    sd = state_dict_from_flax({"params": {"backbone": params}})
    vit.load_state_dict({k[len(BACKBONE):]: v for k, v in sd.items()}, strict=True)
    return vit.eval()


@pytest.mark.parametrize("scan", ["off", "1"])
def test_swiglu_vit_matches_jax(vit_params, image3, scan, monkeypatch):
    """Both block layouts of the JAX tree (unrolled; scanned, the one the
    7B's 40 blocks take) carry over through the bridge."""
    from dinounet_tpu.models.convert import stack_scan_blocks
    from dinounet_tpu.models.vit import DinoViT

    monkeypatch.setenv("DINOUNET_TPU_VIT_SCAN", scan)
    params = vit_params
    if scan == "1":
        params = stack_scan_blocks(params, VIT_KW["depth"])
        assert "blocks_scan" in params and "block0" not in params
    vit = DinoViT(_jax_vit_cfg())
    want = jax.jit(lambda p, x: vit.apply({"params": p}, x, TAKE))(params, _nhwc(image3))
    with torch.inference_mode():
        got = _port_vit(params)(torch.from_numpy(image3), TAKE)
    assert len(got) == len(want) == len(TAKE)
    for (gp, gc), (wp, wc) in zip(got, want):
        np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-4, atol=1e-4)


def test_swiglu_vit_int8_matches_jax(vit_params, image3, monkeypatch):
    """The int8 serving mode of the SwiGLU ViT: qkv, proj, w1, w2 and w3 as
    QuantDense in both packages. The quantizers agree bit for bit (see
    ``test_quant_dense_matches_jax``), but a level flips where an activation
    that the two frameworks sum in another fp32 order sits on a rounding
    edge, and the next projection spreads the flip over its token's whole
    row (one cls token differs by up to 0.08 in 2e-2 relative L2 at this
    seed; other seeds agree to 1e-6). Held: relative L2 of every output
    <= 0.05, half the JAX suite's int8-vs-bf16 bound
    (tests/test_vit_parity.py); a wrong scale or a transposed weight gives
    O(1)."""
    from dinounet_tpu.models.vit import DinoViT

    monkeypatch.setenv("DINOUNET_TPU_VIT_INT8", "1")
    vit = DinoViT(_jax_vit_cfg())
    want = jax.jit(lambda p, x: vit.apply({"params": p}, x, TAKE))(vit_params,
                                                                   _nhwc(image3))
    with torch.inference_mode():
        got = _port_vit(vit_params)(torch.from_numpy(image3), TAKE)
    for pair_got, pair_want in zip(got, want):
        for g, w in zip(pair_got, pair_want):
            w = np.asarray(w)
            assert np.linalg.norm(g.numpy() - w) <= 0.05 * np.linalg.norm(w)


@pytest.mark.parametrize("bias", [True, False])
def test_quant_dense_matches_jax(bias):
    """The port's QuantDense against the JAX module on bf16 activations: the
    int8 weights and activations (and their scales) equal, the bf16 output
    within one ulp (the fp32 rescale is the same; XLA may fuse it)."""
    from dinounet_tpu.models.vit import QuantDense

    rng = np.random.default_rng(6)
    K, D = 256, 96
    x = jnp.asarray(rng.standard_normal((2, 37, K)), jnp.bfloat16)
    kernel = (rng.standard_normal((K, D)) / np.sqrt(K)).astype(np.float32)
    b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    params = {"kernel": jnp.asarray(kernel)}
    if bias:
        params["bias"] = jnp.asarray(b)
    want = QuantDense(D, use_bias=bias, dtype=jnp.bfloat16).apply({"params": params}, x)

    # JAX's quantization, written out as QuantDense computes it
    w_scale = jnp.maximum(jnp.max(jnp.abs(params["kernel"]), axis=0), 1e-12) / 127.0
    wq = jnp.clip(jnp.round(params["kernel"] / w_scale[None, :]), -127, 127)
    xf = x.astype(jnp.float32)
    a_scale = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-12) / 127.0
    xq = jnp.clip(jnp.round(xf / a_scale), -127, 127)

    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    weight = torch.from_numpy(kernel.T.copy())  # the torch layout (D, K)
    twq, tws = quantize_weight(weight.t())
    txq, ta = quantize_act_cm(tx.transpose(1, 2))
    np.testing.assert_array_equal(twq.numpy(), np.asarray(wq, np.int8))
    np.testing.assert_array_equal(tws.numpy(), np.asarray(w_scale))
    np.testing.assert_array_equal(txq.transpose(1, 2).numpy(), np.asarray(xq, np.int8))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(a_scale))
    got = quant_dense(tx, weight, torch.from_numpy(b) if bias else None, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 37, D)
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_ULP, atol=1e-6)


def test_hold_weights_keeps_the_bf16_results(vit_params, image3):
    """Matrices held in bf16 (the 7B serving form) give the same bf16
    outputs as fp32 weights cast on every use, and only the >= 2-D
    parameters change dtype."""
    sd = state_dict_from_flax({"params": {"backbone": vit_params}})
    sd = {k[len(BACKBONE):]: v for k, v in sd.items()}
    cfg = TorchViTConfig(**VIT_KW, dtype="bfloat16")
    master, held = TorchDinoViT(cfg).eval(), TorchDinoViT(cfg).eval()
    master.load_state_dict(sd)
    held.load_state_dict(sd)
    held.hold_weights_(torch.bfloat16)
    for name, p in held.named_parameters():
        assert p.dtype == (torch.bfloat16 if p.dim() >= 2 else torch.float32), name
    x = torch.from_numpy(image3)
    with torch.inference_mode():
        for (a, ac), (b, bc) in zip(master(x, TAKE), held(x, TAKE)):
            assert torch.equal(a, b) and torch.equal(ac, bc)


# ----------------------------------------------------- the 7B-layout DinoUNet

def test_dinounet_7b_layout_matches_jax_fp32():
    from dinounet_tpu.models.dinounet import DinoUNet, DinoUNetConfig

    kw = dict(VIT_KW, depth=4)
    jcfg = DinoUNetConfig(vit=_jax_vit_cfg(depth=4), dtype="float32", **CFG_KW)
    x = np.random.default_rng(7).standard_normal((2, 1, HW, HW)).astype(np.float32)
    shapes = jax.eval_shape(lambda: DinoUNet(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 1), jnp.float32), train=False))
    variables = _fill(shapes, 1)
    want = jax.jit(lambda v, x: DinoUNet(jcfg).apply(v, x, train=False))(variables,
                                                                         _nhwc(x))
    model = TorchDinoUNet(TorchConfig(vit=TorchViTConfig(**kw, dtype="float32"),
                                      dtype="float32", **CFG_KW))
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    attn = model.encoder.dinov3_adapter.interactions[0].extractor.attn
    assert attn.d_value // attn.n_heads == 128  # the 7B adapter's head width
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x))
    assert got.shape == (2, 3, HW, HW) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want), -1, 1),
                               atol=1e-3, rtol=1e-3)


def test_dinounet_7b_builds_with_the_published_layout():
    """dinounet_7b from a plans architecture dict, built on the meta device
    (no memory): 40 SwiGLU blocks taken at (9, 19, 29, 39), the backbone's
    names and shapes those of the published checkpoint's manifest, and
    16 deformable-attention heads of 128 channels in the adapter."""
    from dinounet_tpu.models.convert import IGNORED_CHECKPOINT_KEYS, checkpoint_manifest

    arch = {"n_stages": 4, "features_per_stage": [32, 64, 128, 256],
            "n_conv_per_stage_decoder": [2, 2, 2], "conv_bias": True,
            "norm_op": "torch.nn.modules.instancenorm.InstanceNorm2d",
            "nonlin": "torch.nn.LeakyReLU"}
    cfg = TorchConfig.from_plans_arch(arch, 3, model_name="dinounet_7b")
    with torch.device("meta"):
        model = TorchDinoUNet(cfg)
    adapter = model.encoder.dinov3_adapter
    assert adapter.interaction_indexes == (9, 19, 29, 39)
    assert len(adapter.backbone.blocks) == 40
    got = {k: list(v.shape) for k, v in adapter.backbone.state_dict().items()}
    want = {k: v for k, v in checkpoint_manifest("dinov3_vit7b16").items()
            if k not in IGNORED_CHECKPOINT_KEYS}
    assert got == want
    attn = adapter.interactions[0].extractor.attn
    assert (attn.n_heads, attn.d_value // attn.n_heads) == (16, 128)
    n = sum(p.numel() for p in adapter.backbone.parameters())
    assert 6.7e9 < n < 6.8e9, n


def test_random_on_draws_init_weights_rounded():
    """``DinoUNet.random_on`` (the serving build: matrices of the backbone in
    the compute dtype) draws what ``init_weights`` draws on that device,
    the backbone's matrices rounded once to bf16."""
    cfg = TorchConfig(vit=TorchViTConfig(**dict(VIT_KW, depth=4)), **CFG_KW)
    held = TorchDinoUNet.random_on(cfg, "cpu", seed=3)
    ref = TorchDinoUNet(cfg).init_weights(seed=3)
    want = ref.state_dict()
    for name, t in held.state_dict().items():
        if name.startswith(BACKBONE) and t.dim() >= 2:
            assert t.dtype == torch.bfloat16, name
            assert torch.equal(t, want[name].to(torch.bfloat16)), name
        else:
            assert torch.equal(t, want[name]), name
