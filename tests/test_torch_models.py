"""The port's models vs the JAX package's, on the CPU, with the same weights.

One small DinoUNet (embed 64, depth 4, 2 heads, a 64 x 64 input, decoder
features (8, 16, 32, 64), FAPM rank 16) gets its variable tree from the JAX
model's init, filled with seeded random values so no parameter keeps a
trivial init, and is carried into the port through ``state_dict_from_flax``. Each part (ViT, adapter,
FAPM + decoder) and the whole model then run on the same numpy inputs in both
packages, in fp32 as tests/test_full_model_parity.py runs the JAX model:
1e-3 for the whole model, tighter for the parts. The bridge's names are
checked by a round trip through the JAX package's own torch -> flax
converters, which read the reference torch names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinounet_tpu_torch.models.convert import state_dict_from_flax
from dinounet_tpu_torch.models.dinounet import DinoUNet as TorchDinoUNet
from dinounet_tpu_torch.models.dinounet import DinoUNetConfig as TorchConfig
from dinounet_tpu_torch.models.vit import ViTConfig as TorchViTConfig

FEATURES = (8, 16, 32, 64)
RANK = 16
N_CLASSES = 3
HW = 64
CFG_KW = dict(interaction_indexes=(0, 1, 2, 3), num_classes=N_CLASSES,
              features_per_stage=FEATURES, n_conv_per_stage_decoder=(2, 2, 2),
              conv_bias=True, norm="instancenorm", nonlin="leaky_relu",
              nonlin_kwargs={"negative_slope": 0.01}, fapm_rank=RANK,
              conv_inplane=8, deform_num_heads=4)
VIT_KW = dict(embed_dim=64, depth=4, num_heads=2, ffn_ratio=2, n_storage_tokens=4)


def _jax_config(dtype="float32"):
    from dinounet_tpu.models.dinounet import DinoUNetConfig
    from dinounet_tpu.models.vit import ViTConfig

    return DinoUNetConfig(vit=ViTConfig(**VIT_KW, dtype=dtype), dtype=dtype,
                          **CFG_KW)


def _torch_model(variables, dtype="float32"):
    cfg = TorchConfig(vit=TorchViTConfig(**VIT_KW, dtype=dtype), dtype=dtype,
                      **CFG_KW)
    model = TorchDinoUNet(cfg)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def variables():
    """The JAX DinoUNet's variable tree (structure and shapes from its own
    init, traced abstractly), filled from a numpy seed: kernels normal with
    variance 1/fan_in, every other leaf its init value plus noise, so no
    parameter keeps a trivial value (zero offset kernels, LayerScale 1e-5)."""
    from dinounet_tpu.models.dinounet import DinoUNet

    x = jnp.zeros((1, HW, HW, 1), jnp.float32)
    shapes = jax.eval_shape(
        lambda: DinoUNet(_jax_config()).init(jax.random.PRNGKey(0), x, train=False))
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        noise = rng.standard_normal(shape).astype(np.float32)
        if name.endswith("['kernel']"):
            return noise / np.float32(np.sqrt(np.prod(shape[:-1])))
        if name.endswith("['var']"):  # running variances stay positive
            return rng.uniform(0.75, 1.25, shape).astype(np.float32)
        if name.endswith("['scale']"):
            return 1.0 + 0.02 * noise
        if "level_embed" in name:
            return noise
        return (0.1 if name.endswith("['mean']") else 0.02) * noise

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(1).standard_normal((2, 1, HW, HW)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_vit_outputs(variables, image):
    from dinounet_tpu.models.vit import DinoViT

    vit = DinoViT(_jax_config().vit)
    return jax.jit(lambda v, x: vit.apply(v, x, (0, 1, 2, 3)))(
        {"params": variables["params"]["backbone"]},
        _nhwc(np.repeat(image, 3, axis=1)))


@pytest.fixture(scope="module")
def jax_logits(variables, image):
    from dinounet_tpu.models.dinounet import DinoUNet

    model = DinoUNet(_jax_config())
    return _nchw(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, _nhwc(image)))


def _nhwc(x):
    return jnp.asarray(np.moveaxis(x, 1, -1))


def _nchw(a):
    return np.moveaxis(np.asarray(a, np.float32), -1, 1)


def test_state_dict_names_match_port_model(variables):
    """The bridge emits exactly the port model's parameters and buffers."""
    sd = state_dict_from_flax(variables)
    model_sd = TorchDinoUNet(TorchConfig(vit=TorchViTConfig(**VIT_KW),
                                         **CFG_KW)).state_dict()
    assert sorted(sd) == sorted(model_sd)
    for k, v in model_sd.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


def test_bridge_round_trip_through_reference_converters(variables):
    """flax -> port names -> the JAX package's torch->flax converters ->
    the same flax tree, bit for bit: the port's names are the reference's."""
    from dinounet_tpu.models.convert import convert_dinov3_state_dict
    from tests.test_adapter_parity import convert_adapter_state_dict
    from tests.test_full_model_parity import (convert_decoder_state_dict,
                                              convert_fapm_encoder_state_dict)

    sd = {k: v.numpy() for k, v in state_dict_from_flax(variables).items()}

    def sub(prefix, exclude=None):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix) and not (exclude and k.startswith(exclude))}

    adapter_p, adapter_s = convert_adapter_state_dict(
        sub("encoder.dinov3_adapter.", "encoder.dinov3_adapter.backbone."))
    back = {
        "params": {
            "backbone": convert_dinov3_state_dict(
                sub("encoder.dinov3_adapter.backbone."),
                _jax_config().vit, strict=True),
            "adapter": adapter_p,
            "encoder": convert_fapm_encoder_state_dict(sub("encoder."), len(FEATURES)),
            "decoder": convert_decoder_state_dict(sub("decoder."), len(FEATURES),
                                                  [2, 2, 2]),
        },
        "batch_stats": {"adapter": adapter_s},
    }
    want = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_vit_matches_jax(variables, image, jax_vit_outputs):
    x3 = np.repeat(image, 3, axis=1)
    want = jax_vit_outputs
    model = _torch_model(variables)
    with torch.inference_mode():
        got = model.encoder.dinov3_adapter.backbone(torch.from_numpy(x3),
                                                    (0, 1, 2, 3))
    assert len(got) == len(want) == 4
    for (gp, gc), (wp, wc) in zip(got, want):
        np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-4, atol=1e-4)


def test_adapter_matches_jax(variables, image, jax_vit_outputs):
    from dinounet_tpu.models.adapter import DINOv3Adapter

    x3 = np.repeat(image, 3, axis=1)
    vit_out = jax_vit_outputs
    adapter = DINOv3Adapter(embed_dim=64, conv_inplane=8, n_points=4,
                            deform_num_heads=4, dtype=jnp.float32)
    want = jax.jit(lambda v, x, outs: adapter.apply(v, x, outs, train=False))(
        {"params": variables["params"]["adapter"],
         "batch_stats": variables["batch_stats"]["adapter"]},
        _nhwc(x3), vit_out)
    with torch.inference_mode():
        got = _torch_model(variables).encoder.dinov3_adapter(torch.from_numpy(x3))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), _nchw(w), rtol=5e-4, atol=5e-4)


def test_fapm_and_decoder_match_jax(variables):
    """FAPM + learnable upsampling + decoder on the same adapter-shaped maps,
    every deep-supervision head (the top one is the inference output)."""
    from dinounet_tpu.models.decoder import UNetDecoder
    from dinounet_tpu.models.fapm import FAPMEncoder

    rng = np.random.default_rng(2)
    feats = [rng.standard_normal((2, 64, HW // s, HW // s)).astype(np.float32)
             for s in (4, 8, 16, 32)]
    encoder = FAPMEncoder(target_channels=FEATURES,
                          nonlin_kwargs={"negative_slope": 0.01}, conv_bias=True,
                          rank=RANK, dtype=jnp.float32)
    decoder = UNetDecoder(encoder_channels=FEATURES, encoder_strides=((2, 2),) * 4,
                          encoder_kernel_sizes=((3, 3),) * 4, num_classes=N_CLASSES,
                          n_conv_per_stage=(2, 2, 2), deep_supervision=True,
                          conv_bias=True, dtype=jnp.float32)

    @jax.jit
    def jax_fwd(params, feats):
        skips = encoder.apply({"params": params["encoder"]}, feats, (HW, HW))
        return skips, decoder.apply({"params": params["decoder"]}, skips)

    skips, want = jax_fwd(variables["params"], [_nhwc(f) for f in feats])
    model = _torch_model(variables)
    with torch.inference_mode():
        t_skips = model.encoder.skips_from_features(
            [torch.from_numpy(f) for f in feats], (HW, HW))
        got = model.decoder(t_skips, deep_supervision=True)
        top = model.decoder(t_skips)
    for g, w in zip(t_skips, skips):
        np.testing.assert_allclose(g.numpy(), _nchw(w), rtol=1e-4, atol=1e-4)
    assert len(got) == len(want) == 3
    torch.testing.assert_close(top, got[0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _nchw(w), rtol=1e-4, atol=1e-4)


def test_dinounet_matches_jax_fp32(variables, image, jax_logits):
    with torch.inference_mode():
        got = _torch_model(variables)(torch.from_numpy(image))
    assert got.shape == (2, N_CLASSES, HW, HW) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_logits, atol=1e-3, rtol=1e-3)


def test_dinounet_bf16_close_to_jax_fp32(variables, image, jax_logits):
    """The port in bf16 (the serving dtype) against the fp32 JAX logits,
    within the JAX suite's bf16 model bound (tests/test_vit_parity.py:
    relative error 0.15), as the relative L2 error of the logits."""
    with torch.inference_mode():
        got = _torch_model(variables, "bfloat16")(torch.from_numpy(image)).numpy()
    rel = np.linalg.norm(got - jax_logits) / np.linalg.norm(jax_logits)
    assert rel <= 0.15, rel


@pytest.mark.parametrize("train", [True, False])
def test_seg_head_matches_jax_bf16(train):
    """SegHead on bf16 features: in train mode an fp32 product of the
    bf16-rounded operands (JAX dot_general with an fp32 result), in eval mode
    the logits rounded through bf16 once (JAX's default "convbf" form). Both
    within 1e-5 of the JAX head; train mode differed by 7.8e-3 while the port
    rounded there too."""
    from dinounet_tpu.models.decoder import SegHead as JaxSegHead

    from dinounet_tpu_torch.models.decoder import SegHead

    x = np.random.default_rng(3).standard_normal((2, 16, 16, 32)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    head = JaxSegHead(3, rank=2)
    variables = head.init(jax.random.PRNGKey(0), xj)
    bias = np.random.default_rng(4).standard_normal(3).astype(np.float32)
    variables = {"params": {"kernel": variables["params"]["kernel"],
                            "bias": jnp.asarray(bias)}}
    want = np.moveaxis(np.asarray(head.apply(variables, xj, prefer_reduce=not train)),
                       -1, 1)
    port = SegHead(32, 3, torch.bfloat16)
    sd = state_dict_from_flax({"params": {"decoder": {"seg0": variables["params"]}}})
    port.load_state_dict({k[len("decoder.seg_layers.0."):]: v for k, v in sd.items()})
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(np.moveaxis(x, -1, 1)).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_fresh_model_draws_the_jax_initializers():
    """A fresh port model is initialised as the flax modules are."""
    from dinounet_tpu_torch.models.adapter import sampling_offset_bias

    cfg = TorchConfig(vit=TorchViTConfig(**VIT_KW), **CFG_KW)
    model = TorchDinoUNet(cfg).init_weights(seed=0)
    blk = model.encoder.dinov3_adapter.backbone.blocks[0]
    assert torch.all(blk.ls1.gamma == 1e-5)
    attn = model.encoder.dinov3_adapter.interactions[0].extractor.attn
    assert torch.all(attn.sampling_offsets.weight == 0)
    np.testing.assert_array_equal(attn.sampling_offsets.bias.detach().numpy(),
                                  sampling_offset_bias(4, 1, 4))
    # lecun_normal (qkv, fan_in 64): std 1/8; fan-out normal (3x3 stem conv,
    # 8 outputs): std sqrt(2/72)
    assert abs(float(blk.attn.qkv.weight.detach().std()) - 0.125) < 0.01
    w = model.encoder.dinov3_adapter.spm.stem[0].weight.detach()
    assert abs(float(w.std()) - (2 / 72) ** 0.5) < 0.03
    torch.testing.assert_close(TorchDinoUNet(cfg).init_weights(seed=0).state_dict(),
                               model.state_dict())
