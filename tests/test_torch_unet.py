"""The plans' networks of the port (PlainConvUNet, ResidualEncoderUNet) and
its deep-supervision heads vs the JAX package's, on the CPU.

Each network is built from a plans ``arch_kwargs`` dict in both packages
(3 stages, widths 4 to 8), its JAX variable tree (shapes from an abstract
init) is filled from a numpy seed and carried into the port by
``state_dict_from_flax``; both run the same numpy input in fp32. Outputs and
every deep-supervision head must agree to 1e-4 (absolute and relative: the
same fp32 convs and norms summed in another order), BatchNorm's running
statistics after a train-mode call to 1e-5.

The JAX ResidualEncoderUNet builds in 2-D only (its second conv and later
blocks pass 2-D strides, which flax refuses on a 3-D kernel), so the 3-D
residual network is held against ``_ResidualEncoderUNet3d`` below: the JAX
module's graph and parameter tree with rank-correct strides, made of the JAX
package's flax layers and decoder.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinounet_tpu_torch.models.convert import state_dict_from_flax
from dinounet_tpu_torch.models.plain_unet import PlainConvUNet, PlainUNetConfig
from dinounet_tpu_torch.models.residual_unet import ResidualEncoderUNet, ResidualUNetConfig
from tests.test_torch_models import variables  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
N_CLASSES = 3
SHAPES = {2: (2, 1, 24, 20), 3: (2, 1, 8, 16, 12)}


def plans_arch(dim: int, norm: str = "instancenorm", n_conv=(1, 2, 2)) -> dict:
    """A planner-shaped arch_kwargs dict (lists, torch class paths); the
    3-D strides are anisotropic in the first downsampling, as for a
    thick-slice volume."""
    suffix = f"{dim}d"
    norm_op = {"instancenorm": f"torch.nn.modules.instancenorm.InstanceNorm{suffix}",
               "batchnorm": f"torch.nn.modules.batchnorm.BatchNorm{suffix}"}[norm]
    strides = ([[1, 1], [2, 2], [2, 2]] if dim == 2
               else [[1, 1, 1], [1, 2, 2], [2, 2, 2]])
    return {"n_stages": 3, "features_per_stage": [4, 8, 8],
            "conv_op": f"torch.nn.modules.conv.Conv{suffix}",
            "kernel_sizes": [[3] * dim] * 3, "strides": strides,
            "n_conv_per_stage": list(n_conv), "n_conv_per_stage_decoder": [1, 2],
            "conv_bias": True, "norm_op": norm_op,
            "norm_op_kwargs": {"eps": 1e-5, "affine": True}, "dropout_op": None,
            "dropout_op_kwargs": None, "nonlin": "torch.nn.LeakyReLU",
            "nonlin_kwargs": {"inplace": True}}


class _ResidualEncoderUNet3d:
    """Built lazily (flax is imported inside): see the module docstring."""

    @staticmethod
    def make(cfg):
        from flax import linen as nn

        from dinounet_tpu.models.decoder import UNetDecoder
        from dinounet_tpu.models.layers import Norm, conv_kaiming_init, nonlin_fn

        class Block(nn.Module):
            features: int
            strides: tuple

            @nn.compact
            def __call__(self, x, train=False):
                act = nonlin_fn(cfg.nonlin, cfg.nonlin_kwargs)
                ones = (1,) * 3

                def conv(name, k, s, bias=True):
                    return nn.Conv(self.features, k, strides=s, padding="SAME",
                                   use_bias=bias, dtype=jnp.float32,
                                   kernel_init=conv_kaiming_init, name=name)

                y = conv("conv1", (3, 3, 3), self.strides)(x)
                y = act(Norm(cfg.norm, name="norm1")(y, train=train))
                y = conv("conv2", (3, 3, 3), ones)(y)
                y = Norm(cfg.norm, name="norm2")(y, train=train)
                if x.shape[-1] != self.features or tuple(self.strides) != ones:
                    x = conv("proj", ones, self.strides, bias=False)(x)
                    x = Norm(cfg.norm, name="proj_norm")(x, train=train)
                return act(x + y)

        class Net(nn.Module):
            @nn.compact
            def __call__(self, x, train=False):
                skips = []
                for s, feats in enumerate(cfg.features_per_stage):
                    for b in range(cfg.n_blocks_per_stage[s]):
                        x = Block(feats, tuple(cfg.strides[s]) if b == 0 else (1, 1, 1),
                                  name=f"enc{s}_block{b}")(x, train=train)
                    skips.append(x)
                return UNetDecoder(
                    encoder_channels=cfg.features_per_stage, encoder_strides=cfg.strides,
                    encoder_kernel_sizes=cfg.kernel_sizes, num_classes=cfg.num_classes,
                    n_conv_per_stage=cfg.n_conv_per_stage_decoder,
                    deep_supervision=cfg.deep_supervision and train, norm=cfg.norm,
                    nonlin=cfg.nonlin, nonlin_kwargs=cfg.nonlin_kwargs,
                    conv_bias=cfg.conv_bias, dtype=jnp.float32, name="decoder",
                )(skips, train=train)

        return Net()


def _jax_network(kind: str, arch: dict, ds: bool):
    from dinounet_tpu.models import plain_unet, residual_unet

    if kind == "plain":
        cfg = plain_unet.PlainUNetConfig.from_plans_arch(arch, N_CLASSES, ds)
        return plain_unet.PlainConvUNet(dataclasses.replace(cfg, dtype="float32"))
    cfg = residual_unet.ResidualUNetConfig.from_plans_arch(arch, N_CLASSES, ds)
    cfg = dataclasses.replace(cfg, dtype="float32")
    if len(cfg.kernel_sizes[0]) == 3:
        return _ResidualEncoderUNet3d.make(cfg)
    return residual_unet.ResidualEncoderUNet(cfg)


def _port_network(kind: str, arch: dict, ds: bool):
    cfg_cls, net_cls = ((PlainUNetConfig, PlainConvUNet) if kind == "plain"
                        else (ResidualUNetConfig, ResidualEncoderUNet))
    cfg = dataclasses.replace(cfg_cls.from_plans_arch(arch, N_CLASSES, ds), dtype="float32")
    return net_cls(cfg, 1)


def seeded_variables(module, x_shape, seed: int):
    """`module`'s variable tree from an abstract init, filled from a numpy
    seed: kernels normal with variance 1/fan_in, scales 1 + noise, running
    variances in [0.5, 1.5], everything else small noise."""
    x = jnp.zeros(x_shape, jnp.float32)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x, train=False))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if name.endswith("['kernel']"):
            return noise / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        if name.endswith("['var']"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return 1.0 + 0.1 * noise
        return 0.1 * noise

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _channels_last(x: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(np.moveaxis(x, 1, -1))


def _channels_first(y) -> np.ndarray:
    return np.moveaxis(np.asarray(y), -1, 1)


@pytest.mark.parametrize("mode", ["eval", "train_ds", "batchnorm_eval", "batchnorm_train_ds"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", ["plain", "resenc"])
def test_plans_network_matches_jax(kind, dim, mode):
    train = mode.endswith("train_ds")
    norm = "batchnorm" if mode.startswith("batchnorm") else "instancenorm"
    arch = plans_arch(dim, norm)
    jnet = _jax_network(kind, arch, ds=train)
    x = np.random.default_rng(dim).standard_normal(SHAPES[dim]).astype(np.float32)
    variables = seeded_variables(jnet, _channels_last(x).shape, seed=10 + dim)
    net = _port_network(kind, arch, ds=train)
    net.load_state_dict(state_dict_from_flax(variables), strict=True)
    net.train(train)
    got = net(torch.from_numpy(x))

    if train:
        want, updated = jnet.apply(variables, _channels_last(x), train=True,
                                   mutable=["batch_stats"])
        assert isinstance(got, list) and len(got) == len(want) == 2
    else:
        want = [jnet.apply(variables, _channels_last(x), train=False)]
        got = [got]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and tuple(g.shape) == _channels_first(w).shape
        np.testing.assert_allclose(g.detach().numpy(), _channels_first(w), rtol=TOL,
                                   atol=TOL, err_msg=f"head {i}")
    if train and norm == "batchnorm":
        stats = state_dict_from_flax({"batch_stats": updated["batch_stats"]})
        buffers = dict(net.named_buffers())
        assert stats
        for name, w in stats.items():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(buffers[name].numpy(), w.numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=name)


def test_state_dict_names_are_the_reference_names():
    """dynamic_network_architectures' names for the encoder stages, the
    decoder's transposed convs, stages and heads; the bridge fills all."""
    arch = plans_arch(3)
    for kind, prefix in (("plain", "encoder.stages.1.0.convs.0.conv.weight"),
                         ("resenc", "encoder.stages.1.blocks.1.conv2.norm.weight")):
        net = _port_network(kind, arch, ds=False)
        names = set(net.state_dict())
        assert prefix in names
        assert {"decoder.transpconvs.0.weight", "decoder.stages.1.convs.1.conv.weight",
                "decoder.seg_layers.1.bias"} <= names
        jnet = _jax_network(kind, arch, ds=False)
        variables = seeded_variables(jnet, (1, 8, 16, 12, 1), seed=3)
        assert set(state_dict_from_flax(variables)) == names
    res = _port_network("resenc", arch, ds=False).encoder.stages
    assert not isinstance(res[0].blocks[0].skip, torch.nn.Identity)  # 1 -> 4 channels
    assert isinstance(res[1].blocks[1].skip, torch.nn.Identity)


def test_3d_transposed_conv_anisotropic_stride_matches_flax():
    """kernel = stride = (1, 2, 2): the bridge flips the taps as for 2-D."""
    from flax import linen as nn

    from dinounet_tpu_torch.models.layers import TransposedConv3d

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 4, 5, 6)).astype(np.float32)
    module = nn.ConvTranspose(4, (1, 2, 2), strides=(1, 2, 2), padding="VALID",
                              dtype=jnp.float32)
    variables = seeded_variables_flat(module, _channels_last(x).shape, rng)
    want = _channels_first(module.apply(variables, _channels_last(x)))
    port = TransposedConv3d(3, 4, (1, 2, 2), dtype=torch.float32)
    sd = state_dict_from_flax({"params": {"decoder": {"transpconv0": {
        "transpconv": variables["params"]}}}})
    port.load_state_dict({k.split("transpconvs.0.")[1]: v for k, v in sd.items()})
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 4, 4, 10, 12)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def seeded_variables_flat(module, x_shape, rng):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                jnp.zeros(x_shape, jnp.float32)))
    return jax.tree_util.tree_map(
        lambda leaf: rng.standard_normal(leaf.shape).astype(np.float32), shapes)


def test_dinounet_deep_supervision_heads_match_jax(variables):  # noqa: F811
    """The tiny DinoUNet of tests/test_torch_models.py with deep supervision
    in train mode (drop-path 0): every head, highest resolution first, to
    1e-3 as that file holds the whole model; eval mode returns the top head
    alone."""
    from dinounet_tpu.models.dinounet import DinoUNet

    from dinounet_tpu_torch.models.dinounet import DinoUNet as TorchDinoUNet
    from dinounet_tpu_torch.models.dinounet import DinoUNetConfig as TorchConfig
    from dinounet_tpu_torch.models.vit import ViTConfig as TorchViTConfig
    from tests.test_torch_models import CFG_KW, HW, VIT_KW, _jax_config

    x = np.random.default_rng(6).standard_normal((2, 1, HW, HW)).astype(np.float32)
    cfg = dataclasses.replace(_jax_config(), deep_supervision=True, drop_path_rate=0.0)
    want, _ = jax.jit(lambda v, t: DinoUNet(cfg).apply(v, t, train=True,
                                                       mutable=["batch_stats"]))(
        variables, _channels_last(x))
    model = TorchDinoUNet(TorchConfig(vit=TorchViTConfig(**VIT_KW, dtype="float32"),
                                      dtype="float32", drop_path_rate=0.0,
                                      deep_supervision=True, **CFG_KW))
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    model.train()
    got = model(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == (2, 3, HW >> i, HW >> i)
        np.testing.assert_allclose(g.detach().numpy(), _channels_first(w), rtol=1e-3,
                                   atol=1e-3, err_msg=f"head {i}")
    top = model.eval()(torch.from_numpy(x))
    assert isinstance(top, torch.Tensor) and top.shape == (2, 3, HW, HW)


def test_plans_2d_unet_takes_the_fused_decoder_chain(monkeypatch):
    """A 2-D PlainConvUNet built from a plans dict (lists) runs its decoder
    through ``decoder_chain_cm`` under DINOUNET_TPU_DECODER_TAIL=interpret
    (on the CPU, the chain's plain versions) in bf16 eval mode, every stage
    of it (its eligibility is the JAX package's: each skip a multiple of 128
    wide), and stays within bf16 rounding of the stock stages."""
    from dinounet_tpu_torch.models import decoder as decoder_module

    arch = plans_arch(2, n_conv=(2, 2, 2))
    arch["n_conv_per_stage_decoder"] = [2, 2]
    arch["features_per_stage"] = [8, 16, 16]
    net = PlainConvUNet(PlainUNetConfig.from_plans_arch(arch, N_CLASSES, False), 1)
    net.init_weights(0).eval()
    assert net.decoder.encoder_strides[-1] == (2, 2)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 1, 256, 256)).astype(np.float32))
    with torch.no_grad():
        stock = net(x)
    calls = []
    chain = decoder_module.decoder_chain_cm

    def spy(lres, skips, *args, **kwargs):
        calls.append(len(skips))
        return chain(lres, skips, *args, **kwargs)

    monkeypatch.setattr(decoder_module, "decoder_chain_cm", spy)
    monkeypatch.setenv("DINOUNET_TPU_DECODER_TAIL", "interpret")
    with torch.no_grad():
        fused = net(x)
    assert calls == [2]
    assert fused.shape == stock.shape == (2, N_CLASSES, 256, 256)
    scale = float(stock.abs().max())
    assert float((fused - stock).abs().max()) <= 0.05 * scale


def test_reference_layout_checkpoint_loads_by_name(tmp_path):
    """A checkpoint in dynamic_network_architectures' layout (each conv also
    under ``all_modules.0``, the encoder again under ``decoder.encoder``)
    moves every weight but the heads through ``run.load_pretrained_weights``."""
    from types import SimpleNamespace

    from dinounet_tpu_torch.run import load_pretrained_weights

    net = _port_network("plain", plans_arch(3), ds=False).init_weights(1)
    source = _port_network("plain", plans_arch(3), ds=False).init_weights(2).state_dict()
    extra = {}
    for name, t in source.items():
        if ".convs." in name and ".conv." in name:
            extra[name.replace(".conv.", ".all_modules.0.")] = t
        if name.startswith("encoder."):
            extra["decoder." + name] = t
    path = tmp_path / "checkpoint_final.pth"
    torch.save({"network_weights": {**source, **extra}}, path)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    load_pretrained_weights(SimpleNamespace(network=net), str(path))
    for name, t in net.state_dict().items():
        want = before[name] if name.startswith("decoder.seg_layers.") else source[name]
        assert torch.equal(t, want), name
