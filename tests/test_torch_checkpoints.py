"""The port's DINOv3 backbone loading vs the JAX package's, on the CPU.

The published weights are not in the repository, so every checkpoint here
is synthetic: seeded values in the shapes of the published layout
(``checkpoint_manifest.json``), ``bias_mask`` 1 / 0 / 1 over q / k / v (or
NaN: a mask never initialised), with the manifest's ignored keys. The JAX
package converts a ``.pth`` to its ``.msgpack`` (``convert_torch_checkpoint``)
and loads that (``load_dinov3_params_into``); the port reads either file.
Tolerances:

- the loaded backbone: bit for bit in fp32 (the same values, moved);
- the JAX and port ``dinounet_s`` trainers loaded from the same file, one
  64 x 64 input: fp32 logits to rtol / atol 1e-3, the whole-model tolerance
  of ``tests/test_torch_models.py``. The JAX trainer's variables are drawn
  from a seed through ``jax.eval_shape`` (compiling its ``init`` takes tens
  of seconds on a CPU); its ``initialize`` then loads the file as it would.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dinounet_tpu_torch
from dinounet_tpu_torch.models import convert as port_convert
from dinounet_tpu_torch.models.convert import (backbone_state_dict_from_dinov3,
                                               checkpoint_manifest, load_backbone_params,
                                               load_dinov3_backbone_, state_dict_from_flax,
                                               verify_state_dict_against_manifest)
from dinounet_tpu_torch.models.dinounet import DinoUNet as TorchDinoUNet
from dinounet_tpu_torch.models.vit import VIT_CONFIGS
from dinounet_tpu_torch.models.vit import DinoViT as TorchDinoViT
from dinounet_tpu_torch.models.vit import ViTConfig as TorchViTConfig
from dinounet_tpu_torch.training import dinounet_trainer as port_trainers
from tests.test_torch_api import INJECTED, _trainer_classes
from tests.test_torch_vit7b import VIT_KW as VIT7B_KW
from tests.test_torch_vit7b import _fill

MODEL = "dinov3_vits16"
BACKBONE = "encoder.dinov3_adapter.backbone."
HW = 64
ARCH = {"n_stages": 4, "features_per_stage": [32, 64, 128, 256],
        "kernel_sizes": [[3, 3]] * 4, "strides": [[1, 1], [2, 2], [2, 2], [2, 2]],
        "n_conv_per_stage": [2] * 4, "n_conv_per_stage_decoder": [2, 2, 2],
        "conv_bias": True, "norm_op": "torch.nn.modules.instancenorm.InstanceNorm2d",
        "norm_op_kwargs": {"eps": 1e-05, "affine": True},
        "nonlin": "torch.nn.LeakyReLU", "nonlin_kwargs": {"inplace": True}}
PLANS = {"dataset_name": "Dataset989_Ckpt", "plans_name": "nnUNetPlans",
         "configurations": {"2d": {"patch_size": [HW, HW], "batch_size": 2,
                                   "data_identifier": "nnUNetPlans_2d",
                                   "architecture": {"network_class_name": "DinoUNet",
                                                    "arch_kwargs": ARCH,
                                                    "_kw_requires_import": []}}}}
DATASET_JSON = {"labels": {"background": 0, "a": 1, "b": 2},
                "channel_names": {"0": "CT"}, "file_ending": ".nii.gz"}


def published_state_dict(model_name: str, seed: int, mask: str = "finite") -> dict:
    """Seeded tensors in the manifest's shapes: matrices normal / sqrt(fan
    in), vectors 0.1-scale noise (norm scales and LayerScale around their
    use), bias_mask 1 / 0 / 1 over q / k / v or NaN."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in checkpoint_manifest(model_name).items():
        if name.endswith("bias_mask"):
            n = shape[0] // 3
            v = np.concatenate([np.ones(n), np.zeros(n), np.ones(n)])
            if mask == "nan":
                v[:] = np.nan
        elif len(shape) >= 2 and name not in ("cls_token", "storage_tokens", "mask_token"):
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif name.endswith("norm1.weight") or name.endswith("norm2.weight") \
                or name == "norm.weight":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        sd[name] = torch.from_numpy(np.asarray(v, np.float32))
    return sd


def _strip(sd: dict) -> dict:
    return {k[len(BACKBONE):]: v for k, v in sd.items() if k.startswith(BACKBONE)}


def _jax_backbone_shapes(vit_cfg):
    from dinounet_tpu.models.vit import DinoViT

    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    return jax.eval_shape(lambda: DinoViT(vit_cfg).init(
        jax.random.PRNGKey(0), x, (0,)))["params"]


@pytest.fixture(scope="module")
def vits16_files(tmp_path_factory):
    """The seeded dinov3_vits16 .pth (finite and NaN mask) and the JAX
    package's .msgpack of each."""
    from dinounet_tpu.models.convert import convert_torch_checkpoint

    root = tmp_path_factory.mktemp("vits16")
    files = {}
    for mask in ("finite", "nan"):
        pth = str(root / f"{mask}.pth")
        torch.save(published_state_dict(MODEL, seed=0, mask=mask), pth)
        convert_torch_checkpoint(pth, MODEL, str(root / f"{mask}.msgpack"))
        files[mask] = pth
    return files


def _port_vits16() -> TorchDinoViT:
    return TorchDinoViT(dataclasses.replace(VIT_CONFIGS[MODEL], dtype="float32"))


# ----------------------------------------------------------- the manifest

def _jax_message(shapes):
    from dinounet_tpu.models.convert import verify_state_dict_against_manifest as jax_verify

    with pytest.raises(ValueError) as e:
        jax_verify(shapes, MODEL)
    return str(e.value)


@pytest.mark.parametrize("defect", ["missing", "unexpected", "mis_shaped", "all"])
def test_verify_against_manifest_says_what_jax_says(defect):
    shapes = {k: tuple(v) for k, v in checkpoint_manifest(MODEL).items()}
    verify_state_dict_against_manifest(shapes, MODEL)  # the published layout passes
    if defect in ("missing", "all"):
        for k in [k for k in shapes if k.startswith("blocks.11.")]:
            del shapes[k]
    if defect in ("unexpected", "all"):
        shapes["blocks.0.attn.extra"] = (3,)
    if defect in ("mis_shaped", "all"):
        shapes["blocks.0.attn.qkv.weight"] = (1152, 385)
    with pytest.raises(ValueError) as e:
        verify_state_dict_against_manifest(shapes, MODEL)
    assert str(e.value) == _jax_message(shapes)
    assert str(e.value).startswith("checkpoint does not match the published dinov3_vits16")
    with pytest.raises(KeyError):
        checkpoint_manifest("dinov3_vitg16")


def test_manifest_is_the_jax_packages_file():
    from dinounet_tpu.models import convert as jax_convert

    port = Path(port_convert._MANIFEST_PATH).read_bytes()
    assert port == Path(jax_convert._MANIFEST_PATH).read_bytes()
    assert port_convert.IGNORED_CHECKPOINT_KEYS == jax_convert.IGNORED_CHECKPOINT_KEYS


# ------------------------------------------------- the published .pth layout

@pytest.mark.parametrize("mask", ["finite", "nan"])
def test_pth_loads_as_the_jax_package_loads_it(vits16_files, mask):
    """The port reads the .pth; the JAX package converts it and loads the
    .msgpack into its variables. The two backbones are equal bit for bit;
    a finite mask zeroes the k bias, a NaN one leaves the bias."""
    from dinounet_tpu.models.convert import load_dinov3_params_into
    from dinounet_tpu.models.vit import VIT_CONFIGS as JAX_VIT_CONFIGS

    pth = vits16_files[mask]
    shapes = _jax_backbone_shapes(dataclasses.replace(JAX_VIT_CONFIGS[MODEL],
                                                      dtype="float32"))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    jax_vars = load_dinov3_params_into({"params": {"backbone": zeros}},
                                       pth[:-len(".pth")] + ".msgpack")
    want = _strip(state_dict_from_flax({"params": {"backbone": jax_vars["params"]["backbone"]}}))

    vit = _port_vits16()
    assert load_dinov3_backbone_(vit, pth, MODEL) == len(want)
    got = vit.state_dict()
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.dtype == torch.float32 and torch.equal(t, want[name]), name
    file_bias = published_state_dict(MODEL, seed=0, mask=mask)["blocks.0.attn.qkv.bias"]
    bias, n = got["blocks.0.attn.qkv.bias"], file_bias.shape[0] // 3
    if mask == "finite":
        assert torch.equal(bias[n:2 * n], torch.zeros(n))
        assert torch.equal(bias[:n], file_bias[:n]) and torch.equal(bias[2 * n:], file_bias[2 * n:])
    else:
        assert torch.equal(bias, file_bias)


def test_strict_refuses_a_leftover_key():
    from dinounet_tpu.models.convert import convert_dinov3_state_dict
    from dinounet_tpu.models.vit import VIT_CONFIGS as JAX_VIT_CONFIGS

    sd = published_state_dict(MODEL, seed=1)
    sd["blocks.3.attn.q_norm.weight"] = torch.ones(64)
    sd["head.weight"] = torch.ones(2, 384)
    out = backbone_state_dict_from_dinov3(sd, VIT_CONFIGS[MODEL], strict=False)
    assert "head.weight" not in out and "mask_token" not in out
    with pytest.raises(ValueError) as port:
        backbone_state_dict_from_dinov3(sd, VIT_CONFIGS[MODEL], strict=True)
    with pytest.raises(ValueError) as jax_e:
        convert_dinov3_state_dict({k: v.numpy() for k, v in sd.items()},
                                   JAX_VIT_CONFIGS[MODEL], strict=True)
    assert str(port.value) == str(jax_e.value)
    assert "2 checkpoint key(s) were not converted" in str(port.value)


def test_mis_shaped_files_raise(tmp_path):
    """A file that is present but does not fit raises before anything is
    copied: against the manifest (.pth) or the module (.pth of another
    size, .msgpack)."""
    from dinounet_tpu.models.convert import save_backbone_params

    sd = published_state_dict(MODEL, seed=2)
    sd["blocks.0.mlp.fc1.weight"] = sd["blocks.0.mlp.fc1.weight"][:, :383]
    pth = str(tmp_path / "bad.pth")
    torch.save(sd, pth)
    vit = _port_vits16()
    before = {k: v.clone() for k, v in vit.state_dict().items()}
    with pytest.raises(ValueError, match="mis-shaped: blocks.0.mlp.fc1.weight"):
        load_dinov3_backbone_(vit, pth, MODEL)
    with pytest.raises(ValueError, match="Shape mismatch for blocks.0.mlp.fc1.weight"):
        load_dinov3_backbone_(vit, pth, None)  # no manifest: the module's shapes
    params = _fill(_jax_backbone_shapes(_jax_tiny_cfg()), 3)
    save_backbone_params(params, str(tmp_path / "tiny.msgpack"))
    with pytest.raises((KeyError, ValueError)):
        load_dinov3_backbone_(vit, str(tmp_path / "tiny.msgpack"))
    assert all(torch.equal(t, before[k]) for k, t in vit.state_dict().items())


def test_verify_only_cli_prints_the_jax_line(vits16_files, capsys):
    from dinounet_tpu.models import convert as jax_convert

    argv = [vits16_files["finite"], MODEL, "--verify-only"]
    port_convert.main(argv)
    port_out = capsys.readouterr().out
    jax_convert.main(argv)
    assert port_out == capsys.readouterr().out
    assert port_out.strip().endswith("matches the published dinov3_vits16 layout (188 keys)")


def test_port_imports_no_msgpack():
    pkg = Path(dinounet_tpu_torch.__file__).parent
    pattern = re.compile(r"^\s*(?:from|import)\s+msgpack\b", re.MULTILINE)
    assert not [p for p in pkg.rglob("*.py") if pattern.search(p.read_text())]


# ------------------------------------------------ the JAX package's .msgpack

def _jax_tiny_cfg():
    from dinounet_tpu.models.vit import ViTConfig

    return ViTConfig(**VIT7B_KW, dtype="float32")


@pytest.fixture(scope="module")
def tiny_backbone():
    return _fill(_jax_backbone_shapes(_jax_tiny_cfg()), 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("layout", ["unrolled", "scanned"])
def test_port_reads_the_jax_msgpack(tiny_backbone, tmp_path, monkeypatch, layout, chunked,
                                    dtype):
    """The tree ``convert_torch_checkpoint`` writes, in both block layouts,
    its large leaves chunked (flax's MAX_CHUNK_SIZE set to 100 kB on the
    JAX side: pieces that split blocks), in fp32 and in bf16."""
    from flax import serialization

    from dinounet_tpu.models.convert import save_backbone_params, stack_scan_blocks

    params = jax.tree.map(lambda a: np.asarray(a, jnp.dtype(dtype)), tiny_backbone)
    tree = stack_scan_blocks(params, VIT7B_KW["depth"]) if layout == "scanned" else params
    if chunked:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 100_000)
    path = str(tmp_path / "backbone.msgpack")
    save_backbone_params(tree, path)
    assert (b"__msgpack_chunked_array__" in Path(path).read_bytes()) == chunked

    want = _strip(state_dict_from_flax({"params": {"backbone": params}}))
    got = load_backbone_params(path)
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.dtype == getattr(torch, dtype), name
        assert torch.equal(t.float(), want[name]), name
    vit = TorchDinoViT(TorchViTConfig(**VIT7B_KW, dtype="float32"))
    vit.hold_weights_(torch.bfloat16)
    load_dinov3_backbone_(vit, path)
    for name, t in vit.state_dict().items():
        assert torch.equal(t, want[name].to(t.dtype)), name


# -------------------------------------------------------------- the trainers

def _save_trainer_state():
    from dinounet_tpu.training import dinounet_trainer as jax_trainers

    classes = (_trainer_classes(port_trainers.DinoUNetTrainer)
               + _trainer_classes(jax_trainers.DinoUNetTrainer))
    return [(cls, {a: vars(cls)[a] for a in INJECTED if a in vars(cls)}) for cls in classes]


def _restore_trainer_state(saved) -> None:
    for cls, attrs in saved:
        for a in INJECTED:
            if a in attrs:
                setattr(cls, a, attrs[a])
            elif a in vars(cls):
                delattr(cls, a)


@pytest.fixture()
def restore_trainers():
    saved = _save_trainer_state()
    yield
    _restore_trainer_state(saved)


def _env(root: Path, mp) -> None:
    for sub, var in (("pre", "nnUNet_preprocessed"), ("res", "nnUNet_results")):
        (root / sub).mkdir(exist_ok=True)
        mp.setenv(var, str(root / sub))
    mp.chdir(root)


def _log(trainer) -> str:
    return Path(trainer.log_file).read_text()


@pytest.fixture(scope="module")
def s_trainers(tmp_path_factory, vits16_files):
    """In a directory whose dinounet/checkpoints/ holds only the JAX
    package's converted dinov3_vits16 .msgpack: the JAX DinoUNetTrainer_s
    and the port's, each with the network configuration injected (the
    JAX trainer loads only then), initialized; and the port's
    DinoUNetTrainer_s pointed at the .pth itself."""
    from dinounet_tpu.training import dinounet_trainer as jax_trainers

    from dinounet_tpu.models.dinounet import DinoUNet as JaxDinoUNet

    root = tmp_path_factory.mktemp("trainers")
    ckpt = root / "dinounet" / "checkpoints"
    ckpt.mkdir(parents=True)
    (ckpt / "dinov3_vits16_pretrain.msgpack").write_bytes(
        Path(vits16_files["finite"][:-len(".pth")] + ".msgpack").read_bytes())
    config = {"architecture": ARCH}
    saved = _save_trainer_state()
    with pytest.MonkeyPatch.context() as mp:
        _env(root, mp)

        def seeded_variables(self):
            x = self._example_input()
            shapes = jax.eval_shape(lambda: self.network.init(
                {"params": jax.random.PRNGKey(0)}, x, train=False))
            self.variables = dict(_fill(shapes, 5))

        mp.setattr(jax_trainers.DinoUNetTrainer_s, "_init_params_and_optimizer",
                   seeded_variables)
        jax_trainers.DinoUNetTrainer_s.set_network_config(config)
        jax_trainer = jax_trainers.DinoUNetTrainer_s(PLANS, "2d", 0, DATASET_JSON)
        jax_trainer.initialize()

        port_trainers.DinoUNetTrainer_s.set_network_config(config)
        from_msgpack = port_trainers.DinoUNetTrainer_s(PLANS, "2d", 0, DATASET_JSON,
                                                       device="cpu")
        from_msgpack.initialize()
        port_trainers.DinoUNetTrainer_s.set_network_config(
            config, dinov3_pretrained_path=vits16_files["finite"])
        from_pth = port_trainers.DinoUNetTrainer_s(PLANS, "2d", 0, DATASET_JSON,
                                                   device="cpu")
        from_pth.initialize()
    _restore_trainer_state(saved)
    cfg = jax_trainer.network.cfg
    jax_net = JaxDinoUNet(dataclasses.replace(
        cfg, dtype="float32", vit=dataclasses.replace(cfg.vit, dtype="float32")))
    return jax_trainer, jax_net, from_msgpack, from_pth


def test_msgpack_only_directory_loads_in_both_packages(s_trainers):
    """The JAX size trainers look for the converted .msgpack; the port's
    find it where the .pth is missing, and load the same backbone."""
    jax_trainer, _, from_msgpack, _ = s_trainers
    path = "dinounet/checkpoints/dinov3_vits16_pretrain.msgpack"
    assert f"Loaded DINOv3 backbone weights from {path}" in _log(jax_trainer)
    assert f"Loaded DINOv3 backbone weights from {path}" in _log(from_msgpack)
    want = _strip(state_dict_from_flax(
        {"params": {"backbone": jax_trainer.variables["params"]["backbone"]}}))
    got = from_msgpack.network.encoder.dinov3_adapter.backbone.state_dict()
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert torch.equal(t, want[name]), name


def test_s_trainers_loaded_from_one_file_give_the_jax_logits(s_trainers):
    """The port's DinoUNetTrainer_s loaded from the .pth and the JAX one from
    its .msgpack of that file: with the JAX trainer's other weights, the same
    fp32 logits on a 64 x 64 input."""
    jax_trainer, jax_net, _, from_pth = s_trainers
    x = np.random.default_rng(6).standard_normal((2, 1, HW, HW)).astype(np.float32)
    want = jax.jit(lambda v, x: jax_net.apply(v, x, train=False))(
        jax_trainer.variables, jnp.asarray(np.moveaxis(x, 1, -1)))
    state = state_dict_from_flax(jax_trainer.variables)
    backbone = from_pth.network.encoder.dinov3_adapter.backbone.state_dict()
    state.update({BACKBONE + k: v for k, v in backbone.items()})
    model = TorchDinoUNet(dataclasses.replace(from_pth.network.cfg, dtype="float32"))
    model.load_state_dict(state, strict=True)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want), -1, 1),
                               rtol=1e-3, atol=1e-3)


def test_port_reads_the_size_trainers_own_path(tmp_path, monkeypatch, vits16_files,
                                               restore_trainers):
    """Without set_network_config (``run_training_entry -tr
    DinoUNetTrainer_s``) the JAX trainer reads the base class's path, which
    is None, and trains on a random backbone; the port's reads its own
    ``dinounet/checkpoints/dinov3_vits16_pretrain.pth``. A file that is
    present but broken raises."""
    from dinounet_tpu.training import dinounet_trainer as jax_trainers

    assert jax_trainers.DinoUNetTrainer._network_config is None
    assert jax_trainers.DinoUNetTrainer._dinov3_pretrained_path is None
    _env(tmp_path, monkeypatch)
    ckpt = tmp_path / "dinounet" / "checkpoints"
    ckpt.mkdir(parents=True)
    (ckpt / "dinov3_vits16_pretrain.pth").write_bytes(Path(vits16_files["nan"]).read_bytes())
    trainer = port_trainers.DinoUNetTrainer_s(PLANS, "2d", 0, DATASET_JSON, device="cpu")
    trainer.initialize()
    path = "dinounet/checkpoints/dinov3_vits16_pretrain.pth"
    assert f"Loaded DINOv3 backbone weights from {path}" in _log(trainer)
    vit = _port_vits16()
    load_dinov3_backbone_(vit, vits16_files["nan"], MODEL)
    got = trainer.network.encoder.dinov3_adapter.backbone.state_dict()
    assert all(torch.equal(t, got[k]) for k, t in vit.state_dict().items())

    sd = published_state_dict(MODEL, seed=0)
    del sd["blocks.5.ls1.gamma"]
    torch.save(sd, str(ckpt / "dinov3_vits16_pretrain.pth"))
    trainer = port_trainers.DinoUNetTrainer_s(PLANS, "2d", 0, DATASET_JSON, device="cpu")
    with pytest.raises(ValueError, match=r"missing keys: \['blocks.5.ls1.gamma'\]"):
        trainer.initialize()
