"""The port's learnability run and int8 accuracy experiment
(``tools/learnability_run_torch.py``, ``tools/int8_accuracy_experiment_torch.py``)
against the JAX package's tools, on the CPU.

* ``make_dataset`` writes the JAX tool's ten cases: the same PNG pixels and
  the same dataset.json.
* The tool's ``main`` from raw PNG files to ``evaluate`` on the CPU, with
  ``DINOV3_TRAINERS["dinounet_s"]`` swapped for a small DinoUNet trainer
  (a ViT of width 64 and depth 4 registered as a model of its own, 1 epoch
  of 2 steps) and the plans forced to 64 x 64 instead of 512 x 512 (the
  network's decoder at 512^2 takes minutes a step here): the JAX tool's JSON
  line, a finite Dice, one epoch's record.
* Part A on a small DinoUNet whose weights are the JAX package's
  (``state_dict_from_flax``): on fp32 weights the per-layer quantization
  errors equal the JAX tool's ``_quant_error_per_layer`` to 1e-6; in bf16
  the fp and int8 logits are within the relative L2 of
  ``tests/test_torch_dense_q8.py::test_dinounet_int8_matches_jax`` (5e-2)
  of the JAX package's own fp and int8 forwards (NHWC, transposed); the
  argmax agreement is taken over the class axis.
* Part B on the trained folder: the fp validation's Dice equals the one the
  training's own validation wrote, the int8 validation runs the int8 ops'
  plain versions and gives a finite Dice, and a configuration injected by
  another trainer before it neither changes the network it builds nor
  outlasts it.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import dinounet_tpu_torch.models.vit as t_vit
import dinounet_training_torch
from dinounet_tpu_torch.training import dinounet_trainer as port_trainers
from dinounet_tpu_torch.utilities import registry
from tests.fixture_network import injected_network
from tests.test_torch_dense_q8 import _filled
from tests.test_torch_planning import FAST_SAMPLES
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TINY_MODEL = "learn_tiny"
# the small network: the CLI's plans' decoder, a ViT of width 64 and depth
# 4 (two heads), the adapter and FAPM narrowed (fixture_network's spec)
TINY_SPEC = {
    "model_name": TINY_MODEL, "vit_name": "learn_tiny_vit",
    "vit": dict(embed_dim=64, depth=4, num_heads=2, ffn_ratio=2, n_storage_tokens=4),
    "interaction_indexes": [0, 1, 2, 3],
    "architecture": {"n_stages": 4, "features_per_stage": [8, 16, 32, 64],
                     "n_conv_per_stage_decoder": [2, 2, 2], "conv_bias": True,
                     "norm_op": "torch.nn.modules.instancenorm.InstanceNorm2d",
                     "nonlin": "torch.nn.LeakyReLU"},
    "overrides": {"fapm_rank": 16, "conv_inplane": 8, "deform_num_heads": 4},
}
FORCED_SHAPE = [64, 64]
INJECTED = ("_network_config", "_dinov3_model_name", "_dinov3_pretrained_path")
# the int8 ops of the ViT blocks, counted where the blocks call them
INT8_OPS = ("qkv_q8_dmaj", "dense_q8", "dense_q8_residual_stats",
            "dense_cm_q8_residual_stats")
REL_L2_BOUND = 5e-2  # tests/test_torch_dense_q8.py::test_dinounet_int8_matches_jax


def _load_tool(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


learn_tool = _load_tool("learnability_run_torch")
int8_tool = _load_tool("int8_accuracy_experiment_torch")


@registry.trainers.register("LearnTinyTrainer")
class LearnTinyTrainer(port_trainers.DinoUNetTrainer):
    """A DinoUNet trainer of the small model: the base class builds it from
    the injected configuration as it builds the size variants; 2 steps and
    one validation batch an epoch, from seed 0."""

    _dinov3_model_name = TINY_MODEL

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.seed = 0
        self.num_iterations_per_epoch = 2
        self.num_val_iterations_per_epoch = 1


MISSING = object()


def _class_state():
    """The trainers' own class-level injection attributes (MISSING where a
    class inherits one)."""
    classes = [port_trainers.DinoUNetTrainer, LearnTinyTrainer,
               *port_trainers.DINOV3_TRAINERS.values()]
    return {(cls, a): vars(cls).get(a, MISSING) for cls in classes for a in INJECTED}


@contextlib.contextmanager
def _restored_class_state():
    saved = _class_state()
    try:
        yield
    finally:
        for (cls, a), v in saved.items():
            if v is not MISSING:
                setattr(cls, a, v)
            elif a in vars(cls):
                delattr(cls, a)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The learnability tool's main, 1 epoch, on the CPU (see the module
    docstring): (its result, the last line of its stdout, the workdir). The
    network stays registered for the module's tests."""
    from dinounet_tpu_torch.planning.fingerprint import DatasetFingerprintExtractor

    workdir = tmp_path_factory.mktemp("learn")
    init = DatasetFingerprintExtractor.__init__
    plan = dinounet_training_torch.plan_and_preprocess

    def fast_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.num_foreground_voxels_for_intensitystats = FAST_SAMPLES

    def small_plan(*args, **kwargs):
        return plan(*args, **{**kwargs, "force_target_shape": FORCED_SHAPE})

    with pytest.MonkeyPatch.context() as mp, _restored_class_state(), \
            injected_network(TINY_SPEC):
        for var in ("nnUNet_raw", "nnUNet_preprocessed", "nnUNet_results"):
            mp.setenv(var, "")  # the tool sets them; put back after
        mp.setattr(DatasetFingerprintExtractor, "__init__", fast_init)
        mp.setattr(dinounet_training_torch, "plan_and_preprocess", small_plan)
        mp.setitem(port_trainers.DINOV3_TRAINERS, "dinounet_s", LearnTinyTrainer)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = learn_tool.main(1, str(workdir), "cpu")
        yield result, out.getvalue().strip().splitlines()[-1], str(workdir)


@pytest.fixture
def restore_trainer_state():
    with _restored_class_state():
        yield


def test_make_dataset_writes_the_jax_tools_cases(tmp_path):
    from tools.learnability_run import make_dataset as jax_make_dataset

    from dinounet_tpu_torch.imageio.natural_image import pil_image

    learn_tool.make_dataset(str(tmp_path / "port"))
    jax_make_dataset(str(tmp_path / "jax"))
    port, jax = tmp_path / "port" / "Dataset606_Learn", tmp_path / "jax" / "Dataset606_Learn"
    names = sorted(str(p.relative_to(jax)) for p in jax.rglob("*.png"))
    assert len(names) == 20
    assert sorted(str(p.relative_to(port)) for p in port.rglob("*.png")) == names
    image = pil_image()
    for name in names:
        got, want = (np.asarray(image.open(d / name)) for d in (port, jax))
        assert got.dtype == want.dtype == np.uint8 and got.shape == (512, 512)
        np.testing.assert_array_equal(got, want)
    assert (port / "dataset.json").read_text() == (jax / "dataset.json").read_text()


def test_main_runs_end_to_end_on_the_cpu(trained):
    result, line, workdir = trained
    printed = json.loads(line)
    assert set(printed) == {"metric", "value", "epochs", "workdir"}
    assert printed["metric"] == "learnability_fg_dice" and printed["epochs"] == 1
    assert printed["workdir"] == workdir and printed["value"] == result["fg_dice"]
    assert np.isfinite(result["fg_dice"])
    assert result["result_folder"] == os.path.join(
        workdir, "results", "Dataset606_Learn", "LearnTinyTrainer__nnUNetPlans__2d", "fold_0")
    (epoch,) = result["epochs"]
    assert epoch["epoch"] == 0 and np.isfinite(epoch["pseudo_dice"])
    assert np.isfinite(epoch["train_loss"]) and epoch["seconds"] > 0
    assert epoch["step_ms"] > 0 and result["peak_gib"] is None
    assert result["training_log"]["train_losses"] == [epoch["train_loss"]]
    plans = json.loads(Path(workdir, "preprocessed", "Dataset606_Learn",
                            "nnUNetPlans.json").read_text())
    assert plans["configurations"]["2d"]["patch_size"] == FORCED_SHAPE
    # the epoch report's patches are gone
    assert "train_step_host" not in vars(LearnTinyTrainer)
    assert "on_epoch_end" not in vars(LearnTinyTrainer)


def _tiny_dinounet_case(dtype: str):
    """The JAX package's small DinoUNet (tests/test_torch_dense_q8.py's, at
    `dtype`) with noisy weights, the port's model on the same weights, and
    a (2, 1, 64, 64) input."""
    import jax
    import jax.numpy as jnp

    from dinounet_tpu.models.dinounet import DinoUNet as JaxDinoUNet
    from dinounet_tpu.models.dinounet import DinoUNetConfig
    from dinounet_tpu.models.vit import ViTConfig

    from dinounet_tpu_torch.models.convert import state_dict_from_flax
    from dinounet_tpu_torch.models.dinounet import DinoUNet
    from dinounet_tpu_torch.models.dinounet import DinoUNetConfig as TConfig

    vit = dict(TINY_SPEC["vit"], dtype=dtype)
    kw = dict(interaction_indexes=(0, 1, 2, 3), num_classes=3,
              features_per_stage=(8, 16, 32, 64), n_conv_per_stage_decoder=(2, 2, 2),
              conv_bias=True, norm="instancenorm", nonlin="leaky_relu",
              nonlin_kwargs={"negative_slope": 0.01}, fapm_rank=16, conv_inplane=8,
              deform_num_heads=4, dtype=dtype)
    rng = np.random.default_rng(24)
    x = rng.standard_normal((2, 1, 64, 64)).astype(np.float32)
    jmodel = JaxDinoUNet(DinoUNetConfig(vit=ViTConfig(**vit), **kw))
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    variables = _filled(lambda: jmodel.init(jax.random.PRNGKey(0), xj[:1], train=False), rng)
    model = DinoUNet(TConfig(vit=t_vit.ViTConfig(**vit), **kw))
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jmodel, variables, xj, model.eval(), torch.from_numpy(x)


def test_part_a_weight_errors_equal_the_jax_tools():
    """fp32 weights: the errors from the levels and scales the int8 mode
    caches equal the JAX tool's formula on the same weights."""
    from tools.int8_accuracy_experiment import _quant_error_per_layer

    _, variables, _, model, x = _tiny_dinounet_case("float32")
    want = {re.sub(r"^block(\d+)/", r"blocks.\1.", k).replace("/", "."): v
            for k, v in _quant_error_per_layer(variables["params"]["backbone"]).items()}
    backbone = model.encoder.dinov3_adapter.backbone
    got = int8_tool.quant_error_per_layer(backbone)
    assert len(got) == 16 and set(got) == set(want)
    for name, err in got.items():
        assert abs(err - want[name]) <= 1e-6, name
        assert 0 < err < 0.02
    # part A's summary over the same errors; the forwards fill nothing on
    # the CPU, the cached levels are the ones quant_error_per_layer made
    summary = int8_tool.part_a("cpu", model, x)
    errs = sorted(want.values())
    assert summary["n_quantized_layers"] == 16
    assert abs(summary["weight_quant_rel_l2_median"] - errs[8]) <= 1e-6
    assert abs(summary["weight_quant_rel_l2_worst"] - errs[-1]) <= 1e-6


def test_part_a_logits_match_the_jax_forwards(monkeypatch):
    """bf16: the port's fp and int8 logits against the JAX package's own
    (its int8 chain in interpret mode), and part A's numbers from them."""
    import jax

    monkeypatch.setenv("DINOUNET_TPU_ATTN_IMPL", "pallas")
    monkeypatch.setenv("DINOUNET_TPU_DENSE_IMPL", "interpret")
    monkeypatch.setenv("DINOUNET_TPU_INT8_QKV", "1")
    monkeypatch.setenv("DINOUNET_TPU_INT8_ADAPTER", "0")
    jmodel, variables, xj, model, x = _tiny_dinounet_case("bfloat16")
    want = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("DINOUNET_TPU_VIT_INT8", flag)
        out = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, xj)
        want[flag] = np.moveaxis(np.asarray(out, np.float32), -1, 1)
    monkeypatch.delenv("DINOUNET_TPU_VIT_INT8")
    ref, q = int8_tool.fp_and_int8_logits(model, x)
    assert "DINOUNET_TPU_VIT_INT8" not in os.environ  # put back as found
    assert ref.shape == q.shape == (2, 3, 64, 64)
    for got, flag in ((ref, "0"), (q, "1")):
        assert np.all(np.isfinite(got))
        assert np.linalg.norm(got - want[flag]) / np.linalg.norm(want[flag]) <= REL_L2_BOUND
    assert not np.array_equal(ref, q)
    summary = int8_tool.part_a("cpu", model, x)
    rel = np.linalg.norm(q - ref) / np.linalg.norm(ref)
    assert summary["logit_rel_l2"] == pytest.approx(rel, rel=1e-6)
    assert summary["logit_mae"] == pytest.approx(np.abs(q - ref).mean(), rel=1e-6)
    # the class axis of NCHW logits (the JAX tool takes axis 1 of NHWC ones:
    # the image rows)
    by_class = (q.argmax(1) == ref.argmax(1)).mean()
    assert summary["argmax_agreement"] == by_class


@pytest.fixture
def int8_spies(monkeypatch):
    """Calls of the ViT blocks' int8 ops (on the CPU their plain versions
    run and no kernel launch is counted)."""
    counts = dict.fromkeys(INT8_OPS, 0)
    for name in INT8_OPS:
        def counted(*args, _fn=getattr(t_vit, name), _name=name, **kwargs):
            counts[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(t_vit, name, counted)
    return counts


def _written_dice(result) -> float:
    return result["results"]["foreground_mean"]["Dice"]


def test_part_b_revalidates_the_trained_fold(trained, int8_spies, restore_trainer_state):
    result, _, workdir = trained
    before = _class_state()
    seen = []
    dense_q8 = t_vit.dense_q8

    def watched(*args, **kwargs):
        seen.append(os.environ.get("DINOUNET_TPU_VIT_INT8"))
        return dense_q8(*args, **kwargs)

    t_vit.dense_q8 = watched
    try:
        out = int8_tool.part_b(workdir, "cpu")
    finally:
        t_vit.dense_q8 = dense_q8
    assert out["val_fg_dice_fp"] == _written_dice(result)
    assert np.isfinite(out["val_fg_dice_int8"])
    assert out["dice_delta"] == out["val_fg_dice_int8"] - out["val_fg_dice_fp"]
    # the int8 run alone called the int8 ops: 2 validation cases x 4 mirrors,
    # once a block of the 4
    assert seen == ["1"] * 2 * 4 * 4
    assert int8_spies["qkv_q8_dmaj"] == int8_spies["dense_q8_residual_stats"] == 32
    assert int8_spies["dense_cm_q8_residual_stats"] == 32
    assert _class_state() == before
    assert "DINOUNET_TPU_VIT_INT8" not in os.environ


def test_part_b_after_another_trainers_injection(trained, restore_trainer_state):
    """dinounet_b's configuration injected (as the api phase of a smoke run
    leaves it): part B still builds the folder's small network, and leaves
    dinounet_b's injection as it found it."""
    from dinounet_tpu_torch.training.dinounet_trainer import (DinoUNetTrainer,
                                                              DinoUNetTrainer_b)

    result, _, workdir = trained
    other = {"architecture": dict(TINY_SPEC["architecture"],
                                  features_per_stage=[16, 32, 64, 128])}
    DinoUNetTrainer_b.set_network_config(other)
    assert DinoUNetTrainer._dinov3_model_name == "dinounet_b"
    before = _class_state()
    built = []
    build = DinoUNetTrainer.build_network_architecture.__func__

    def recorded(cls, *args, **kwargs):
        network = build(cls, *args, **kwargs)
        built.append(network.cfg)
        return network

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DinoUNetTrainer, "build_network_architecture", classmethod(recorded))
        out = int8_tool.part_b(workdir, "cpu")
    assert out["val_fg_dice_fp"] == _written_dice(result)
    plans = json.loads(Path(workdir, "preprocessed", "Dataset606_Learn",
                            "nnUNetPlans.json").read_text())
    features = plans["configurations"]["2d"]["architecture"]["arch_kwargs"][
        "features_per_stage"]
    assert built and all(cfg.vit.embed_dim == 64 and list(cfg.features_per_stage)
                         == features for cfg in built)
    assert _class_state() == before
    assert DinoUNetTrainer._network_config is other


def test_tools_main_prints_the_jax_tools_keys(trained, monkeypatch, capsys,
                                              restore_trainer_state):
    """The int8 tool's command line: part B's JSON line has the JAX tool's
    keys."""
    _, _, workdir = trained
    out = int8_tool.main(["--trained", workdir, "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert set(line) == {"metric", "val_fg_dice_fp", "val_fg_dice_int8", "dice_delta"}
    assert line["metric"] == "int8_accuracy_bounds"
