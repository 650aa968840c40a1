"""The port's Python API and end-to-end CLI against the JAX package's, on the
CPU.

* ``api.plan_and_preprocess`` with the CLI's arguments (forced 512 x 512, 4
  stages, the 2d configuration) returns the JAX package's
  ``network_configurations``; a second call takes the "already completed"
  path and fingerprints nothing.
* ``api.training``, both branches (a registered trainer's name; a class with
  ``initial_lr`` / ``num_epochs`` / ``batch_size``), trains a small DinoUNet
  trainer for 2 steps on the CPU and ends in the final validation: the
  returned training log, and a ``summary.json`` equal to the JAX package's
  ``compute_metrics_on_folder`` on the port's validation folder.
* ``api.evaluate`` returns the JAX ``api.evaluate``'s dict on the same folders.
* ``dinounet_training_torch.main_dinov3(..., device="cpu")`` runs from raw
  PNG files to ``evaluate`` with ``DINOV3_TRAINERS["dinounet_s"]`` swapped for
  the small trainer; ``main``'s flags are the JAX ``main``'s.
* ``set_network_config`` / ``build_network_architecture`` give the JAX
  trainer's ``DinoUNetConfig`` fields, with and without an injection.

``restore_trainer_state`` puts the trainers' class-level injection back after
each test, so that later tests in the same process build their own networks.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from dinounet_tpu_torch.models.dinounet import DinoUNet as TorchDinoUNet
from dinounet_tpu_torch.models.dinounet import DinoUNetConfig as TorchConfig
from dinounet_tpu_torch.models.vit import ViTConfig as TorchViTConfig
from dinounet_tpu_torch.training import dinounet_trainer as port_trainers
from dinounet_tpu_torch.utilities import registry
from tests.helpers import make_png_dataset
from tests.test_torch_models import CFG_KW, VIT_KW
from tests.test_torch_planning import fast_fingerprints  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
DATASET_ID, DATASET = 501, "Dataset501_Toy2d"
CLI_KW = dict(verify_dataset_integrity=True, force_target_shape=[512, 512],
              force_n_stages=4, configurations=["2d"], verbose=False,
              force_rerun=False)
# the small set the API trains on: 64 x 64 after resampling, one tile
TINY_KW = dict(CLI_KW, force_target_shape=[64, 64])
INJECTED = ("_network_config", "_dinov3_model_name", "_dinov3_pretrained_path")


@registry.trainers.register("ApiTinyDinoUNetTrainer")
class ApiTinyDinoUNetTrainer(port_trainers.DinoUNetTrainer):
    """The small DinoUNet of tests/test_torch_models.py, 1 epoch of 2 steps;
    `last` is the last one built."""

    last = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        ApiTinyDinoUNetTrainer.last = self
        self.seed = 0
        self.num_epochs = 1
        self.num_iterations_per_epoch = 2
        self.num_val_iterations_per_epoch = 1

    @classmethod
    def build_network_architecture(cls, architecture_class_name, arch_init_kwargs,
                                   arch_init_kwargs_req_import, num_input_channels,
                                   num_output_channels, enable_deep_supervision=True):
        return TorchDinoUNet(TorchConfig(vit=TorchViTConfig(**VIT_KW),
                                         deep_supervision=enable_deep_supervision,
                                         **CFG_KW))


def _trainer_classes(base):
    out, todo = [], [base]
    while todo:
        cls = todo.pop()
        out.append(cls)
        todo.extend(cls.__subclasses__())
    return out


@pytest.fixture(autouse=True)
def restore_trainer_state():
    """Both packages' DinoUNet trainers get their class-level network
    configuration, model name and checkpoint path back after the test."""
    from dinounet_tpu.training import dinounet_trainer as jax_trainers

    classes = (_trainer_classes(port_trainers.DinoUNetTrainer)
               + _trainer_classes(jax_trainers.DinoUNetTrainer))
    saved = [(cls, {a: vars(cls)[a] for a in INJECTED if a in vars(cls)})
             for cls in classes]
    yield
    for cls, attrs in saved:
        for a in INJECTED:
            if a in attrs:
                setattr(cls, a, attrs[a])
            elif a in vars(cls):
                delattr(cls, a)


def _env(root: str, mp) -> None:
    for sub, var in (("raw", "nnUNet_raw"), ("pre", "nnUNet_preprocessed"),
                     ("res", "nnUNet_results")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        mp.setenv(var, os.path.join(root, sub))


def _same(a, b) -> bool:
    """Equality of JSON-like trees, NaN equal to NaN."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_plan_and_preprocess_matches_jax(tmp_path, monkeypatch,
                                         fast_fingerprints):  # noqa: F811
    from dinounet_tpu import api as jax_api

    from dinounet_tpu_torch import api

    configs = {}
    for name, module in (("jax", jax_api), ("port", api)):
        _env(str(tmp_path / name), monkeypatch)
        make_png_dataset(str(tmp_path / name / "raw"), n_cases=4)
        assert not module._check_preprocessing_completed(DATASET_ID, "nnUNetPlans", ["2d"])
        configs[name] = module.plan_and_preprocess(DATASET_ID, **CLI_KW)
        assert module._check_preprocessing_completed(DATASET_ID, "nnUNetPlans", ["2d"])
    assert configs["port"] == configs["jax"]
    plans_identifier, network_configs = configs["port"]
    assert plans_identifier == "nnUNetPlans" and list(network_configs) == ["2d"]
    cfg = network_configs["2d"]
    assert cfg["architecture"]["n_stages"] == 4
    assert cfg["data_config"]["patch_size"] == [512, 512]
    assert cfg["data_config"]["batch_size"] == 2

    def no_fingerprints(*args, **kwargs):
        raise AssertionError("the completed dataset was fingerprinted again")

    monkeypatch.setattr(api, "extract_fingerprints", no_fingerprints)
    assert api.plan_and_preprocess(DATASET_ID, **CLI_KW) == configs["port"]


@pytest.fixture(scope="module")
def planned(tmp_path_factory):
    """tests/helpers.py's PNG set planned and preprocessed by the port's
    api.plan_and_preprocess (64 x 64, 4 stages), under a module-wide
    nnUNet_* environment."""
    from dinounet_tpu_torch import api

    root = str(tmp_path_factory.mktemp("api"))
    with pytest.MonkeyPatch.context() as mp:
        _env(root, mp)
        make_png_dataset(os.path.join(root, "raw"), n_cases=6)
        api.plan_and_preprocess(DATASET_ID, **TINY_KW)
        yield root, mp


def _assert_jax_summary(root: str, output_folder: str) -> str:
    """The trainer's validation summary.json equals the JAX package's
    compute_metrics_on_folder on the same folder; returns the folder."""
    from dinounet_tpu.evaluation.metrics import compute_metrics_on_folder
    from dinounet_tpu.imageio.natural_image import NaturalImage2DIO

    val = os.path.join(output_folder, "validation")
    want = os.path.join(root, "jax_summary.json")
    compute_metrics_on_folder(os.path.join(root, "pre", DATASET, "gt_segmentations"),
                              val, want, NaturalImage2DIO(), ".png", [1, 2], None,
                              num_processes=1)
    assert Path(val, "summary.json").read_text() == Path(want).read_text()
    return val


@pytest.fixture(scope="module")
def trained_by_name(planned):
    from dinounet_tpu_torch import api

    root, _ = planned
    return api.training(DATASET_ID, "2d", 0, trainer_class="ApiTinyDinoUNetTrainer",
                        device="cpu")


def test_training_by_registered_name(planned, trained_by_name):
    from dinounet_tpu_torch import api

    root, _ = planned
    output_folder, log = trained_by_name
    assert output_folder == os.path.join(
        root, "res", DATASET, "ApiTinyDinoUNetTrainer__nnUNetPlans__2d", "fold_0")
    assert log["epochs"] == [0]
    assert len(log["train_losses"]) == len(log["val_losses"]) == 1
    assert np.all(np.isfinite(log["train_losses"] + log["val_losses"]))
    assert log["lrs"] == [1e-2]
    _assert_jax_summary(root, output_folder)
    from_disk = api._load_training_log_from_folder(output_folder)
    assert from_disk == {k: log[k] for k in ("epochs", "train_losses", "val_losses")}


def test_training_with_custom_hyperparameters(planned):
    """The custom branch builds the trainer itself, on the device asked for
    (a CUDA trainer would raise here), with the learning rate, epochs and
    batch size given."""
    from dinounet_tpu_torch import api

    root, _ = planned
    output_folder, log = api.training(DATASET_ID, "2d", 1, ApiTinyDinoUNetTrainer,
                                      device="cpu", initial_lr=1e-3, num_epochs=1,
                                      batch_size=3)
    assert output_folder.endswith(os.path.join(
        "ApiTinyDinoUNetTrainer__nnUNetPlans__2d", "fold_1"))
    assert log["lrs"] == [1e-3] and log["epochs"] == [0]
    assert np.all(np.isfinite(log["train_losses"] + log["val_losses"]))
    trainer = ApiTinyDinoUNetTrainer.last
    assert trainer.output_folder == output_folder and trainer.device.type == "cpu"
    assert trainer.configuration_manager.batch_size == 3
    assert trainer.dataloader_train.generate_train_batch()["data"].shape[0] == 3
    _assert_jax_summary(root, output_folder)


def test_evaluate_matches_jax(planned, trained_by_name, tmp_path):
    from dinounet_tpu import api as jax_api

    from dinounet_tpu_torch import api

    output_folder, _ = trained_by_name
    written = Path(output_folder, "validation", "summary.json").read_text()
    want = jax_api.evaluate(DATASET_ID, output_folder, output_file=str(tmp_path / "j.json"),
                            num_processes=1)
    got = api.evaluate(DATASET_ID, output_folder, output_file=str(tmp_path / "p.json"),
                       num_processes=2)
    assert _same(got, want)
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    # the default output is the validation folder's summary.json, rewritten
    assert _same(api.evaluate(DATASET_ID, output_folder), want)
    assert Path(output_folder, "validation", "summary.json").read_text() == written


def test_main_dinov3_runs_end_to_end_on_the_cpu(tmp_path, monkeypatch,
                                                 fast_fingerprints):  # noqa: F811
    import dinounet_training_torch as cli

    from dinounet_tpu_torch.evaluation.metrics import load_summary_json

    _env(str(tmp_path), monkeypatch)
    make_png_dataset(str(tmp_path / "raw"), n_cases=4)
    monkeypatch.setitem(port_trainers.DINOV3_TRAINERS, "dinounet_s",
                        ApiTinyDinoUNetTrainer)
    written = {}
    evaluate = cli.evaluate

    def evaluate_after_reading(dataset_id, result_folder):
        written["summary"] = load_summary_json(
            os.path.join(result_folder, "validation", "summary.json"))
        return evaluate(dataset_id=dataset_id, result_folder=result_folder)

    monkeypatch.setattr(cli, "evaluate", evaluate_after_reading)
    result_folder, log, results = cli.main_dinov3("dinounet_s", DATASET_ID, num_epochs=1,
                                                  device="cpu")
    assert result_folder == str(tmp_path / "res" / DATASET
                                / "ApiTinyDinoUNetTrainer__nnUNetPlans__2d" / "fold_0")
    assert len(log["train_losses"]) == 1 and np.isfinite(log["train_losses"][0])
    assert log["lrs"] == [1e-3]
    assert _same(results, written["summary"])
    assert np.isfinite(results["foreground_mean"]["Dice"])
    plans = json.loads((tmp_path / "pre" / DATASET / "nnUNetPlans.json").read_text())
    assert plans["configurations"]["2d"]["patch_size"] == [512, 512]
    injected = port_trainers.DinoUNetTrainer._network_config
    assert injected["architecture"]["n_stages"] == 4
    assert injected["data_config"]["patch_size"] == [512, 512]
    assert os.path.isfile(os.path.join(result_folder, "checkpoint_final.pth"))


def _load_script(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_main(module, argv, monkeypatch):
    """Run `module.main()` with `argv`; returns its parser's actions and the
    keyword arguments main_dinov3 got."""
    calls, parsers = [], []
    parse_args = argparse.ArgumentParser.parse_args

    def recording_parse_args(self, *args, **kwargs):
        parsers.append(self)
        return parse_args(self, *args, **kwargs)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", recording_parse_args)
    monkeypatch.setattr(module, "main_dinov3", lambda **kw: calls.append(kw))
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    module.main()
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    (parser,), (kwargs,) = parsers, calls
    actions = [(a.option_strings, a.dest, a.default, a.choices, a.type, a.nargs,
                a.required) for a in parser._actions]
    return actions, kwargs


@pytest.mark.parametrize("argv", [[], ["--model", "dinounet_b", "--datasetid", "3",
                                       "--epoch", "2", "--gpuid", "1"]])
def test_main_flags_match_jax(monkeypatch, argv):
    jax_cli = _load_script(REPO / "dinounet_training.py", "_jax_dinounet_training")
    port_cli = _load_script(REPO / "dinounet_training_torch.py", "_port_dinounet_training")
    want_actions, want = _run_main(jax_cli, argv, monkeypatch)
    got_actions, got = _run_main(port_cli, argv, monkeypatch)
    assert got_actions == want_actions
    assert ("--model" in argv) == (want["model_name"] == "dinounet_b")
    assert got == dict(want, device="cuda:1" if "--gpuid" in argv else "cuda:0")
    assert [a for a in got_actions if a[1] == "model"][0][3] == [
        "dinounet_7b", "dinounet_b", "dinounet_l", "dinounet_s"]


def _config_fields(cfg) -> dict:
    """The port's DinoUNetConfig fields (the JAX config's also holds the
    plans' kernel sizes and strides, which the port's decoder does not
    read), the ViT config's as a dict."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(TorchConfig)}
    out["vit"] = {f.name: getattr(cfg.vit, f.name) for f in dataclasses.fields(TorchViTConfig)}
    return out


ARCH = {"n_stages": 4, "features_per_stage": [32, 64, 128, 256],
        "kernel_sizes": [[3, 3]] * 4, "strides": [[1, 1], [2, 2], [2, 2], [2, 2]],
        "n_conv_per_stage": [2, 2, 2, 2], "n_conv_per_stage_decoder": [2, 2, 2],
        "conv_bias": True, "norm_op": "torch.nn.modules.instancenorm.InstanceNorm2d",
        "norm_op_kwargs": {"eps": 1e-05, "affine": True}, "nonlin": "torch.nn.LeakyReLU",
        "nonlin_kwargs": {"inplace": True}}
# the injected network configuration: another width and one decoder conv a
# stage, so that a build from the plans' own architecture would differ
INJECTED_CONFIG = {"architecture": {**ARCH, "features_per_stage": [16, 32, 64, 128],
                                    "n_conv_per_stage_decoder": [1, 1, 1]},
                   "data_config": {"batch_size": 2, "patch_size": [512, 512]}}
# injection case -> (the class injected into, set_network_config's model name)
INJECTIONS = {"none": None, "into_b": ("DinoUNetTrainer_b", None),
              "into_s_as_l": ("DinoUNetTrainer_s", "dinounet_l"),
              "into_base": ("DinoUNetTrainer", None)}


@pytest.mark.parametrize("injection", sorted(INJECTIONS))
def test_network_config_injection_matches_jax(monkeypatch, injection):
    """After an injection every DinoUNet trainer builds the same network
    configuration in both packages: the injected architecture with the
    injected model. Without one, each port trainer builds the plans'
    architecture with its own model; the JAX trainers' static builder reads
    the base class's model name (dinounet_s) for every size, so there the
    two agree on all but the backbone."""
    from dinounet_tpu.training import dinounet_trainer as jax_trainers

    built = {}
    for name, module in (("jax", jax_trainers), ("port", port_trainers)):
        monkeypatch.setattr(module, "DinoUNet", lambda cfg: cfg)
        if INJECTIONS[injection] is not None:
            target, model_name = INJECTIONS[injection]
            getattr(module, target).set_network_config(INJECTED_CONFIG,
                                                       dinov3_model_name=model_name)
        built[name] = {
            trainer: _config_fields(getattr(module, trainer).build_network_architecture(
                "PlainConvUNet", dict(ARCH), [], 1, 3, False))
            for trainer in ("DinoUNetTrainer", "DinoUNetTrainer_s", "DinoUNetTrainer_b",
                            "DinoUNetTrainer_l")}
    widths = {t: c["vit"]["embed_dim"] for t, c in built["port"].items()}
    features = {c["features_per_stage"] for c in built["port"].values()}
    if injection == "none":
        backbone = ("vit", "interaction_indexes")
        for trainer, got in built["port"].items():
            want = built["jax"][trainer]
            assert ({k: v for k, v in got.items() if k not in backbone}
                    == {k: v for k, v in want.items() if k not in backbone})
            assert (got == want) == (trainer in ("DinoUNetTrainer", "DinoUNetTrainer_s"))
        assert widths == {"DinoUNetTrainer": 384, "DinoUNetTrainer_s": 384,
                          "DinoUNetTrainer_b": 768, "DinoUNetTrainer_l": 1024}
        assert features == {(32, 64, 128, 256)}
    else:
        assert built["port"] == built["jax"]
        want = {"into_b": 768, "into_s_as_l": 1024, "into_base": 384}[injection]
        assert set(widths.values()) == {want}
        assert features == {(16, 32, 64, 128)}


def test_get_dinov3_trainer():
    from dinounet_tpu.training import dinounet_trainer as jax_trainers

    assert sorted(port_trainers.DINOV3_TRAINERS) == sorted(jax_trainers.DINOV3_TRAINERS)
    for name, cls in port_trainers.DINOV3_TRAINERS.items():
        assert port_trainers.get_dinov3_trainer(name) is cls
        assert cls.__name__ == jax_trainers.get_dinov3_trainer(name).__name__
        assert registry.trainers.get(cls.__name__) is cls
    with pytest.raises(ValueError):
        port_trainers.get_dinov3_trainer("dinounet_xl")
    # every size reads the published .pth, or the JAX package's .msgpack of
    # the same stem where the .pth is missing (dinounet_7b included)
    for name, cls in port_trainers.DINOV3_TRAINERS.items():
        jax_path = jax_trainers.get_dinov3_trainer(name)._dinov3_pretrained_path
        assert cls._dinov3_pretrained_path == jax_path[:-len(".msgpack")] + ".pth"
