"""The port's path from raw files to segmentation files, on the CPU, against
the JAX package.

* Prediction from files: both packages' ``nnUNetPredictor`` get
  ``manual_initialization`` on the same weights (the small DinoUNet of
  tests/test_torch_models.py, carried over by ``state_dict_from_flax``), fp32,
  and predict the same raw PNG files with mirror TTA and the probabilities
  saved. The segmentation files must agree on at least 99.9 % of the pixels
  (argmax near-ties) and the probabilities within 1e-4.
* Training to validation: the port preprocesses the PNG dataset from a plans
  file the JAX planner wrote (tiny patch and network), ``run.run_training``
  trains a small DinoUNet trainer for 2 steps and ends in
  ``perform_actual_validation``; its ``summary.json`` must equal the JAX
  package's ``compute_metrics_on_folder`` on the port's validation folder.
  ``initialize_from_trained_model_folder`` on the port's
  ``checkpoint_final.pth`` must predict the same files as
  ``manual_initialization`` on the trained weights, as must both prediction
  CLIs, ``predict_single_npy_array`` and ``predict_from_list_of_npy_arrays``;
  the training CLI's validation-only run repeats the validation;
  ``load_pretrained_weights`` moves every weight but the segmentation head.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dinounet_tpu_torch.inference.predictor import nnUNetPredictor
from dinounet_tpu_torch.models.dinounet import DinoUNet as TorchDinoUNet
from dinounet_tpu_torch.models.dinounet import DinoUNetConfig as TorchConfig
from dinounet_tpu_torch.models.vit import ViTConfig as TorchViTConfig
from dinounet_tpu_torch.training.dinounet_trainer import DinoUNetTrainer
from dinounet_tpu_torch.utilities import registry
from dinounet_tpu_torch.utilities.json_export import load_json
from dinounet_tpu_torch.utilities.plans_handler import PlansManager
from tests.test_torch_models import CFG_KW, VIT_KW, _jax_config, _torch_model  # noqa: F401
from tests.test_torch_models import variables  # noqa: F401
from tests.test_torch_preprocessing import planned_png_dataset
from tests.torch_threads import one_torch_thread  # noqa: F401

DATASET = "Dataset501_Toy2d"
SEG_AGREEMENT = 0.999
PROBABILITY_ATOL = 1e-4


@registry.trainers.register("PipelineTinyDinoUNetTrainer")
class PipelineTinyDinoUNetTrainer(DinoUNetTrainer):
    """The small DinoUNet of tests/test_torch_models.py, 1 epoch of 2 steps."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
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


def _env(root: str, monkeypatch) -> None:
    for sub in ("raw", "pre", "res"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    monkeypatch.setenv("nnUNet_raw", os.path.join(root, "raw"))
    monkeypatch.setenv("nnUNet_preprocessed", os.path.join(root, "pre"))
    monkeypatch.setenv("nnUNet_results", os.path.join(root, "res"))


def _raw_cases(root: str, n: int):
    images = os.path.join(root, "raw", DATASET, "imagesTr")
    return [[os.path.join(images, f)] for f in sorted(os.listdir(images))[:n]]


def _read_png(path: str) -> np.ndarray:
    from dinounet_tpu_torch.imageio.natural_image import NaturalImage2DIO

    return NaturalImage2DIO().read_seg(path)[0]


def _assert_same_outputs(folder_a: str, folder_b: str, names) -> None:
    for n in names:
        np.testing.assert_array_equal(_read_png(os.path.join(folder_a, n + ".png")),
                                      _read_png(os.path.join(folder_b, n + ".png")))
        np.testing.assert_array_equal(np.load(os.path.join(folder_a, n + ".npz"))["probabilities"],
                                      np.load(os.path.join(folder_b, n + ".npz"))["probabilities"])


def test_predict_from_files_matches_jax(tmp_path, monkeypatch, variables):  # noqa: F811
    from dinounet_tpu.inference.predictor import nnUNetPredictor as JaxPredictor
    from dinounet_tpu.models.dinounet import DinoUNet
    from dinounet_tpu.utilities.plans_handler import PlansManager as JaxPlans

    _env(str(tmp_path), monkeypatch)
    plans = load_json(planned_png_dataset(str(tmp_path), n_cases=2))
    dataset_json = load_json(str(tmp_path / "raw" / DATASET / "dataset.json"))
    cases = _raw_cases(str(tmp_path), 2)

    jpm = JaxPlans(plans)
    jp = JaxPredictor(tile_step_size=0.5, use_mirroring=True, tile_batch=4)
    jp.manual_initialization(DinoUNet(_jax_config()), jpm, jpm.get_configuration("2d"),
                             [variables], dataset_json, "nnUNetTrainer", (0, 1))
    jp.predict_from_files(cases, str(tmp_path / "jax"), save_probabilities=True,
                          num_processes_preprocessing=1,
                          num_processes_segmentation_export=1)

    pm = PlansManager(plans)
    p = nnUNetPredictor(tile_step_size=0.5, use_mirroring=True, device="cpu",
                        tile_batch=4)
    p.manual_initialization(_torch_model(variables), pm, pm.get_configuration("2d"), None,
                            dataset_json, "nnUNetTrainer", (0, 1))
    written = p.predict_from_files(cases, str(tmp_path / "port"), save_probabilities=True,
                                   num_processes_preprocessing=2,
                                   num_processes_segmentation_export=2)
    names = ["case_000", "case_001"]
    assert written == [str(tmp_path / "port" / n) for n in names]
    for n in names:
        got = _read_png(str(tmp_path / "port" / (n + ".png")))
        want = _read_png(str(tmp_path / "jax" / (n + ".png")))
        assert got.shape == want.shape == (1, 1, 72, 64)
        agree = float(np.mean(got == want))
        assert agree >= SEG_AGREEMENT, (n, agree)
        pg = np.load(tmp_path / "port" / (n + ".npz"))["probabilities"]
        pw = np.load(tmp_path / "jax" / (n + ".npz"))["probabilities"]
        assert pg.dtype == pw.dtype and pg.shape == pw.shape == (3, 1, 72, 64)
        np.testing.assert_allclose(pg, pw, rtol=0, atol=PROBABILITY_ATOL)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's preprocess_dataset and run.run_training on the planned PNG
    dataset (fold 0), under a module-wide nnUNet_* environment."""
    from dinounet_tpu_torch.planning.plan_and_preprocess_api import preprocess_dataset
    from dinounet_tpu_torch.run import run_training

    root = str(tmp_path_factory.mktemp("pipeline"))
    with pytest.MonkeyPatch.context() as mp:
        _env(root, mp)
        planned_png_dataset(root)
        preprocess_dataset(501, configurations=["2d"], num_processes=[2])
        trainer = run_training(501, "2d", 0, "PipelineTinyDinoUNetTrainer", device="cpu")
        yield root, trainer


def test_run_training_ends_in_validation_with_the_jax_summary(trained):
    from dinounet_tpu.evaluation.metrics import compute_metrics_on_folder
    from dinounet_tpu.imageio.natural_image import NaturalImage2DIO

    root, trainer = trained
    val = os.path.join(trainer.output_folder, "validation")
    _, val_keys = trainer.do_split()
    assert len(val_keys) == 2
    assert sorted(os.listdir(val)) == sorted([k + ".png" for k in val_keys] + ["summary.json"])
    for k in val_keys:
        seg = _read_png(os.path.join(val, k + ".png"))
        assert seg.shape == (1, 1, 72, 64) and set(np.unique(seg)) <= {0, 1, 2}
    gt = os.path.join(root, "pre", DATASET, "gt_segmentations")
    want = os.path.join(root, "jax_summary.json")
    compute_metrics_on_folder(gt, val, want, NaturalImage2DIO(), ".png", [1, 2], None,
                              num_processes=1)
    with open(want) as f, open(os.path.join(val, "summary.json")) as g:
        assert g.read() == f.read()


def test_model_folder_predicts_as_the_trained_weights(trained, tmp_path, monkeypatch):
    """initialize_from_trained_model_folder on the trainer's
    checkpoint_final.pth, manual_initialization on its weights and the
    model-folder CLI write the same files."""
    from dinounet_tpu_torch.inference import predictor as predictor_module
    from dinounet_tpu_torch.training.checkpointing import load_checkpoint

    root, trainer = trained
    checkpoint = load_checkpoint(os.path.join(trainer.output_folder, "checkpoint_final.pth"))
    assert checkpoint["trainer_name"] == "PipelineTinyDinoUNetTrainer"
    assert checkpoint["init_args"]["configuration"] == "2d"
    assert checkpoint["inference_allowed_mirroring_axes"] == (0, 1)
    cases = _raw_cases(root, 2)
    names = ["case_000", "case_001"]

    # every predictor here runs at the CLIs' tile batch (nnUNetPredictor's
    # default, which the CLIs do not set): the bf16 CPU convs may round
    # differently at another batch, and the files are compared bit for bit
    from_folder = nnUNetPredictor(device="cpu")
    from_folder.initialize_from_trained_model_folder(trainer.output_folder_base, None)
    assert from_folder.allowed_mirroring_axes == (0, 1)
    from_folder.predict_from_files(cases, str(tmp_path / "folder"), save_probabilities=True)

    manual = nnUNetPredictor(device="cpu")
    network = PipelineTinyDinoUNetTrainer.build_network_architecture(
        None, {}, None, 1, 3, enable_deep_supervision=False)
    manual.manual_initialization(network, trainer.plans_manager,
                                 trainer.configuration_manager,
                                 [trainer.network.state_dict()], trainer.dataset_json,
                                 "PipelineTinyDinoUNetTrainer", (0, 1))
    manual.predict_from_files(cases, str(tmp_path / "manual"), save_probabilities=True)
    _assert_same_outputs(str(tmp_path / "folder"), str(tmp_path / "manual"), names)

    inputs = tmp_path / "inputs"
    inputs.mkdir()
    for (f,) in cases:
        os.symlink(f, inputs / os.path.basename(f))
    monkeypatch.setattr(sys, "argv", [
        "predict", "-i", str(inputs), "-o", str(tmp_path / "cli"), "-m",
        trainer.output_folder_base, "-f", "0", "--save_probabilities", "-npp", "1",
        "-nps", "1", "-device", "cpu"])
    predictor_module.predict_entry_point_modelfolder()
    _assert_same_outputs(str(tmp_path / "folder"), str(tmp_path / "cli"), names)

    # the dataset-name CLI, through nnUNet_results
    monkeypatch.setenv("nnUNet_results", os.path.join(root, "res"))
    monkeypatch.setattr(sys, "argv", [
        "predict", "-i", str(inputs), "-o", str(tmp_path / "cli_d"), "-d", "501",
        "-tr", "PipelineTinyDinoUNetTrainer", "-c", "2d", "-f", "0",
        "--save_probabilities", "-device", "cpu"])
    predictor_module.predict_entry_point()
    _assert_same_outputs(str(tmp_path / "folder"), str(tmp_path / "cli_d"), names)

    # the cases as arrays: the same segmentations and probabilities
    from dinounet_tpu_torch.imageio.natural_image import NaturalImage2DIO

    images = [NaturalImage2DIO().read_images(f) for f in cases]
    seg, probs = from_folder.predict_single_npy_array(images[0][0], dict(images[0][1]),
                                                      None, None, True)
    np.testing.assert_array_equal(seg, _read_png(str(tmp_path / "folder" / "case_000.png"))[0])
    np.testing.assert_array_equal(
        probs, np.load(tmp_path / "folder" / "case_000.npz")["probabilities"])
    arrays = tmp_path / "arrays"
    arrays.mkdir()
    written = from_folder.predict_from_list_of_npy_arrays(
        [i for i, _ in images], None, [p for _, p in images],
        [str(arrays / n) for n in names], num_processes=2, save_probabilities=True)
    assert written == [str(arrays / n) for n in names]
    _assert_same_outputs(str(tmp_path / "folder"), str(arrays), names)


def test_training_cli_validation_only_repeats_the_validation(trained, monkeypatch):
    """run_training_entry --val: the trainer restored from
    checkpoint_final.pth validates again, to the same files and summary."""
    from dinounet_tpu_torch.run import run_training_entry

    root, trainer = trained
    val = os.path.join(trainer.output_folder, "validation")
    before = {f: Path(val, f).read_bytes() if f.endswith(".json")
              else _read_png(os.path.join(val, f)) for f in os.listdir(val)}
    _env(root, monkeypatch)
    monkeypatch.setattr(sys, "argv", ["train", "501", "2d", "0", "-tr",
                                      "PipelineTinyDinoUNetTrainer", "--val",
                                      "-device", "cpu"])
    run_training_entry()
    assert sorted(os.listdir(val)) == sorted(before)
    for f, want in before.items():
        path = os.path.join(val, f)
        if f.endswith(".json"):
            assert Path(path).read_bytes() == want
        else:
            np.testing.assert_array_equal(_read_png(path), want)


def test_load_pretrained_weights_skips_the_segmentation_head(trained):
    from dinounet_tpu_torch.run import get_trainer_from_args, load_pretrained_weights

    root, trainer = trained
    with pytest.MonkeyPatch.context() as mp:
        _env(root, mp)
        fresh = get_trainer_from_args(501, "2d", 0, "PipelineTinyDinoUNetTrainer",
                                      device="cpu")
        fresh.seed = 1
        fresh.initialize()
        before = {k: v.clone() for k, v in fresh.network.state_dict().items()}
        load_pretrained_weights(fresh, os.path.join(trainer.output_folder,
                                                    "checkpoint_final.pth"))
    trained_state = trainer.network.state_dict()
    seg_names = [k for k in before if any("seg" in p for p in k.split("."))]
    assert seg_names
    for name, t in fresh.network.state_dict().items():
        want = before[name] if name in seg_names else trained_state[name]
        assert torch.equal(t, want), name


def test_unported_options_raise(trained, tmp_path):
    """What was once refused is ported: striding the cases over
    ``num_parts``, the cascade's previous-stage files and the model axis
    itself (multi-GPU training, in tests/test_torch_parallel.py): a
    trainer's DinoUNet builds its backbone's blocks as the rank's shards,
    and in the int8 serving mode as in bf16 their row-parallel projections
    go to the model group's collectives (no longer a refusal), which a
    process with no process group cannot reach; the two-rank int8 runs are
    in tests/test_torch_parallel.py."""
    from dinounet_tpu_torch.parallel.sharding import ModelShard

    root, trainer = trained
    p = nnUNetPredictor(device="cpu")
    p.initialize_from_trained_model_folder(trainer.output_folder_base, (0,))
    cases = _raw_cases(root, 1)
    # part 1 of 2 of one case holds none; a part outside them raises
    assert p.predict_from_files(cases, str(tmp_path / "o"), num_parts=2, part_id=1) == []
    with pytest.raises(ValueError, match="part"):
        p.predict_from_files(cases, str(tmp_path / "o"), num_parts=2, part_id=2)
    # the cascade is ported: each case is paired with its previous stage's file
    _, _, prev = p._manage_input_and_output_lists(cases, str(tmp_path / "o"), str(tmp_path))
    ending = p.dataset_json["file_ending"]
    assert prev == [str(tmp_path / (os.path.basename(c[0])[:-(len(ending) + 5)] + ending))
                    for c in cases]
    network = DinoUNetTrainer.build_network("cpu", trainer.configuration_manager, 1, 3,
                                            seed=0, shard=ModelShard(0, 2))
    C = network.cfg.vit.embed_dim
    blocks = network.encoder.dinov3_adapter.backbone.blocks
    assert tuple(blocks[0].attn.qkv.weight.shape) == (3 * C // 2, C)
    assert tuple(blocks[0].mlp.fc2.weight.shape) == (C, network.cfg.vit.ffn_hidden // 2)
    x = torch.zeros((1, 1, *trainer.configuration_manager.patch_size))
    for int8 in ("0", "1"):
        with pytest.MonkeyPatch.context() as mp, torch.no_grad():
            mp.setenv("DINOUNET_TPU_VIT_INT8", int8)
            with pytest.raises(ValueError, match="process group"):
                network.eval()(x)
