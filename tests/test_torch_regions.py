"""Region-based training in the port vs the JAX trainer, on the CPU.

Labels declared as overlapping regions (``whole`` = {1, 2}, ``inner`` = {2},
``regions_class_order`` [1, 2], as ``tests/test_training_e2e.py::
test_region_based_training``), with and without an ignore label. On the same
logits and label maps the port's trainer and the JAX trainer make the same
region targets (exactly), the same DC+BCE loss (fp32, rtol 1e-5: the same
sums in another order) and the same validation counts of sigmoid > 0.5
(exactly). Then a small DinoUNet trainer trains, validates and exports a
region-labelled PNG set end to end.
"""

import functools
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinounet_tpu_torch.models.dinounet import DinoUNet as TorchDinoUNet
from dinounet_tpu_torch.models.dinounet import DinoUNetConfig as TorchConfig
from dinounet_tpu_torch.models.vit import ViTConfig as TorchViTConfig
from dinounet_tpu_torch.training.dinounet_trainer import DinoUNetTrainer
from dinounet_tpu_torch.training.trainer import nnUNetTrainer
from dinounet_tpu_torch.utilities import registry
from dinounet_tpu_torch.utilities.label_handling import LabelManager
from tests.helpers import make_png_dataset
from tests.test_torch_api import TINY_KW
from tests.test_torch_models import CFG_KW, VIT_KW
from tests.test_torch_planning import fast_fingerprints  # noqa: F401

REGION_LABELS = {"background": 0, "whole": [1, 2], "inner": [2]}
ORDER = [1, 2]


def _labels(ignore: bool) -> dict:
    return {**REGION_LABELS, "ignore": 3} if ignore else dict(REGION_LABELS)


def _port_trainer(labels: dict, batch_dice: bool, logits: torch.Tensor):
    """The state the port trainer's loss and validation step read, around
    a network that returns `logits`."""
    class Fixed:
        def eval(self):
            pass

        def __call__(self, x):
            return logits

    ns = SimpleNamespace(label_manager=LabelManager(labels, ORDER),
                         configuration_manager=SimpleNamespace(batch_dice=batch_dice),
                         network=Fixed(), is_cascaded=False)
    ns._seg_to_region_onehot = functools.partial(nnUNetTrainer._seg_to_region_onehot, ns)
    ns._loss = functools.partial(nnUNetTrainer._loss, ns)
    ns._batch_to_device = lambda batch: (torch.from_numpy(batch["data"]),
                                         torch.from_numpy(batch["seg"][:, 0]).long())
    return ns


def _jax_trainer(labels: dict, batch_dice: bool, logits_nhwc):
    """The same for the JAX trainer: its loss, its region targets and its
    jitted validation step, the model's apply returning `logits_nhwc`."""
    from jax.sharding import Mesh

    from dinounet_tpu.training.trainer import nnUNetTrainer as JaxTrainer
    from dinounet_tpu.utilities.label_handling import LabelManager as JaxLabelManager

    ns = SimpleNamespace(
        label_manager=JaxLabelManager(labels, ORDER),
        configuration_manager=SimpleNamespace(batch_dice=batch_dice, patch_size=(16, 12)),
        network=SimpleNamespace(apply=lambda variables, x, train: logits_nhwc),
        tx=None, augment_cfg=None, is_cascaded=False,
        mesh=Mesh(np.array(jax.devices("cpu")[:1]).reshape(1, 1), ("data", "model")))
    ns._seg_to_region_onehot = functools.partial(JaxTrainer._seg_to_region_onehot, ns)
    ns._loss_fn = functools.partial(JaxTrainer._loss_fn, ns)
    JaxTrainer._build_steps(ns)
    return ns


@pytest.mark.parametrize("batch_dice", [False, True])
@pytest.mark.parametrize("ignore", [False, True])
def test_region_loss_and_counts_match_jax(ignore, batch_dice):
    rng = np.random.default_rng(3 + ignore)
    seg = rng.integers(0, 4 if ignore else 3, (2, 16, 12))
    logits = (2.0 * rng.standard_normal((2, 2, 16, 12))).astype(np.float32)
    t_logits = torch.from_numpy(logits)
    j_logits = jnp.asarray(np.moveaxis(logits, 1, -1))
    port = _port_trainer(_labels(ignore), batch_dice, t_logits)
    jx = _jax_trainer(_labels(ignore), batch_dice, j_logits)

    t_seg = torch.from_numpy(seg)
    onehot = port._seg_to_region_onehot(t_seg)
    want = np.asarray(jx._seg_to_region_onehot(jnp.asarray(seg)))
    assert onehot.shape == (2, 2 + ignore, 16, 12)
    np.testing.assert_array_equal(onehot.numpy(), np.moveaxis(want, -1, 1))

    loss = port._loss(t_logits, t_seg)
    np.testing.assert_allclose(loss.item(), float(jx._loss_fn(j_logits, jnp.asarray(seg))),
                               rtol=1e-5)

    batch = {"data": np.zeros((2, 1, 16, 12), np.float32), "seg": seg[:, None]}
    v_loss, tp, fp, fn = nnUNetTrainer.validation_step_host(port, batch)
    j_loss, j_tp, j_fp, j_fn = jx._val_step({}, {}, jnp.zeros((2, 16, 12, 1)),
                                            jnp.asarray(seg, jnp.int32))
    np.testing.assert_allclose(v_loss.item(), float(j_loss), rtol=1e-5)
    for got, want in ((tp, j_tp), (fp, j_fp), (fn, j_fn)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tp.shape == (2,)


@registry.trainers.register("RegionsTinyDinoUNetTrainer")
class RegionsTinyDinoUNetTrainer(DinoUNetTrainer):
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
                                         **{**CFG_KW, "num_classes": num_output_channels}))


def test_region_training_trains_validates_and_exports(tmp_path, monkeypatch,
                                                      fast_fingerprints):  # noqa: F811
    """tests/helpers.py's PNG set with its labels declared as regions,
    planned and preprocessed by the port (64 x 64), then run_training of a
    small DinoUNet trainer: finite losses, one pseudo-Dice a region, the
    validation exported through regions_class_order and its summary."""
    from dinounet_tpu_torch import api
    from dinounet_tpu_torch.run import run_training
    from dinounet_tpu_torch.utilities.json_export import load_json, save_json

    for sub, var in (("raw", "nnUNet_raw"), ("pre", "nnUNet_preprocessed"),
                     ("res", "nnUNet_results")):
        (tmp_path / sub).mkdir()
        monkeypatch.setenv(var, str(tmp_path / sub))
    make_png_dataset(str(tmp_path / "raw"), "Dataset604_Regions", n_cases=6,
                     size=(72, 64), n_classes=3)
    dsj_file = str(tmp_path / "raw" / "Dataset604_Regions" / "dataset.json")
    dsj = load_json(dsj_file)
    dsj["labels"] = dict(REGION_LABELS)
    dsj["regions_class_order"] = ORDER
    save_json(dsj, dsj_file)
    api.plan_and_preprocess(604, **TINY_KW)

    trainer = run_training(604, "2d", 0, "RegionsTinyDinoUNetTrainer", device="cpu")
    assert trainer.label_manager.has_regions
    log = trainer.logger.my_fantastic_logging
    assert np.isfinite(log["train_losses"][-1]) and np.isfinite(log["val_losses"][-1])
    assert len(log["dice_per_class_or_region"][-1]) == 2
    folder = os.path.join(trainer.output_folder, "validation")
    summary = load_json(os.path.join(folder, "summary.json"))
    assert len(summary["mean"]) == 2  # one entry a foreground region
    assert np.isfinite(summary["foreground_mean"]["Dice"])
    from PIL import Image

    _, val_keys = trainer.do_split()
    for k in val_keys:
        seg = np.asarray(Image.open(os.path.join(folder, k + ".png")))
        assert seg.shape == (72, 64) and set(np.unique(seg)) <= {0, 1, 2}
