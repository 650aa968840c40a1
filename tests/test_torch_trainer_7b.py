"""``DinoUNetTrainer_7b``'s build, on the CPU, at the 7B's layout and a small
width (the SwiGLU ViT of ``tests/test_torch_vit7b.py``: Dh 128, no qkv bias,
one adapter head of 128 channels).

The trainer builds its network on its device with the backbone's matrices
held in bf16 (the compute dtype) before drawing the weights. Every use casts
a weight to bf16 anyway, so the held build computes what the fp32-held
build computes with the same (bf16-valued) weights: one train step gives
the same loss bit for bit, and the same trainable parameters after the
SGD step. The predictor built from the trained folder holds the matrices
in bf16 too and gives the trainer's logits bit for bit.
"""

import os

import numpy as np
import torch

from dinounet_tpu_torch.inference.predictor import nnUNetPredictor
from dinounet_tpu_torch.models.dinounet import DinoUNet as TorchDinoUNet
from dinounet_tpu_torch.models.dinounet import DinoUNetConfig as TorchConfig
from dinounet_tpu_torch.models.vit import ViTConfig as TorchViTConfig
from dinounet_tpu_torch.run import get_trainer_from_args
from dinounet_tpu_torch.training.dinounet_trainer import DinoUNetTrainer, DinoUNetTrainer_7b
from dinounet_tpu_torch.utilities import registry
from dinounet_tpu_torch.utilities.synthetic_dataset import write_disk_ring_dataset
from tests.test_torch_training import ARCH
from tests.test_torch_vit7b import CFG_KW, HW, VIT_KW

BACKBONE = "encoder.dinov3_adapter.backbone."


def _tiny_7b(enable_deep_supervision: bool = False) -> TorchDinoUNet:
    return TorchDinoUNet(TorchConfig(vit=TorchViTConfig(**dict(VIT_KW, depth=4)),
                                     deep_supervision=enable_deep_supervision, **CFG_KW))


@registry.trainers.register("Tiny7bTrainer")
class Tiny7bTrainer(DinoUNetTrainer_7b):
    """DinoUNetTrainer_7b's build around the small 7B-layout network."""

    @classmethod
    def build_network_architecture(cls, architecture_class_name, arch_init_kwargs,
                                   arch_init_kwargs_req_import, num_input_channels,
                                   num_output_channels, enable_deep_supervision=True):
        return _tiny_7b(enable_deep_supervision)


@registry.trainers.register("Tiny7bFp32HeldTrainer")
class Tiny7bFp32HeldTrainer(DinoUNetTrainer):
    """The same network through the base build: every matrix held in fp32."""

    build_network_architecture = Tiny7bTrainer.build_network_architecture


def test_7b_build_holds_bf16_and_trains_and_predicts_as_fp32(tmp_path, monkeypatch):
    for sub in ("pre", "res"):
        (tmp_path / sub).mkdir()
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path / "pre"))
    monkeypatch.setenv("nnUNet_results", str(tmp_path / "res"))
    write_disk_ring_dataset(str(tmp_path / "pre"), "Dataset993_Tiny7b", 4, (72, 72),
                            (HW, HW), 2, ARCH, seed=6)
    trainers = {}
    for name in ("Tiny7bTrainer", "Tiny7bFp32HeldTrainer"):
        trainer = get_trainer_from_args(993, "2d", 0, name, device="cpu")
        trainer.seed = 0
        trainer.on_train_start()
        trainers[name] = trainer
    held, ref = trainers["Tiny7bTrainer"], trainers["Tiny7bFp32HeldTrainer"]
    for name, p in held.network.named_parameters():
        bf16 = name.startswith(BACKBONE) and p.dim() >= 2
        assert p.dtype == (torch.bfloat16 if bf16 else torch.float32), name
    # the fp32-held network with the held one's weights
    ref.network.load_state_dict(held.network.state_dict())
    assert all(t.dtype == torch.float32 for t in ref.network.state_dict().values()
               if t.is_floating_point())

    batch = held.dataloader_train.generate_train_batch()
    losses = [t.train_step_host(batch) for t in (held, ref)]
    assert torch.isfinite(losses[0]) and torch.equal(losses[0], losses[1])
    trained = dict(ref.network.named_parameters())
    for name, p in held.network.named_parameters():
        assert torch.equal(p.float(), trained[name].float()), name

    held.save_checkpoint(os.path.join(held.output_folder, "checkpoint_final.pth"))
    predictor = nnUNetPredictor(device="cpu", use_mirroring=False)
    predictor.initialize_from_trained_model_folder(held.output_folder_base, use_folds=(0,))
    predictor._load(predictor.list_of_parameters[0])
    backbone = predictor.network.encoder.dinov3_adapter.backbone
    assert backbone.blocks[0].mlp.w1.weight.dtype == torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 1, HW, HW)).astype(np.float32))
    with torch.inference_mode():
        want = held.network.eval()(x)
        got = predictor.network(x)
    assert torch.equal(got, want)
