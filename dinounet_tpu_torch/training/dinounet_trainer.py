"""DinoUNet trainer family, PyTorch.

Counterpart of ``dinounet_tpu/training/dinounet_trainer.py`` (ref:
dinounet_training.py:833-956): a trainer that ignores the plans' network
class and builds DinoUNet (frozen DINOv3 backbone + adapter + FAPM + decoder)
from the plans' architecture dict, and the size variants pinning the
backbone. Deep supervision is off (the base class
is nnUNetTrainerNoDeepSupervision).

``set_network_config`` injects a network configuration (an entry of
``api.plan_and_preprocess``'s ``network_configurations``) at class level, as
the reference does (ref :842-855): it copies the configuration, the model
name and the checkpoint path down to ``DinoUNetTrainer``, so that from then
on every DinoUNet trainer of the process builds that configuration's
architecture with that model, whatever its own size. Without an injection
each trainer builds from the plans' architecture with its own model.
``DINOV3_TRAINERS`` and ``get_dinov3_trainer`` map the CLI's model names to
the size variants.

``initialize`` loads the pretrained backbone (``models/convert.py::
load_dinov3_backbone_``): the injected checkpoint path where there is an
injection, else the trainer's own. The published ``.pth`` is read as it is
downloaded; where it is missing and the JAX package's converted
``.msgpack`` of the same stem exists (the file the JAX size trainers look
for), that is read. A file that is present but does not match the
backbone raises; only a missing file leaves the randomly initialised
frozen backbone, with a warning in the log, as in the JAX trainer. The JAX
trainer reads only the base class's path, which stays None without an
injection (``dinounet_tpu/training/dinounet_trainer.py:67``): the port reads
the size trainer's own on purpose.

``DinoUNetTrainer_7b`` builds dinounet_7b on the trainer's device with the
frozen backbone's matrices held at the compute dtype (bf16: 12.5 GiB where
fp32 would take 27 GB), as ``DinoUNet.random_on`` builds it for serving,
and only then draws the weights or has them loaded. Every number is the
same as with fp32 matrices cast at each use.

Under a model axis (``DINOUNET_TPU_MODEL_AXIS`` > 1, several ranks) every
DinoUNet trainer, s / b / l and 7b, builds each rank's shards of the
backbone's blocks (``parallel/sharding.py``: the heads and FFN columns of
the mlp and SwiGLU blocks alike), and the pretrained backbone's ``.pth`` or
``.msgpack`` is read into those shards; everything trainable is whole on
every rank. The int8 serving mode (``DINOUNET_TPU_VIT_INT8=1``) splits
too: its row-parallel layers take their scales over the model group and sum
exact int32 products (``models/vit.py``), so a rank's blocks give the whole
int8 backbone's output.
"""

import os

import torch

from dinounet_tpu_torch.models.convert import load_dinov3_backbone_, published_name
from dinounet_tpu_torch.models.dinounet import DinoUNet, DinoUNetConfig
from dinounet_tpu_torch.training.trainer_variants import nnUNetTrainerNoDeepSupervision
from dinounet_tpu_torch.utilities import registry


@registry.trainers.register("DinoUNetTrainer")
class DinoUNetTrainer(nnUNetTrainerNoDeepSupervision):
    """ref dinounet_training.py:833-881."""

    _network_config = None
    _dinov3_pretrained_path = None
    _dinov3_model_name = "dinounet_s"

    @classmethod
    def set_network_config(cls, network_config, dinov3_pretrained_path=None,
                           dinov3_model_name=None, adapter_type: str = "default"):
        """Class-level config injection, copied down to the base class so the
        network builder sees it (ref :842-855)."""
        cls._network_config = network_config
        if dinov3_pretrained_path is not None:
            cls._dinov3_pretrained_path = dinov3_pretrained_path
        if dinov3_model_name is not None:
            cls._dinov3_model_name = dinov3_model_name
        DinoUNetTrainer._network_config = cls._network_config
        DinoUNetTrainer._dinov3_model_name = cls._dinov3_model_name
        DinoUNetTrainer._dinov3_pretrained_path = cls._dinov3_pretrained_path

    @classmethod
    def build_network_architecture(cls, architecture_class_name: str, arch_init_kwargs: dict,
                                   arch_init_kwargs_req_import, num_input_channels: int,
                                   num_output_channels: int,
                                   enable_deep_supervision: bool = True,
                                   shard=None) -> DinoUNet:
        """Ignores the plans' network class; returns DinoUNet (ref :857-881),
        from the injected configuration and model where there is one; with
        `shard`, its backbone's blocks are that rank's shards."""
        if DinoUNetTrainer._network_config is not None:
            arch = dict(DinoUNetTrainer._network_config["architecture"])
            model_name = DinoUNetTrainer._dinov3_model_name
        else:
            arch = dict(arch_init_kwargs)
            arch.setdefault("n_stages", len(arch.get("features_per_stage", [32, 64, 128, 256])))
            model_name = cls._dinov3_model_name
        cfg = DinoUNetConfig.from_plans_arch(
            arch, num_classes=num_output_channels, model_name=model_name,
            deep_supervision=enable_deep_supervision)
        return DinoUNet(cfg) if shard is None else DinoUNet(cfg, shard=shard)

    def initialize(self):
        super().initialize()
        requested = (DinoUNetTrainer._dinov3_pretrained_path
                     if DinoUNetTrainer._network_config is not None
                     else self._dinov3_pretrained_path)
        candidates = [requested] if requested else []
        if requested and requested.endswith(".pth"):
            candidates.append(requested[:-len(".pth")] + ".msgpack")
        path = next((c for c in candidates if os.path.exists(c)), None)
        if path is None:
            self.print_to_log_file(
                "WARNING: no pretrained DINOv3 checkpoint found "
                f"({requested}); the frozen backbone is randomly initialized.")
            return
        backbone = self.network.encoder.dinov3_adapter.backbone
        load_dinov3_backbone_(backbone, path, published_name(backbone.cfg))
        self.print_to_log_file(f"Loaded DINOv3 backbone weights from {path}")


@registry.trainers.register("DinoUNetTrainer_s")
class DinoUNetTrainer_s(DinoUNetTrainer):
    """DINOv3 ViT-S/16 (ref :885-893)."""
    _dinov3_model_name = "dinounet_s"
    _dinov3_pretrained_path = "dinounet/checkpoints/dinov3_vits16_pretrain.pth"


@registry.trainers.register("DinoUNetTrainer_b")
class DinoUNetTrainer_b(DinoUNetTrainer):
    """DINOv3 ViT-B/16 (ref :897-905)."""
    _dinov3_model_name = "dinounet_b"
    _dinov3_pretrained_path = "dinounet/checkpoints/dinov3_vitb16_pretrain.pth"


@registry.trainers.register("DinoUNetTrainer_l")
class DinoUNetTrainer_l(DinoUNetTrainer):
    """DINOv3 ViT-L/16 (ref :909-917)."""
    _dinov3_model_name = "dinounet_l"
    _dinov3_pretrained_path = "dinounet/checkpoints/dinov3_vitl16_pretrain.pth"


@registry.trainers.register("DinoUNetTrainer_7b")
class DinoUNetTrainer_7b(DinoUNetTrainer):
    """DINOv3 ViT-7B/16 (ref :921-930)."""
    _dinov3_model_name = "dinounet_7b"
    _dinov3_pretrained_path = "dinounet/checkpoints/dinov3_vit7b16_pretrain.pth"

    @classmethod
    def build_network(cls, device, configuration_manager, num_input_channels: int,
                      num_output_channels: int, enable_deep_supervision: bool = True,
                      seed=None, shard=None) -> DinoUNet:
        """Built on `device` with the backbone's matrices at the compute
        dtype before any weight is drawn or loaded (``DinoUNet.random_on``'s
        build): nothing of it passes through the host, and the device holds
        the backbone in fp32 only while it is constructed. With `seed` the
        draws are ``init_weights``' on that device's generator. With `shard`
        the backbone's blocks are built as that rank's shards."""
        cm = configuration_manager
        with torch.device(device):
            network = cls.build_network_architecture(
                cm.network_arch_class_name, cm.network_arch_init_kwargs,
                cm.network_arch_init_kwargs_req_import, num_input_channels,
                num_output_channels, enable_deep_supervision,
                **({} if shard is None else {"shard": shard}))
        network.encoder.dinov3_adapter.backbone.hold_weights_(network.compute_dtype)
        return network if seed is None else network.init_weights(seed)


# ref dinounet_training.py:935-940
DINOV3_TRAINERS = {
    "dinounet_s": DinoUNetTrainer_s,
    "dinounet_b": DinoUNetTrainer_b,
    "dinounet_l": DinoUNetTrainer_l,
    "dinounet_7b": DinoUNetTrainer_7b,
}


def get_dinov3_trainer(model_name: str):
    if model_name not in DINOV3_TRAINERS:
        raise ValueError(
            f"Unsupported model: {model_name}. Supported: {list(DINOV3_TRAINERS)}"
        )
    return DINOV3_TRAINERS[model_name]
