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

The published DINOv3 ``.pth`` backbones load in a later slice; until then a
trainer whose checkpoint file is missing goes on with a randomly initialised
frozen backbone and says so in its log, as the JAX trainer does, and one
whose file is present raises rather than train from the wrong weights.
``DinoUNetTrainer_7b`` raises. Its kernels are all ported (the MSDA
backward takes the adapter's 128 channels a head), but the trainer builds
its network on the host in fp32 and moves it whole to the device: 27 GB of
host memory for the 6.7e9 backbone parameters, and the frozen backbone held
in fp32 on the card. Training the 7B waits for a trainer that builds the
network on the card with the frozen backbone's matrices held in bf16, as
``DinoUNet.random_on`` and ``DinoViT.hold_weights_`` do for serving.
"""

import os

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
                                   enable_deep_supervision: bool = True) -> DinoUNet:
        """Ignores the plans' network class; returns DinoUNet (ref :857-881),
        from the injected configuration and model where there is one."""
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
        return DinoUNet(cfg)

    def initialize(self):
        super().initialize()
        path = (DinoUNetTrainer._dinov3_pretrained_path
                if DinoUNetTrainer._network_config is not None
                else self._dinov3_pretrained_path)
        if path and os.path.exists(path):
            raise NotImplementedError(
                f"{path} exists, but loading a published DINOv3 backbone into "
                "the port waits for the checkpoint slice; remove it or train "
                "with the JAX package")
        self.print_to_log_file(
            "WARNING: no pretrained DINOv3 checkpoint found "
            f"({path}); the frozen backbone is randomly initialized.")


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
    """DINOv3 ViT-7B/16 (ref :921-930): not trainable in the port yet."""
    _dinov3_model_name = "dinounet_7b"

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DinoUNetTrainer_7b waits for a trainer that builds dinounet_7b on "
            "the device with its frozen backbone held in bf16: this one builds "
            "the network on the host in fp32 (27 GB for the backbone) and moves "
            "it whole; dinounet_7b serves through nnUNetPredictor")


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
