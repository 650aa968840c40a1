"""A DinoUNet network that is none of the published sizes, built by the
port's DinoUNet trainers for as long as a ``with`` block lasts.

A checkpoint carries no network configuration, so a model folder written
for a small test network (``tools/make_jax_checkpoint_fixture.py`` and its
``network.json``) predicts and resumes only where every DinoUNet trainer
builds that network. ``injected_network(spec)`` registers the spec's ViT
(``vit``: ``ViTConfig``'s fields, as ``vit_name``) and its
``interaction_indexes`` for ``model_name``, injects the plans'
``architecture`` with that model (``set_network_config``), and overrides
``DinoUNetConfig``'s adapter fields (``overrides``); all of it is undone
after. It imports no JAX package: the tests and ``chip_smoke.py`` share it.
"""

import contextlib

from dinounet_tpu_torch.models import dinounet as dinounet_module
from dinounet_tpu_torch.models.vit import VIT_CONFIGS, ViTConfig
from dinounet_tpu_torch.training import dinounet_trainer


@contextlib.contextmanager
def injected_network(spec: dict):
    base = dinounet_trainer.DinoUNetTrainer
    saved = (base._network_config, base._dinov3_model_name, base._dinov3_pretrained_path,
             dinounet_trainer.DinoUNetConfig)
    original = dinounet_trainer.DinoUNetConfig

    class InjectedConfig(original):
        @classmethod
        def from_plans_arch(cls, arch, num_classes, **kwargs):
            return original.from_plans_arch(arch, num_classes,
                                            **{**spec.get("overrides", {}), **kwargs})

    VIT_CONFIGS[spec["vit_name"]] = ViTConfig(**spec["vit"])
    dinounet_module.DINOV3_MODEL_NAMES[spec["model_name"]] = spec["vit_name"]
    dinounet_module.DINOV3_INTERACTION_INDEXES[spec["model_name"]] = tuple(
        spec["interaction_indexes"])
    dinounet_trainer.DinoUNetConfig = InjectedConfig
    base.set_network_config({"architecture": spec["architecture"]},
                            dinov3_model_name=spec["model_name"])
    base._dinov3_pretrained_path = None
    try:
        yield
    finally:
        (base._network_config, base._dinov3_model_name, base._dinov3_pretrained_path,
         dinounet_trainer.DinoUNetConfig) = saved
        VIT_CONFIGS.pop(spec["vit_name"], None)
        dinounet_module.DINOV3_MODEL_NAMES.pop(spec["model_name"], None)
        dinounet_module.DINOV3_INTERACTION_INDEXES.pop(spec["model_name"], None)
