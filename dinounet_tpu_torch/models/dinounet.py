"""DinoUNet: frozen DINOv3 ViT + ViT-Adapter + FAPM + U-Net decoder, PyTorch.

Counterpart of ``dinounet_tpu/models/dinounet.py``. The plans'
``architecture`` dict configures it (op strings through the registry); the
adapter has the reference's fixed hyperparameters (conv_inplane 64, 4 points,
16 heads, drop-path 0.3, cffn_ratio 0.25, deform_ratio 0.5). Input and output
are NCHW; the logits are fp32. ``train()`` / ``eval()`` choose the path, as
``train=`` does in the JAX package: train mode runs the adapter's unfused,
drop-path, checkpointed graph and BatchNorm batch statistics. The backbone is
frozen (its parameters do not require grad, the JAX optimizer's
``backbone_param_filter``) and runs under ``no_grad``. With
``deep_supervision`` in the config, train mode returns every decoder head's
logits, highest resolution first (JAX ``dinounet.py:158-169``); eval mode
returns the top head. The DinoUNet trainers train without deep supervision
(``nnUNetTrainerNoDeepSupervision``), as in the JAX package. Module nesting
and parameter names follow the reference
(``encoder.dinov3_adapter.backbone.blocks.0...``, ``decoder.seg_layers.0...``),
so its checkpoints load by name; ``models/convert.py`` maps the JAX package's
parameter trees onto the same names.
"""

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from dinounet_tpu_torch.configuration import COMPUTE_DTYPE
from dinounet_tpu_torch.models.adapter import DINOv3Adapter
from dinounet_tpu_torch.models.decoder import UNetDecoder
from dinounet_tpu_torch.models.fapm import FAPMEncoder
from dinounet_tpu_torch.models.layers import init_module
from dinounet_tpu_torch.models.vit import VIT_CONFIGS, DinoViT, ViTConfig
from dinounet_tpu_torch.utilities.registry import resolve_op_name

DINOV3_MODEL_NAMES = {
    "dinounet_s": "dinov3_vits16",
    "dinounet_b": "dinov3_vitb16",
    "dinounet_l": "dinov3_vitl16",
    "dinounet_7b": "dinov3_vit7b16",
}
DINOV3_INTERACTION_INDEXES = {
    "dinounet_s": (2, 5, 8, 11),
    "dinounet_b": (2, 5, 8, 11),
    "dinounet_l": (4, 11, 17, 23),
    "dinounet_7b": (9, 19, 29, 39),
}


@dataclasses.dataclass(frozen=True)
class DinoUNetConfig:
    vit: ViTConfig
    interaction_indexes: Tuple[int, ...]
    num_classes: int = 2
    features_per_stage: Tuple[int, ...] = (32, 64, 128, 256)
    n_conv_per_stage_decoder: Tuple[int, ...] = (2, 2, 2)
    conv_bias: bool = True
    norm: str = "instancenorm"
    norm_kwargs: Optional[dict] = None
    nonlin: str = "leaky_relu"
    nonlin_kwargs: Optional[dict] = None
    fapm_rank: int = 256
    conv_inplane: int = 64
    n_points: int = 4
    deform_num_heads: int = 16
    drop_path_rate: float = 0.3
    cffn_ratio: float = 0.25
    deform_ratio: float = 0.5
    remat_adapter: bool = True
    deep_supervision: bool = False
    dtype: str = COMPUTE_DTYPE

    @classmethod
    def from_plans_arch(cls, arch: dict, num_classes: int,
                        model_name: str = "dinounet_s",
                        **overrides) -> "DinoUNetConfig":
        """Build from a plans.json network architecture dict. The plans'
        kernel sizes and strides are not read: the decoder is fixed at 3x3
        convs and 2x2 upsampling over the adapter's 4 scales."""
        features = list(arch["features_per_stage"])
        n_dec = list(arch["n_conv_per_stage_decoder"])
        if arch["n_stages"] != 4:
            # the adapter outputs exactly 4 scales
            base = features[0] if features else 32
            features = [base * (2 ** i) for i in range(4)]
            n_dec = (n_dec + [n_dec[-1]] * 3)[:3]
        return cls(
            vit=VIT_CONFIGS[DINOV3_MODEL_NAMES[model_name]],
            interaction_indexes=DINOV3_INTERACTION_INDEXES[model_name],
            num_classes=num_classes,
            features_per_stage=tuple(features),
            n_conv_per_stage_decoder=tuple(n_dec),
            conv_bias=arch.get("conv_bias", False),
            norm=resolve_op_name(arch.get("norm_op")),
            norm_kwargs=arch.get("norm_op_kwargs") or {},
            nonlin=resolve_op_name(arch.get("nonlin")),
            nonlin_kwargs=arch.get("nonlin_kwargs") or {},
            **overrides,
        )


class DinoUNet(nn.Module):
    """forward(x (B, C, H, W)) -> fp32 logits (B, classes, H, W)."""

    def __init__(self, cfg: DinoUNetConfig):
        super().__init__()
        self.cfg = cfg
        cdt = getattr(torch, cfg.dtype)
        self.compute_dtype = cdt
        vit_cfg = dataclasses.replace(cfg.vit, dtype=cfg.dtype)
        adapter = DINOv3Adapter(
            DinoViT(vit_cfg), cfg.interaction_indexes, cfg.vit.embed_dim,
            conv_inplane=cfg.conv_inplane, n_points=cfg.n_points,
            deform_num_heads=cfg.deform_num_heads, cffn_ratio=cfg.cffn_ratio,
            deform_ratio=cfg.deform_ratio, patch_size=cfg.vit.patch_size,
            dtype=cdt, drop_path_rate=cfg.drop_path_rate, remat=cfg.remat_adapter)
        adapter.backbone.requires_grad_(False)
        self.encoder = FAPMEncoder(
            adapter, cfg.vit.embed_dim, cfg.features_per_stage, norm=cfg.norm,
            nonlin=cfg.nonlin, nonlin_kwargs=cfg.nonlin_kwargs,
            conv_bias=cfg.conv_bias, rank=cfg.fapm_rank, dtype=cdt)
        n = len(cfg.features_per_stage)
        self.decoder = UNetDecoder(
            cfg.features_per_stage, ((2, 2),) * n, ((3, 3),) * n,
            cfg.num_classes, cfg.n_conv_per_stage_decoder, norm=cfg.norm,
            norm_kwargs=cfg.norm_kwargs, nonlin=cfg.nonlin,
            nonlin_kwargs=cfg.nonlin_kwargs, conv_bias=cfg.conv_bias, dtype=cdt)

    def init_weights(self, seed: int) -> "DinoUNet":
        """Draw every parameter as the JAX package's initializers do, from a
        torch.Generator on the parameters' device seeded with `seed` (random
        weights for serving tests)."""
        device = next(self.parameters()).device
        init_module(self, torch.Generator(device=device).manual_seed(seed))
        return self

    @classmethod
    def random_on(cls, cfg: DinoUNetConfig, device, seed: int) -> "DinoUNet":
        """A model with random weights built on `device`: constructed there,
        the frozen backbone's matrices held at the compute dtype
        (``DinoViT.hold_weights_``), then drawn by ``init_weights`` from a
        generator there. No fp32 copy of the backbone exists on the host,
        nor on the device after construction (the 7B's would take 27 GB).
        The same draws as ``init_weights`` on that device's generator, not
        the CPU's."""
        with torch.device(device):
            model = cls(cfg)
        model.encoder.dinov3_adapter.backbone.hold_weights_(model.compute_dtype)
        return model.init_weights(seed)

    def forward(self, x: torch.Tensor):
        C = x.shape[1]
        # channel handling: replicate to 3 channels
        if C == 1:
            x3 = x.expand(-1, 3, -1, -1)
        elif C == 2:
            x3 = torch.cat([x, x[:, :1]], dim=1)
        else:
            x3 = x[:, :3]
        # deep supervision is a training output: inference returns the top head
        return self.decoder(self.encoder(x3.to(self.compute_dtype)),
                            deep_supervision=self.cfg.deep_supervision and self.training)
