"""PlainConvUNet: the stock nnU-Net architecture built from plans.json, 2-D
or 3-D, PyTorch.

Counterpart of ``dinounet_tpu/models/plain_unet.py`` (ref: the default
trainer's network, dynamic_network_architectures' PlainConvUNet): per
encoder stage a stack of conv-norm-nonlin blocks whose first conv carries
the stage's stride, then the shared ``UNetDecoder``. The rank of the plans'
kernel sizes picks 2-D (NCHW) or 3-D (NCDHW). Convs pad as XLA's SAME does,
as the JAX package's flax convs do: a strided conv over an even size pads
(0, 1) where dynamic_network_architectures pads (1, 1), so a checkpoint of
the original nnU-Net loads by name but its strided convs see the map
shifted by one pixel. Parameter names are dynamic_network_architectures'
(``encoder.stages.0.0.convs.1.conv.weight``, ``decoder.transpconvs.0.weight``,
``decoder.seg_layers.2.bias``).
"""

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from dinounet_tpu_torch.configuration import COMPUTE_DTYPE
from dinounet_tpu_torch.models.decoder import UNetDecoder
from dinounet_tpu_torch.models.layers import StackedConvBlocks, init_module
from dinounet_tpu_torch.utilities.registry import resolve_op_name


def _per_stage(value, n: int) -> Tuple[int, ...]:
    """A plans entry given as one int for every stage, or per stage."""
    return tuple([value] * n if isinstance(value, int) else value)


def _tuples(seq) -> Tuple[Tuple[int, ...], ...]:
    """Plans carry lists: the kernel sizes and strides as tuples of ints, so
    the decoder's route checks compare them with tuples."""
    return tuple(tuple(int(v) for v in k) for k in seq)


@dataclasses.dataclass(frozen=True)
class PlainUNetConfig:
    num_classes: int
    features_per_stage: Tuple[int, ...]
    kernel_sizes: Tuple[Tuple[int, ...], ...]
    strides: Tuple[Tuple[int, ...], ...]
    n_conv_per_stage: Tuple[int, ...]
    n_conv_per_stage_decoder: Tuple[int, ...]
    conv_bias: bool = True
    norm: str = "instancenorm"
    norm_kwargs: Optional[dict] = None
    nonlin: str = "leaky_relu"
    nonlin_kwargs: Optional[dict] = None
    deep_supervision: bool = False
    dtype: str = COMPUTE_DTYPE

    @classmethod
    def from_plans_arch(cls, arch: dict, num_classes: int,
                        deep_supervision: Optional[bool] = None) -> "PlainUNetConfig":
        n = arch["n_stages"]
        return cls(
            num_classes=num_classes,
            features_per_stage=tuple(arch["features_per_stage"]),
            kernel_sizes=_tuples(arch["kernel_sizes"]),
            strides=_tuples(arch["strides"]),
            n_conv_per_stage=_per_stage(arch["n_conv_per_stage"], n),
            n_conv_per_stage_decoder=_per_stage(arch["n_conv_per_stage_decoder"], n - 1),
            conv_bias=arch.get("conv_bias", True),
            norm=resolve_op_name(arch.get("norm_op")),
            norm_kwargs=arch.get("norm_op_kwargs") or {},
            nonlin=resolve_op_name(arch.get("nonlin")),
            nonlin_kwargs=arch.get("nonlin_kwargs") or {},
            deep_supervision=(arch.get("deep_supervision", False)
                              if deep_supervision is None else deep_supervision),
        )


class PlansUNet(nn.Module):
    """What the plans' two networks share: an encoder whose ``stages`` give
    the skips, the decoder, the weights' draw and the forward."""

    def _build_decoder(self, cfg) -> UNetDecoder:
        return UNetDecoder(
            cfg.features_per_stage, cfg.strides, cfg.kernel_sizes, cfg.num_classes,
            cfg.n_conv_per_stage_decoder, norm=cfg.norm, norm_kwargs=cfg.norm_kwargs,
            nonlin=cfg.nonlin, nonlin_kwargs=cfg.nonlin_kwargs,
            conv_bias=cfg.conv_bias, dtype=self.compute_dtype)

    def init_weights(self, seed: int):
        """Draw every parameter as the JAX package's initializers do, from a
        torch.Generator on the parameters' device seeded with `seed`."""
        device = next(self.parameters()).device
        init_module(self, torch.Generator(device=device).manual_seed(seed))
        return self

    def forward(self, x: torch.Tensor):
        """x (B, C, *spatial) -> fp32 logits (B, classes, *spatial), or in
        train mode with deep supervision every head's, highest resolution
        first."""
        x = x.to(self.compute_dtype)
        skips = []
        for stage in self.encoder.stages:
            x = stage(x)
            skips.append(x)
        return self.decoder(skips,
                            deep_supervision=self.cfg.deep_supervision and self.training)


class PlainConvUNet(PlansUNet):
    def __init__(self, cfg: PlainUNetConfig, input_channels: int):
        super().__init__()
        self.cfg = cfg
        self.input_channels = input_channels
        self.compute_dtype = getattr(torch, cfg.dtype)
        self.encoder = nn.Module()
        stages = []
        cin = input_channels
        for s, feats in enumerate(cfg.features_per_stage):
            stages.append(nn.Sequential(StackedConvBlocks(
                cfg.n_conv_per_stage[s], cin, feats, cfg.kernel_sizes[s], cfg.norm,
                cfg.norm_kwargs, cfg.nonlin, cfg.nonlin_kwargs, cfg.conv_bias,
                self.compute_dtype, initial_stride=cfg.strides[s])))
            cin = feats
        self.encoder.stages = nn.Sequential(*stages)
        self.decoder = self._build_decoder(cfg)
