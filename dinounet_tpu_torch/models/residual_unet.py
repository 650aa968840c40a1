"""ResidualEncoderUNet: the residual-encoder nnU-Net variant built from
plans.json, 2-D or 3-D, PyTorch.

Counterpart of ``dinounet_tpu/models/residual_unet.py`` (ref: the network
that ``ResEncUNetPlanner`` / ``nnUNetPlannerResEnc{M,L}`` plan): each encoder
stage is a stack of residual blocks, conv-norm-nonlin-conv-norm with the
nonlinearity after the residual add; the first block of a stage carries the
stride, and a block whose channels or stride change projects its input by a
strided 1x1 conv and a norm. The decoder is the shared ``UNetDecoder``.
Convs pad as XLA's SAME does (see ``plain_unet.py``).

Names follow dynamic_network_architectures' where the modules agree
(``encoder.stages.1.blocks.0.conv1.conv.weight``, ``...conv2.norm.weight``);
the projection is ``skip.conv`` / ``skip.norm`` (the reference pools and then
projects, ``skip.1``; the JAX package projects with the strided conv). In
3-D the projection and the later blocks' convs are rank-correct: the JAX
module's ``conv2`` and the later blocks pass 2-D strides, which flax
refuses on a 3-D kernel, so its ResidualEncoderUNet builds in 2-D only.
"""

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from dinounet_tpu_torch.configuration import COMPUTE_DTYPE
from dinounet_tpu_torch.models.layers import ConvNormAct, Nonlin
from dinounet_tpu_torch.models.plain_unet import PlansUNet, _per_stage, _tuples
from dinounet_tpu_torch.utilities.registry import resolve_op_name


class ResidualBlock(nn.Module):
    """conv1 (conv-norm-nonlin) -> conv2 (conv-norm) + skip -> nonlin; the
    skip projects (strided 1x1 conv, norm) where channels or stride change."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: Sequence[int],
                 stride: Sequence[int], norm: str, norm_kwargs: Optional[dict],
                 nonlin: str, nonlin_kwargs: Optional[dict], conv_bias: bool,
                 dtype: torch.dtype):
        super().__init__()
        ones = (1,) * len(kernel_size)
        self.conv1 = ConvNormAct(in_ch, out_ch, kernel_size, norm, norm_kwargs, nonlin,
                                 nonlin_kwargs, conv_bias, dtype, stride=stride)
        self.conv2 = ConvNormAct(out_ch, out_ch, kernel_size, norm, norm_kwargs, "none",
                                 None, conv_bias, dtype)
        self.act = Nonlin(nonlin, nonlin_kwargs)
        if in_ch != out_ch or tuple(stride) != ones:
            self.skip = ConvNormAct(in_ch, out_ch, ones, norm, norm_kwargs, "none", None,
                                    False, dtype, stride=stride)
        else:
            self.skip = nn.Identity()

    def forward(self, x):
        return self.act(self.skip(x) + self.conv2(self.conv1(x)))


class StackedResidualBlocks(nn.Module):
    def __init__(self, n_blocks: int, in_ch: int, out_ch: int,
                 kernel_size: Sequence[int], stride: Sequence[int], **kwargs):
        super().__init__()
        ones = (1,) * len(kernel_size)
        self.blocks = nn.Sequential(*[
            ResidualBlock(in_ch if b == 0 else out_ch, out_ch, kernel_size,
                          stride if b == 0 else ones, **kwargs)
            for b in range(n_blocks)])

    def forward(self, x):
        return self.blocks(x)


@dataclasses.dataclass(frozen=True)
class ResidualUNetConfig:
    num_classes: int
    features_per_stage: Tuple[int, ...]
    kernel_sizes: Tuple[Tuple[int, ...], ...]
    strides: Tuple[Tuple[int, ...], ...]
    n_blocks_per_stage: Tuple[int, ...]
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
                        deep_supervision: Optional[bool] = None) -> "ResidualUNetConfig":
        n = arch["n_stages"]
        # ResEnc plans name the block counts 'n_conv_per_stage' (the repo's
        # planner) or 'n_blocks_per_stage' (dynamic_network_architectures')
        blocks = arch.get("n_blocks_per_stage", arch.get("n_conv_per_stage"))
        return cls(
            num_classes=num_classes,
            features_per_stage=tuple(arch["features_per_stage"]),
            kernel_sizes=_tuples(arch["kernel_sizes"]),
            strides=_tuples(arch["strides"]),
            n_blocks_per_stage=_per_stage(blocks, n),
            n_conv_per_stage_decoder=_per_stage(arch["n_conv_per_stage_decoder"], n - 1),
            conv_bias=arch.get("conv_bias", True),
            norm=resolve_op_name(arch.get("norm_op")),
            norm_kwargs=arch.get("norm_op_kwargs") or {},
            nonlin=resolve_op_name(arch.get("nonlin")),
            nonlin_kwargs=arch.get("nonlin_kwargs") or {},
            deep_supervision=(arch.get("deep_supervision", False)
                              if deep_supervision is None else deep_supervision),
        )


class ResidualEncoderUNet(PlansUNet):
    def __init__(self, cfg: ResidualUNetConfig, input_channels: int):
        super().__init__()
        self.cfg = cfg
        self.input_channels = input_channels
        self.compute_dtype = getattr(torch, cfg.dtype)
        self.encoder = nn.Module()
        stages = []
        cin = input_channels
        for s, feats in enumerate(cfg.features_per_stage):
            stages.append(StackedResidualBlocks(
                cfg.n_blocks_per_stage[s], cin, feats, cfg.kernel_sizes[s],
                cfg.strides[s], norm=cfg.norm, norm_kwargs=cfg.norm_kwargs,
                nonlin=cfg.nonlin, nonlin_kwargs=cfg.nonlin_kwargs,
                conv_bias=cfg.conv_bias, dtype=self.compute_dtype))
            cin = feats
        self.encoder.stages = nn.Sequential(*stages)
        self.decoder = self._build_decoder(cfg)
