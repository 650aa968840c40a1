"""FAPM (fidelity-aware projection module) and the encoder around it, PyTorch.

Counterpart of ``dinounet_tpu/models/fapm.py``. FAPM: a shared and a
per-scale 1x1 basis (embed_dim -> rank), a FiLM generator from the shared
branch modulating the specific one, then per scale a refinement (1x1 reduce
-> norm/act -> depthwise-separable 3x3 -> 1x1 -> squeeze-excitation) plus a
projected residual of the modulated features. The encoder holds the
DINOv3Adapter, as the reference's DINOv3EncoderAdapter does, and upsamples
skip i to (H/2^i, W/2^i) with a learnable x2 transposed conv. Parameter names
are the reference's (``fapm.refinement_blocks.0.3.depthwise.weight``, ...).
"""

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from dinounet_tpu_torch.models.adapter import DINOv3Adapter
from dinounet_tpu_torch.models.layers import (Conv2d, DepthwiseSeparableConv,
                                              LearnableUpsample, Nonlin, Norm,
                                              SqueezeExcitation)


class FAPM(nn.Module):
    def __init__(self, in_channels: int, rank: int, out_channels: Sequence[int],
                 norm: str = "instancenorm", nonlin: str = "leaky_relu",
                 nonlin_kwargs: Optional[dict] = None, conv_bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.rank = rank

        def conv1x1(cin, cout):
            return Conv2d(cin, cout, 1, bias=conv_bias, dtype=dtype)

        self.shared_basis = conv1x1(in_channels, rank)
        self.specific_bases = nn.ModuleList(
            [conv1x1(in_channels, rank) for _ in out_channels])
        self.film_generators = nn.ModuleList(
            [conv1x1(rank, 2 * rank) for _ in out_channels])
        self.refinement_blocks = nn.ModuleList([
            nn.Sequential(
                conv1x1(rank, oc), Norm(norm, oc), Nonlin(nonlin, nonlin_kwargs),
                DepthwiseSeparableConv(oc, oc, norm, nonlin, nonlin_kwargs,
                                       conv_bias, dtype),
                conv1x1(oc, oc), SqueezeExcitation(oc, dtype=dtype))
            for oc in out_channels])
        self.shortcut_projections = nn.ModuleList([
            conv1x1(rank, oc) if oc != rank else nn.Identity()
            for oc in out_channels])

    def forward(self, x_list: List[torch.Tensor]) -> List[torch.Tensor]:
        outs = []
        for i, x in enumerate(x_list):
            z_shared = self.shared_basis(x)
            z_specific = self.specific_bases[i](x)
            gamma, beta = torch.split(self.film_generators[i](z_shared),
                                      self.rank, dim=1)
            z_mod = gamma * z_specific + beta
            outs.append(self.refinement_blocks[i](z_mod)
                        + self.shortcut_projections[i](z_mod))
        return outs


class FAPMEncoder(nn.Module):
    """x (B, 3, H, W) -> adapter maps -> FAPM -> skips at (H/2^i, W/2^i)."""

    def __init__(self, dinov3_adapter: DINOv3Adapter, embed_dim: int,
                 target_channels: Sequence[int], norm: str = "instancenorm",
                 nonlin: str = "leaky_relu", nonlin_kwargs: Optional[dict] = None,
                 conv_bias: bool = False, rank: int = 256,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dinov3_adapter = dinov3_adapter
        self.fapm = FAPM(embed_dim, rank, tuple(target_channels), norm, nonlin,
                         nonlin_kwargs, conv_bias, dtype)
        self.ups = nn.ModuleList([LearnableUpsample(c, dtype)
                                  for c in target_channels])

    def skips_from_features(self, adapter_feats: List[torch.Tensor],
                            image_hw: Tuple[int, int]) -> List[torch.Tensor]:
        H, W = image_hw
        return [up(y, (H // (2 ** i), W // (2 ** i)))
                for i, (up, y) in enumerate(zip(self.ups, self.fapm(adapter_feats)))]

    def forward(self, x):
        return self.skips_from_features(self.dinov3_adapter(x), x.shape[2:])
