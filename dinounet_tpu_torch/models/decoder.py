"""nnU-Net-style conv U-Net decoder with deep-supervision heads, PyTorch.

Counterpart of ``dinounet_tpu/models/decoder.py`` on its plain concat path:
per stage transposed conv (from below) -> concat(skip) -> stacked
conv-norm-nonlin blocks -> 1x1 segmentation head. All heads exist (so
checkpoints load whatever the deep-supervision flag); with deep supervision
the call returns every head's logits, highest resolution first, else only the
top one. Parameter names are the reference's (``transpconvs.0.weight``,
``stages.0.convs.1.norm.weight``, ``seg_layers.2.bias``).
"""

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dinounet_tpu_torch.models.layers import (Conv2d, StackedConvBlocks,
                                              TransposedConv)


class SegHead(Conv2d):
    """1x1 conv to num_classes: the input contracted in the compute dtype,
    logits in fp32 with the bias added in fp32."""

    def __init__(self, in_ch: int, num_classes: int, dtype: torch.dtype):
        super().__init__(in_ch, num_classes, 1, bias=True, dtype=dtype,
                         init="lecun")

    def forward(self, x):
        cdt = self.compute_dtype
        y = F.conv2d(x.to(cdt), self.weight.to(cdt))
        return y.float() + self.bias[:, None, None]


class UNetDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int],
                 encoder_strides: Sequence[Tuple[int, int]],
                 encoder_kernel_sizes: Sequence[Tuple[int, int]],
                 num_classes: int, n_conv_per_stage: Sequence[int],
                 norm: str = "instancenorm", norm_kwargs: Optional[dict] = None,
                 nonlin: str = "leaky_relu", nonlin_kwargs: Optional[dict] = None,
                 conv_bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        n_stages = len(encoder_channels)
        if len(n_conv_per_stage) != n_stages - 1:
            raise ValueError("n_conv_per_stage needs one entry per decoder stage")
        self.transpconvs = nn.ModuleList()
        self.stages = nn.ModuleList()
        self.seg_layers = nn.ModuleList()
        for s in range(1, n_stages):
            below = encoder_channels[-s]
            skip_ch = encoder_channels[-(s + 1)]
            self.transpconvs.append(TransposedConv(
                below, skip_ch, tuple(encoder_strides[-s]), bias=conv_bias,
                dtype=dtype))
            self.stages.append(StackedConvBlocks(
                n_conv_per_stage[s - 1], 2 * skip_ch, skip_ch,
                tuple(encoder_kernel_sizes[-(s + 1)]), norm, norm_kwargs,
                nonlin, nonlin_kwargs, conv_bias, dtype))
            self.seg_layers.append(SegHead(skip_ch, num_classes, dtype))

    def forward(self, skips: List[torch.Tensor], deep_supervision: bool = False):
        if len(skips) != len(self.stages) + 1:
            raise ValueError(f"expected {len(self.stages) + 1} skips, got {len(skips)}")
        lres = skips[-1]
        seg_outputs = []
        last = len(self.stages) - 1
        for s, (up, stage, seg) in enumerate(zip(self.transpconvs, self.stages,
                                                 self.seg_layers)):
            x = stage(torch.cat([up(lres), skips[-(s + 2)]], dim=1))
            if deep_supervision or s == last:
                seg_outputs.append(seg(x))
            lres = x
        seg_outputs = seg_outputs[::-1]
        return seg_outputs if deep_supervision else seg_outputs[0]
