"""nnU-Net-style conv U-Net decoder with deep-supervision heads, PyTorch.

Counterpart of ``dinounet_tpu/models/decoder.py``: per stage transposed conv
(from below) -> concat(skip) -> stacked conv-norm-nonlin blocks -> 1x1
segmentation head, in 2-D (NCHW) or 3-D (NCDHW) by the rank of the strides
and kernel sizes. All heads exist (so checkpoints load whatever the
deep-supervision flag); with deep supervision the call returns every head's
logits, highest resolution first, else only the top one. Parameter names are
the reference's (``transpconvs.0.weight``, ``stages.0.convs.1.norm.weight``,
``seg_layers.2.bias``). The 3-D stages run stock ``F.conv3d`` and
``F.conv_transpose3d`` (the JAX package's 3-D convs are XLA's, no Pallas).

In eval mode two 2-D inference routes of the JAX package can replace the stock
stages, on the same parameters (``configuration.py``):
- the fused channel-major chain (DINOUNET_TPU_DECODER_TAIL): from the first
  stage from which every remaining stage is eligible, all of them run through
  ``ops/decoder_tail.py::decoder_chain_cm``, each InstanceNorm apply in the
  next kernel's prologue and the seg heads fused with theirs;
- the HWBC stages (DINOUNET_TPU_DECODER_HWBC): an eligible sub-128-channel
  stage runs its two convs through ``ops/conv_hwbc.py``, conv0 reading the
  transposed-conv output and the skip as two inputs.
Their eligibility rules are the JAX package's (``decoder.py:323-420``), Mosaic
limits included, so both packages take a route on the same shapes.
"""

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dinounet_tpu_torch.configuration import use_decoder_hwbc, use_decoder_tail
from dinounet_tpu_torch.models.layers import (Conv2d, Conv3d, StackedConvBlocks,
                                              transposed_conv_nd)
from dinounet_tpu_torch.ops.conv_hwbc import (conv3x3_hwbc, hwbc_supported,
                                              instance_norm_prologue_params)
from dinounet_tpu_torch.ops.decoder_tail import (_pick_stripe, decoder_chain_cm,
                                                 tail_supported)


class _SegHeadForward:
    """1x1 conv to num_classes on operands rounded to the compute dtype,
    logits in fp32 with the bias added in fp32. In train mode the product is
    taken in fp32, as the JAX package's dot_general with an fp32 result does
    (``decoder.py:185-190``); in eval mode it rounds through the compute
    dtype once, as its default inference form ("convbf") does."""

    def forward(self, x):
        cdt = self.compute_dtype
        w = self.weight.to(cdt)
        if self.training:
            y = torch.einsum("bc...,kc->bk...", x.to(cdt).float(),
                             w.reshape(w.shape[0], w.shape[1]).float())
        else:
            y = self._conv(x.to(cdt), w).float()
        return y + self.bias.view(-1, *([1] * (x.dim() - 2)))


class SegHead(_SegHeadForward, Conv2d):
    def __init__(self, in_ch: int, num_classes: int, dtype: torch.dtype):
        super().__init__(in_ch, num_classes, 1, bias=True, dtype=dtype,
                         init="lecun")


class SegHead3d(_SegHeadForward, Conv3d):
    def __init__(self, in_ch: int, num_classes: int, dtype: torch.dtype):
        super().__init__(in_ch, num_classes, 1, bias=True, dtype=dtype,
                         init="lecun")


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
        self.encoder_channels = tuple(encoder_channels)
        self.encoder_strides = tuple(tuple(st) for st in encoder_strides)
        self.encoder_kernel_sizes = tuple(tuple(k) for k in encoder_kernel_sizes)
        self.n_conv_per_stage = tuple(n_conv_per_stage)
        self.norm, self.nonlin = norm, nonlin
        self.eps = (norm_kwargs or {}).get("eps", 1e-5)
        self.slope = (nonlin_kwargs or {}).get("negative_slope", 0.01)
        self.transpconvs = nn.ModuleList()
        self.stages = nn.ModuleList()
        self.seg_layers = nn.ModuleList()
        seg_head = SegHead if len(self.encoder_kernel_sizes[0]) == 2 else SegHead3d
        for s in range(1, n_stages):
            below = encoder_channels[-s]
            skip_ch = encoder_channels[-(s + 1)]
            self.transpconvs.append(transposed_conv_nd(
                below, skip_ch, self.encoder_strides[-s], bias=conv_bias,
                dtype=dtype))
            self.stages.append(StackedConvBlocks(
                n_conv_per_stage[s - 1], 2 * skip_ch, skip_ch,
                self.encoder_kernel_sizes[-(s + 1)], norm, norm_kwargs,
                nonlin, nonlin_kwargs, conv_bias, dtype))
            self.seg_layers.append(seg_head(skip_ch, num_classes, dtype))

    def forward(self, skips: List[torch.Tensor], deep_supervision: bool = False):
        if len(skips) != len(self.stages) + 1:
            raise ValueError(f"expected {len(self.stages) + 1} skips, got {len(skips)}")
        lres = skips[-1]
        seg_outputs = []
        last = len(self.stages) - 1
        for s, (up, stage, seg) in enumerate(zip(self.transpconvs, self.stages,
                                                 self.seg_layers)):
            if self._use_fused_chain(s, skips):
                outs = self._fused_chain(s, lres, skips, deep_supervision)
                seg_outputs.extend(o for o in outs if o is not None)
                break
            x_up, skip = up(lres), skips[-(s + 2)]
            if self._use_hwbc(s, x_up, skip):
                x = self._hwbc_stage(s, x_up, skip)
            else:
                x = stage(torch.cat([x_up, skip], dim=1))
            if deep_supervision or s == last:
                seg_outputs.append(seg(x))
            lres = x
        seg_outputs = seg_outputs[::-1]
        return seg_outputs if deep_supervision else seg_outputs[0]

    def _stage_is_2conv_3x3_in_leaky(self, s: int) -> bool:
        return (self.norm == "instancenorm" and self.nonlin == "leaky_relu"
                and self.n_conv_per_stage[s] == 2
                and self.encoder_kernel_sizes[-(s + 2)] == (3, 3))

    def _use_fused_chain(self, s: int, skips) -> bool:
        """All-or-nothing from stage s (JAX ``_use_fused_chain``): every
        remaining stage upsamples by 2, has two 3x3 InstanceNorm + leaky ReLU
        convs, and has a skip map the JAX kernels take."""
        if self.training or not use_decoder_tail(skips[-1]):
            return False
        for j in range(s, len(self.stages)):
            if self.encoder_strides[-(j + 1)] != (2, 2):
                return False
            if not self._stage_is_2conv_3x3_in_leaky(j):
                return False
            skip = skips[-(j + 2)]
            if skip.dim() != 4:
                return False
            H, W = skip.shape[2], skip.shape[3]
            if not tail_supported(tuple(skip.shape)):
                return False
            if H % 2 or W % 2 or _pick_stripe(H // 2, vmem_rows=16) is None:
                return False
        return True

    @staticmethod
    def _bias(m):
        """A conv's bias, zeros where it has none (conv_bias=False)."""
        if m.bias is not None:
            return m.bias
        return torch.zeros(m.out_channels, device=m.weight.device)

    def _conv_params(self, block):
        return block.conv.weight, self._bias(block.conv), block.norm.weight, block.norm.bias

    def _fused_chain(self, s: int, lres, skips, deep_supervision: bool):
        """Stages s.. through ``decoder_chain_cm``: one entry per stage, fp32
        logits where a head is computed, None elsewhere."""
        stage_params, seg_params, chain_skips = [], [], []
        for j in range(s, len(self.stages)):
            up = self.transpconvs[j]
            c0, c1 = self.stages[j].convs
            stage_params.append((up.weight, self._bias(up), *self._conv_params(c0),
                                 *self._conv_params(c1)))
            seg_params.append((self.seg_layers[j].weight, self.seg_layers[j].bias))
            chain_skips.append(skips[-(j + 2)])
        return decoder_chain_cm(lres, chain_skips, stage_params, seg_params,
                                deep_supervision, eps=self.eps, slope=self.slope)

    def _use_hwbc(self, s: int, x_up, skip) -> bool:
        """JAX ``_use_hwbc``: a sub-128-channel 2-D bf16 stage of two 3x3
        InstanceNorm + leaky ReLU convs whose map the JAX kernel takes."""
        if self.training or not self._stage_is_2conv_3x3_in_leaky(s):
            return False
        if x_up.dim() != 4 or x_up.dtype != torch.bfloat16 or x_up.shape != skip.shape:
            return False
        if self.encoder_channels[-(s + 2)] >= 128:
            return False
        if not use_decoder_hwbc(x_up):
            return False
        B, C, H, W = x_up.shape
        return hwbc_supported((B, H, W, C))

    def _hwbc_stage(self, s: int, x_up, skip):
        """conv0([x_up, skip]) + IN + leaky + conv1 + IN + leaky through
        ``conv3x3_hwbc`` on (H, W, B, C) views of the NCHW maps; the last
        apply + leaky stays a plain op, as in the JAX package."""
        c0, c1 = self.stages[s].convs
        w0, b0, g0, be0 = self._conv_params(c0)
        w1, b1, g1, be1 = self._conv_params(c1)
        n = x_up.shape[2] * x_up.shape[3]
        y0, s0, q0 = conv3x3_hwbc(x_up.permute(2, 3, 0, 1), w0, b0,
                                  x2=skip.permute(2, 3, 0, 1))
        p0 = instance_norm_prologue_params(s0, q0, n, g0, be0, self.eps)
        y1, s1, q1 = conv3x3_hwbc(y0, w1, b1, prologue=p0, leaky_slope=self.slope)
        sc1, sh1 = instance_norm_prologue_params(s1, q1, n, g1, be1, self.eps)
        yf = y1.float() * sc1[None, None] + sh1[None, None]
        yl = torch.where(yf >= 0, yf, yf * self.slope).to(x_up.dtype)
        return yl.permute(2, 3, 0, 1)
