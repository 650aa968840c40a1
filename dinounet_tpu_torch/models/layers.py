"""Shared building blocks (NCHW) for the adapter, FAPM and U-Net decoder.

Counterpart of ``dinounet_tpu/models/layers.py``. Parameters are fp32 and
named as the reference torch modules name them (``weight``, ``bias``,
``running_mean``...), so published checkpoints load by name; every conv and
linear casts its input and weights to the model's compute dtype, as the flax
modules do with ``dtype=``. Fresh parameters are drawn as the flax modules
draw theirs: each layer with random parameters names its distribution in
``init_params(gen)`` (see ``lecun_normal_`` and ``kaiming_fan_out_normal_``),
and ``init_module(module, gen)`` applies them; the norms and LayerScale are
constructed at their constant init values (ones, zeros, 1e-5).
"""

import functools
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dinounet_tpu_torch.configuration import use_decoder_tail
from dinounet_tpu_torch.ops.decoder_tail import _pick_stripe, transpconv2x2_cm

# flax's truncated normal has std 1 after truncation at +-2: the unit-variance
# correction of variance_scaling(..., "truncated_normal")
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """Normal(0, std) truncated to +-2 std (flax initializers.truncated_normal)."""
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax lecun_normal: variance 1/fan_in, truncated normal."""
    trunc_normal_(t, math.sqrt(1.0 / fan_in) / _TRUNC_STD, gen)


def kaiming_fan_out_normal_(t: torch.Tensor, fan_out: int,
                            gen: torch.Generator) -> None:
    """The reference's conv init, normal(0, sqrt(2 / fan_out)) (flax
    variance_scaling(2, "fan_out", "normal"), fan_out = kh * kw * C_out)."""
    with torch.no_grad():
        t.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)


def init_module(module: nn.Module, gen: torch.Generator) -> None:
    """Draw every parameter of `module` with its layer's initializer,
    children before parents (a parent's init overrides its children's, as
    MSDeformAttn's zero offset kernels override its Linears')."""
    for m in reversed(list(module.modules())):
        init = getattr(m, "init_params", None)
        if init is not None:
            init(gen)


class Linear(nn.Linear):
    """nn.Linear computing in `dtype`; lecun_normal weight, zero bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def init_params(self, gen):
        lecun_normal_(self.weight, self.in_features, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        cdt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(cdt)
        return F.linear(x.to(cdt), self.weight.to(cdt), b)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in `dtype`. `init` is "kaiming" (the reference's
    fan-out normal, flax conv_kaiming_init) or "lecun" (flax's nn.Conv
    default); biases start at zero."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=1,
                 padding=0, groups: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16, init: str = "kaiming"):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding, groups=groups, bias=bias)
        self.compute_dtype = dtype
        self.init = init

    def init_params(self, gen):
        kh, kw = self.kernel_size
        if self.init == "kaiming":
            kaiming_fan_out_normal_(self.weight, kh * kw * self.out_channels, gen)
        else:
            lecun_normal_(self.weight, kh * kw * self.in_channels // self.groups, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        cdt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(cdt)
        return F.conv2d(x.to(cdt), self.weight.to(cdt), b, self.stride,
                        self.padding, self.dilation, self.groups)


class TransposedConv(nn.ConvTranspose2d):
    """ConvTranspose2d(kernel = stride): exact x2 upsampling, computing in
    `dtype`; fan-out normal weight (fan_out = kh * kw * C_out)."""

    def __init__(self, in_ch: int, out_ch: int, stride: Tuple[int, int] = (2, 2),
                 bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_ch, out_ch, tuple(stride), stride=tuple(stride),
                         bias=bias)
        self.compute_dtype = dtype

    def init_params(self, gen):
        kh, kw = self.kernel_size
        kaiming_fan_out_normal_(self.weight, kh * kw * self.out_channels, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        cdt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(cdt)
        return F.conv_transpose2d(x.to(cdt), self.weight.to(cdt), b, self.stride)


class Nonlin(nn.Module):
    """The plans' nonlinearity by semantic name (see nonlin_fn)."""

    def __init__(self, name: str, kwargs: Optional[dict] = None):
        super().__init__()
        self.fn = nonlin_fn(name, kwargs)

    def forward(self, x):
        return self.fn(x)


def nonlin_fn(name: str, kwargs: Optional[dict] = None) -> Callable:
    kwargs = kwargs or {}
    if name == "leaky_relu":
        slope = kwargs.get("negative_slope", 0.01)
        return lambda x: F.leaky_relu(x, negative_slope=slope)
    if name == "relu":
        return F.relu
    if name == "gelu":
        return F.gelu
    if name == "none":
        return lambda x: x
    raise KeyError(f"Unknown nonlinearity {name}")


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=True): fp32 one-pass statistics over H, W per
    (sample, channel); the result in the input's dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=(2, 3), keepdim=True) - mean * mean,
                          min=0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight[:, None, None] + self.bias[:, None, None]).to(x.dtype)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with flax's semantics, fp32 in and out (the flax module's
    dtype=float32, momentum 0.9). In eval mode it applies the running
    statistics. In train mode it normalises with the batch mean and the
    biased batch variance, E[x^2] - E[x]^2 clamped at 0 as flax computes it,
    and updates ra = 0.9 ra + 0.1 batch_stat with the *biased* variance too.
    F.batch_norm(training=True) would put the unbiased variance into
    running_var, so the update is done here."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=0.1)

    def forward(self, x):
        xf = x.float()
        if not self.training:
            return F.batch_norm(xf, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        axes = (0, 2, 3)
        mean = xf.mean(dim=axes)
        var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean, min=0.0)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(self.momentum * mean)
            self.running_var.mul_(keep).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean[:, None, None]) * scale[:, None, None]
                + self.bias[:, None, None])


def Norm(kind: str, num_features: int, eps: float = 1e-5) -> nn.Module:
    """The norm named by the plans ('instancenorm' | 'batchnorm' | 'none')."""
    if kind == "instancenorm":
        return InstanceNorm(num_features, eps)
    if kind == "batchnorm":
        return BatchNorm(num_features, eps=eps)
    if kind == "none":
        return nn.Identity()
    raise KeyError(f"Unknown norm kind {kind}")


class ConvNormAct(nn.Module):
    """conv -> norm -> nonlin (nnU-Net's ConvDropoutNormReLU order)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: Tuple[int, int],
                 norm: str, norm_kwargs: Optional[dict], nonlin: str,
                 nonlin_kwargs: Optional[dict], conv_bias: bool,
                 dtype: torch.dtype):
        super().__init__()
        pad = tuple((k - 1) // 2 for k in kernel_size)
        self.conv = Conv2d(in_ch, out_ch, tuple(kernel_size), padding=pad,
                           bias=conv_bias, dtype=dtype)
        self.norm = Norm(norm, out_ch, eps=(norm_kwargs or {}).get("eps", 1e-5))
        self.nonlin = Nonlin(nonlin, nonlin_kwargs)

    def forward(self, x):
        return self.nonlin(self.norm(self.conv(x)))


class StackedConvBlocks(nn.Module):
    """n ConvNormAct blocks; the first maps in -> out channels."""

    def __init__(self, n_convs: int, in_ch: int, out_ch: int,
                 kernel_size: Tuple[int, int], norm: str,
                 norm_kwargs: Optional[dict], nonlin: str,
                 nonlin_kwargs: Optional[dict], conv_bias: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.convs = nn.Sequential(*[
            ConvNormAct(in_ch if i == 0 else out_ch, out_ch, kernel_size, norm,
                        norm_kwargs, nonlin, nonlin_kwargs, conv_bias, dtype)
            for i in range(n_convs)])

    def forward(self, x):
        return self.convs(x)


class SqueezeExcitation(nn.Module):
    """SE block: channel means in fp32, 1x1 -> ReLU -> 1x1, sigmoid gate."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        reduced = max(1, channels // reduction)
        self.fc = nn.Sequential(
            Conv2d(channels, reduced, 1, dtype=dtype, init="lecun"), nn.ReLU(),
            Conv2d(reduced, channels, 1, dtype=dtype, init="lecun"))

    def forward(self, x):
        w = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        return x * torch.sigmoid(self.fc(w))


class DepthwiseSeparableConv(nn.Module):
    """depthwise 3x3 -> pointwise 1x1 -> norm -> nonlin."""

    def __init__(self, in_ch: int, out_ch: int, norm: str, nonlin: str,
                 nonlin_kwargs: Optional[dict], bias: bool, dtype: torch.dtype):
        super().__init__()
        self.depthwise = Conv2d(in_ch, in_ch, 3, padding=1, groups=in_ch,
                                bias=bias, dtype=dtype)
        self.pointwise = Conv2d(in_ch, out_ch, 1, bias=bias, dtype=dtype)
        self.bn = Norm(norm, out_ch)
        self.act = Nonlin(nonlin, nonlin_kwargs)

    def forward(self, x):
        return self.act(self.bn(self.pointwise(self.depthwise(x))))


@functools.lru_cache(maxsize=None)
def _resize_matrix(src: int, dst: int) -> np.ndarray:
    """One axis of a bilinear resize as a dense (dst, src) matrix: torch's
    F.interpolate(bilinear, align_corners=False, antialias=False), out-of-range
    taps dropped and the row renormalized (the JAX package's matrix)."""
    scale = src / dst
    out = np.zeros((dst, src), np.float32)
    for i in range(dst):
        center = (i + 0.5) * scale - 0.5
        js = np.arange(int(np.floor(center - 1.0)), int(np.ceil(center + 1.0)) + 1)
        w = np.maximum(0.0, 1.0 - np.abs(js - center))
        valid = (js >= 0) & (js < src)
        if w.sum() > 0:
            np.add.at(out[i], js[valid], w[valid] / w.sum())
            kept = out[i].sum()
            if kept > 0:
                out[i] /= kept
    return out


@functools.lru_cache(maxsize=64)
def _resize_matrix_on(src: int, dst: int, dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_matrix(src, dst)).to(device=device, dtype=dtype)


def bilinear_resize(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear resize of an NCHW map as two matrix products (H, then W) in
    the input's dtype with fp32 accumulation, matching
    F.interpolate(bilinear, align_corners=False, antialias=False)."""
    H, W = x.shape[2], x.shape[3]
    if (H, W) == tuple(size):
        return x
    y = x
    if size[0] != H:
        y = torch.einsum("hH,bcHw->bchw",
                         _resize_matrix_on(H, size[0], x.dtype, x.device), y)
    if size[1] != W:
        y = torch.einsum("wW,bchW->bchw",
                         _resize_matrix_on(W, size[1], x.dtype, x.device), y)
    return y


class LearnableUpsample(nn.Module):
    """A shared 2x transposed conv repeated while the map fits in the target,
    then a bilinear resize to the exact size. In eval mode, with the decoder
    tail route on (DINOUNET_TPU_DECODER_TAIL, ``configuration.py``), a bf16
    map's doublings run through ``ops/decoder_tail.py::transpconv2x2_cm`` where
    the JAX package runs them channel-major (``layers.py:540-569``)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.up2 = TransposedConv(channels, channels, (2, 2), dtype=dtype)

    def forward(self, x, target_size: Tuple[int, int]):
        h, w = x.shape[2], x.shape[3]
        doublings = []
        while h * 2 <= target_size[0] and w * 2 <= target_size[1]:
            doublings.append(h)
            h, w = h * 2, w * 2
        if doublings and self._use_cm(x, doublings):
            for _ in doublings:
                x = transpconv2x2_cm(x, self.up2.weight, self.up2.bias)
        else:
            for _ in doublings:
                x = self.up2(x)
        if (h, w) != tuple(target_size):
            x = bilinear_resize(x, target_size)
        return x

    def _use_cm(self, x, heights) -> bool:
        if self.training or x.dim() != 4 or x.dtype != torch.bfloat16:
            return False
        if not use_decoder_tail(x):
            return False
        return all(_pick_stripe(h, vmem_rows=16) is not None for h in heights)
