"""Shared building blocks for the adapter, FAPM and the U-Nets: NCHW, and
NCDHW for the 3-D convs, norms and transposed convs of the plans' networks.

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
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dinounet_tpu_torch.configuration import use_decoder_tail
from dinounet_tpu_torch.ops.decoder_tail import _pick_stripe, transpconv2x2_cm

# flax's truncated normal has std 1 after truncation at +-2: the unit-variance
# correction of variance_scaling(..., "truncated_normal")
_TRUNC_STD = 0.87962566103423978


def _draw_fp32(t: torch.Tensor, fill: Callable[[torch.Tensor], None]) -> None:
    """Run the in-place draw `fill` on t, or, for a tensor held in a narrower
    dtype (a frozen backbone at its serving dtype), on an fp32 tensor of its
    shape that is then rounded into t: a draw in bf16 would be coarse."""
    with torch.no_grad():
        if t.dtype == torch.float32:
            fill(t)
        else:
            full = torch.empty(t.shape, dtype=torch.float32, device=t.device)
            fill(full)
            t.copy_(full)


def trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """Normal(0, std) truncated to +-2 std (flax initializers.truncated_normal)."""
    _draw_fp32(t, lambda u: nn.init.trunc_normal_(u, 0.0, std, -2.0 * std, 2.0 * std,
                                                  generator=gen))


def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax lecun_normal: variance 1/fan_in, truncated normal."""
    trunc_normal_(t, math.sqrt(1.0 / fan_in) / _TRUNC_STD, gen)


def kaiming_fan_out_normal_(t: torch.Tensor, fan_out: int,
                            gen: torch.Generator) -> None:
    """The reference's conv init, normal(0, sqrt(2 / fan_out)) (flax
    variance_scaling(2, "fan_out", "normal"), fan_out = kh * kw * C_out)."""
    _draw_fp32(t, lambda u: u.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen))


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


def xla_same_pads(sizes: Sequence[int], kernel: Sequence[int],
                  stride: Sequence[int]) -> List[Tuple[int, int]]:
    """XLA's "SAME" padding, (lo, hi) per spatial dim: the output has
    ceil(n / s) positions and the odd pixel of an odd total pads the end
    (flax ``padding="SAME"``). A stride-2 3x3 conv over an even size pads
    (0, 1), where torch's symmetric padding=1 would pad (1, 1)."""
    pads = []
    for n, k, st in zip(sizes, kernel, stride):
        total = max((-(-n // st) - 1) * st + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


class _ConvForward:
    """The forward and init of Conv2d / Conv3d: inputs and weights cast to
    the compute dtype; "kaiming" init (the reference's fan-out normal, flax
    conv_kaiming_init) or "lecun" (flax's nn.Conv default), zero biases.
    Built with padding="same", the conv pads as XLA's SAME does
    (``xla_same_pads``), per call from the input's size."""

    def _setup(self, dtype: torch.dtype, init: str, same: bool) -> None:
        self.compute_dtype = dtype
        self.init = init
        self.same = same

    def init_params(self, gen):
        field = math.prod(self.kernel_size)
        if self.init == "kaiming":
            kaiming_fan_out_normal_(self.weight, field * self.out_channels, gen)
        else:
            lecun_normal_(self.weight, field * self.in_channels // self.groups, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        cdt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(cdt)
        padding = self.padding
        if self.same:
            pads = xla_same_pads(x.shape[2:], self.kernel_size, self.stride)
            if all(lo == hi for lo, hi in pads):
                padding = tuple(lo for lo, _ in pads)
            else:
                x = F.pad(x, [v for lo, hi in reversed(pads) for v in (lo, hi)])
                padding = 0
        return self._conv(x.to(cdt), self.weight.to(cdt), b, self.stride,
                          padding, self.dilation, self.groups)


class Conv2d(_ConvForward, nn.Conv2d):
    """nn.Conv2d computing in `dtype` (see ``_ConvForward``)."""
    _conv = staticmethod(F.conv2d)

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=1,
                 padding=0, groups: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16, init: str = "kaiming"):
        same = padding == "same"
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=0 if same else padding, groups=groups, bias=bias)
        self._setup(dtype, init, same)


class Conv3d(_ConvForward, nn.Conv3d):
    """nn.Conv3d computing in `dtype` (see ``_ConvForward``): stock
    ``F.conv3d``, as the JAX package runs its 3-D convs through XLA."""
    _conv = staticmethod(F.conv3d)

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=1,
                 padding=0, groups: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16, init: str = "kaiming"):
        same = padding == "same"
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=0 if same else padding, groups=groups, bias=bias)
        self._setup(dtype, init, same)


def conv_nd(in_ch: int, out_ch: int, kernel_size: Sequence[int], **kwargs) -> nn.Module:
    """Conv2d or Conv3d by the rank of `kernel_size`."""
    cls = Conv2d if len(kernel_size) == 2 else Conv3d
    return cls(in_ch, out_ch, tuple(kernel_size), **kwargs)


class _TransposedConvForward:
    """ConvTranspose(kernel = stride): exact upsampling by the stride,
    computing in `dtype`; fan-out normal weight (fan_out = prod(kernel) *
    C_out), zero bias."""

    def init_params(self, gen):
        kaiming_fan_out_normal_(self.weight,
                                math.prod(self.kernel_size) * self.out_channels, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        cdt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(cdt)
        return self._conv_t(x.to(cdt), self.weight.to(cdt), b, self.stride)


class TransposedConv(_TransposedConvForward, nn.ConvTranspose2d):
    """2-D: ConvTranspose2d(kernel = stride)."""
    _conv_t = staticmethod(F.conv_transpose2d)

    def __init__(self, in_ch: int, out_ch: int, stride: Tuple[int, int] = (2, 2),
                 bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_ch, out_ch, tuple(stride), stride=tuple(stride),
                         bias=bias)
        self.compute_dtype = dtype


class TransposedConv3d(_TransposedConvForward, nn.ConvTranspose3d):
    """3-D: ConvTranspose3d(kernel = stride), anisotropic strides such as
    (1, 2, 2) included; stock ``F.conv_transpose3d``."""
    _conv_t = staticmethod(F.conv_transpose3d)

    def __init__(self, in_ch: int, out_ch: int, stride: Tuple[int, int, int],
                 bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_ch, out_ch, tuple(stride), stride=tuple(stride),
                         bias=bias)
        self.compute_dtype = dtype


def transposed_conv_nd(in_ch: int, out_ch: int, stride: Sequence[int],
                       **kwargs) -> nn.Module:
    """TransposedConv or TransposedConv3d by the rank of `stride`."""
    cls = TransposedConv if len(stride) == 2 else TransposedConv3d
    return cls(in_ch, out_ch, tuple(stride), **kwargs)


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


def _per_channel(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (C,) vector shaped to broadcast over (B, C, *spatial) of rank ndim."""
    return v.view(-1, *([1] * (ndim - 2)))


class InstanceNorm(nn.Module):
    """InstanceNorm{2,3}d(affine=True): fp32 one-pass statistics over the
    spatial axes per (sample, channel); the result in the input's dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        xf = x.float()
        axes = tuple(range(2, x.dim()))
        mean = xf.mean(dim=axes, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=axes, keepdim=True) - mean * mean,
                          min=0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * _per_channel(self.weight, x.dim())
                + _per_channel(self.bias, x.dim())).to(x.dtype)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over 2 or 3 spatial axes with flax's semantics, fp32 in and
    out (the flax module's dtype=float32, momentum 0.9). In eval mode it
    applies the running statistics. In train mode it normalises with the
    batch mean and the biased batch variance, E[x^2] - E[x]^2 clamped at 0
    as flax computes it, and updates ra = 0.9 ra + 0.1 batch_stat with the
    *biased* variance too. F.batch_norm(training=True) would put the
    unbiased variance into running_var, so the update is done here."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=0.1)

    def forward(self, x):
        xf = x.float()
        if not self.training:
            return F.batch_norm(xf, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        axes = (0,) + tuple(range(2, x.dim()))
        mean = xf.mean(dim=axes)
        var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean, min=0.0)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(self.momentum * mean)
            self.running_var.mul_(keep).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - _per_channel(mean, x.dim())) * _per_channel(scale, x.dim())
                + _per_channel(self.bias, x.dim()))


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
    """conv -> norm -> nonlin (nnU-Net's ConvDropoutNormReLU order), 2-D or
    3-D by the rank of `kernel_size`; the conv pads as XLA's SAME does."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: Sequence[int],
                 norm: str, norm_kwargs: Optional[dict], nonlin: str,
                 nonlin_kwargs: Optional[dict], conv_bias: bool,
                 dtype: torch.dtype, stride: Optional[Sequence[int]] = None):
        super().__init__()
        stride = tuple(stride) if stride is not None else (1,) * len(kernel_size)
        self.conv = conv_nd(in_ch, out_ch, kernel_size, stride=stride,
                            padding="same", bias=conv_bias, dtype=dtype)
        self.norm = Norm(norm, out_ch, eps=(norm_kwargs or {}).get("eps", 1e-5))
        self.nonlin = Nonlin(nonlin, nonlin_kwargs)

    def forward(self, x):
        return self.nonlin(self.norm(self.conv(x)))


class StackedConvBlocks(nn.Module):
    """n ConvNormAct blocks; the first maps in -> out channels and carries
    `initial_stride` (default all 1)."""

    def __init__(self, n_convs: int, in_ch: int, out_ch: int,
                 kernel_size: Sequence[int], norm: str,
                 norm_kwargs: Optional[dict], nonlin: str,
                 nonlin_kwargs: Optional[dict], conv_bias: bool,
                 dtype: torch.dtype, initial_stride: Optional[Sequence[int]] = None):
        super().__init__()
        self.convs = nn.Sequential(*[
            ConvNormAct(in_ch if i == 0 else out_ch, out_ch, kernel_size, norm,
                        norm_kwargs, nonlin, nonlin_kwargs, conv_bias, dtype,
                        stride=initial_stride if i == 0 else None)
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
