"""Plain reference of nnU-Net's 2-D training augmentation of one sample,
given its random draws: rotation and scaling of the sampling grid about the
centres with a crop to the patch (bilinear data, nearest labels, -1 outside),
Gaussian noise, a separable Gaussian blur (radius 4, edges replicated),
multiplicative brightness, range-preserving contrast, low-resolution
simulation (a 1/zoom grid sampled back bilinearly), inverted and plain gamma
that keep the sample's mean and standard deviation, mirroring, the
nonzero-mask zeroing and the -1 -> 0 label cleanup (nnU-Net v2's
``nnUNetTrainer.get_training_transforms``, batchgenerators' transforms).

The draws are a dict of ``angle``, ``scale``, ``noise`` ((C, H, W) or None),
``blur_sigmas``, ``brightness``, ``contrast``, ``lowres_zooms`` (per channel,
None where not applied), ``gamma_invert``, ``gamma`` and ``flips`` (H, W).
Warps go through ``F.grid_sample``; every step computes in `dtype`."""

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def _grid_sample(img: torch.Tensor, src_y, src_x, mode: str) -> torch.Tensor:
    """img (C, H, W) at source pixel coordinates (h, w), zero outside."""
    H, W = img.shape[-2:]
    grid = torch.stack([src_x / (W - 1) * 2 - 1, src_y / (H - 1) * 2 - 1], -1)[None]
    return F.grid_sample(img[None], grid.to(img.dtype), mode=mode, padding_mode="zeros",
                         align_corners=True)[0]


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """img (H, W) blurred by a normalised 9-tap Gaussian in both axes."""
    t = torch.arange(-4, 5, dtype=img.dtype, device=img.device)
    k = torch.exp(-0.5 * (t / max(sigma, 1e-6)) ** 2)
    k = k / k.sum()
    x = F.pad(img[None, None], (4, 4, 4, 4), mode="replicate")
    return F.conv2d(x, (k[:, None] * k[None, :])[None, None])[0, 0]


def _lowres(img: torch.Tensor, zoom: float) -> torch.Tensor:
    """img (H, W) snapped to the centres of a 1/zoom grid, sampled back."""
    H, W = img.shape
    step = 1.0 / zoom

    def snap(n):
        i = torch.arange(n, dtype=img.dtype, device=img.device)
        return torch.floor(i / step) * step + step / 2

    yy, xx = torch.meshgrid(snap(H), snap(W), indexing="ij")
    return _grid_sample(img[None], yy, xx, "bilinear")[0]


def _gamma(x: torch.Tensor, gamma: float, invert: bool) -> torch.Tensor:
    xin = -x if invert else x
    mean, std = xin.mean(), xin.std(correction=0)
    lo, hi = xin.min(), xin.max()
    rng = torch.clamp(hi - lo, min=1e-7)
    y = ((xin - lo) / rng) ** gamma * (hi - lo) + lo
    y = (y - y.mean()) / torch.clamp(y.std(correction=0), min=1e-8) * std + mean
    return -y if invert else y


def augment(data: torch.Tensor, seg: torch.Tensor, d: dict, patch: Tuple[int, int],
            use_mask: Sequence[bool] = (), dtype=torch.float32):
    """data (C, H_in, W_in), seg (H_in, W_in) integer labels -> the sample
    at `patch`: data in `dtype`, labels int64."""
    H, W = patch
    H_in, W_in = data.shape[-2:]
    dev = data.device
    x = data.to(dtype)

    angle = torch.tensor(d["angle"], dtype=dtype, device=dev)
    scale = torch.tensor(d["scale"], dtype=dtype, device=dev)
    yy = (torch.arange(H, dtype=dtype, device=dev) - (H - 1) / 2)[:, None]
    xx = (torch.arange(W, dtype=dtype, device=dev) - (W - 1) / 2)[None, :]
    src_y = (torch.cos(angle) * yy - torch.sin(angle) * xx) * scale + (H_in - 1) / 2
    src_x = (torch.sin(angle) * yy + torch.cos(angle) * xx) * scale + (W_in - 1) / 2
    x = _grid_sample(x, src_y, src_x, "bilinear")
    lab = _grid_sample((seg.to(dtype) + 1)[None], src_y, src_x, "nearest")[0]
    lab = lab.round().long() - 1

    if d["noise"] is not None:
        x = x + d["noise"].to(dev, dtype)
    x = torch.stack([_blur(x[c], s) if s is not None else x[c]
                     for c, s in enumerate(d["blur_sigmas"])])
    if d["brightness"] is not None:
        x = x * torch.tensor(d["brightness"], dtype=dtype, device=dev)[:, None, None]
    if d["contrast"] is not None:
        f = torch.tensor(d["contrast"], dtype=dtype, device=dev)[:, None, None]
        mean = x.mean((1, 2), keepdim=True)
        x = torch.clamp((x - mean) * f + mean, x.amin((1, 2), keepdim=True),
                        x.amax((1, 2), keepdim=True))
    x = torch.stack([_lowres(x[c], z) if z is not None else x[c]
                     for c, z in enumerate(d["lowres_zooms"])])
    if d["gamma_invert"] is not None:
        x = _gamma(x, d["gamma_invert"], True)
    if d["gamma"] is not None:
        x = _gamma(x, d["gamma"], False)

    dims = [a for a, f in zip((-2, -1), d["flips"]) if f]
    if dims:
        x, lab = torch.flip(x, dims), torch.flip(lab, dims)
    outside = lab < 0
    x = torch.stack([torch.where(outside, torch.zeros_like(x[c]), x[c])
                     if c < len(use_mask) and use_mask[c] else x[c] for c in range(len(x))])
    return x, torch.where(outside, torch.zeros_like(lab), lab)
