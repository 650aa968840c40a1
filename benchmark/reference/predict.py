"""Plain reference of nnU-Net's sliding-window prediction of one 2-D case:
padding, tile origins, mirror test-time augmentation, Gaussian weighting,
un-padding. Written from nnU-Net v2's ``predict_from_raw_data.py`` and
``sliding_window_prediction.py``, not from the program."""

import itertools
from typing import List, Sequence, Tuple

import numpy as np
import torch


def gaussian(patch: Sequence[int], sigma_scale: float = 1.0 / 8,
             value_scaling_factor: float = 10.0) -> np.ndarray:
    """nnU-Net's importance map: a centred Gaussian with sigma patch / 8,
    scaled to a maximum of 10, rounded through float16, zeros lifted to the
    smallest positive value."""
    g = np.ones(tuple(patch), np.float64)
    for axis, p in enumerate(patch):
        x = np.arange(p) - p // 2
        shape = [1] * len(patch)
        shape[axis] = p
        g = g * np.exp(-(x ** 2) / (2 * (p * sigma_scale) ** 2)).reshape(shape)
    g = (g / g.max() * value_scaling_factor).astype(np.float16).astype(np.float32)
    g[g == 0] = g[g != 0].min()
    return g


def padded_size(size: Sequence[int], patch: Sequence[int]) -> List[int]:
    """At least the patch, and a multiple of half of it."""
    return [-(-max(s, p) // max(1, p // 2)) * max(1, p // 2) for s, p in zip(size, patch)]


def steps(size: Sequence[int], patch: Sequence[int], step: float) -> List[List[int]]:
    out = []
    for s, p in zip(size, patch):
        n = int(np.ceil((s - p) / (p * step))) + 1
        actual = (s - p) / (n - 1) if n > 1 else 0.0
        out.append([int(np.round(actual * i)) for i in range(n)])
    return out


def mirrored(model, x: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """The mean over every flip combination of `axes` (spatial axes) of
    flip(model(flip(x)))."""
    combos = flips(axes)
    total = None
    for c in combos:
        y = model(torch.flip(x, c) if c else x)
        y = torch.flip(y, c) if c else y
        total = y if total is None else total + y
    return total / len(combos)


def padded(case: np.ndarray, patch: Tuple[int, int], step: float, device):
    """The case (C, 1, H, W) padded as the sliding window pads it, (C, PH,
    PW) on `device`; its tile origins; the offset of the case inside it."""
    C, _, H, W = case.shape
    PH, PW = padded_size((H, W), patch)
    lo_h, lo_w = (PH - H) // 2, (PW - W) // 2
    x = torch.zeros((C, PH, PW), dtype=torch.float32, device=device)
    x[:, lo_h:lo_h + H, lo_w:lo_w + W] = torch.from_numpy(case[:, 0]).to(device)
    ys, xs = steps((PH, PW), patch, step)
    return x, [(y, xo) for y in ys for xo in xs], (lo_h, lo_w)


def flips(axes: Sequence[int]) -> List[tuple]:
    """Every flip combination of the spatial `axes`, as dims of a (B, C, H,
    W) batch."""
    dims = [a + 2 for a in axes]
    return [c for r in range(len(dims) + 1) for c in itertools.combinations(dims, r)]


def tile_inputs(case: np.ndarray, patch: Tuple[int, int], step: float,
                mirror_axes: Sequence[int], device) -> torch.Tensor:
    """Every (tile, mirror variant) the sliding window gives the network for
    the case, (n, C, *patch) float32."""
    x, origins, _ = padded(case, patch, step, device)
    tiles = torch.stack([x[:, y:y + patch[0], xo:xo + patch[1]] for y, xo in origins])
    return torch.cat([torch.flip(tiles, c) if c else tiles for c in flips(mirror_axes)])


@torch.no_grad()
def predict_case(model, case: np.ndarray, patch: Tuple[int, int], step: float,
                 mirror_axes: Sequence[int], device, tiles_per_call: int = 4) -> torch.Tensor:
    """float32 logits (K, 1, H, W) of a (C, 1, H, W) case, on `device`."""
    H, W = case.shape[2:]
    x, origins, (lo_h, lo_w) = padded(case, patch, step, device)
    PH, PW = x.shape[1:]
    g = torch.from_numpy(gaussian(patch)).to(device)
    accum = weights = None
    for i in range(0, len(origins), tiles_per_call):
        batch = origins[i:i + tiles_per_call]
        tiles = torch.stack([x[:, y:y + patch[0], xo:xo + patch[1]] for y, xo in batch])
        out = mirrored(model, tiles, mirror_axes)
        if accum is None:
            accum = torch.zeros((out.shape[1], PH, PW), dtype=torch.float32, device=device)
            weights = torch.zeros((PH, PW), dtype=torch.float32, device=device)
        for (y, xo), o in zip(batch, out):
            accum[:, y:y + patch[0], xo:xo + patch[1]] += o * g
            weights[y:y + patch[0], xo:xo + patch[1]] += g
    logits = accum / weights
    return logits[:, lo_h:lo_h + H, lo_w:lo_w + W][:, None]
