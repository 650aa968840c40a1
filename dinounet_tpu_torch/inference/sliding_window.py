"""Gaussian-weighted sliding-window tile prediction on the device, 2-D nets.

Counterpart of ``dinounet_tpu/inference/sliding_window.py`` for 2-D patches:
the tiles of every z-slice form one work list, run through the network in
fixed-size batches (the last batch padded with repeats of its last tile,
which are not accumulated), averaged over the mirror-TTA flips, weighted by
the Gaussian and added into fp32 logits and weight accumulators on the
device. The volume is padded as the JAX package pads it (Y and X up to
half-patch multiples), so both packages place the same tile grid.
The 3-D predictor and host-side accumulation are not ported yet.
"""

import itertools
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dinounet_tpu_torch.configuration import accum_budget_bytes


@lru_cache(maxsize=2)
def compute_gaussian(tile_size: Tuple[int, ...], sigma_scale: float = 1.0 / 8,
                     value_scaling_factor: float = 10.0) -> np.ndarray:
    """Centered Gaussian, sigma = tile_size / 8, scaled to a maximum of
    value_scaling_factor, rounded through fp16, zeros replaced by the
    smallest positive value."""
    center = [i // 2 for i in tile_size]
    sigmas = [i * sigma_scale for i in tile_size]
    grids = np.meshgrid(*[np.arange(s) for s in tile_size], indexing="ij")
    g = np.ones(tile_size, dtype=np.float64)
    for grid, c, s in zip(grids, center, sigmas):
        g = g * np.exp(-((grid - c) ** 2) / (2 * s ** 2))
    g = g / g.max() * value_scaling_factor
    g = g.astype(np.float16).astype(np.float32)
    g[g == 0] = np.min(g[g != 0])
    return g


def compute_steps_for_sliding_window(image_size: Sequence[int],
                                     tile_size: Sequence[int],
                                     tile_step_size: float) -> List[List[int]]:
    if not all(i >= j for i, j in zip(image_size, tile_size)):
        raise ValueError(f"image {tuple(image_size)} smaller than tile {tuple(tile_size)}")
    if not 0 < tile_step_size <= 1:
        raise ValueError(f"tile_step_size must be in (0, 1], got {tile_step_size}")
    target_step_sizes = [i * tile_step_size for i in tile_size]
    num_steps = [int(np.ceil((i - k) / j)) + 1
                 for i, j, k in zip(image_size, target_step_sizes, tile_size)]
    steps = []
    for dim in range(len(tile_size)):
        max_step_value = image_size[dim] - tile_size[dim]
        if num_steps[dim] > 1:
            actual_step_size = max_step_value / (num_steps[dim] - 1)
        else:
            actual_step_size = 99999999999
        steps.append([int(np.round(actual_step_size * i)) for i in range(num_steps[dim])])
    return steps


def pad_nd_image(image: np.ndarray, new_shape: Sequence[int],
                 mode: str = "constant") -> Tuple[np.ndarray, List[List[int]]]:
    """Pad the trailing spatial dims up to new_shape (centered); returns
    (padded, [[lo, hi], ...] slices that revert the padding)."""
    spatial_ndim = len(new_shape)
    old_shape = image.shape[-spatial_ndim:]
    pad_total = [max(0, n - o) for n, o in zip(new_shape, old_shape)]
    pad_lo = [p // 2 for p in pad_total]
    pad_hi = [p - lo for p, lo in zip(pad_total, pad_lo)]
    pad_width = [(0, 0)] * (image.ndim - spatial_ndim) + list(zip(pad_lo, pad_hi))
    padded = np.pad(image, pad_width, mode=mode)
    revert = [[lo, lo + o] for lo, o in zip(pad_lo, old_shape)]
    return padded, revert


def sliding_window_offsets_2d(volume_shape_zyx: Sequence[int],
                              patch_size: Tuple[int, int],
                              tile_step_size: float = 0.5) -> np.ndarray:
    """All (z, oy, ox) tile origins of a 2-D network over a (Z, Y, X) volume."""
    Z, Y, X = volume_shape_zyx
    steps = compute_steps_for_sliding_window((Y, X), patch_size, tile_step_size)
    return np.array([(z, sy, sx) for z in range(Z) for sy in steps[0]
                     for sx in steps[1]], dtype=np.int64)


def _require_2d(patch_size) -> None:
    if len(patch_size) != 2:
        raise NotImplementedError(
            "only 2-D patches are ported; the 3-D sliding window is not yet")


def prepare_sliding_window_volume(data: np.ndarray, patch_size: Sequence[int],
                                  tile_step_size: float, device
                                  ) -> Tuple[torch.Tensor, np.ndarray, List[List[int]]]:
    """(C, Z, Y, X) host data -> (volume (Z, C, Y', X') fp32 on `device`,
    tile origins (N, 3), revert slices). Y and X are padded to at least the
    patch and up to a multiple of half the patch, as the JAX package pads."""
    _require_2d(patch_size)
    if data.ndim != 4:
        raise ValueError("data must be (C, Z, Y, X); 2-D inputs as (C, 1, Y, X)")
    _, Z, Y, X = data.shape

    def up(v, q):
        return -(-v // q) * q

    target = (Z, up(max(Y, patch_size[0]), max(1, patch_size[0] // 2)),
              up(max(X, patch_size[1]), max(1, patch_size[1] // 2)))
    padded, revert = pad_nd_image(data, target)
    volume = torch.from_numpy(np.ascontiguousarray(padded, dtype=np.float32))
    volume = volume.permute(1, 0, 2, 3).contiguous().to(device)
    offsets = sliding_window_offsets_2d(padded.shape[1:], tuple(patch_size),
                                        tile_step_size)
    return volume, offsets, revert


def mirror_variants(mirror_axes: Optional[Sequence[int]]) -> List[Tuple[int, ...]]:
    """Every flip combination of mirror TTA, as tensor dims of an NCHW batch
    (spatial axis a is dim a + 2)."""
    if not mirror_axes:
        return [()]
    dims = tuple(a + 2 for a in mirror_axes)
    return [c for i in range(len(dims) + 1) for c in itertools.combinations(dims, i)]


class TilePredictor2d:
    """Runs one padded volume's tile list through `network` and accumulates
    Gaussian-weighted logits. predict(volume (Z, C, Y, X), offsets (N, 3)) ->
    (accumulated logits (Z, K, Y, X), weights (Z, 1, Y, X)), fp32, on the
    volume's device. `weights` may be passed back in to skip the (fold-
    invariant) weight accumulation when summing folds."""

    def __init__(self, network: nn.Module, patch_size: Tuple[int, int],
                 num_classes: int, tile_batch: int = 8,
                 mirror_axes: Optional[Sequence[int]] = None,
                 use_gaussian: bool = True):
        _require_2d(patch_size)
        self.network = network
        self.patch_size = tuple(patch_size)
        self.num_classes = num_classes
        self.tile_batch = tile_batch
        self.variants = mirror_variants(mirror_axes)
        g = compute_gaussian(self.patch_size)
        self._gaussian = g if use_gaussian else np.ones_like(g)

    def forward_tiles(self, tiles: torch.Tensor) -> torch.Tensor:
        """Mirror-averaged fp32 logits of a (B, C, ph, pw) tile batch."""
        logits = None
        for dims in self.variants:
            t = torch.flip(tiles, dims) if dims else tiles
            out = self.network(t).float()
            out = torch.flip(out, dims) if dims else out
            logits = out if logits is None else logits + out
        return logits / len(self.variants)

    @torch.inference_mode()
    def predict(self, volume: torch.Tensor, offsets: np.ndarray,
                weights: Optional[torch.Tensor] = None):
        Z, _, Y, X = volume.shape
        ph, pw = self.patch_size
        dev = volume.device
        gaussian = torch.from_numpy(self._gaussian).to(dev)
        accum = torch.zeros((Z, self.num_classes, Y, X), dtype=torch.float32,
                            device=dev)
        scatter_weights = weights is None
        if scatter_weights:
            weights = torch.zeros((Z, 1, Y, X), dtype=torch.float32, device=dev)
        n = len(offsets)
        for start in range(0, n, self.tile_batch):
            offs = [tuple(int(v) for v in o) for o in offsets[start:start + self.tile_batch]]
            k = len(offs)
            offs += [offs[-1]] * (self.tile_batch - k)  # fixed batch size
            tiles = torch.stack([volume[z, :, oy:oy + ph, ox:ox + pw]
                                 for z, oy, ox in offs])
            weighted = self.forward_tiles(tiles) * gaussian
            for i, (z, oy, ox) in enumerate(offs[:k]):
                accum[z, :, oy:oy + ph, ox:ox + pw] += weighted[i]
                if scatter_weights:
                    weights[z, 0, oy:oy + ph, ox:ox + pw] += gaussian
        return accum, weights


def finalize_sliding_window_logits(accum: torch.Tensor, weights: torch.Tensor,
                                   revert: Sequence[Sequence[int]],
                                   out_dtype=torch.float32) -> np.ndarray:
    """Accumulators -> host logits (K, Z, Y, X): divide, cast, one copy to
    the host, inf check, un-pad."""
    logits = (accum / weights).to(out_dtype).cpu().numpy()
    if not np.all(np.isfinite(logits)):
        raise RuntimeError(
            "Encountered inf in predicted array. Aborting... If this problem "
            "persists, reduce value_scaling_factor in compute_gaussian or "
            "increase the dtype of the accumulation.")
    logits = logits.transpose(1, 0, 2, 3)
    sl = (slice(None),) + tuple(slice(lo, hi) for lo, hi in revert)
    return logits[sl]


def check_accum_budget(volume_shape_zyx: Sequence[int], num_classes: int) -> None:
    """Raise if the fp32 accumulator pair would exceed the device budget."""
    accum_bytes = int(np.prod(volume_shape_zyx)) * (num_classes + 1) * 4
    if accum_bytes > accum_budget_bytes():
        raise NotImplementedError(
            f"sliding-window accumulators need {accum_bytes / 2**30:.1f} GiB, "
            f"over the device budget of {accum_budget_bytes() / 2**30:.1f} GiB; "
            "host-side accumulation is not ported yet")


def predict_sliding_window_return_logits(
        network: nn.Module, data: np.ndarray, patch_size: Tuple[int, int],
        num_classes: int, tile_step_size: float = 0.5,
        mirror_axes: Optional[Sequence[int]] = None, tile_batch: int = 8,
        use_gaussian: bool = True, device=None) -> np.ndarray:
    """Sliding window of a 2-D network over (C, Z, Y, X) host data on
    `device` (default: the network's). Returns fp32 logits (K, Z, Y, X) on
    the host."""
    if device is None:
        device = next(network.parameters()).device
    volume, offsets, revert = prepare_sliding_window_volume(
        data, patch_size, tile_step_size, device)
    check_accum_budget((volume.shape[0],) + tuple(volume.shape[2:]), num_classes)
    predictor = TilePredictor2d(network, tuple(patch_size), num_classes,
                                tile_batch, mirror_axes, use_gaussian)
    accum, weights = predictor.predict(volume, offsets)
    return finalize_sliding_window_logits(accum, weights, revert)
