"""Gaussian-weighted sliding-window tile prediction on the device, 2-D and
3-D networks.

Counterpart of ``dinounet_tpu/inference/sliding_window.py``: the tiles of a
volume (of every z-slice for a 2-D network, the volumetric grid for a 3-D
one) form one work list, run through the network in fixed-size batches (the
last batch padded with repeats of its last tile, which are not accumulated),
averaged over the mirror-TTA flips, weighted by the Gaussian and added into
fp32 logits and weight accumulators on the device. The volume is padded as
the JAX package pads it (to at least the patch, then up to half-patch
multiples: Y and X for a 2-D network, all three axes for a 3-D one), so both
packages place the same tile grid.

Past the device budget (``DINOUNET_TPU_SW_ACCUM_BUDGET_BYTES``, 0 forces it)
the accumulators live on the host: the device still predicts and weights
each tile batch, the host adds it in numpy, in the same order (the JAX
package's ``_predict_host_accumulate``, ref predict_from_raw_data.py:709-718).
``predict_sliding_window_return_logits_with_target`` feeds a network that
takes (image, mask) the mask's tiles beside the image's, flipped alike.

Layouts on the device: a 2-D network's volume is (Z, C, Y, X), its
accumulators (Z, K, Y, X) and (Z, 1, Y, X); a 3-D network's volume is
(C, Z, Y, X), its accumulators (K, Z, Y, X) and (1, Z, Y, X). Either way a
tile origin (z, y, x) indexes all three by ``tile_index``.
"""

import itertools
from functools import lru_cache
from typing import Iterator, List, Optional, Sequence, Tuple

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


def sliding_window_offsets_3d(volume_shape_zyx: Sequence[int],
                              patch_size: Tuple[int, int, int],
                              tile_step_size: float = 0.5) -> np.ndarray:
    """All (oz, oy, ox) tile origins of a 3-D network over a (Z, Y, X) volume."""
    steps = compute_steps_for_sliding_window(volume_shape_zyx, patch_size,
                                             tile_step_size)
    return np.array([(sz, sy, sx) for sz in steps[0] for sy in steps[1]
                     for sx in steps[2]], dtype=np.int64)


def tile_index(offset: Sequence[int], patch_size: Sequence[int]) -> tuple:
    """The index of the tile at `offset` into a volume or accumulator in
    this module's layout: (z, :, y-range, x-range) in 2-D, (:, z-range,
    y-range, x-range) in 3-D."""
    if len(patch_size) == 2:
        z, oy, ox = offset
        ph, pw = patch_size
        return (z, slice(None), slice(oy, oy + ph), slice(ox, ox + pw))
    return (slice(None),) + tuple(slice(o, o + p) for o, p in zip(offset, patch_size))


def prepare_sliding_window_volume(data: np.ndarray, patch_size: Sequence[int],
                                  tile_step_size: float, device
                                  ) -> Tuple[torch.Tensor, np.ndarray, List[List[int]]]:
    """(C, Z, Y, X) host data -> (volume fp32 on `device` in this module's
    layout, tile origins (N, 3), revert slices). 2-D: Y and X padded to at
    least the patch and up to a multiple of half the patch; 3-D: Z, Y and X
    alike, as the JAX package pads."""
    if data.ndim != 4:
        raise ValueError("data must be (C, Z, Y, X); 2-D inputs as (C, 1, Y, X)")
    if len(patch_size) not in (2, 3):
        raise ValueError(f"patch_size must have 2 or 3 entries, got {tuple(patch_size)}")
    _, Z, Y, X = data.shape

    def up(v, q):
        return -(-v // q) * q

    if len(patch_size) == 2:
        target = (Z, up(max(Y, patch_size[0]), max(1, patch_size[0] // 2)),
                  up(max(X, patch_size[1]), max(1, patch_size[1] // 2)))
    else:
        target = tuple(up(max(n, p), max(1, p // 2))
                       for n, p in zip((Z, Y, X), patch_size))
    padded, revert = pad_nd_image(data, target)
    volume = torch.from_numpy(np.ascontiguousarray(padded, dtype=np.float32))
    if len(patch_size) == 2:
        volume = volume.permute(1, 0, 2, 3).contiguous()
        offsets = sliding_window_offsets_2d(padded.shape[1:], tuple(patch_size),
                                            tile_step_size)
    else:
        offsets = sliding_window_offsets_3d(padded.shape[1:], tuple(patch_size),
                                            tile_step_size)
    return volume.to(device), offsets, revert


def spatial_shape(volume: torch.Tensor, patch_size: Sequence[int]) -> Tuple[int, int, int]:
    """(Z, Y, X) of a volume in this module's layout."""
    if len(patch_size) == 2:
        return (volume.shape[0],) + tuple(volume.shape[2:])
    return tuple(volume.shape[1:])


def accumulator_shapes(volume: torch.Tensor, patch_size: Sequence[int],
                       num_classes: int) -> Tuple[tuple, tuple]:
    """Shapes of the logits and weight accumulators of `volume`."""
    Z, Y, X = spatial_shape(volume, patch_size)
    if len(patch_size) == 2:
        return (Z, num_classes, Y, X), (Z, 1, Y, X)
    return (num_classes, Z, Y, X), (1, Z, Y, X)


def mirror_variants(mirror_axes: Optional[Sequence[int]]) -> List[Tuple[int, ...]]:
    """Every flip combination of mirror TTA, as tensor dims of a (B, C,
    *spatial) batch (spatial axis a is dim a + 2)."""
    if not mirror_axes:
        return [()]
    dims = tuple(a + 2 for a in mirror_axes)
    return [c for i in range(len(dims) + 1) for c in itertools.combinations(dims, i)]


class TilePredictor:
    """Runs one padded volume's tile list through `network` and accumulates
    Gaussian-weighted logits, on the device (``predict``) or on the host
    (``predict_host``). `weights` may be passed back in to skip the (fold-
    invariant) weight accumulation when summing folds, and `accum` to add a
    fold into the same host buffer."""

    def __init__(self, network: nn.Module, patch_size: Sequence[int],
                 num_classes: int, tile_batch: int = 8,
                 mirror_axes: Optional[Sequence[int]] = None,
                 use_gaussian: bool = True):
        self.network = network
        self.patch_size = tuple(patch_size)
        self.num_classes = num_classes
        self.tile_batch = tile_batch
        self.variants = mirror_variants(mirror_axes)
        g = compute_gaussian(self.patch_size)
        self._gaussian = g if use_gaussian else np.ones_like(g)

    def forward_tiles(self, tiles: torch.Tensor,
                      targets: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mirror-averaged fp32 logits of a (B, C, *patch) tile batch (with
        `targets`, the network takes (tiles, targets), flipped alike)."""
        logits = None
        for dims in self.variants:
            t = torch.flip(tiles, dims) if dims else tiles
            if targets is None:
                out = self.network(t)
            else:
                out = self.network(t, torch.flip(targets, dims) if dims else targets)
            out = out.float()
            out = torch.flip(out, dims) if dims else out
            logits = out if logits is None else logits + out
        return logits / len(self.variants)

    def weighted_batches(self, volume: torch.Tensor, offsets: np.ndarray,
                         target: Optional[torch.Tensor] = None
                         ) -> Iterator[Tuple[List[tuple], torch.Tensor]]:
        """(the batch's tile origins, its Gaussian-weighted logits (k, K,
        *patch)) for each tile batch, in order."""
        gaussian = torch.from_numpy(self._gaussian).to(volume.device)
        n = len(offsets)
        for start in range(0, n, self.tile_batch):
            offs = [tuple(int(v) for v in o) for o in offsets[start:start + self.tile_batch]]
            k = len(offs)
            offs += [offs[-1]] * (self.tile_batch - k)  # fixed batch size
            tiles = torch.stack([volume[tile_index(o, self.patch_size)] for o in offs])
            tars = None if target is None else torch.stack(
                [target[tile_index(o, self.patch_size)] for o in offs])
            yield offs[:k], (self.forward_tiles(tiles, tars) * gaussian)[:k]

    @torch.inference_mode()
    def predict(self, volume: torch.Tensor, offsets: np.ndarray,
                weights: Optional[torch.Tensor] = None,
                target: Optional[torch.Tensor] = None):
        """(logits accumulator, weights), fp32 on the volume's device."""
        dev = volume.device
        accum_shape, weights_shape = accumulator_shapes(volume, self.patch_size,
                                                        self.num_classes)
        gaussian = torch.from_numpy(self._gaussian).to(dev)
        accum = torch.zeros(accum_shape, dtype=torch.float32, device=dev)
        scatter_weights = weights is None
        if scatter_weights:
            weights = torch.zeros(weights_shape, dtype=torch.float32, device=dev)
        for offs, weighted in self.weighted_batches(volume, offsets, target):
            for i, o in enumerate(offs):
                idx = tile_index(o, self.patch_size)
                accum[idx] += weighted[i]
                if scatter_weights:
                    weights[idx] += gaussian
        return accum, weights

    @torch.inference_mode()
    def predict_host(self, volume: torch.Tensor, offsets: np.ndarray,
                     accum: Optional[np.ndarray] = None,
                     weights: Optional[np.ndarray] = None,
                     target: Optional[torch.Tensor] = None):
        """``predict`` with the accumulators in host memory: each weighted
        tile batch comes back to the host once and is added there in numpy,
        in the same order."""
        accum_shape, weights_shape = accumulator_shapes(volume, self.patch_size,
                                                        self.num_classes)
        if accum is None:
            accum = np.zeros(accum_shape, np.float32)
        scatter_weights = weights is None
        if scatter_weights:
            weights = np.zeros(weights_shape, np.float32)
        for offs, weighted in self.weighted_batches(volume, offsets, target):
            weighted = weighted.cpu().numpy()
            for i, o in enumerate(offs):
                idx = tile_index(o, self.patch_size)
                accum[idx] += weighted[i]
                if scatter_weights:
                    weights[idx] += self._gaussian
        return accum, weights


def finalize_sliding_window_logits(accum, weights, revert: Sequence[Sequence[int]],
                                   patch_size: Sequence[int],
                                   out_dtype=torch.float32) -> np.ndarray:
    """Accumulators (tensors on the device, or host arrays) of a network
    with `patch_size` -> host logits (K, Z, Y, X): divide, cast, one copy to
    the host, inf check, un-pad."""
    if isinstance(accum, np.ndarray):
        accum, weights = torch.from_numpy(accum), torch.from_numpy(weights)
    logits = (accum / weights).to(out_dtype).cpu().numpy()
    if not np.all(np.isfinite(logits)):
        raise RuntimeError(
            "Encountered inf in predicted array. Aborting... If this problem "
            "persists, reduce value_scaling_factor in compute_gaussian or "
            "increase the dtype of the accumulation.")
    if len(patch_size) == 2:
        logits = logits.transpose(1, 0, 2, 3)  # (Z, K, Y, X) -> (K, Z, Y, X)
    sl = (slice(None),) + tuple(slice(lo, hi) for lo, hi in revert)
    return logits[sl]


def over_accum_budget(volume: torch.Tensor, patch_size: Sequence[int],
                      num_classes: int) -> bool:
    """Whether the fp32 accumulator pair of `volume` exceeds the device
    budget, so the host accumulates."""
    voxels = int(np.prod(spatial_shape(volume, patch_size)))
    return voxels * (num_classes + 1) * 4 > accum_budget_bytes()


def predict_sliding_window_return_logits(
        network: nn.Module, data: np.ndarray, patch_size: Sequence[int],
        num_classes: int, tile_step_size: float = 0.5,
        mirror_axes: Optional[Sequence[int]] = None, tile_batch: int = 8,
        use_gaussian: bool = True, device=None,
        target_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Sliding window of a 2-D or 3-D network over (C, Z, Y, X) host data
    on `device` (default: the network's). With `target_mask` (C_t, Z, Y, X)
    the network takes (image, mask) tiles. Returns fp32 logits (K, Z, Y, X)
    on the host."""
    if device is None:
        device = next(network.parameters()).device
    volume, offsets, revert = prepare_sliding_window_volume(
        data, patch_size, tile_step_size, device)
    target = None
    if target_mask is not None:
        target, _, _ = prepare_sliding_window_volume(
            np.asarray(target_mask), patch_size, tile_step_size, device)
    predictor = TilePredictor(network, patch_size, num_classes, tile_batch,
                              mirror_axes, use_gaussian)
    if over_accum_budget(volume, patch_size, num_classes):
        accum, weights = predictor.predict_host(volume, offsets, target=target)
    else:
        accum, weights = predictor.predict(volume, offsets, target=target)
    return finalize_sliding_window_logits(accum, weights, revert, patch_size)


def predict_sliding_window_return_logits_with_target(
        network: nn.Module, data: np.ndarray, target_mask: np.ndarray,
        patch_size: Sequence[int], num_classes: int, **kwargs) -> np.ndarray:
    """The `*_with_target` entry point (ref predict_from_raw_data.py:728-776):
    the network's forward takes (image tile, mask tile)."""
    return predict_sliding_window_return_logits(
        network, data, patch_size, num_classes, target_mask=target_mask, **kwargs)
