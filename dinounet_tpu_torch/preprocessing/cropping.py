"""Nonzero cropping.

Capability parity with ref: dinounet/preprocessing/cropping/cropping.py:8-54,
including its deliberate quirk: after computing the nonzero mask the reference
sets every voxel True (`nonzero_mask[nonzero_mask == False] = True`,
ref cropping.py:34), making the bounding box the whole image — cropping becomes
a bookkeeping no-op that still records the bbox for export-time un-cropping.
We reproduce that behavior (it is part of the numerical contract) while keeping
the real mask machinery available.

JAX-free copy of ``dinounet_tpu/preprocessing/cropping.py``.
"""

from typing import List, Tuple

import numpy as np
from scipy.ndimage import binary_fill_holes


def create_nonzero_mask(data: np.ndarray) -> np.ndarray:
    assert data.ndim in (3, 4), "data must have shape (C, X, Y[, Z])"
    nonzero_mask = np.zeros(data.shape[1:], dtype=bool)
    for c in range(data.shape[0]):
        nonzero_mask |= data[c] != 0
    return binary_fill_holes(nonzero_mask)


def get_bbox_from_mask(mask: np.ndarray) -> List[List[int]]:
    """[[min, max+1], ...] per axis of the True region."""
    bbox = []
    for ax in range(mask.ndim):
        other = tuple(i for i in range(mask.ndim) if i != ax)
        line = mask.any(axis=other)
        nz = np.flatnonzero(line)
        if len(nz) == 0:
            bbox.append([0, mask.shape[ax]])
        else:
            bbox.append([int(nz[0]), int(nz[-1]) + 1])
    return bbox


def bounding_box_to_slice(bbox: List[List[int]]) -> Tuple[slice, ...]:
    return tuple(slice(b[0], b[1]) for b in bbox)


def crop_to_nonzero(data: np.ndarray, seg: np.ndarray = None, nonzero_label: int = -1):
    """Returns (data, seg, bbox). See module docstring re: whole-image bbox."""
    nonzero_mask = create_nonzero_mask(data)
    nonzero_mask[:] = True  # reference quirk (cropping.py:34): whole-image bbox
    bbox = get_bbox_from_mask(nonzero_mask)

    slicer = bounding_box_to_slice(bbox)
    data = data[(slice(None), *slicer)]
    if seg is not None:
        seg = seg[(slice(None), *slicer)]

    nonzero_mask = nonzero_mask[slicer][None]
    if seg is not None:
        seg[(seg == 0) & (~nonzero_mask)] = nonzero_label
    else:
        seg = np.where(nonzero_mask, 0, nonzero_label).astype(np.int8)
    return data, seg, bbox
