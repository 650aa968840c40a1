"""Network topology search: pooling axes, kernel sizes, patch-size padding.

Capability parity with ref: dinounet/experiment_planning/experiment_planners/
network_topology.py:30-118, including the DinoUNet modification that force-
continues pooling when a fixed stage count is requested (ref :76-84).

JAX-free copy of ``dinounet_tpu/planning/topology.py``.
"""

from copy import deepcopy
from typing import List, Sequence, Tuple

import numpy as np


def get_shape_must_be_divisible_by(net_numpool_per_axis) -> np.ndarray:
    return 2 ** np.array(net_numpool_per_axis)


def pad_shape(shape, must_be_divisible_by) -> np.ndarray:
    """Round each axis UP to the next multiple of must_be_divisible_by."""
    if not isinstance(must_be_divisible_by, (tuple, list, np.ndarray)):
        must_be_divisible_by = [must_be_divisible_by] * len(shape)
    assert len(must_be_divisible_by) == len(shape)
    new_shp = [
        shape[i] + must_be_divisible_by[i] - shape[i] % must_be_divisible_by[i]
        for i in range(len(shape))
    ]
    for i in range(len(shape)):
        if shape[i] % must_be_divisible_by[i] == 0:
            new_shp[i] -= must_be_divisible_by[i]
    return np.array(new_shp).astype(int)


def get_pool_and_conv_props(spacing: Sequence[float], patch_size: Sequence[int],
                            min_feature_map_size: int, max_numpool: int):
    """Iteratively pool the axes whose spacing is within 2x of the finest spacing
    and whose size still allows it; kernel sizes grow 1->3 per axis as spacings
    homogenize. Returns (num_pool_per_axis, pool_op_kernel_sizes,
    conv_kernel_sizes, padded_patch_size, shape_must_be_divisible_by)."""
    force_stages = max_numpool + 1 if max_numpool < 999999 else None
    dim = len(spacing)

    current_spacing = deepcopy(list(spacing))
    current_size = deepcopy(list(patch_size))

    pool_op_kernel_sizes = [[1] * dim]
    conv_kernel_sizes: List[List[int]] = []
    num_pool_per_axis = [0] * dim
    kernel_size = [1] * dim

    while True:
        valid_axes = [i for i in range(dim) if current_size[i] >= 2 * min_feature_map_size]
        if len(valid_axes) < 1:
            break
        spacings_of_axes = [current_spacing[i] for i in valid_axes]
        min_spacing = min(spacings_of_axes)
        valid_axes = [i for i in valid_axes if current_spacing[i] / min_spacing < 2]
        valid_axes = [i for i in valid_axes if num_pool_per_axis[i] < max_numpool]

        if len(valid_axes) == 1:
            if current_size[valid_axes[0]] >= 3 * min_feature_map_size:
                pass
            else:
                break
        if len(valid_axes) < 1:
            if force_stages is not None and len(pool_op_kernel_sizes) < force_stages:
                # forced stage count: keep pooling even past the usual constraints
                valid_axes = [
                    i for i in range(dim)
                    if num_pool_per_axis[i] < max_numpool and current_size[i] >= 2
                ]
                if len(valid_axes) == 0:
                    valid_axes = [int(np.argmin(current_size))]
            else:
                break

        for d in range(dim):
            if kernel_size[d] != 3 and current_spacing[d] / min(current_spacing) < 2:
                kernel_size[d] = 3

        pool_kernel = [1] * dim
        for v in valid_axes:
            pool_kernel[v] = 2
            num_pool_per_axis[v] += 1
            current_spacing[v] *= 2
            current_size[v] = np.ceil(current_size[v] / 2)

        pool_op_kernel_sizes.append(pool_kernel)
        conv_kernel_sizes.append(deepcopy(kernel_size))

    must_be_divisible_by = get_shape_must_be_divisible_by(num_pool_per_axis)
    patch_size = pad_shape(patch_size, must_be_divisible_by)

    def _to_tuple(lst):
        return tuple(_to_tuple(i) if isinstance(i, list) else i for i in lst)

    conv_kernel_sizes.append([3] * dim)  # bottleneck conv
    return (num_pool_per_axis, _to_tuple(pool_op_kernel_sizes),
            _to_tuple(conv_kernel_sizes), tuple(int(i) for i in patch_size),
            must_be_divisible_by)
