"""A synthetic preprocessed 2-D dataset, for smoke runs and tests of training.

``write_disk_ring_dataset`` writes, under ``<preprocessed_root>/<name>/``,
what nnU-Net's preprocessing leaves for a 2-D configuration:
``dataset.json``, the plans file ``nnUNetPlans.json`` (one ``2d``
configuration with the given patch, batch size and network ``architecture``
dict) and ``nnUNetPlans_2d/<case>.npz`` (``data`` (1, 1, H, W) float32,
``seg`` (1, 1, H, W) int8) with ``<case>.pkl`` properties holding the
``class_locations`` the loader's foreground oversampling reads. Each case is
a noisy image with a bright disk (label 1) and a dark ring (label 2) at
random places and sizes: the intensities correlate with the labels, so a
network that trains at all lowers its loss within a few dozen steps. All of
it comes from a numpy seed.
"""

import json
import os
import pickle

import numpy as np

LABELS = {"background": 0, "disk": 1, "ring": 2}


def disk_ring_case(rng: np.random.Generator, H: int, W: int):
    """One case: image (1, 1, H, W) float32, labels (1, 1, H, W) int8."""
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    seg = np.zeros((H, W), np.int8)
    m = min(H, W)
    r_disk = rng.uniform(0.10, 0.18) * m
    cy, cx = rng.uniform(r_disk + 1, H - r_disk - 1), rng.uniform(r_disk + 1, W - r_disk - 1)
    seg[(yy - cy) ** 2 + (xx - cx) ** 2 <= r_disk ** 2] = 1
    r_out = rng.uniform(0.12, 0.20) * m
    r_in = r_out * rng.uniform(0.55, 0.75)
    cy, cx = rng.uniform(r_out + 1, H - r_out - 1), rng.uniform(r_out + 1, W - r_out - 1)
    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
    seg[(d2 <= r_out ** 2) & (d2 >= r_in ** 2) & (seg == 0)] = 2
    img = rng.normal(0.0, 0.6, (H, W)).astype(np.float32)
    img += np.where(seg == 1, 2.0, 0.0) + np.where(seg == 2, -1.5, 0.0)
    img = (img - img.mean()) / img.std()
    return img.astype(np.float32)[None, None], seg[None, None]


def _class_locations(rng: np.random.Generator, seg: np.ndarray, max_per_class: int):
    out = {}
    for label in (1, 2):
        locs = np.argwhere(seg == label)  # (N, 4): channel, z, y, x
        if len(locs) > max_per_class:
            locs = locs[rng.choice(len(locs), max_per_class, replace=False)]
        out[label] = locs
    return out


def write_disk_ring_dataset(preprocessed_root: str, dataset_name: str, n_cases: int,
                            size, patch_size, batch_size: int, architecture: dict,
                            seed: int = 0) -> str:
    """Write the dataset (see the module docstring); returns its folder."""
    rng = np.random.default_rng(seed)
    base = os.path.join(preprocessed_root, dataset_name)
    data_dir = os.path.join(base, "nnUNetPlans_2d")
    os.makedirs(data_dir, exist_ok=True)
    H, W = size
    for i in range(n_cases):
        data, seg = disk_ring_case(rng, H, W)
        name = os.path.join(data_dir, f"case_{i:03d}")
        np.savez_compressed(name + ".npz", data=data, seg=seg)
        props = {"class_locations": _class_locations(rng, seg, 10000),
                 "shape_before_cropping": (1, H, W), "spacing": [999.0, 1.0, 1.0]}
        with open(name + ".pkl", "wb") as f:
            pickle.dump(props, f)
    dataset_json = {"labels": LABELS, "channel_names": {"0": "synthetic"},
                    "numTraining": n_cases, "file_ending": ".npz"}
    plans = {
        "dataset_name": dataset_name, "plans_name": "nnUNetPlans",
        "configurations": {"2d": {
            "data_identifier": "nnUNetPlans_2d", "preprocessor_name": "DefaultPreprocessor",
            "batch_size": batch_size, "patch_size": list(patch_size),
            "median_image_size_in_voxels": [H, W], "spacing": [1.0, 1.0],
            "normalization_schemes": ["ZScoreNormalization"], "use_mask_for_norm": [False],
            "batch_dice": True,
            "architecture": {"network_class_name": "DinoUNet", "arch_kwargs": architecture,
                             "_kw_requires_import": []},
        }},
    }
    with open(os.path.join(base, "dataset.json"), "w") as f:
        json.dump(dataset_json, f, indent=2)
    with open(os.path.join(base, "nnUNetPlans.json"), "w") as f:
        json.dump(plans, f, indent=2)
    return base
