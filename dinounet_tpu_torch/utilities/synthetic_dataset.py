"""Synthetic 2-D and 3-D datasets, for smoke runs and tests of training and
of the path from raw files.

Each case is a noisy image with a bright disk (label 1) and a dark ring
(label 2) at random places and sizes (``disk_ring_case``): the intensities
correlate with the labels, so a network that trains at all lowers its loss
within a few dozen steps. All of it comes from a numpy seed. Three writers:

``write_disk_ring_dataset`` writes, under ``<preprocessed_root>/<name>/``,
what nnU-Net's preprocessing leaves for a 2-D configuration:
``dataset.json``, the plans file ``nnUNetPlans.json`` (one ``2d``
configuration with the given patch, batch size and network ``architecture``
dict) and ``nnUNetPlans_2d/<case>.npz`` (``data`` (1, 1, H, W) float32,
``seg`` (1, 1, H, W) int8) with ``<case>.pkl`` properties holding the
``class_locations`` the loader's foreground oversampling reads.

``write_disk_ring_raw_dataset`` writes a raw dataset of one-slice NIfTI
cases (``imagesTr``, ``labelsTr``, ``imagesTs``, ``dataset.json``) under
``<raw_root>/<name>/`` and a hand-written plans file for it under
``<preprocessed_root>/<name>/``, for preprocessing without the planner.

``write_disk_ring_png_dataset`` writes a raw dataset of grey PNG cases
(``imagesTr``, ``labelsTr``, ``dataset.json``) and no plans file: the
planner's input, read through ``NaturalImage2DIO``, as the JAX package's
``tests/helpers.py::make_png_dataset`` writes one for its planning tests.

``write_sphere_shell_raw_dataset`` writes a raw 3-D dataset of NIfTI volumes
at 1 mm isotropic (``imagesTr``, ``labelsTr``, ``imagesTs``,
``dataset.json``), each a noisy volume with a bright sphere (label 1) and a
dark spherical shell (label 2) (``sphere_shell_case``), and no plans file:
the planner's input for ``3d_fullres``.
"""

import json
import os
import pickle

import numpy as np

from dinounet_tpu_torch.imageio.nifti import write_nifti

LABELS = {"background": 0, "disk": 1, "ring": 2}
LABELS_3D = {"background": 0, "sphere": 1, "shell": 2}


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


def _intensity_properties(foreground: np.ndarray) -> dict:
    """The planner's foreground intensity statistics of one channel."""
    return {"max": float(np.max(foreground)), "mean": float(np.mean(foreground)),
            "median": float(np.median(foreground)), "min": float(np.min(foreground)),
            "percentile_00_5": float(np.percentile(foreground, 0.5)),
            "percentile_99_5": float(np.percentile(foreground, 99.5)),
            "std": float(np.std(foreground))}


def write_disk_ring_raw_dataset(raw_root: str, preprocessed_root: str,
                                dataset_name: str, n_train: int, n_test: int, size,
                                in_plane_spacing: float, target_spacing: float,
                                patch_size, batch_size: int, architecture: dict,
                                seed: int = 0) -> str:
    """Write the raw dataset and its plans (see the module docstring):
    `n_train` labelled and `n_test` unlabelled cases of one (H, W) slice at
    `in_plane_spacing` mm (1 mm between slices), drawn in that order from
    one generator; the plans resample to `target_spacing` mm in plane.
    Returns the raw dataset's folder."""
    rng = np.random.default_rng(seed)
    H, W = size
    folder = os.path.join(raw_root, dataset_name)
    for sub in ("imagesTr", "labelsTr", "imagesTs"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    spacing_xyz = (in_plane_spacing, in_plane_spacing, 1.0)
    foreground = []
    for i in range(n_train + n_test):
        img, seg = disk_ring_case(rng, H, W)  # (1, 1, H, W): one slice (z, y, x)
        name = f"case_{i:03d}"
        if i < n_train:
            write_nifti(os.path.join(folder, "imagesTr", name + "_0000.nii.gz"),
                        img[0], spacing_xyz)
            write_nifti(os.path.join(folder, "labelsTr", name + ".nii.gz"),
                        seg[0].astype(np.uint8), spacing_xyz)
            foreground.append(img[0][seg[0] > 0])
        else:
            write_nifti(os.path.join(folder, "imagesTs", name + "_0000.nii.gz"),
                        img[0], spacing_xyz)
    dataset_json = {"channel_names": {"0": "synthetic"}, "labels": LABELS,
                    "numTraining": n_train, "file_ending": ".nii.gz"}

    resampling_kwargs = {"order_z": 0, "force_separate_z": None}
    plans = {
        "dataset_name": dataset_name, "plans_name": "nnUNetPlans",
        "original_median_spacing_after_transp": [1.0, in_plane_spacing, in_plane_spacing],
        "original_median_shape_after_transp": [1, H, W],
        "image_reader_writer": "NiftiIO",
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "configurations": {"2d": {
            "data_identifier": "nnUNetPlans_2d", "preprocessor_name": "DefaultPreprocessor",
            "batch_size": batch_size, "patch_size": list(patch_size),
            "median_image_size_in_voxels": [
                round(H * in_plane_spacing / target_spacing),
                round(W * in_plane_spacing / target_spacing)],
            "spacing": [target_spacing, target_spacing],
            "normalization_schemes": ["ZScoreNormalization"], "use_mask_for_norm": [False],
            "resampling_fn_data": "resample_data_or_seg_to_shape",
            "resampling_fn_seg": "resample_data_or_seg_to_shape",
            "resampling_fn_data_kwargs": {"is_seg": False, "order": 3, **resampling_kwargs},
            "resampling_fn_seg_kwargs": {"is_seg": True, "order": 1, **resampling_kwargs},
            "resampling_fn_probabilities": "resample_data_or_seg_to_shape",
            "resampling_fn_probabilities_kwargs": {"is_seg": False, "order": 1,
                                                   **resampling_kwargs},
            "architecture": {"network_class_name": "DinoUNet", "arch_kwargs": architecture,
                             "_kw_requires_import": []},
            "batch_dice": True,
        }},
        "experiment_planner_used": "ExperimentPlanner", "label_manager": "LabelManager",
        "foreground_intensity_properties_per_channel": {
            "0": _intensity_properties(np.concatenate(foreground))},
    }
    for base in (folder, os.path.join(preprocessed_root, dataset_name)):
        os.makedirs(base, exist_ok=True)
        with open(os.path.join(base, "dataset.json"), "w") as f:
            json.dump(dataset_json, f, indent=2)
    with open(os.path.join(preprocessed_root, dataset_name, "nnUNetPlans.json"), "w") as f:
        json.dump(plans, f, indent=2)
    return folder


def write_disk_ring_png_dataset(raw_root: str, dataset_name: str, n_cases: int, size,
                                seed: int = 0) -> str:
    """Write `n_cases` labelled (H, W) cases as 8-bit grey PNG files and
    their dataset.json under <raw_root>/<dataset_name>/ (see the module
    docstring); returns that folder. Keep H >= W: with a forced target shape
    the planner takes the transpose from the argmax of the in-plane spacing,
    which garbles the forced patch when W > H (the reference's quirk, which
    the planner keeps)."""
    from dinounet_tpu_torch.imageio.natural_image import pil_image

    Image = pil_image()
    rng = np.random.default_rng(seed)
    H, W = size
    folder = os.path.join(raw_root, dataset_name)
    for sub in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    for i in range(n_cases):
        img, seg = disk_ring_case(rng, H, W)  # z-scored: +-4 covers it
        grey = np.clip(np.round(img[0, 0] * 32.0 + 128.0), 0, 255).astype(np.uint8)
        name = f"case_{i:03d}"
        Image.fromarray(grey).save(os.path.join(folder, "imagesTr", name + "_0000.png"))
        Image.fromarray(seg[0, 0].astype(np.uint8)).save(
            os.path.join(folder, "labelsTr", name + ".png"))
    dataset_json = {"channel_names": {"0": "rescale_to_0_1"}, "labels": LABELS,
                    "numTraining": n_cases, "file_ending": ".png",
                    "overwrite_image_reader_writer": "NaturalImage2DIO"}
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump(dataset_json, f, indent=2)
    return folder


def sphere_shell_case(rng: np.random.Generator, D: int, H: int, W: int):
    """One 3-D case: image (D, H, W) float32 (z-scored), labels (D, H, W)
    uint8: a sphere (1) and a shell (2) at random places and sizes."""
    zz, yy, xx = (np.arange(n, dtype=np.float32) for n in (D, H, W))
    zz, yy, xx = zz[:, None, None], yy[None, :, None], xx[None, None, :]
    seg = np.zeros((D, H, W), np.uint8)
    m = min(D, H, W)

    def centre(r):
        return [rng.uniform(r + 1, n - r - 1) for n in (D, H, W)]

    r_sphere = rng.uniform(0.10, 0.18) * m
    cz, cy, cx = centre(r_sphere)
    seg[(zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2 <= r_sphere ** 2] = 1
    r_out = rng.uniform(0.12, 0.20) * m
    r_in = r_out * rng.uniform(0.55, 0.75)
    cz, cy, cx = centre(r_out)
    d2 = (zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2
    seg[(d2 <= r_out ** 2) & (d2 >= r_in ** 2) & (seg == 0)] = 2
    img = rng.standard_normal((D, H, W), dtype=np.float32) * np.float32(0.6)
    img += np.where(seg == 1, np.float32(2.0), np.float32(0.0))
    img += np.where(seg == 2, np.float32(-1.5), np.float32(0.0))
    img = (img - img.mean()) / img.std()
    return img.astype(np.float32), seg


def write_sphere_shell_raw_dataset(raw_root: str, dataset_name: str, n_train: int,
                                   n_test: int, size, seed: int = 0) -> str:
    """Write `n_train` labelled and `n_test` unlabelled (D, H, W) cases at
    1 mm isotropic, drawn in that order from one generator, and their
    dataset.json under <raw_root>/<dataset_name>/ (see the module
    docstring); returns that folder."""
    rng = np.random.default_rng(seed)
    folder = os.path.join(raw_root, dataset_name)
    for sub in ("imagesTr", "labelsTr", "imagesTs"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    for i in range(n_train + n_test):
        img, seg = sphere_shell_case(rng, *size)
        name = f"case_{i:03d}"
        sub = "imagesTr" if i < n_train else "imagesTs"
        write_nifti(os.path.join(folder, sub, name + "_0000.nii.gz"), img, (1.0, 1.0, 1.0))
        if i < n_train:
            write_nifti(os.path.join(folder, "labelsTr", name + ".nii.gz"), seg,
                        (1.0, 1.0, 1.0))
    dataset_json = {"channel_names": {"0": "synthetic"}, "labels": LABELS_3D,
                    "numTraining": n_train, "file_ending": ".nii.gz"}
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump(dataset_json, f, indent=2)
    return folder
