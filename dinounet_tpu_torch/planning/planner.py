"""Experiment planner: target spacing, patch/batch size, network topology.

Capability parity with ref: dinounet/experiment_planning/experiment_planners/
default_experiment_planner.py:24-739, including the DinoUNet modifications:
``force_target_shape`` (back-computes spacing from the median shape, ref
:177-232), ``force_n_stages`` (re-runs topology with max_numpool = n-1, ref
:363-374 and in the memory-shrink loop :441), and ``max_batch_size`` (ref
:478-480).

The reference estimates memory by instantiating a torch network and
summing its feature-map sizes (ref :99-117); this computes the same quantity
analytically (closed-form sum over stages of the
dynamic_network_architectures feature-map accounting), so planning builds no
network. The reference constants stay as they are, the 8 GB target
included, so the plans equal the JAX package's byte for byte.

JAX-free copy of ``dinounet_tpu/planning/planner.py``.
"""

import os
import shutil
from copy import deepcopy
from typing import List, Optional, Tuple, Union

import numpy as np

from dinounet_tpu_torch import paths
from dinounet_tpu_torch.configuration import ANISO_THRESHOLD
from dinounet_tpu_torch.imageio.reader_writer_registry import determine_reader_writer_from_dataset_json
from dinounet_tpu_torch.planning.dataset_utils import get_filenames_of_train_images_and_targets
from dinounet_tpu_torch.planning.topology import get_pool_and_conv_props
from dinounet_tpu_torch.preprocessing.normalization import get_normalization_scheme
from dinounet_tpu_torch.preprocessing.resampling import compute_new_shape
from dinounet_tpu_torch.utilities import registry
from dinounet_tpu_torch.utilities.json_export import load_json, recursive_fix_for_json_export, save_json
from dinounet_tpu_torch.utilities.misc import maybe_convert_to_dataset_name


def compute_unet_feature_map_size(patch_size, features_per_stage, strides,
                                  n_conv_per_stage, n_conv_per_stage_decoder,
                                  num_classes: int, deep_supervision: bool = False) -> int:
    """Total feature-map elements of a PlainConvUNet — the closed form of
    torch's net.compute_conv_feature_map_size (ref planner :99-117)."""
    n_stages = len(features_per_stage)
    # per-stage spatial sizes (successive integer division, axis-wise)
    sizes = []
    cur = list(patch_size)
    for s in range(n_stages):
        cur = [i // j for i, j in zip(cur, strides[s])]
        sizes.append(list(cur))

    total = np.int64(0)
    for s in range(n_stages):
        total += np.int64(n_conv_per_stage[s]) * features_per_stage[s] * np.prod(sizes[s], dtype=np.int64)
    # decoder stage s works at encoder stage e = n_stages - 2 - s
    for s in range(n_stages - 1):
        e = n_stages - 2 - s
        sz = np.prod(sizes[e], dtype=np.int64)
        total += np.int64(n_conv_per_stage_decoder[s]) * features_per_stage[e] * sz
        total += np.int64(features_per_stage[e]) * sz  # transpconv output
        if deep_supervision or s == n_stages - 2:
            total += np.int64(num_classes) * sz
    return int(total)


@registry.planners.register("ExperimentPlanner")
class ExperimentPlanner:
    def __init__(self, dataset_name_or_id: Union[str, int],
                 gpu_memory_target_in_gb: float = 8,
                 preprocessor_name: str = "DefaultPreprocessor",
                 plans_name: str = "nnUNetPlans",
                 overwrite_target_spacing: Union[List[float], Tuple[float, ...]] = None,
                 force_target_shape: Union[List[int], Tuple[int, ...]] = None,
                 max_batch_size: int = 32,
                 force_n_stages: Optional[int] = None,
                 suppress_transpose: bool = False):
        self.dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
        self.suppress_transpose = suppress_transpose
        self.raw_dataset_folder = os.path.join(paths.nnUNet_raw(), self.dataset_name)
        preprocessed_folder = os.path.join(paths.nnUNet_preprocessed(), self.dataset_name)
        self.dataset_json = load_json(os.path.join(self.raw_dataset_folder, "dataset.json"))
        self.dataset = get_filenames_of_train_images_and_targets(
            self.raw_dataset_folder, self.dataset_json
        )

        fp_file = os.path.join(preprocessed_folder, "dataset_fingerprint.json")
        if not os.path.isfile(fp_file):
            raise RuntimeError(
                "Fingerprint missing for this dataset. Run fingerprint extraction first."
            )
        self.dataset_fingerprint = load_json(fp_file)

        self.anisotropy_threshold = ANISO_THRESHOLD

        # nnU-Net v2 reference constants (ref :53-75)
        self.UNet_base_num_features = 32
        self.UNet_class_name = "dynamic_network_architectures.architectures.unet.PlainConvUNet"
        self.UNet_reference_val_3d = 560000000
        self.UNet_reference_val_2d = 85000000
        self.UNet_reference_com_nfeatures = 32
        self.UNet_reference_val_corresp_GB = 8
        self.UNet_reference_val_corresp_bs_2d = 12
        self.UNet_reference_val_corresp_bs_3d = 2
        self.UNet_featuremap_min_edge_length = 4
        self.UNet_blocks_per_stage_encoder = (2,) * 14
        self.UNet_blocks_per_stage_decoder = (2,) * 13
        self.UNet_min_batch_size = 2
        self.UNet_max_features_2d = 512
        self.UNet_max_features_3d = 320
        self.max_dataset_covered = 0.05
        self.UNet_vram_target_GB = gpu_memory_target_in_gb
        self.lowres_creation_threshold = 0.25

        self.preprocessor_name = preprocessor_name
        self.plans_identifier = plans_name
        self.overwrite_target_spacing = overwrite_target_spacing
        self.force_target_shape = force_target_shape
        self.max_batch_size = max_batch_size
        self.force_n_stages = force_n_stages
        if overwrite_target_spacing is not None:
            assert len(overwrite_target_spacing) and all(
                isinstance(i, float) for i in overwrite_target_spacing
            ), "overwrite_target_spacing must be three floats"
        self.plans = None

        splits_file = os.path.join(self.raw_dataset_folder, "splits_final.json")
        if os.path.isfile(splits_file):
            target = os.path.join(preprocessed_folder, "splits_final.json")
            if not os.path.isfile(target):
                os.makedirs(preprocessed_folder, exist_ok=True)
                shutil.copy(splits_file, target)

    def determine_reader_writer(self):
        example_image = self.dataset[next(iter(self.dataset))]["images"][0]
        return determine_reader_writer_from_dataset_json(self.dataset_json, example_image)

    def static_estimate_VRAM_usage(self, patch_size, num_input_channels: int,
                                   output_channels: int, arch_kwargs: dict) -> int:
        return compute_unet_feature_map_size(
            patch_size,
            arch_kwargs["features_per_stage"],
            arch_kwargs["strides"],
            arch_kwargs["n_conv_per_stage"],
            arch_kwargs["n_conv_per_stage_decoder"],
            output_channels,
        )

    def determine_resampling(self, *args, **kwargs):
        data_kwargs = {"is_seg": False, "order": 3, "order_z": 0, "force_separate_z": None}
        seg_kwargs = {"is_seg": True, "order": 1, "order_z": 0, "force_separate_z": None}
        return ("resample_data_or_seg_to_shape", data_kwargs,
                "resample_data_or_seg_to_shape", seg_kwargs)

    def determine_segmentation_softmax_export_fn(self, *args, **kwargs):
        kwargs_ = {"is_seg": False, "order": 1, "order_z": 0, "force_separate_z": None}
        return "resample_data_or_seg_to_shape", kwargs_

    def determine_fullres_target_spacing(self, configuration_type: str = "3d") -> np.ndarray:
        """ref :162-262 incl. the force_target_shape back-computation."""
        if self.overwrite_target_spacing is not None:
            return np.array(self.overwrite_target_spacing)

        spacings = self.dataset_fingerprint["spacings"]
        sizes = self.dataset_fingerprint["shapes_after_crop"]

        if self.force_target_shape is not None:
            median_spacing = np.median(np.vstack(spacings), 0)
            median_shape = np.median(np.vstack(sizes), 0)
            fts = list(self.force_target_shape)
            if configuration_type == "2d":
                if len(fts) == 2:
                    target_shape_2d = np.array(fts)
                elif len(fts) == 3:
                    target_shape_2d = np.array(fts[1:])
                else:
                    raise ValueError("force_target_shape must have 2 or 3 elements")
                scale = target_shape_2d / median_shape[1:]
                return median_spacing[1:] / scale
            if len(fts) == 2:
                scale_2d = np.array(fts) / median_shape[1:]
                sp_2d = median_spacing[1:] / scale_2d
                return np.array([median_spacing[0], sp_2d[0], sp_2d[1]])
            if len(fts) == 3:
                return median_spacing / (np.array(fts) / median_shape)
            raise ValueError("force_target_shape must have 2 or 3 elements")

        target = np.percentile(np.vstack(spacings), 50, 0)
        target_size = np.percentile(np.vstack(sizes), 50, 0)
        worst_spacing_axis = np.argmax(target)
        other_axes = [i for i in range(len(target)) if i != worst_spacing_axis]
        other_spacings = [target[i] for i in other_axes]
        other_sizes = [target_size[i] for i in other_axes]

        has_aniso_spacing = target[worst_spacing_axis] > self.anisotropy_threshold * max(other_spacings)
        has_aniso_voxels = target_size[worst_spacing_axis] * self.anisotropy_threshold < min(other_sizes)
        if has_aniso_spacing and has_aniso_voxels:
            spacings_of_axis = np.vstack(spacings)[:, worst_spacing_axis]
            target_axis = np.percentile(spacings_of_axis, 10)
            if target_axis < max(other_spacings):
                target_axis = max(max(other_spacings), target_axis) + 1e-5
            target[worst_spacing_axis] = target_axis
        return target

    def determine_normalization_scheme_and_whether_mask_is_used_for_norm(self):
        modalities = self.dataset_json.get("channel_names", self.dataset_json.get("modality"))
        schemes = [get_normalization_scheme(m) for m in modalities.values()]
        if self.dataset_fingerprint["median_relative_size_after_cropping"] < 3 / 4.0:
            use_mask = [
                s.leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true
                for s in schemes
            ]
        else:
            use_mask = [False] * len(schemes)
        return [s.__name__ for s in schemes], use_mask

    def determine_transpose(self):
        if self.suppress_transpose:
            return [0, 1, 2], [0, 1, 2]
        if self.force_target_shape is not None and len(self.force_target_shape) == 2:
            configuration_type = "2d"
        else:
            configuration_type = "3d"
        # NOTE: for a forced-2d shape this returns a 2-vector and argmax ranges over
        # {0, 1} — replicating the reference's behavior exactly (ref :290-299)
        target_spacing = self.determine_fullres_target_spacing(configuration_type)
        max_spacing_axis = int(np.argmax(target_spacing))
        remaining = [i for i in range(3) if i != max_spacing_axis]
        transpose_forward = [max_spacing_axis] + remaining
        transpose_backward = [transpose_forward.index(i) for i in range(3)]
        return transpose_forward, transpose_backward

    def get_plans_for_configuration(self, spacing, median_shape, data_identifier: str,
                                    approximate_n_voxels_dataset: float, _cache: dict,
                                    override_patch_size=None) -> dict:
        def _features_per_stage(num_stages, max_num_features):
            return tuple(
                min(max_num_features, self.UNet_base_num_features * 2 ** i)
                for i in range(num_stages)
            )

        def _keygen(patch_size, strides):
            return str(patch_size) + "_" + str(strides)

        assert all(i > 0 for i in spacing), f"Spacing must be > 0! Spacing: {spacing}"
        num_input_channels = len(
            self.dataset_json.get("channel_names", self.dataset_json.get("modality"))
        )
        max_num_features = (
            self.UNet_max_features_2d if len(spacing) == 2 else self.UNet_max_features_3d
        )
        dim = len(spacing)

        tmp = 1 / np.array(spacing)
        if override_patch_size is not None and len(override_patch_size) == dim:
            initial_patch_size = np.array(list(override_patch_size))
        else:
            if dim == 3:
                initial_patch_size = [round(i) for i in tmp * (256 ** 3 / np.prod(tmp)) ** (1 / 3)]
            elif dim == 2:
                initial_patch_size = [round(i) for i in tmp * (2048 ** 2 / np.prod(tmp)) ** (1 / 2)]
            else:
                raise RuntimeError()
            initial_patch_size = np.array(
                [min(i, j) for i, j in zip(initial_patch_size, median_shape[:dim])]
            )

        network_num_pool_per_axis, pool_op_kernel_sizes, conv_kernel_sizes, patch_size, \
            shape_must_be_divisible_by = get_pool_and_conv_props(
                spacing, initial_patch_size, self.UNet_featuremap_min_edge_length, 999999
            )
        num_stages = len(pool_op_kernel_sizes)

        if self.force_n_stages is not None and self.force_n_stages != num_stages:
            network_num_pool_per_axis, pool_op_kernel_sizes, conv_kernel_sizes, patch_size, \
                shape_must_be_divisible_by = get_pool_and_conv_props(
                    spacing, initial_patch_size, self.UNet_featuremap_min_edge_length,
                    self.force_n_stages - 1,
                )
            num_stages = len(pool_op_kernel_sizes)

        conv_op = f"torch.nn.modules.conv.Conv{dim}d"
        norm_op = f"torch.nn.modules.instancenorm.InstanceNorm{dim}d"
        architecture_kwargs = {
            "network_class_name": self.UNet_class_name,
            "arch_kwargs": {
                "n_stages": num_stages,
                "features_per_stage": _features_per_stage(num_stages, max_num_features),
                "conv_op": conv_op,
                "kernel_sizes": conv_kernel_sizes,
                "strides": pool_op_kernel_sizes,
                "n_conv_per_stage": self.UNet_blocks_per_stage_encoder[:num_stages],
                "n_conv_per_stage_decoder": self.UNet_blocks_per_stage_decoder[:num_stages - 1],
                "conv_bias": True,
                "norm_op": norm_op,
                "norm_op_kwargs": {"eps": 1e-5, "affine": True},
                "dropout_op": None,
                "dropout_op_kwargs": None,
                "nonlin": "torch.nn.LeakyReLU",
                "nonlin_kwargs": {"inplace": True},
            },
            "_kw_requires_import": ("conv_op", "norm_op", "dropout_op", "nonlin"),
        }

        def _estimate():
            key = _keygen(patch_size, pool_op_kernel_sizes)
            if key not in _cache:
                _cache[key] = self.static_estimate_VRAM_usage(
                    patch_size, num_input_channels, len(self.dataset_json["labels"]),
                    architecture_kwargs["arch_kwargs"],
                )
            return _cache[key]

        estimate = _estimate()
        reference = (
            self.UNet_reference_val_2d if dim == 2 else self.UNet_reference_val_3d
        ) * (self.UNet_vram_target_GB / self.UNet_reference_val_corresp_GB)
        ref_bs = (
            self.UNet_reference_val_corresp_bs_2d if dim == 2
            else self.UNet_reference_val_corresp_bs_3d
        )

        # shrink the largest (relative to median shape) axis until it fits (ref :419-467)
        while (override_patch_size is None) and ((estimate / ref_bs * 2) > reference):
            axis_to_be_reduced = np.argsort(
                [i / j for i, j in zip(patch_size, median_shape[:dim])]
            )[-1]
            patch_size = list(patch_size)
            tmp_ps = deepcopy(patch_size)
            tmp_ps[axis_to_be_reduced] -= shape_must_be_divisible_by[axis_to_be_reduced]
            _, _, _, _, shape_must_be_divisible_by = get_pool_and_conv_props(
                spacing, tmp_ps, self.UNet_featuremap_min_edge_length, 999999
            )
            patch_size[axis_to_be_reduced] -= shape_must_be_divisible_by[axis_to_be_reduced]

            max_numpool = (self.force_n_stages - 1) if self.force_n_stages is not None else 999999
            network_num_pool_per_axis, pool_op_kernel_sizes, conv_kernel_sizes, patch_size, \
                shape_must_be_divisible_by = get_pool_and_conv_props(
                    spacing, patch_size, self.UNet_featuremap_min_edge_length, max_numpool
                )
            num_stages = len(pool_op_kernel_sizes)
            architecture_kwargs["arch_kwargs"].update({
                "n_stages": num_stages,
                "kernel_sizes": conv_kernel_sizes,
                "strides": pool_op_kernel_sizes,
                "features_per_stage": _features_per_stage(num_stages, max_num_features),
                "n_conv_per_stage": self.UNet_blocks_per_stage_encoder[:num_stages],
                "n_conv_per_stage_decoder": self.UNet_blocks_per_stage_decoder[:num_stages - 1],
            })
            estimate = _estimate()

        batch_size = round((reference / estimate) * ref_bs)
        bs_5_percent = round(
            approximate_n_voxels_dataset * self.max_dataset_covered
            / np.prod(patch_size, dtype=np.float64)
        )
        batch_size = max(
            min(batch_size, bs_5_percent, self.max_batch_size), self.UNet_min_batch_size
        )

        res_data, res_data_kwargs, res_seg, res_seg_kwargs = self.determine_resampling()
        res_softmax, res_softmax_kwargs = self.determine_segmentation_softmax_export_fn()
        normalization_schemes, mask_is_used = \
            self.determine_normalization_scheme_and_whether_mask_is_used_for_norm()

        return {
            "data_identifier": data_identifier,
            "preprocessor_name": self.preprocessor_name,
            "batch_size": batch_size,
            "patch_size": [int(i) for i in patch_size],
            "median_image_size_in_voxels": [float(i) for i in median_shape],
            "spacing": [float(i) for i in spacing],
            "normalization_schemes": normalization_schemes,
            "use_mask_for_norm": mask_is_used,
            "resampling_fn_data": res_data,
            "resampling_fn_seg": res_seg,
            "resampling_fn_data_kwargs": res_data_kwargs,
            "resampling_fn_seg_kwargs": res_seg_kwargs,
            "resampling_fn_probabilities": res_softmax,
            "resampling_fn_probabilities_kwargs": res_softmax_kwargs,
            "architecture": architecture_kwargs,
        }

    def plan_experiment(self) -> dict:
        """ref :520-687: builds 2d / 3d_fullres / 3d_lowres / 3d_cascade_fullres."""
        _tmp = {}

        transpose_forward, transpose_backward = self.determine_transpose()
        fullres_spacing = self.determine_fullres_target_spacing("3d")
        fullres_spacing_transposed = fullres_spacing[transpose_forward]

        new_shapes = [
            compute_new_shape(j, i, fullres_spacing)
            for i, j in zip(self.dataset_fingerprint["spacings"],
                            self.dataset_fingerprint["shapes_after_crop"])
        ]
        new_median_shape = np.median(new_shapes, 0)
        new_median_shape_transposed = new_median_shape[transpose_forward]

        approximate_n_voxels_dataset = float(
            np.prod(new_median_shape_transposed, dtype=np.float64)
            * self.dataset_json["numTraining"]
        )

        if new_median_shape_transposed[0] != 1:
            plan_3d_fullres = self.get_plans_for_configuration(
                fullres_spacing_transposed, new_median_shape_transposed,
                self.generate_data_identifier("3d_fullres"),
                approximate_n_voxels_dataset, _tmp,
                override_patch_size=(
                    np.array(self.force_target_shape)[transpose_forward]
                    if (self.force_target_shape is not None and len(self.force_target_shape) == 3)
                    else None
                ),
            )
            # maybe add 3d_lowres (ref :560-600)
            patch_size_fullres = plan_3d_fullres["patch_size"]
            median_num_voxels = np.prod(new_median_shape_transposed, dtype=np.float64)
            num_voxels_in_patch = np.prod(patch_size_fullres, dtype=np.float64)
            plan_3d_lowres = None
            lowres_spacing = np.array(deepcopy(plan_3d_fullres["spacing"]))
            spacing_increase_factor = 1.03
            while num_voxels_in_patch / median_num_voxels < self.lowres_creation_threshold:
                max_spacing = max(lowres_spacing)
                if np.any((max_spacing / lowres_spacing) > 2):
                    lowres_spacing[(max_spacing / lowres_spacing) > 2] *= spacing_increase_factor
                else:
                    lowres_spacing *= spacing_increase_factor
                median_num_voxels = np.prod(
                    np.array(plan_3d_fullres["spacing"]) / lowres_spacing
                    * new_median_shape_transposed, dtype=np.float64,
                )
                plan_3d_lowres = self.get_plans_for_configuration(
                    lowres_spacing,
                    tuple(round(i) for i in np.array(plan_3d_fullres["spacing"])
                          / lowres_spacing * new_median_shape_transposed),
                    self.generate_data_identifier("3d_lowres"),
                    float(median_num_voxels * self.dataset_json["numTraining"]),
                    _tmp, override_patch_size=None,
                )
                num_voxels_in_patch = np.prod(plan_3d_lowres["patch_size"], dtype=np.int64)
            if plan_3d_lowres is not None and (
                np.prod(new_median_shape_transposed, dtype=np.float64) / median_num_voxels < 2
            ):
                plan_3d_lowres = None
            if plan_3d_lowres is not None:
                plan_3d_lowres["batch_dice"] = False
                plan_3d_fullres["batch_dice"] = True
            else:
                plan_3d_fullres["batch_dice"] = False
        else:
            plan_3d_fullres = None
            plan_3d_lowres = None

        # 2d configuration with its own spacing derivation (ref :604-640)
        fullres_spacing_2d = self.determine_fullres_target_spacing("2d")
        median_spacing = np.median(np.vstack(self.dataset_fingerprint["spacings"]), 0)
        if len(fullres_spacing_2d) == 2:
            spacing_3d_for_2d = np.array(
                [median_spacing[0], fullres_spacing_2d[0], fullres_spacing_2d[1]]
            )
        else:
            spacing_3d_for_2d = np.array(fullres_spacing_2d)
        spacing_transposed_2d = spacing_3d_for_2d[transpose_forward]

        new_shapes_2d = [
            compute_new_shape(j, i, spacing_3d_for_2d)
            for i, j in zip(self.dataset_fingerprint["spacings"],
                            self.dataset_fingerprint["shapes_after_crop"])
        ]
        new_median_shape_2d = np.median(new_shapes_2d, 0)
        new_median_shape_transposed_2d = new_median_shape_2d[transpose_forward]
        approximate_n_voxels_2d = float(
            np.prod(new_median_shape_transposed_2d, dtype=np.float64)
            * self.dataset_json["numTraining"]
        )

        override_patch_size_2d = None
        if self.force_target_shape is not None and len(self.force_target_shape) == 2:
            tmp_vec = np.array([1, self.force_target_shape[0], self.force_target_shape[1]])
            override_patch_size_2d = tmp_vec[transpose_forward][1:].tolist()

        plan_2d = self.get_plans_for_configuration(
            spacing_transposed_2d[1:], new_median_shape_transposed_2d[1:],
            self.generate_data_identifier("2d"), approximate_n_voxels_2d, _tmp,
            override_patch_size=override_patch_size_2d,
        )
        plan_2d["batch_dice"] = True

        median_spacing_t = np.median(self.dataset_fingerprint["spacings"], 0)[transpose_forward]
        median_shape_t = np.median(
            self.dataset_fingerprint["shapes_after_crop"], 0
        )[transpose_forward]

        shutil.copy(
            os.path.join(self.raw_dataset_folder, "dataset.json"),
            os.path.join(paths.nnUNet_preprocessed(), self.dataset_name, "dataset.json"),
        )

        plans = {
            "dataset_name": self.dataset_name,
            "plans_name": self.plans_identifier,
            "original_median_spacing_after_transp": [float(i) for i in median_spacing_t],
            "original_median_shape_after_transp": [int(round(i)) for i in median_shape_t],
            "image_reader_writer": self.determine_reader_writer().__name__,
            "transpose_forward": [int(i) for i in transpose_forward],
            "transpose_backward": [int(i) for i in transpose_backward],
            "configurations": {"2d": plan_2d},
            "experiment_planner_used": self.__class__.__name__,
            "label_manager": "LabelManager",
            "foreground_intensity_properties_per_channel": self.dataset_fingerprint[
                "foreground_intensity_properties_per_channel"
            ],
        }

        if plan_3d_lowres is not None:
            plans["configurations"]["3d_lowres"] = plan_3d_lowres
            if plan_3d_fullres is not None:
                plans["configurations"]["3d_lowres"]["next_stage"] = "3d_cascade_fullres"
        if plan_3d_fullres is not None:
            plans["configurations"]["3d_fullres"] = plan_3d_fullres
            if plan_3d_lowres is not None:
                plans["configurations"]["3d_cascade_fullres"] = {
                    "inherits_from": "3d_fullres",
                    "previous_stage": "3d_lowres",
                }

        self.plans = plans
        self.save_plans(plans)
        return plans

    def save_plans(self, plans):
        plans = recursive_fix_for_json_export(plans)
        plans_file = os.path.join(
            paths.nnUNet_preprocessed(), self.dataset_name, self.plans_identifier + ".json"
        )
        # keep non-default configurations from an existing plans file (ref :692-707)
        if os.path.isfile(plans_file):
            old_plans = load_json(plans_file)
            old_cfgs = old_plans["configurations"]
            for c in list(plans["configurations"].keys()):
                old_cfgs.pop(c, None)
            plans["configurations"].update(old_cfgs)
        save_json(plans, plans_file, sort_keys=False)

    def generate_data_identifier(self, configuration_name: str) -> str:
        return self.plans_identifier + "_" + configuration_name

    def load_plans(self, fname: str):
        self.plans = load_json(fname)
