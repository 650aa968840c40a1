"""DefaultPreprocessor: transpose -> crop -> normalize -> resample -> save.

Capability parity with ref: dinounet/preprocessing/preprocessors/
default_preprocessor.py:33-299. Normalization happens BEFORE resampling (the
reference's invariant, ref :76-80); foreground locations (<=10k per class,
seeded) are stored in the .pkl properties for oversampling during training.
Output format is byte-compatible: <case>.npz {data, seg} + <case>.pkl.

JAX-free copy of ``dinounet_tpu/preprocessing/preprocessor.py``.
"""

import os
import pickle
import shutil
# Threads, not processes: the heavy work is numpy/scipy (GIL-releasing), and
# a forked child cannot use its parent's CUDA context. The reference uses
# spawn pools for the same reason.
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple, Union

import numpy as np

from dinounet_tpu_torch import paths
from dinounet_tpu_torch.preprocessing.cropping import crop_to_nonzero
from dinounet_tpu_torch.preprocessing.normalization import get_normalization_scheme_by_name
from dinounet_tpu_torch.preprocessing.resampling import compute_new_shape
from dinounet_tpu_torch.planning.dataset_utils import get_filenames_of_train_images_and_targets
from dinounet_tpu_torch.utilities import registry
from dinounet_tpu_torch.utilities.json_export import load_json
from dinounet_tpu_torch.utilities.misc import maybe_convert_to_dataset_name
from dinounet_tpu_torch.utilities.plans_handler import ConfigurationManager, PlansManager


@registry.preprocessors.register("DefaultPreprocessor")
class DefaultPreprocessor:
    def __init__(self, verbose: bool = True):
        self.verbose = verbose

    def run_case_npy(self, data: np.ndarray, seg: Union[np.ndarray, None], properties: dict,
                     plans_manager: PlansManager, configuration_manager: ConfigurationManager,
                     dataset_json: Union[dict, str]) -> Tuple[np.ndarray, np.ndarray]:
        data = np.copy(data)
        if seg is not None:
            assert data.shape[1:] == seg.shape[1:], (
                "Shape mismatch between image and segmentation"
            )
            seg = np.copy(seg)
        has_seg = seg is not None

        tf = plans_manager.transpose_forward
        data = data.transpose([0, *[i + 1 for i in tf]])
        if seg is not None:
            seg = seg.transpose([0, *[i + 1 for i in tf]])
        original_spacing = [properties["spacing"][i] for i in tf]

        properties["shape_before_cropping"] = data.shape[1:]
        data, seg, bbox = crop_to_nonzero(data, seg)
        properties["bbox_used_for_cropping"] = bbox
        properties["shape_after_cropping_and_before_resampling"] = data.shape[1:]

        target_spacing = list(configuration_manager.spacing)
        if len(target_spacing) < len(data.shape[1:]):
            # 2d config: keep the between-slice spacing unchanged
            target_spacing = [original_spacing[0]] + target_spacing
        new_shape = compute_new_shape(data.shape[1:], original_spacing, target_spacing)

        # normalize BEFORE resampling (ref :76-80)
        data = self._normalize(
            data, seg, configuration_manager,
            plans_manager.foreground_intensity_properties_per_channel,
        )

        data = configuration_manager.resampling_fn_data(
            data, new_shape, original_spacing, target_spacing
        )
        seg = configuration_manager.resampling_fn_seg(
            seg, new_shape, original_spacing, target_spacing
        )

        if has_seg:
            if isinstance(dataset_json, str):
                dataset_json = load_json(dataset_json)
            label_manager = plans_manager.get_label_manager(dataset_json)
            collect_for_this = (
                label_manager.foreground_regions if label_manager.has_regions
                else label_manager.foreground_labels
            )
            if label_manager.has_ignore_label:
                collect_for_this.append(label_manager.all_labels)
            properties["class_locations"] = self._sample_foreground_locations(
                seg, collect_for_this, verbose=self.verbose
            )
            seg = self.modify_seg_fn(seg, plans_manager, dataset_json, configuration_manager)

        seg = seg.astype(np.int16 if np.max(seg) > 127 else np.int8)
        return data, seg

    def run_case(self, image_files: List[str], seg_file: Union[str, None],
                 plans_manager: PlansManager, configuration_manager: ConfigurationManager,
                 dataset_json: Union[dict, str]):
        if isinstance(dataset_json, str):
            dataset_json = load_json(dataset_json)
        rw = plans_manager.image_reader_writer_class()
        data, data_properties = rw.read_images(image_files)
        seg = rw.read_seg(seg_file)[0] if seg_file is not None else None
        data, seg = self.run_case_npy(
            data, seg, data_properties, plans_manager, configuration_manager, dataset_json
        )
        return data, seg, data_properties

    def run_case_save(self, output_filename_truncated: str, image_files: List[str],
                      seg_file: str, plans_manager: PlansManager,
                      configuration_manager: ConfigurationManager,
                      dataset_json: Union[dict, str]):
        data, seg, properties = self.run_case(
            image_files, seg_file, plans_manager, configuration_manager, dataset_json
        )
        np.savez_compressed(output_filename_truncated + ".npz", data=data, seg=seg)
        with open(output_filename_truncated + ".pkl", "wb") as f:
            pickle.dump(properties, f)

    @staticmethod
    def _sample_foreground_locations(seg: np.ndarray, classes_or_regions,
                                     seed: int = 1234, verbose: bool = False) -> dict:
        """<=10k coords per class/region, at least 1% coverage (ref :156-181)."""
        num_samples = 10000
        min_percent_coverage = 0.01
        rndst = np.random.RandomState(seed)
        class_locs = {}
        for c in classes_or_regions:
            k = tuple(c) if isinstance(c, list) else c
            if isinstance(c, (tuple, list)):
                mask = seg == c[0]
                for cc in c[1:]:
                    mask = mask | (seg == cc)
                all_locs = np.argwhere(mask)
            else:
                all_locs = np.argwhere(seg == c)
            if len(all_locs) == 0:
                class_locs[k] = []
                continue
            target = min(num_samples, len(all_locs))
            target = max(target, int(np.ceil(len(all_locs) * min_percent_coverage)))
            class_locs[k] = all_locs[rndst.choice(len(all_locs), target, replace=False)]
        return class_locs

    def _normalize(self, data: np.ndarray, seg: np.ndarray,
                   configuration_manager: ConfigurationManager,
                   foreground_intensity_properties_per_channel: dict) -> np.ndarray:
        for c in range(data.shape[0]):
            scheme = configuration_manager.normalization_schemes[c]
            normalizer = get_normalization_scheme_by_name(scheme)(
                use_mask_for_norm=configuration_manager.use_mask_for_norm[c],
                intensityproperties=foreground_intensity_properties_per_channel[str(c)],
            )
            data[c] = normalizer.run(data[c], seg[0])
        return data

    def run(self, dataset_name_or_id: Union[int, str], configuration_name: str,
            plans_identifier: str, num_processes: int):
        dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
        assert os.path.isdir(os.path.join(paths.nnUNet_raw(), dataset_name)), (
            "The requested dataset could not be found in nnUNet_raw"
        )
        plans_file = os.path.join(
            paths.nnUNet_preprocessed(), dataset_name, plans_identifier + ".json"
        )
        assert os.path.isfile(plans_file), f"Expected plans file {plans_file} not found"
        plans_manager = PlansManager(load_json(plans_file))
        configuration_manager = plans_manager.get_configuration(configuration_name)

        dataset_json = load_json(
            os.path.join(paths.nnUNet_preprocessed(), dataset_name, "dataset.json")
        )
        output_directory = os.path.join(
            paths.nnUNet_preprocessed(), dataset_name, configuration_manager.data_identifier
        )
        if os.path.isdir(output_directory):
            shutil.rmtree(output_directory)
        os.makedirs(output_directory, exist_ok=True)

        dataset = get_filenames_of_train_images_and_targets(
            os.path.join(paths.nnUNet_raw(), dataset_name), dataset_json
        )
        jobs = [
            (os.path.join(output_directory, k), dataset[k]["images"], dataset[k]["label"],
             plans_manager, configuration_manager, dataset_json)
            for k in dataset.keys()
        ]
        if num_processes <= 1 or len(jobs) <= 1:
            for j in jobs:
                self.run_case_save(*j)
        else:
            with ThreadPoolExecutor(max_workers=min(num_processes, len(jobs))) as pool:
                list(pool.map(_run_case_save_star, [(self,) + j for j in jobs]))

    def modify_seg_fn(self, seg: np.ndarray, plans_manager, dataset_json,
                      configuration_manager) -> np.ndarray:
        return seg


def _run_case_save_star(args):
    self_, *rest = args
    return self_.run_case_save(*rest)
