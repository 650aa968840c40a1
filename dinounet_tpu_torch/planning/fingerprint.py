"""Dataset fingerprint extraction.

Capability parity with ref: dinounet/experiment_planning/dataset_fingerprint/
fingerprint_extractor.py:18-199: per case (parallel over a process pool):
read -> crop_to_nonzero -> sample <=N foreground intensities; aggregated output
json carries spacings, shapes_after_crop, per-channel foreground intensity stats
and median_relative_size_after_cropping.

JAX-free copy of ``dinounet_tpu/planning/fingerprint.py``.
"""

import os
# Threads, not processes: the heavy work is numpy/scipy (GIL-releasing), and
# forking a process that holds a CUDA context or torch's threads can
# deadlock. The reference uses spawn pools for the same reason.
from concurrent.futures import ThreadPoolExecutor
from typing import List, Type, Union

import numpy as np

from dinounet_tpu_torch import paths
from dinounet_tpu_torch.configuration import default_num_processes
from dinounet_tpu_torch.imageio.base import BaseReaderWriter
from dinounet_tpu_torch.imageio.reader_writer_registry import determine_reader_writer_from_dataset_json
from dinounet_tpu_torch.planning.dataset_utils import get_filenames_of_train_images_and_targets
from dinounet_tpu_torch.preprocessing.cropping import crop_to_nonzero
from dinounet_tpu_torch.utilities.json_export import load_json, save_json
from dinounet_tpu_torch.utilities.misc import maybe_convert_to_dataset_name


class DatasetFingerprintExtractor:
    def __init__(self, dataset_name_or_id: Union[str, int],
                 num_processes: int = default_num_processes, verbose: bool = False):
        self.dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
        self.verbose = verbose
        self.input_folder = os.path.join(paths.nnUNet_raw(), self.dataset_name)
        self.num_processes = num_processes
        self.dataset_json = load_json(os.path.join(self.input_folder, "dataset.json"))
        self.dataset = get_filenames_of_train_images_and_targets(
            self.input_folder, self.dataset_json
        )
        # ref: fingerprint_extractor.py — 10^7 voxels sampled across the dataset
        self.num_foreground_voxels_for_intensitystats = 10e7

    @staticmethod
    def collect_foreground_intensities(segmentation: np.ndarray, images: np.ndarray,
                                       seed: int = 1234, num_samples: int = 10000):
        assert images.ndim == 4 and segmentation.ndim == 4
        assert not np.any(np.isnan(segmentation)) and not np.any(np.isnan(images))

        rs = np.random.RandomState(seed)
        intensities_per_channel = []
        intensity_statistics_per_channel = []
        foreground_mask = segmentation[0] > 0

        for i in range(len(images)):
            fg = images[i][foreground_mask]
            num_fg = len(fg)
            # sample with replacement so sparse cases aren't underrepresented
            intensities_per_channel.append(
                rs.choice(fg, num_samples, replace=True) if num_fg > 0 else []
            )
            intensity_statistics_per_channel.append({
                "mean": np.mean(fg) if num_fg > 0 else np.nan,
                "median": np.median(fg) if num_fg > 0 else np.nan,
                "min": np.min(fg) if num_fg > 0 else np.nan,
                "max": np.max(fg) if num_fg > 0 else np.nan,
                "percentile_99_5": np.percentile(fg, 99.5) if num_fg > 0 else np.nan,
                "percentile_00_5": np.percentile(fg, 0.5) if num_fg > 0 else np.nan,
            })
        return intensities_per_channel, intensity_statistics_per_channel

    @staticmethod
    def analyze_case(image_files: List[str], segmentation_file: str,
                     reader_writer_class: Type[BaseReaderWriter], num_samples: int = 10000):
        rw = reader_writer_class()
        images, properties_images = rw.read_images(image_files)
        segmentation, _ = rw.read_seg(segmentation_file)
        data_cropped, seg_cropped, bbox = crop_to_nonzero(images, segmentation)

        fg_intensities, fg_stats = DatasetFingerprintExtractor.collect_foreground_intensities(
            seg_cropped, data_cropped, num_samples=num_samples
        )
        shape_before_crop = images.shape[1:]
        shape_after_crop = data_cropped.shape[1:]
        relative_size = np.prod(shape_after_crop) / np.prod(shape_before_crop)
        return (shape_after_crop, properties_images["spacing"], fg_intensities,
                fg_stats, relative_size)

    def run(self, overwrite_existing: bool = False) -> dict:
        out_folder = os.path.join(paths.nnUNet_preprocessed(), self.dataset_name)
        os.makedirs(out_folder, exist_ok=True)
        properties_file = os.path.join(out_folder, "dataset_fingerprint.json")

        if os.path.isfile(properties_file) and not overwrite_existing:
            return load_json(properties_file)

        reader_writer_class = determine_reader_writer_from_dataset_json(
            self.dataset_json,
            self.dataset[next(iter(self.dataset))]["images"][0],
        )
        num_samples_per_case = int(
            self.num_foreground_voxels_for_intensitystats // len(self.dataset)
        )

        keys = list(self.dataset.keys())
        args = [
            (self.dataset[k]["images"], self.dataset[k]["label"],
             reader_writer_class, num_samples_per_case)
            for k in keys
        ]
        if self.num_processes <= 1 or len(keys) <= 1:
            results = [self.analyze_case(*a) for a in args]
        else:
            with ThreadPoolExecutor(max_workers=min(self.num_processes, len(keys))) as pool:
                results = list(pool.map(_analyze_case_star, args))

        shapes_after_crop = [r[0] for r in results]
        spacings = [r[1] for r in results]
        fg_per_channel = [
            np.concatenate([np.asarray(r[2][i]) for r in results if len(r[2][i]) > 0])
            if any(len(r[2][i]) > 0 for r in results) else np.array([0.0])
            for i in range(len(results[0][2]))
        ]
        median_relative_size = np.median([r[4] for r in results], 0)

        num_channels = len(
            self.dataset_json.get("channel_names", self.dataset_json.get("modality", {}))
        )
        intensity_statistics_per_channel = {}
        for i in range(num_channels):
            v = fg_per_channel[i]
            intensity_statistics_per_channel[i] = {
                "mean": float(np.mean(v)),
                "median": float(np.median(v)),
                "std": float(np.std(v)),
                "min": float(np.min(v)),
                "max": float(np.max(v)),
                "percentile_99_5": float(np.percentile(v, 99.5)),
                "percentile_00_5": float(np.percentile(v, 0.5)),
            }

        fingerprint = {
            "spacings": spacings,
            "shapes_after_crop": shapes_after_crop,
            "foreground_intensity_properties_per_channel": intensity_statistics_per_channel,
            "median_relative_size_after_cropping": median_relative_size,
        }
        try:
            save_json(fingerprint, properties_file)
        except Exception:
            if os.path.isfile(properties_file):
                os.remove(properties_file)
            raise
        return fingerprint


def _analyze_case_star(args):
    return DatasetFingerprintExtractor.analyze_case(*args)
