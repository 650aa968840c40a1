"""Merge cross-validation fold predictions into one folder and re-evaluate.

Capability parity with ref: dinounet/evaluation/accumulate_cv_results.py:12-60:
copy each fold's validation predictions into a merged folder (each case is
validated by exactly one fold), carry plans/dataset jsons along, and compute a
fresh summary.json over the merged set rather than trying to merge per-fold
summaries.

JAX-free copy of ``dinounet_tpu/evaluation/accumulate_cv_results.py``.
"""

import os
import shutil
from typing import List, Tuple, Union

from dinounet_tpu_torch import paths
from dinounet_tpu_torch.configuration import default_num_processes
from dinounet_tpu_torch.evaluation.metrics import compute_metrics_on_folder
from dinounet_tpu_torch.utilities.json_export import load_json
from dinounet_tpu_torch.planning.dataset_utils import subfiles
from dinounet_tpu_torch.utilities.plans_handler import PlansManager


def accumulate_cv_results(trained_model_folder: str,
                          merged_output_folder: str,
                          folds: Union[List[int], Tuple[int, ...]],
                          num_processes: int = default_num_processes,
                          overwrite: bool = True) -> None:
    if overwrite and os.path.isdir(merged_output_folder):
        shutil.rmtree(merged_output_folder)
    os.makedirs(merged_output_folder, exist_ok=True)

    dataset_json = load_json(os.path.join(trained_model_folder, "dataset.json"))
    plans_manager = PlansManager(
        load_json(os.path.join(trained_model_folder, "plans.json")))
    rw = plans_manager.image_reader_writer_class()
    for sidecar in ("dataset.json", "plans.json"):
        shutil.copy(os.path.join(trained_model_folder, sidecar),
                    os.path.join(merged_output_folder, sidecar))

    copied_something = False
    for f in folds:
        validation_folder = os.path.join(trained_model_folder, f"fold_{f}", "validation")
        if not os.path.isdir(validation_folder):
            raise RuntimeError(
                f"fold {f} of model {trained_model_folder} is missing. Please train it!")
        for pf in subfiles(validation_folder, suffix=dataset_json["file_ending"],
                           join=False):
            dst = os.path.join(merged_output_folder, pf)
            if overwrite and os.path.isfile(dst):
                raise RuntimeError(
                    f"More than one of your folds has a prediction for case {pf}")
            if overwrite or not os.path.isfile(dst):
                shutil.copy(os.path.join(validation_folder, pf), dst)
                copied_something = True

    if copied_something or not os.path.isfile(
            os.path.join(merged_output_folder, "summary.json")):
        label_manager = plans_manager.get_label_manager(dataset_json)
        gt_folder = os.path.join(paths.nnUNet_raw(), plans_manager.dataset_name,
                                 "labelsTr")
        if not os.path.isdir(gt_folder):
            gt_folder = os.path.join(paths.nnUNet_preprocessed(),
                                     plans_manager.dataset_name, "gt_segmentations")
        compute_metrics_on_folder(
            gt_folder, merged_output_folder,
            os.path.join(merged_output_folder, "summary.json"),
            rw, dataset_json["file_ending"],
            label_manager.foreground_regions if label_manager.has_regions
            else label_manager.foreground_labels,
            label_manager.ignore_label, num_processes)
