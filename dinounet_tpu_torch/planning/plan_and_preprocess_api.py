"""Preprocessing of a planned raw dataset.

JAX-free copy of ``preprocess_dataset`` and ``preprocess`` from
``dinounet_tpu/planning/plan_and_preprocess_api.py:75-119`` (ref: dinounet/
experiment_planning/plan_and_preprocess_api.py): each configuration of the
plans file runs through its preprocessor, and the raw labels are copied to
``gt_segmentations`` for the metrics of the trainer's final validation.
Fingerprinting and planning are not ported yet: the plans file is written
beforehand (``utilities/synthetic_dataset.py`` writes one for its raw
dataset).
"""

import os
import shutil
from typing import List, Union

from dinounet_tpu_torch import paths
from dinounet_tpu_torch.planning.dataset_utils import get_filenames_of_train_images_and_targets
from dinounet_tpu_torch.utilities.json_export import load_json
from dinounet_tpu_torch.utilities.misc import maybe_convert_to_dataset_name
from dinounet_tpu_torch.utilities.plans_handler import PlansManager


def preprocess_dataset(dataset_id: Union[int, str], plans_identifier: str = "nnUNetPlans",
                       configurations=("2d", "3d_fullres", "3d_lowres"),
                       num_processes=(8, 4, 8), verbose: bool = False) -> None:
    if isinstance(num_processes, int):
        num_processes = [num_processes]
    num_processes = list(num_processes)
    if len(num_processes) == 1:
        num_processes = num_processes * len(configurations)
    if len(num_processes) != len(configurations):
        raise RuntimeError(
            "num_processes must have length 1 or match the number of configurations"
        )

    dataset_name = maybe_convert_to_dataset_name(dataset_id)
    plans_file = os.path.join(paths.nnUNet_preprocessed(), dataset_name,
                              plans_identifier + ".json")
    plans_manager = PlansManager(plans_file)
    for n, c in zip(num_processes, configurations):
        if c not in plans_manager.available_configurations:
            print(f"INFO: Configuration {c} not found in plans; skipping.")
            continue
        configuration_manager = plans_manager.get_configuration(c)
        preprocessor = configuration_manager.preprocessor_class(verbose=verbose)
        preprocessor.run(dataset_id, c, plans_identifier, num_processes=n)

    # copy gt segmentations for later evaluation (ref :134-142)
    gt_folder = os.path.join(paths.nnUNet_preprocessed(), dataset_name, "gt_segmentations")
    os.makedirs(gt_folder, exist_ok=True)
    dataset_json = load_json(os.path.join(paths.nnUNet_raw(), dataset_name, "dataset.json"))
    dataset = get_filenames_of_train_images_and_targets(
        os.path.join(paths.nnUNet_raw(), dataset_name), dataset_json
    )
    for k in dataset:
        dst = os.path.join(gt_folder, k + dataset_json["file_ending"])
        src = dataset[k]["label"]
        if not os.path.isfile(dst) or os.path.getmtime(src) > os.path.getmtime(dst):
            shutil.copy(src, dst)


def preprocess(dataset_ids: List[int], plans_identifier: str = "nnUNetPlans",
               configurations=("2d", "3d_fullres", "3d_lowres"),
               num_processes=(8, 4, 8), verbose: bool = False):
    for d in dataset_ids:
        preprocess_dataset(d, plans_identifier, configurations, num_processes, verbose)
