"""Transfer a plans file from one dataset to another (pretraining workflows).

Capability parity with ref: dinounet/experiment_planning/plans_for_pretraining/
move_plans_between_datasets.py:14-87 — copy the source plans into the target
dataset's preprocessed folder, rewriting dataset_name, data_identifier, the
image reader/writer (probed from the target's raw data) and the plans name.

JAX-free copy of ``dinounet_tpu/planning/move_plans_between_datasets.py``.
"""

import argparse
import os
from typing import Optional, Union

from dinounet_tpu_torch import paths
from dinounet_tpu_torch.imageio.reader_writer_registry import (
    determine_reader_writer_from_dataset_json,
)
from dinounet_tpu_torch.planning.dataset_utils import (
    get_filenames_of_train_images_and_targets,
)
from dinounet_tpu_torch.utilities.json_export import load_json, save_json
from dinounet_tpu_torch.utilities.misc import maybe_convert_to_dataset_name


def move_plans_between_datasets(
        source_dataset_name_or_id: Union[int, str],
        target_dataset_name_or_id: Union[int, str],
        source_plans_identifier: str,
        target_plans_identifier: Optional[str] = None) -> str:
    """Returns the path of the written target plans file."""
    source_dataset_name = maybe_convert_to_dataset_name(source_dataset_name_or_id)
    target_dataset_name = maybe_convert_to_dataset_name(target_dataset_name_or_id)
    if target_plans_identifier is None:
        target_plans_identifier = source_plans_identifier

    source_folder = os.path.join(paths.nnUNet_preprocessed(), source_dataset_name)
    if not os.path.isdir(source_folder):
        raise FileNotFoundError(
            "Cannot move plans: preprocessed directory of the source dataset is "
            "missing. Run plan_and_preprocess for the source dataset first.")
    source_plans_file = os.path.join(
        source_folder, source_plans_identifier + ".json")
    if not os.path.isfile(source_plans_file):
        raise FileNotFoundError(f"Source plans missing: {source_plans_file}")

    plans = load_json(source_plans_file)
    plans["dataset_name"] = target_dataset_name

    # data_identifier must follow the target plans identifier (ref :39-48)
    if target_plans_identifier != source_plans_identifier:
        for c in plans["configurations"]:
            cfg = plans["configurations"][c]
            if "data_identifier" in cfg:
                old = cfg["data_identifier"]
                cfg["data_identifier"] = (
                    target_plans_identifier + old[len(source_plans_identifier):]
                    if old.startswith(source_plans_identifier)
                    else target_plans_identifier + "_" + old)

    # the reader/writer is re-probed from the target dataset (ref :50-62)
    target_raw = os.path.join(paths.nnUNet_raw(), target_dataset_name)
    target_dataset_json = load_json(os.path.join(target_raw, "dataset.json"))
    dataset = get_filenames_of_train_images_and_targets(
        target_raw, target_dataset_json)
    example_image = next(iter(dataset.values()))["images"][0]
    rw = determine_reader_writer_from_dataset_json(
        target_dataset_json, example_image)
    plans["image_reader_writer"] = rw.__name__
    plans["plans_name"] = target_plans_identifier

    out_dir = os.path.join(paths.nnUNet_preprocessed(), target_dataset_name)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, target_plans_identifier + ".json")
    save_json(plans, out, sort_keys=False)
    return out


def entry_point_move_plans_between_datasets():
    """CLI (ref move_plans_between_datasets.py:65-87,
    nnUNetv2_move_plans_between_datasets)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-s", type=str, required=True, help="source dataset")
    parser.add_argument("-t", type=str, required=True, help="target dataset")
    parser.add_argument("-sp", type=str, required=True,
                        help="source plans identifier")
    parser.add_argument("-tp", type=str, default=None,
                        help="target plans identifier (default: same as -sp)")
    args = parser.parse_args()
    move_plans_between_datasets(args.s, args.t, args.sp, args.tp)


if __name__ == "__main__":
    entry_point_move_plans_between_datasets()
