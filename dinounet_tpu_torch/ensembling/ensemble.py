"""Probability ensembling across models / cross-validation folds.

Capability parity with ref: dinounet/ensembling/ensemble.py:17-206.

JAX-free copy of ``dinounet_tpu/ensembling/ensemble.py``, except that
``ensemble_crossvalidations`` copies the first model's dataset.json and
plans.json beside the merged cases, as the reference does: the
postprocessing search of find_best_configuration reads them there when an
ensemble wins; and that the cases are merged in ``num_processes`` threads,
as the reference fans them out over its pool (the same files).
"""

import os
import pickle
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from dinounet_tpu_torch.configuration import default_num_processes
from dinounet_tpu_torch.imageio.base import BaseReaderWriter
from dinounet_tpu_torch.utilities.json_export import load_json
from dinounet_tpu_torch.utilities.label_handling import LabelManager
from dinounet_tpu_torch.utilities.plans_handler import PlansManager


def average_probabilities(list_of_files: List[str]) -> np.ndarray:
    """ref :17-30."""
    assert len(list_of_files), "At least one file must be given in list_of_files"
    avg = None
    for f in list_of_files:
        p = np.load(f)["probabilities"]
        avg = p.astype(np.float32) if avg is None else avg + p
    return avg / len(list_of_files)


def merge_files(list_of_files, output_filename_truncated: str, output_file_ending: str,
                image_reader_writer: BaseReaderWriter, label_manager: LabelManager,
                save_probabilities: bool = False):
    """ref :32-46 (note: the reference feeds probabilities back through
    convert_logits_to_segmentation — nonlin applied twice; replicated for
    output parity, argmax is invariant under the extra softmax)."""
    with open(list_of_files[0][:-4] + ".pkl", "rb") as f:
        properties = pickle.load(f)
    probabilities = average_probabilities(list_of_files)
    segmentation = label_manager.convert_logits_to_segmentation(probabilities)
    image_reader_writer.write_seg(
        segmentation, output_filename_truncated + output_file_ending, properties
    )
    if save_probabilities:
        np.savez_compressed(output_filename_truncated + ".npz", probabilities=probabilities)
        with open(output_filename_truncated + ".pkl", "wb") as f:
            pickle.dump(probabilities, f)


def ensemble_folders(list_of_input_folders: List[str], output_folder: str,
                     save_merged_probabilities: bool = False,
                     num_processes: int = default_num_processes,
                     dataset_json_file_or_dict=None, plans_json_file_or_dict=None):
    """Mean of saved .npz probabilities across model folders (ref :49-113)."""
    dataset_json = (
        load_json(dataset_json_file_or_dict)
        if isinstance(dataset_json_file_or_dict, str)
        else dataset_json_file_or_dict
    ) or load_json(os.path.join(list_of_input_folders[0], "dataset.json"))
    plans = (
        load_json(plans_json_file_or_dict)
        if isinstance(plans_json_file_or_dict, str)
        else plans_json_file_or_dict
    ) or load_json(os.path.join(list_of_input_folders[0], "plans.json"))
    plans_manager = PlansManager(plans)
    rw = plans_manager.image_reader_writer_class()
    label_manager = plans_manager.get_label_manager(dataset_json)

    files_per_folder = [
        {f for f in os.listdir(fo) if f.endswith(".npz")} for fo in list_of_input_folders
    ]
    common = set.intersection(*files_per_folder)
    assert common, "No common .npz prediction files found across the input folders"
    os.makedirs(output_folder, exist_ok=True)
    with ThreadPoolExecutor(max_workers=max(1, min(num_processes, len(common)))) as pool:
        list(pool.map(lambda f: merge_files(
            [os.path.join(fo, f) for fo in list_of_input_folders],
            os.path.join(output_folder, f[:-4]), dataset_json["file_ending"],
            rw, label_manager, save_merged_probabilities), sorted(common)))


def ensemble_crossvalidations(list_of_trained_model_folders: List[str],
                              output_folder: str, folds=(0, 1, 2, 3, 4),
                              num_processes: int = default_num_processes):
    """Merge per-fold validation predictions of several trained models
    (ref :128-206): each case is predicted by exactly one fold per model; the
    models' probabilities for that case are averaged. The first model's
    dataset.json and plans.json go beside them."""
    dataset_json = load_json(os.path.join(list_of_trained_model_folders[0], "dataset.json"))
    plans_manager = PlansManager(
        load_json(os.path.join(list_of_trained_model_folders[0], "plans.json"))
    )
    rw = plans_manager.image_reader_writer_class()
    label_manager = plans_manager.get_label_manager(dataset_json)

    # case -> [one npz per model]
    case_files = {}
    for model in list_of_trained_model_folders:
        for f in folds:
            val = os.path.join(model, f"fold_{f}", "validation")
            if not os.path.isdir(val):
                continue
            for fn in os.listdir(val):
                if fn.endswith(".npz"):
                    case_files.setdefault(fn, []).append(os.path.join(val, fn))
    os.makedirs(output_folder, exist_ok=True)
    for sidecar in ("dataset.json", "plans.json"):
        shutil.copy(os.path.join(list_of_trained_model_folders[0], sidecar),
                    os.path.join(output_folder, sidecar))
    complete = []
    for fn, files in sorted(case_files.items()):
        if len(files) != len(list_of_trained_model_folders):
            print(f"WARNING: case {fn} is missing predictions from some models; skipping")
            continue
        complete.append((fn, files))
    with ThreadPoolExecutor(max_workers=max(1, min(num_processes, len(complete) or 1))) as pool:
        list(pool.map(lambda job: merge_files(
            job[1], os.path.join(output_folder, job[0][:-4]), dataset_json["file_ending"],
            rw, label_manager, False), complete))


def entry_point_ensemble_folders():
    """CLI (ref ensemble.py:210-244, nnUNetv2_ensemble)."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("-i", nargs="+", type=str, required=True,
                        help="input folders with .npz probability files")
    parser.add_argument("-o", type=str, required=True, help="output folder")
    parser.add_argument("-np", type=int, default=default_num_processes)
    parser.add_argument("--save_npz", action="store_true")
    args = parser.parse_args()
    ensemble_folders(args.i, args.o, save_merged_probabilities=args.save_npz,
                     num_processes=args.np)


if __name__ == "__main__":
    entry_point_ensemble_folders()
