"""Connected-component postprocessing.

Capability parity with ref: dinounet/postprocessing/remove_connected_components.py
(:22-336): keep-largest-component per foreground-union and per label/region,
greedy accept-if-improves search against ground truth, postprocessing.pkl /
postprocessing.json artifacts, and apply-to-folder.

JAX-free copy of ``dinounet_tpu/postprocessing/remove_connected_components.py``;
postprocessing.pkl pickles the port's own functions, so the port reads the
files it wrote without importing the JAX package. A folder's files are
postprocessed in ``num_processes`` threads, as the reference fans them out
over its pool (the JAX copy takes them one at a time): the same files.
"""

import os
import pickle
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Tuple, Union

import numpy as np
from scipy import ndimage

from dinounet_tpu_torch.configuration import default_num_processes
from dinounet_tpu_torch.evaluation.metrics import (
    compute_metrics_on_folder,
    label_or_region_to_key,
    load_summary_json,
    region_or_label_to_mask,
)
from dinounet_tpu_torch.imageio.base import BaseReaderWriter
from dinounet_tpu_torch.planning.dataset_utils import subfiles
from dinounet_tpu_torch.utilities.json_export import load_json, recursive_fix_for_json_export, save_json
from dinounet_tpu_torch.utilities.plans_handler import PlansManager


def remove_all_but_largest_component(mask: np.ndarray) -> np.ndarray:
    """Boolean mask of the largest connected component (scipy labeling)."""
    labeled, n = ndimage.label(mask)
    if n <= 1:
        return mask.copy()
    sizes = ndimage.sum(mask, labeled, range(1, n + 1))
    keep = int(np.argmax(sizes)) + 1
    return labeled == keep


def remove_all_but_largest_component_from_segmentation(
    segmentation: np.ndarray, labels_or_regions, background_label: int = 0
) -> np.ndarray:
    """ref :22-35."""
    mask = np.zeros_like(segmentation, dtype=bool)
    if not isinstance(labels_or_regions, list):
        labels_or_regions = [labels_or_regions]
    for l_or_r in labels_or_regions:
        mask |= region_or_label_to_mask(segmentation, l_or_r)
    mask_keep = remove_all_but_largest_component(mask)
    ret = np.copy(segmentation)
    ret[mask & ~mask_keep] = background_label
    return ret


def apply_postprocessing(segmentation: np.ndarray, pp_fns: List[Callable],
                         pp_fn_kwargs: List[dict]) -> np.ndarray:
    for fn, kwargs in zip(pp_fns, pp_fn_kwargs):
        segmentation = fn(segmentation, **kwargs)
    return segmentation


def load_postprocess_save(segmentation_file: str, output_fname: str,
                          image_reader_writer: BaseReaderWriter,
                          pp_fns: List[Callable], pp_fn_kwargs: List[dict]):
    seg, props = image_reader_writer.read_seg(segmentation_file)
    seg = apply_postprocessing(seg[0], pp_fns, pp_fn_kwargs)
    image_reader_writer.write_seg(seg, output_fname, props)


def _run_pp_on_folder(src_folder, dst_folder, files, rw, pp_fns, pp_fn_kwargs,
                      num_processes: int = 1):
    os.makedirs(dst_folder, exist_ok=True)
    with ThreadPoolExecutor(max_workers=max(1, min(num_processes, len(files) or 1))) as pool:
        list(pool.map(lambda f: load_postprocess_save(
            os.path.join(src_folder, f), os.path.join(dst_folder, f), rw,
            pp_fns, pp_fn_kwargs), files))


def determine_postprocessing(folder_predictions: str, folder_ref: str,
                             plans_file_or_dict, dataset_json_file_or_dict,
                             num_processes: int = default_num_processes,
                             keep_postprocessed_files: bool = True):
    """Greedy keep-largest-component search (ref :53-247)."""
    output_folder = os.path.join(folder_predictions, "postprocessed")

    if plans_file_or_dict is None:
        plans_file_or_dict = load_json(os.path.join(folder_predictions, "plans.json"))
    plans_manager = PlansManager(
        plans_file_or_dict if isinstance(plans_file_or_dict, dict)
        else load_json(plans_file_or_dict)
    )
    if dataset_json_file_or_dict is None:
        dataset_json_file_or_dict = os.path.join(folder_predictions, "dataset.json")
    dataset_json = (
        dataset_json_file_or_dict if isinstance(dataset_json_file_or_dict, dict)
        else load_json(dataset_json_file_or_dict)
    )

    rw = plans_manager.image_reader_writer_class()
    label_manager = plans_manager.get_label_manager(dataset_json)
    labels_or_regions = (
        label_manager.foreground_regions if label_manager.has_regions
        else label_manager.foreground_labels
    )

    predicted_files = subfiles(folder_predictions, suffix=dataset_json["file_ending"], join=False)

    if not os.path.isfile(os.path.join(folder_predictions, "summary.json")):
        compute_metrics_on_folder(
            folder_ref, folder_predictions,
            os.path.join(folder_predictions, "summary.json"), rw,
            dataset_json["file_ending"], labels_or_regions,
            label_manager.ignore_label, num_processes,
        )

    pp_fns: List[Callable] = []
    pp_fn_kwargs: List[dict] = []

    # 1) all-but-largest on the foreground union
    output_here = os.path.join(output_folder, "temp", "keep_largest_fg")
    kwargs = {"labels_or_regions": label_manager.foreground_labels}
    _run_pp_on_folder(folder_predictions, output_here, predicted_files, rw,
                      [remove_all_but_largest_component_from_segmentation], [kwargs],
                      num_processes)
    compute_metrics_on_folder(
        folder_ref, output_here, os.path.join(output_here, "summary.json"), rw,
        dataset_json["file_ending"], labels_or_regions, label_manager.ignore_label,
        num_processes,
    )
    baseline = load_summary_json(os.path.join(folder_predictions, "summary.json"))
    pp_res = load_summary_json(os.path.join(output_here, "summary.json"))
    do_this = pp_res["foreground_mean"]["Dice"] > baseline["foreground_mean"]["Dice"]
    if do_this:
        for class_id in pp_res["mean"].keys():
            if pp_res["mean"][class_id]["Dice"] < baseline["mean"][class_id]["Dice"]:
                do_this = False
                break
    if do_this:
        source = output_here
        pp_fns.append(remove_all_but_largest_component_from_segmentation)
        pp_fn_kwargs.append(kwargs)
    else:
        source = folder_predictions

    # 2) per label/region
    if len(labels_or_regions) > 1:
        for label_or_region in labels_or_regions:
            kwargs = {"labels_or_regions": label_or_region}
            output_here = os.path.join(output_folder, "temp", "keep_largest_perClassOrRegion")
            _run_pp_on_folder(source, output_here, predicted_files, rw,
                              [remove_all_but_largest_component_from_segmentation], [kwargs],
                              num_processes)
            compute_metrics_on_folder(
                folder_ref, output_here, os.path.join(output_here, "summary.json"), rw,
                dataset_json["file_ending"], labels_or_regions,
                label_manager.ignore_label, num_processes,
            )
            baseline = load_summary_json(os.path.join(source, "summary.json"))
            pp_res = load_summary_json(os.path.join(output_here, "summary.json"))
            if pp_res["mean"][label_or_region]["Dice"] > baseline["mean"][label_or_region]["Dice"]:
                best = os.path.join(output_folder, "temp", "keep_largest_perClassOrRegion_currentBest")
                if os.path.isdir(best):
                    shutil.rmtree(best)
                shutil.move(output_here, best)
                source = best
                pp_fns.append(remove_all_but_largest_component_from_segmentation)
                pp_fn_kwargs.append(kwargs)

    for f in subfiles(source, join=False):
        shutil.copy(os.path.join(source, f), os.path.join(output_folder, f))
    with open(os.path.join(folder_predictions, "postprocessing.pkl"), "wb") as f:
        pickle.dump((pp_fns, pp_fn_kwargs), f)

    baseline = load_summary_json(os.path.join(folder_predictions, "summary.json"))
    final = load_summary_json(os.path.join(output_folder, "summary.json"))
    tmp = {
        "input_folder": {i: baseline[i] for i in ["foreground_mean", "mean"]},
        "postprocessed": {i: final[i] for i in ["foreground_mean", "mean"]},
        "postprocessing_fns": [i.__name__ for i in pp_fns],
        "postprocessing_kwargs": pp_fn_kwargs,
    }
    tmp["input_folder"]["mean"] = {
        label_or_region_to_key(k): v for k, v in tmp["input_folder"]["mean"].items()
    }
    tmp["postprocessed"]["mean"] = {
        label_or_region_to_key(k): v for k, v in tmp["postprocessed"]["mean"].items()
    }
    save_json(recursive_fix_for_json_export(tmp),
              os.path.join(folder_predictions, "postprocessing.json"))

    shutil.rmtree(os.path.join(output_folder, "temp"))
    if not keep_postprocessed_files:
        shutil.rmtree(output_folder)
    return pp_fns, pp_fn_kwargs


def apply_postprocessing_to_folder(input_folder: str, output_folder: str,
                                   pp_fns: List[Callable], pp_fn_kwargs: List[dict],
                                   plans_file_or_dict=None, dataset_json_file_or_dict=None,
                                   num_processes: int = default_num_processes):
    """ref :248-300."""
    if plans_file_or_dict is None:
        plans_file_or_dict = load_json(os.path.join(input_folder, "plans.json"))
    plans_manager = PlansManager(
        plans_file_or_dict if isinstance(plans_file_or_dict, dict)
        else load_json(plans_file_or_dict)
    )
    if dataset_json_file_or_dict is None:
        dataset_json_file_or_dict = os.path.join(input_folder, "dataset.json")
    dataset_json = (
        dataset_json_file_or_dict if isinstance(dataset_json_file_or_dict, dict)
        else load_json(dataset_json_file_or_dict)
    )
    rw = plans_manager.image_reader_writer_class()
    files = subfiles(input_folder, suffix=dataset_json["file_ending"], join=False)
    _run_pp_on_folder(input_folder, output_folder, files, rw, pp_fns, pp_fn_kwargs,
                      num_processes)


def entry_point_determine_postprocessing():
    """CLI (ref remove_connected_components.py:248-289,
    nnUNetv2_determine_postprocessing)."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("-i", type=str, required=True,
                        help="folder with predictions to analyse")
    parser.add_argument("-ref", type=str, required=True, help="ground-truth folder")
    parser.add_argument("-plans_json", type=str, default=None)
    parser.add_argument("-dataset_json", type=str, default=None)
    parser.add_argument("-np", type=int, default=default_num_processes)
    parser.add_argument("--remove_postprocessed", action="store_true")
    args = parser.parse_args()
    determine_postprocessing(
        args.i, args.ref, args.plans_json, args.dataset_json,
        num_processes=args.np,
        keep_postprocessed_files=not args.remove_postprocessed,
    )


def entry_point_apply_postprocessing():
    """CLI (ref remove_connected_components.py:292-336,
    nnUNetv2_apply_postprocessing)."""
    import argparse
    import pickle

    parser = argparse.ArgumentParser()
    parser.add_argument("-i", type=str, required=True)
    parser.add_argument("-o", type=str, required=True)
    parser.add_argument("-pp_pkl_file", type=str, required=True)
    parser.add_argument("-np", type=int, default=default_num_processes)
    parser.add_argument("-plans_json", type=str, default=None)
    parser.add_argument("-dataset_json", type=str, default=None)
    args = parser.parse_args()
    with open(args.pp_pkl_file, "rb") as f:
        pp_fns, pp_fn_kwargs = pickle.load(f)
    apply_postprocessing_to_folder(
        args.i, args.o, pp_fns, pp_fn_kwargs,
        plans_file_or_dict=args.plans_json,
        dataset_json_file_or_dict=args.dataset_json,
        num_processes=args.np,
    )


if __name__ == "__main__":
    import sys

    # the command print_inference_instructions writes passes -pp_pkl_file:
    # it applies a postprocessing; without it, the search
    if "-pp_pkl_file" in sys.argv:
        entry_point_apply_postprocessing()
    else:
        entry_point_determine_postprocessing()


# reference CLI name (ref remove_connected_components.py:298)
entry_point_determine_postprocessing_folder = entry_point_determine_postprocessing
