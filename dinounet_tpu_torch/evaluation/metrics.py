"""Segmentation evaluation metrics.

Capability parity with ref: dinounet/evaluation/evaluate_predictions.py:40-390:
per-case per-label/region Dice, IoU, Sensitivity, Specificity, Precision,
TP/FP/FN/TN counts, HD95 and ASD with voxel spacing, folder-level aggregation
(mean + foreground_mean) and summary.json with tuple-key en/decoding.

medpy is not in this image; HD95/ASD are computed directly with scipy's
euclidean distance transform over surface voxels — the same algorithm medpy
implements (binary erosion border extraction + EDT sampling).

JAX-free copy of ``dinounet_tpu/evaluation/metrics.py``.
"""

import os
# Threads, not processes: the heavy work is numpy/scipy (GIL-releasing), and
# a forked child cannot use its parent's CUDA context. The reference uses
# spawn pools for the same reason.
from concurrent.futures import ThreadPoolExecutor
from copy import deepcopy
from typing import List, Optional, Tuple, Union

import numpy as np
from scipy.ndimage import binary_erosion, distance_transform_edt, generate_binary_structure

from dinounet_tpu_torch.imageio.base import BaseReaderWriter
from dinounet_tpu_torch.planning.dataset_utils import subfiles
from dinounet_tpu_torch.utilities.json_export import load_json, save_json


def label_or_region_to_key(label_or_region) -> str:
    return str(label_or_region)


def key_to_label_or_region(key: str):
    try:
        return int(key)
    except ValueError:
        key = key.replace("(", "").replace(")", "")
        return tuple(int(i) for i in key.split(",") if len(i.strip()) > 0)


def save_summary_json(results: dict, output_file: str):
    """ref :40-55 (tuple keys stringified)."""
    converted = deepcopy(results)
    converted["mean"] = {
        label_or_region_to_key(k): results["mean"][k] for k in results["mean"]
    }
    for entry in converted["metric_per_case"]:
        entry["metrics"] = {
            label_or_region_to_key(k): v for k, v in entry["metrics"].items()
        }
    save_json(converted, output_file, sort_keys=True)


def load_summary_json(filename: str) -> dict:
    results = load_json(filename)
    results["mean"] = {
        key_to_label_or_region(k): v for k, v in results["mean"].items()
    }
    for entry in results["metric_per_case"]:
        entry["metrics"] = {
            key_to_label_or_region(k): v for k, v in entry["metrics"].items()
        }
    return results


def labels_to_list_of_regions(labels: List[int]):
    return [(i,) for i in labels]


def region_or_label_to_mask(segmentation: np.ndarray, region_or_label) -> np.ndarray:
    if np.isscalar(region_or_label):
        return segmentation == region_or_label
    mask = np.zeros_like(segmentation, dtype=bool)
    for r in region_or_label:
        mask |= segmentation == r
    return mask


def compute_tp_fp_fn_tn(mask_ref, mask_pred, ignore_mask=None):
    use_mask = np.ones_like(mask_ref, dtype=bool) if ignore_mask is None else ~ignore_mask
    tp = int(np.sum(mask_ref & mask_pred & use_mask))
    fp = int(np.sum(~mask_ref & mask_pred & use_mask))
    fn = int(np.sum(mask_ref & ~mask_pred & use_mask))
    tn = int(np.sum(~mask_ref & ~mask_pred & use_mask))
    return tp, fp, fn, tn


def _surface_distances(result: np.ndarray, reference: np.ndarray,
                       voxelspacing) -> np.ndarray:
    """Distances from result's surface voxels to reference's surface (medpy
    __surface_distances algorithm: border = mask ^ erosion(mask); EDT of the
    complement of the reference border sampled at the result border)."""
    footprint = generate_binary_structure(result.ndim, 1)
    result_border = result ^ binary_erosion(result, structure=footprint, iterations=1)
    reference_border = reference ^ binary_erosion(reference, structure=footprint, iterations=1)
    dt = distance_transform_edt(~reference_border, sampling=voxelspacing)
    return dt[result_border]


def compute_surface_distances(mask_ref: np.ndarray, mask_pred: np.ndarray,
                              spacing: Tuple[float, ...]) -> dict:
    """HD95 (symmetric 95th percentile) + ASD (directed mean), medpy semantics."""
    mask_ref = mask_ref.astype(bool)
    mask_pred = mask_pred.astype(bool)
    if not np.any(mask_ref) or not np.any(mask_pred):
        return {"HD95": np.nan, "ASD": np.nan}
    if len(spacing) != mask_ref.ndim:
        if len(spacing) > mask_ref.ndim:
            spacing = tuple(float(s) for s in spacing[-mask_ref.ndim:])
        else:
            spacing = tuple(float(s) for s in spacing) + (1.0,) * (mask_ref.ndim - len(spacing))
    try:
        sds_pred_ref = _surface_distances(mask_pred, mask_ref, spacing)
        sds_ref_pred = _surface_distances(mask_ref, mask_pred, spacing)
        hd95 = float(np.percentile(np.hstack((sds_pred_ref, sds_ref_pred)), 95))
        asd = float(sds_pred_ref.mean())
        return {"HD95": hd95, "ASD": asd}
    except Exception as e:
        print(f"Warning: Surface distance computation failed: {e}")
        return {"HD95": np.nan, "ASD": np.nan}


def compute_metrics(reference_file: str, prediction_file: str,
                    image_reader_writer: BaseReaderWriter, labels_or_regions,
                    ignore_label: Optional[int] = None) -> dict:
    """ref :152-235."""
    seg_ref, ref_props = image_reader_writer.read_seg(reference_file)
    seg_pred, pred_props = image_reader_writer.read_seg(prediction_file)
    spacing = ref_props.get("spacing") or pred_props.get("spacing")
    if spacing is None:
        spacing = (1.0,) * (seg_ref.ndim - 1)

    ignore_mask = seg_ref == ignore_label if ignore_label is not None else None

    results = {"reference_file": reference_file, "prediction_file": prediction_file,
               "metrics": {}}
    for r in labels_or_regions:
        m = results["metrics"][r] = {}
        mask_ref = region_or_label_to_mask(seg_ref, r)
        mask_pred = region_or_label_to_mask(seg_pred, r)
        tp, fp, fn, tn = compute_tp_fp_fn_tn(mask_ref, mask_pred, ignore_mask)
        if tp + fp + fn == 0:
            m["Dice"] = np.nan
            m["IoU"] = np.nan
        else:
            m["Dice"] = 2 * tp / (2 * tp + fp + fn)
            m["IoU"] = tp / (tp + fp + fn)
        m["Sensitivity"] = tp / (tp + fn) if tp + fn > 0 else np.nan
        m["Specificity"] = tn / (tn + fp) if tn + fp > 0 else np.nan
        m["Precision"] = tp / (tp + fp) if tp + fp > 0 else np.nan

        mask_ref_sp = np.squeeze(mask_ref, 0) if mask_ref.shape[0] == 1 else mask_ref
        mask_pred_sp = np.squeeze(mask_pred, 0) if mask_pred.shape[0] == 1 else mask_pred
        sd = compute_surface_distances(mask_ref_sp, mask_pred_sp, spacing)
        m["HD95"] = sd["HD95"]
        m["ASD"] = sd["ASD"]

        m["FP"] = fp
        m["TP"] = tp
        m["FN"] = fn
        m["TN"] = tn
        m["n_pred"] = fp + tp
        m["n_ref"] = fn + tp
    return results


def _compute_metrics_star(args):
    return compute_metrics(*args)


def compute_metrics_on_folder(folder_ref: str, folder_pred: str, output_file: Optional[str],
                              image_reader_writer: BaseReaderWriter, file_ending: str,
                              regions_or_labels, ignore_label: Optional[int] = None,
                              num_processes: int = 8, chill: bool = True) -> dict:
    """ref :238-303."""
    files_pred = subfiles(folder_pred, suffix=file_ending, join=False)
    files_ref = subfiles(folder_ref, suffix=file_ending, join=False)
    if not chill:
        present = [os.path.isfile(os.path.join(folder_pred, i)) for i in files_ref]
        assert all(present), "Not all files in folder_ref exist in folder_pred"
    files_ref = [os.path.join(folder_ref, i) for i in files_pred]
    files_pred = [os.path.join(folder_pred, i) for i in files_pred]

    jobs = [
        (r, p, image_reader_writer, regions_or_labels, ignore_label)
        for r, p in zip(files_ref, files_pred)
    ]
    if num_processes <= 1 or len(jobs) <= 1:
        results = [compute_metrics(*j) for j in jobs]
    else:
        with ThreadPoolExecutor(max_workers=min(num_processes, len(jobs))) as pool:
            results = list(pool.map(_compute_metrics_star, jobs))

    metric_list = list(results[0]["metrics"][regions_or_labels[0]].keys())
    means = {}
    for r in regions_or_labels:
        means[r] = {}
        for metric in metric_list:
            means[r][metric] = float(np.nanmean(
                [i["metrics"][r][metric] for i in results]
            ))

    foreground_mean = {}
    for metric in metric_list:
        values = []
        for k in means.keys():
            if k == 0 or k == "0":
                continue
            values.append(means[k][metric])
        foreground_mean[metric] = float(np.mean(values)) if values else np.nan

    result = {"metric_per_case": results, "mean": means,
              "foreground_mean": foreground_mean}
    if output_file is not None:
        save_summary_json(result, output_file)
    return result


def compute_metrics_on_folder2(folder_ref: str, folder_pred: str, dataset_json_file: str,
                               plans_file: str, output_file: Optional[str] = None,
                               num_processes: int = 8, chill: bool = False) -> dict:
    """ref :305-330: derive labels/regions + reader from dataset/plans jsons."""
    from dinounet_tpu_torch.utilities.plans_handler import PlansManager

    dataset_json = load_json(dataset_json_file)
    plans_manager = PlansManager(load_json(plans_file))
    label_manager = plans_manager.get_label_manager(dataset_json)
    if output_file is None:
        output_file = os.path.join(folder_pred, "summary.json")
    lbl_or_regions = (
        label_manager.foreground_regions if label_manager.has_regions
        else label_manager.foreground_labels
    )
    return compute_metrics_on_folder(
        folder_ref, folder_pred, output_file,
        plans_manager.image_reader_writer_class(), dataset_json["file_ending"],
        lbl_or_regions, label_manager.ignore_label, num_processes, chill=chill,
    )


def evaluate_folder_entry_point():
    """Evaluation CLI (ref evaluate_predictions.py:333-365,
    nnUNetv2_evaluate_folder)."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("gt_folder", type=str)
    parser.add_argument("pred_folder", type=str)
    parser.add_argument("-djfile", type=str, required=True, help="dataset.json")
    parser.add_argument("-pfile", type=str, required=True, help="plans.json")
    parser.add_argument("-o", type=str, default=None, help="output summary.json")
    parser.add_argument("-np", type=int, default=8)
    parser.add_argument("--chill", action="store_true",
                        help="don't fail on missing predictions")
    args = parser.parse_args()
    compute_metrics_on_folder2(
        args.gt_folder, args.pred_folder, args.djfile, args.pfile,
        output_file=args.o, num_processes=args.np, chill=args.chill,
    )


if __name__ == "__main__":
    evaluate_folder_entry_point()


def compute_metrics_on_folder_simple(
        folder_ref: str, folder_pred: str,
        labels: Union[Tuple[int, ...], List[int]],
        output_file: Optional[str] = None, num_processes: int = 8,
        ignore_label: Optional[int] = None, chill: bool = False) -> dict:
    """Evaluate without dataset/plans jsons: labels given explicitly, the
    reader/writer probed from the gt file ending (ref :327-340)."""
    from dinounet_tpu_torch.imageio.reader_writer_registry import (
        determine_reader_writer_from_file_ending,
    )

    example_file = subfiles(folder_ref, join=True)[0]
    file_ending = os.path.splitext(example_file)[-1]
    rw = determine_reader_writer_from_file_ending(file_ending, example_file)()
    if output_file is None:
        output_file = os.path.join(folder_pred, "summary.json")
    return compute_metrics_on_folder(
        folder_ref, folder_pred, output_file, rw, file_ending, list(labels),
        ignore_label=ignore_label, num_processes=num_processes, chill=chill)


def evaluate_simple_entry_point():
    """Evaluation CLI without dataset/plans jsons (ref :361-378,
    nnUNetv2_evaluate_simple)."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("gt_folder", type=str)
    parser.add_argument("pred_folder", type=str)
    parser.add_argument("-l", type=int, nargs="+", required=True, help="labels")
    parser.add_argument("-il", type=int, default=None, help="ignore label")
    parser.add_argument("-o", type=str, default=None, help="output summary.json")
    parser.add_argument("-np", type=int, default=8)
    parser.add_argument("--chill", action="store_true")
    args = parser.parse_args()
    compute_metrics_on_folder_simple(
        args.gt_folder, args.pred_folder, args.l, args.o, args.np, args.il,
        chill=args.chill)
