"""Segmentation evaluation metrics.

Capability parity with ref: dinounet/evaluation/evaluate_predictions.py:40-390:
per-case per-label/region Dice, IoU, Sensitivity, Specificity, Precision,
TP/FP/FN/TN counts, HD95 and ASD with voxel spacing, folder-level aggregation
(mean + foreground_mean) and summary.json with tuple-key en/decoding.

medpy is not in this image; HD95/ASD are computed directly with scipy's
euclidean distance transform over surface voxels — the same algorithm medpy
implements (binary erosion border extraction + EDT sampling).

JAX-free copy of ``dinounet_tpu/evaluation/metrics.py``, except that a
folder's surface distances go through one pool of ``num_processes`` threads,
a case, label or region and direction each (the Euclidean distance
transforms, which release the GIL, dominate a large volume's metrics: ~4 s
each at 256^3). The cases are read, and their counts taken, in the calling
thread meanwhile. The numbers are the same; host memory stays that of
``num_processes`` transforms, however many cases and labels a folder has.
"""

import os
import threading
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


def _spacing_for(spacing, ndim: int) -> Tuple[float, ...]:
    if len(spacing) > ndim:
        return tuple(float(s) for s in spacing[-ndim:])
    return tuple(float(s) for s in spacing) + (1.0,) * (ndim - len(spacing))


def _hd95_asd(sds_pred_ref: np.ndarray, sds_ref_pred: np.ndarray) -> dict:
    hd95 = float(np.percentile(np.hstack((sds_pred_ref, sds_ref_pred)), 95))
    return {"HD95": hd95, "ASD": float(sds_pred_ref.mean())}


def _failed(e: Exception) -> dict:
    print(f"Warning: Surface distance computation failed: {e}")
    return {"HD95": np.nan, "ASD": np.nan}


def compute_surface_distances(mask_ref: np.ndarray, mask_pred: np.ndarray,
                              spacing: Tuple[float, ...]) -> dict:
    """HD95 (symmetric 95th percentile) + ASD (directed mean), medpy semantics."""
    mask_ref = mask_ref.astype(bool)
    mask_pred = mask_pred.astype(bool)
    if not np.any(mask_ref) or not np.any(mask_pred):
        return {"HD95": np.nan, "ASD": np.nan}
    if len(spacing) != mask_ref.ndim:
        spacing = _spacing_for(spacing, mask_ref.ndim)
    try:
        return _hd95_asd(_surface_distances(mask_pred, mask_ref, spacing),
                         _surface_distances(mask_ref, mask_pred, spacing))
    except Exception as e:
        return _failed(e)


class _SurfacePool:
    """Runs surface distances in `workers` threads, with at most `workers`
    submitted and not yet done: each holds its label's two masks and, while
    it runs, a float64 distance volume, so what waits for a thread is held
    back in the submitting thread rather than queued."""

    def __init__(self, workers: int):
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._slots = threading.BoundedSemaphore(workers)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._pool.shutdown()

    def submit(self, fn, *args):
        self._slots.acquire()
        future = self._pool.submit(fn, *args)
        future.add_done_callback(lambda _: self._slots.release())
        return future

    def surface_distances(self, mask_ref: np.ndarray, mask_pred: np.ndarray, spacing):
        """`compute_surface_distances` in two tasks, one a direction; returns
        a function that waits for them and gives its dict."""
        if not np.any(mask_ref) or not np.any(mask_pred):
            return lambda: {"HD95": np.nan, "ASD": np.nan}
        if len(spacing) != mask_ref.ndim:
            spacing = _spacing_for(spacing, mask_ref.ndim)
        pred_ref = self.submit(_surface_distances, mask_pred, mask_ref, spacing)
        ref_pred = self.submit(_surface_distances, mask_ref, mask_pred, spacing)

        def result():
            try:
                return _hd95_asd(pred_ref.result(), ref_pred.result())
            except Exception as e:
                return _failed(e)
        return result


def _case_metrics(reference_file: str, prediction_file: str,
                  image_reader_writer: BaseReaderWriter, labels_or_regions,
                  ignore_label: Optional[int], pool: _SurfacePool):
    """Reads a case and takes its counts here, a label's masks at a time,
    and hands its surface distances to `pool`; returns a function that
    waits for them and gives `compute_metrics`'s result."""
    seg_ref, ref_props = image_reader_writer.read_seg(reference_file)
    seg_pred, pred_props = image_reader_writer.read_seg(prediction_file)
    spacing = ref_props.get("spacing") or pred_props.get("spacing")
    if spacing is None:
        spacing = (1.0,) * (seg_ref.ndim - 1)

    ignore_mask = seg_ref == ignore_label if ignore_label is not None else None

    counts, surfaces = {}, {}
    for r in labels_or_regions:
        mask_ref = region_or_label_to_mask(seg_ref, r)
        mask_pred = region_or_label_to_mask(seg_pred, r)
        counts[r] = compute_tp_fp_fn_tn(mask_ref, mask_pred, ignore_mask)
        mask_ref_sp = np.squeeze(mask_ref, 0) if mask_ref.shape[0] == 1 else mask_ref
        mask_pred_sp = np.squeeze(mask_pred, 0) if mask_pred.shape[0] == 1 else mask_pred
        surfaces[r] = pool.surface_distances(mask_ref_sp, mask_pred_sp, spacing)

    def finish():
        results = {"reference_file": reference_file, "prediction_file": prediction_file,
                   "metrics": {}}
        for r in labels_or_regions:
            m = results["metrics"][r] = {}
            tp, fp, fn, tn = counts[r]
            if tp + fp + fn == 0:
                m["Dice"] = np.nan
                m["IoU"] = np.nan
            else:
                m["Dice"] = 2 * tp / (2 * tp + fp + fn)
                m["IoU"] = tp / (tp + fp + fn)
            m["Sensitivity"] = tp / (tp + fn) if tp + fn > 0 else np.nan
            m["Specificity"] = tn / (tn + fp) if tn + fp > 0 else np.nan
            m["Precision"] = tp / (tp + fp) if tp + fp > 0 else np.nan

            sd = surfaces[r]()
            m["HD95"] = sd["HD95"]
            m["ASD"] = sd["ASD"]

            m["FP"] = fp
            m["TP"] = tp
            m["FN"] = fn
            m["TN"] = tn
            m["n_pred"] = fp + tp
            m["n_ref"] = fn + tp
        return results
    return finish


def compute_metrics(reference_file: str, prediction_file: str,
                    image_reader_writer: BaseReaderWriter, labels_or_regions,
                    ignore_label: Optional[int] = None) -> dict:
    """ref :152-235."""
    with _SurfacePool(2) as pool:
        return _case_metrics(reference_file, prediction_file, image_reader_writer,
                             labels_or_regions, ignore_label, pool)()


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

    with _SurfacePool(max(1, num_processes)) as pool:
        pending = [_case_metrics(r, p, image_reader_writer, regions_or_labels,
                                 ignore_label, pool)
                   for r, p in zip(files_ref, files_pred)]
        results = [finish() for finish in pending]

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
