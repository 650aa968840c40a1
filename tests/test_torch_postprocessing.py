"""nnU-Net's post-training tools in the port vs the JAX package, on the CPU.

Two "trained" models (3d_lowres and 3d_cascade_fullres, two folds of two
validation cases each) are written as their validation folders would be:
segmentations, probabilities and properties, with the plans and dataset
beside them and the ground truth under nnUNet_raw and
gt_segmentations. Each package then runs on its own copy of that tree, and
everything they write must be equal (paths and module names aside):
- ``accumulate_cv_results``: the merged folders and their summary.json;
- ``ensemble_folders`` and ``ensemble_crossvalidations``: the merged
  segmentations (and probabilities); the port also writes the first
  model's plans.json and dataset.json beside an ensemble, as the reference
  does;
- ``determine_postprocessing``: the kept functions (by name) and their
  kwargs, postprocessing.json and the postprocessed summary.json;
- ``find_best_configuration``: inference_information.json and
  inference_instructions.txt;
for labels and for regions. Where the ensemble wins, the JAX package's
postprocessing search looks for the ensemble's plans.json, which its
ensembling never wrote, and raises; given those files it completes and
writes what the port writes. ``plot_overlay`` and
``plot_overlay_preprocessed`` write the same PNG bytes.
"""

import importlib
import json
import os
import pickle
import shutil

import numpy as np
import pytest

from dinounet_tpu_torch.imageio.nifti import NiftiIO, write_nifti
from dinounet_tpu_torch.utilities.label_handling import LabelManager

PACKAGES = ("dinounet_tpu", "dinounet_tpu_torch")
ID, DATASET = 605, "Dataset605_Post"
SHAPE = (10, 16, 16)
CASES = [f"case_{i:03d}" for i in range(4)]
FOLDS = {0: CASES[:2], 1: CASES[2:]}
MODELS = ("3d_lowres", "3d_cascade_fullres")
LABELS = {"background": 0, "a": 1, "b": 2}
REGIONS = {"background": 0, "whole": [1, 2], "inner": [2]}
PLANS = {"dataset_name": DATASET, "plans_name": "nnUNetPlans",
         "image_reader_writer": "NiftiIO",
         "configurations": {
             "3d_fullres": {"data_identifier": "nnUNetPlans_3d_fullres"},
             "3d_lowres": {"data_identifier": "nnUNetPlans_3d_lowres",
                           "next_stage": "3d_cascade_fullres"},
             "3d_cascade_fullres": {"inherits_from": "3d_fullres",
                                    "previous_stage": "3d_lowres"}}}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _truth(i: int, regions: bool) -> np.ndarray:
    gt = np.zeros(SHAPE, np.uint8)
    if regions:  # 2 inside 1
        gt[1:8, 2 + i % 2:12, 2:12] = 1
        gt[3:6, 4:8, 4 + i % 2:9] = 2
    else:  # apart
        gt[1:5, 2 + i % 2:7, 2:7] = 1
        gt[5:9, 9:13, 9 + i % 2:14] = 2
    return gt


def _model_output(gt: np.ndarray, model: str, scenario: str, regions: bool):
    """(intended labels, confidence): both models keep two small spurious
    blobs (what the postprocessing should remove). "single": the lowres
    model also gets a confident wrong blob, so the cascade model wins and
    the ensemble ties it at best. "ensemble": each model gets a weak wrong
    blob where the other is confident, so only the ensemble is right."""
    seg = gt.copy()
    conf = np.full(SHAPE, 0.95, np.float32)
    seg[8:10, 0:2, 14:16] = 1
    seg[0:1, 14:16, 0:2] = 2
    lowres = model == "3d_lowres"
    if scenario == "single" and lowres:
        seg[6:9, 1:4, 1:4] = 2
    elif scenario == "ensemble":
        box = (slice(6, 9), slice(1, 4), slice(1, 4)) if lowres else (
            slice(1, 3), slice(12, 15), slice(5, 8))
        seg[box] = 2 if lowres else 1
        conf[box] = 0.6
    return seg, conf


def _probabilities(seg, conf, regions: bool) -> np.ndarray:
    if regions:
        whole = np.where(seg > 0, conf, 1 - conf)
        inner = np.where(seg == 2, conf, 1 - conf)
        return np.stack([whole, inner]).astype(np.float32)
    return np.stack([np.where(seg == c, conf, (1 - conf) / 2) for c in range(3)]
                    ).astype(np.float32)


def _write_tree(root: str, regions: bool, scenario: str) -> None:
    labels = REGIONS if regions else LABELS
    dataset_json = {"channel_names": {"0": "CT"}, "labels": labels, "numTraining": 4,
                    "file_ending": ".nii.gz"}
    if regions:
        dataset_json["regions_class_order"] = [1, 2]
    lm = LabelManager(labels, dataset_json.get("regions_class_order"))
    raw = os.path.join(root, "raw", DATASET)
    pre = os.path.join(root, "preprocessed", DATASET)
    for d in (os.path.join(raw, "labelsTr"), os.path.join(raw, "imagesTr"),
              os.path.join(pre, "gt_segmentations")):
        os.makedirs(d, exist_ok=True)
    for name, obj in ((os.path.join(raw, "dataset.json"), dataset_json),
                      (os.path.join(pre, "nnUNetPlans.json"), PLANS)):
        with open(name, "w") as f:
            json.dump(obj, f)
    image = np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)
    for i, case in enumerate(CASES):
        gt = _truth(i, regions)
        for folder in (os.path.join(raw, "labelsTr"), os.path.join(pre, "gt_segmentations")):
            write_nifti(os.path.join(folder, case + ".nii.gz"), gt, (1.0, 1.0, 1.0))
        write_nifti(os.path.join(raw, "imagesTr", case + "_0000.nii.gz"), image + gt,
                    (1.0, 1.0, 1.0))
    props = NiftiIO().read_seg(os.path.join(raw, "labelsTr", CASES[0] + ".nii.gz"))[1]
    for model in MODELS:
        base = os.path.join(root, "results", DATASET, f"nnUNetTrainer__nnUNetPlans__{model}")
        os.makedirs(base, exist_ok=True)
        for name, obj in (("plans.json", PLANS), ("dataset.json", dataset_json)):
            with open(os.path.join(base, name), "w") as f:
                json.dump(obj, f)
        for fold, cases in FOLDS.items():
            val = os.path.join(base, f"fold_{fold}", "validation")
            os.makedirs(val, exist_ok=True)
            for case in cases:
                seg, conf = _model_output(_truth(CASES.index(case), regions), model,
                                          scenario, regions)
                p = _probabilities(seg, conf, regions)
                NiftiIO().write_seg(lm.convert_probabilities_to_segmentation(p),
                                    os.path.join(val, case + ".nii.gz"), props)
                np.savez_compressed(os.path.join(val, case + ".npz"), probabilities=p)
                with open(os.path.join(val, case + ".pkl"), "wb") as f:
                    pickle.dump(props, f)


def _env(monkeypatch, root: str) -> None:
    for sub in ("raw", "preprocessed", "results"):
        monkeypatch.setenv("nnUNet_" + sub, os.path.join(root, sub))


def _trees(tmp_path, regions: bool, scenario: str):
    src = str(tmp_path / "src")
    _write_tree(src, regions, scenario)
    roots = {}
    for pkg in PACKAGES:
        roots[pkg] = str(tmp_path / pkg)
        shutil.copytree(src, roots[pkg])
    return roots


def _model_folder(root: str, model: str) -> str:
    return os.path.join(root, "results", DATASET, f"nnUNetTrainer__nnUNetPlans__{model}")


def _same_outputs(a: str, b: str, roots) -> None:
    """Every file the two packages wrote under a / b: images and arrays
    equal; json equal with each root (and module path) replaced."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)), (names, sorted(os.listdir(b)))
    for name in names:
        fa, fb = os.path.join(a, name), os.path.join(b, name)
        if os.path.isdir(fa):
            _same_outputs(fa, fb, roots)
        elif name.endswith(".nii.gz"):
            np.testing.assert_array_equal(NiftiIO().read_seg(fa)[0], NiftiIO().read_seg(fb)[0])
        elif name.endswith(".npz"):
            np.testing.assert_array_equal(np.load(fa)["probabilities"],
                                          np.load(fb)["probabilities"])
        elif name.endswith((".json", ".txt")):
            texts = []
            for f, pkg in ((fa, "dinounet_tpu"), (fb, "dinounet_tpu_torch")):
                with open(f) as fh:
                    texts.append(fh.read().replace(roots[pkg], "ROOT")
                                 .replace("dinounet_tpu_torch.", "dinounet_tpu."))
            assert texts[0] == texts[1], name
        elif name.endswith(".pkl"):
            with open(fa, "rb") as fh:
                pa = pickle.load(fh)
            with open(fb, "rb") as fh:
                pb = pickle.load(fh)
            assert type(pa) is type(pb)
            if isinstance(pa, np.ndarray):
                np.testing.assert_array_equal(pa, pb)


@pytest.mark.parametrize("regions", [False, True])
def test_post_training_tools_match_jax(tmp_path, monkeypatch, regions):
    roots = _trees(tmp_path, regions, "single")
    written = {}
    for pkg in PACKAGES:
        root = roots[pkg]
        _env(monkeypatch, root)
        acc = _mod(pkg, "evaluation.accumulate_cv_results")
        ens = _mod(pkg, "ensembling.ensemble")
        pp = _mod(pkg, "postprocessing.remove_connected_components")
        fbc = _mod(pkg, "evaluation.find_best_configuration")
        folders = [_model_folder(root, m) for m in MODELS]
        acc.accumulate_cv_results(folders[0], os.path.join(root, "merged"), (0, 1),
                                  num_processes=1)
        ens.ensemble_folders([os.path.join(f, "fold_0", "validation") for f in folders],
                             os.path.join(root, "ensembled"), save_merged_probabilities=True,
                             num_processes=1,
                             dataset_json_file_or_dict=os.path.join(folders[0], "dataset.json"),
                             plans_json_file_or_dict=os.path.join(folders[0], "plans.json"))
        ens.ensemble_crossvalidations(folders, os.path.join(root, "crossval"), (0, 1),
                                      num_processes=1)
        written[pkg] = pp.determine_postprocessing(
            os.path.join(root, "merged"),
            os.path.join(root, "preprocessed", DATASET, "gt_segmentations"),
            os.path.join(folders[0], "plans.json"), os.path.join(folders[0], "dataset.json"),
            num_processes=1)
        models = [{"plans": "nnUNetPlans", "configuration": m, "trainer": "nnUNetTrainer"}
                  for m in MODELS]
        written[pkg, "info"] = fbc.find_best_configuration(ID, models, num_processes=1,
                                                           folds=(0, 1))
    jax_root, port_root = roots["dinounet_tpu"], roots["dinounet_tpu_torch"]
    ensemble = ("ensemble___nnUNetTrainer__nnUNetPlans__3d_lowres___nnUNetTrainer__"
                "nnUNetPlans__3d_cascade_fullres___0_1")
    for folder in ("crossval", os.path.join("results", DATASET, "ensembles", ensemble)):
        for sidecar in ("plans.json", "dataset.json"):  # the port's, as the reference's
            assert os.path.isfile(os.path.join(port_root, folder, sidecar))
            os.remove(os.path.join(port_root, folder, sidecar))
    for sub in ("merged", "ensembled", "crossval", os.path.join("results", DATASET)):
        _same_outputs(os.path.join(jax_root, sub), os.path.join(port_root, sub), roots)

    (jax_fns, jax_kwargs), (fns, kwargs) = written["dinounet_tpu"], written["dinounet_tpu_torch"]
    assert [f.__name__ for f in fns] == [f.__name__ for f in jax_fns]
    assert kwargs == jax_kwargs
    assert len(fns) >= 1  # the search kept something
    assert all(f.__module__ == "dinounet_tpu_torch.postprocessing.remove_connected_components"
               for f in fns)
    info = written["dinounet_tpu_torch", "info"]
    assert ensemble in info["all_results"]
    assert info["best_model_or_ensemble"]["selected_model_or_models"] == [
        {"configuration": "3d_cascade_fullres", "trainer": "nnUNetTrainer",
         "plans_identifier": "nnUNetPlans"}]
    with open(info["best_model_or_ensemble"]["postprocessing_file"], "rb") as f:
        assert pickle.load(f)[0][0].__module__.startswith("dinounet_tpu_torch.")


def test_find_best_configuration_when_the_ensemble_wins(tmp_path, monkeypatch):
    """The JAX package's ensembling writes no plans.json beside an ensemble,
    so its postprocessing search raises where the ensemble wins. Given the
    first model's plans.json and dataset.json there, as the reference and
    the port write them, it completes, and both packages write the same
    files, keep the same postprocessing and give the same inference
    information."""
    roots = _trees(tmp_path, False, "ensemble")
    models = [{"plans": "nnUNetPlans", "configuration": m, "trainer": "nnUNetTrainer"}
              for m in MODELS]
    _env(monkeypatch, roots["dinounet_tpu"])
    jax_fbc = _mod("dinounet_tpu", "evaluation.find_best_configuration")
    with pytest.raises(FileNotFoundError, match="plans.json"):
        jax_fbc.find_best_configuration(ID, models, num_processes=1, folds=(0, 1))
    shutil.rmtree(os.path.join(roots["dinounet_tpu"], "results", DATASET, "ensembles"))
    jax_ensemble = jax_fbc.ensemble_crossvalidations

    def ensemble_with_sidecars(folders, output_folder, *args, **kwargs):
        jax_ensemble(folders, output_folder, *args, **kwargs)
        for sidecar in ("dataset.json", "plans.json"):
            shutil.copy(os.path.join(folders[0], sidecar), os.path.join(output_folder, sidecar))

    monkeypatch.setattr(jax_fbc, "ensemble_crossvalidations", ensemble_with_sidecars)
    infos = {"dinounet_tpu": jax_fbc.find_best_configuration(ID, models, num_processes=1,
                                                             folds=(0, 1))}
    _env(monkeypatch, roots["dinounet_tpu_torch"])
    fbc = _mod("dinounet_tpu_torch", "evaluation.find_best_configuration")
    infos["dinounet_tpu_torch"] = fbc.find_best_configuration(ID, models, num_processes=1,
                                                              folds=(0, 1))
    _same_outputs(*(os.path.join(roots[pkg], "results", DATASET) for pkg in PACKAGES), roots)

    info = infos["dinounet_tpu_torch"]
    best = info["best_model_or_ensemble"]
    assert [m["configuration"] for m in best["selected_model_or_models"]] == list(MODELS)
    results = info["all_results"]
    assert results[max(results, key=results.get)] > max(
        v for k, v in results.items() if not k.startswith("ensemble___"))
    postprocessing = {}
    for pkg in PACKAGES:
        with open(infos[pkg]["best_model_or_ensemble"]["postprocessing_file"], "rb") as f:
            fns, kwargs = pickle.load(f)
        assert all(fn.__module__.startswith(pkg + ".") for fn in fns)
        postprocessing[pkg] = [fn.__name__ for fn in fns], kwargs
    assert postprocessing["dinounet_tpu_torch"] == postprocessing["dinounet_tpu"]
    with open(os.path.join(roots["dinounet_tpu_torch"], "results", DATASET,
                           "inference_instructions.txt")) as f:
        text = f.read()
    assert "python -m dinounet_tpu_torch.ensembling.ensemble" in text
    assert "-prev_stage_predictions OUTPUT_FOLDER_PREV_STAGE" in text
    assert "dinounet_tpu." not in text


def test_overlay_pngs_match_jax(tmp_path):
    src = str(tmp_path / "src")
    _write_tree(src, False, "single")
    raw = os.path.join(src, "raw", DATASET)
    image = os.path.join(raw, "imagesTr", CASES[1] + "_0000.nii.gz")
    label = os.path.join(raw, "labelsTr", CASES[1] + ".nii.gz")
    case = str(tmp_path / "case.npz")
    data = NiftiIO().read_images([image])[0].astype(np.float32)
    seg = NiftiIO().read_seg(label)[0].astype(np.int8)
    seg[0, :, 0] = -1
    np.savez_compressed(case, data=data, seg=seg)
    pngs = {}
    for pkg in PACKAGES:
        ov = _mod(pkg, "utilities.overlay_plots")
        rw = _mod(pkg, "imageio.nifti").NiftiIO()
        raw_png, pre_png = str(tmp_path / f"{pkg}_raw.png"), str(tmp_path / f"{pkg}_pre.png")
        ov.plot_overlay(image, label, rw, raw_png)
        ov.plot_overlay_preprocessed(case, pre_png)
        with open(raw_png, "rb") as f, open(pre_png, "rb") as g:
            pngs[pkg] = f.read(), g.read()
    assert pngs["dinounet_tpu"] == pngs["dinounet_tpu_torch"]
    assert pngs["dinounet_tpu_torch"][0][:4] == b"\x89PNG"
