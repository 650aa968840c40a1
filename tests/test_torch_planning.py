"""The port's fingerprinting, planning and preprocessing against the JAX
package's, on the CPU.

All of it is host numpy / scipy, so the two packages must write the same
files: on tests/helpers.py's 2-D PNG and 3-D NIfTI datasets, each package in
its own nnUNet_* roots, ``dataset_fingerprint.json`` and the plans file are
equal as parsed JSON (floats exactly), and every planned configuration's
preprocessed ``.npz`` arrays and ``.pkl`` properties are equal bit for bit,
for the default planner, the DinoUNet CLI's forced 512 x 512 shape with 4
stages, an overwritten target spacing, a binding ``max_batch_size``, a small
``gpu_memory_target`` (the patch-shrinking loop) and ``ResEncUNetPlanner``.
Also held against the JAX package: ``get_pool_and_conv_props``,
``verify_dataset_integrity`` on broken datasets, ``move_plans_between_datasets``
and the planning CLI entries.

The fingerprint samples 10^8 foreground intensities over a dataset (several
seconds and ~1 GB a run); outside ``test_fingerprint_matches_jax`` both
packages' extractors sample FAST_SAMPLES instead (``fast_fingerprints``).
"""

import importlib
import json
import os
import pickle
import sys

import numpy as np
import pytest

from tests.helpers import make_nifti_dataset, make_png_dataset
from tests.test_torch_preprocessing import assert_same_tree

PACKAGES = ("dinounet_tpu", "dinounet_tpu_torch")
# dataset id -> (folder name, generator, a target spacing to overwrite with)
DATASETS = {501: ("Dataset501_Toy2d", make_png_dataset, [999.0, 0.5, 0.5]),
            502: ("Dataset502_Toy3d", make_nifti_dataset, [2.0, 0.8, 0.8])}
FAST_SAMPLES = 1e5
FORCED = {"force_target_shape": [512, 512], "force_n_stages": 4}
# planner case -> (registered planner, its arguments); max_batch_size binds
# on the NIfTI set's forced 2d configuration (32 without it), and a 0.01 GB
# target makes the planner shrink the patch
PLANNER_CASES = {
    "default": ("ExperimentPlanner", {}),
    "forced_512": ("ExperimentPlanner", FORCED),
    "target_spacing": ("ExperimentPlanner", {"overwrite_target_spacing": None}),
    "max_batch_size": ("ExperimentPlanner", {**FORCED, "max_batch_size": 8}),
    "gpu_memory_target": ("ExperimentPlanner", {"gpu_memory_target_in_gb": 0.01}),
    "resenc": ("ResEncUNetPlanner", {}),
}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture()
def fast_fingerprints(monkeypatch):
    for pkg in PACKAGES:
        cls = _mod(pkg, "planning.fingerprint").DatasetFingerprintExtractor
        init = cls.__init__

        def fast_init(self, *args, _init=init, **kwargs):
            _init(self, *args, **kwargs)
            self.num_foreground_voxels_for_intensitystats = FAST_SAMPLES

        monkeypatch.setattr(cls, "__init__", fast_init)


def _use_root(root: str, monkeypatch) -> None:
    for sub, var in (("raw", "nnUNet_raw"), ("pre", "nnUNet_preprocessed"),
                     ("res", "nnUNet_results")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        monkeypatch.setenv(var, os.path.join(root, sub))


def _raw(root: str, dataset_id: int, monkeypatch) -> str:
    """The dataset under <root>/raw, with nnUNet_* pointing into <root>."""
    _use_root(root, monkeypatch)
    name, make, _ = DATASETS[dataset_id]
    return make(os.path.join(root, "raw"))


def _load(path: str):
    with open(path) as f:
        return json.load(f)


def _assert_same_preprocessed(dir_a: str, dir_b: str) -> int:
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b)), (dir_a, dir_b)
    for name in names:
        a, b = os.path.join(dir_a, name), os.path.join(dir_b, name)
        if name.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files) == ["data", "seg"]
            for k in za.files:
                assert_same_tree(zb[k], za[k], f"{name}:{k}")
        elif name.endswith(".pkl"):
            with open(a, "rb") as f:
                pa = pickle.load(f)
            with open(b, "rb") as f:
                assert_same_tree(pickle.load(f), pa, name)
    return len(names)


def _assert_same_dataset_folders(root_a: str, root_b: str, dataset: str) -> None:
    """The fingerprint, every plans file and every preprocessed folder of
    `dataset` under the two nnUNet_preprocessed roots are the same."""
    a, b = os.path.join(root_a, "pre", dataset), os.path.join(root_b, "pre", dataset)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in sorted(os.listdir(a)):
        if name.endswith(".json"):
            assert _load(os.path.join(b, name)) == _load(os.path.join(a, name)), name
        elif os.path.isdir(os.path.join(a, name)) and name != "gt_segmentations":
            assert _assert_same_preprocessed(os.path.join(a, name), os.path.join(b, name))


@pytest.mark.parametrize("dataset_id", sorted(DATASETS))
def test_fingerprint_matches_jax(tmp_path, monkeypatch, dataset_id):
    folders = {}
    for pkg in PACKAGES:
        root = str(tmp_path / pkg)
        _raw(root, dataset_id, monkeypatch)
        fpe = _mod(pkg, "planning.fingerprint").DatasetFingerprintExtractor
        fpe(dataset_id, num_processes=2).run()
        folders[pkg] = os.path.join(root, "pre", DATASETS[dataset_id][0])
    want, got = (_load(os.path.join(folders[p], "dataset_fingerprint.json"))
                 for p in PACKAGES)
    assert got == want
    assert len(got["spacings"]) == len(got["shapes_after_crop"]) > 1


@pytest.mark.parametrize("case", sorted(PLANNER_CASES))
@pytest.mark.parametrize("dataset_id", sorted(DATASETS))
def test_plans_and_preprocessed_cases_match_jax(tmp_path, monkeypatch, fast_fingerprints,
                                                dataset_id, case):
    planner_name, kwargs = PLANNER_CASES[case]
    if "overwrite_target_spacing" in kwargs:
        kwargs = {"overwrite_target_spacing": DATASETS[dataset_id][2]}
    name = DATASETS[dataset_id][0]
    plans = {}
    for pkg in PACKAGES:
        root = str(tmp_path / pkg)
        _raw(root, dataset_id, monkeypatch)
        _mod(pkg, "planning.fingerprint").DatasetFingerprintExtractor(
            dataset_id, num_processes=2).run()
        planner = _mod(pkg, "utilities.registry").planners.get(planner_name)
        p = planner(dataset_id, **kwargs)
        p.plan_experiment()
        plans[pkg] = _load(os.path.join(root, "pre", name, p.plans_identifier + ".json"))
        configurations = sorted(c for c, v in plans[pkg]["configurations"].items()
                                if "data_identifier" in v)
        _mod(pkg, "planning.plan_and_preprocess_api").preprocess_dataset(
            dataset_id, p.plans_identifier, configurations, 2)
    got, want = plans["dinounet_tpu_torch"], plans["dinounet_tpu"]
    assert got == want
    assert got["experiment_planner_used"] == planner_name
    if case in ("forced_512", "max_batch_size") and dataset_id == 501:
        cfg = got["configurations"]["2d"]
        assert cfg["patch_size"] == [512, 512]
        assert cfg["architecture"]["arch_kwargs"]["n_stages"] == 4
    if case == "max_batch_size" and dataset_id == 502:
        assert got["configurations"]["2d"]["batch_size"] == 8
    _assert_same_dataset_folders(str(tmp_path / "dinounet_tpu"),
                                 str(tmp_path / "dinounet_tpu_torch"), name)


TOPOLOGY_CASES = {  # spacing, patch, min feature map edge, max_numpool
    "isotropic_2d": ((1.0, 1.0), (512, 512), 4, 999999),
    "isotropic_3d": ((1.0, 1.0, 1.0), (128, 128, 128), 4, 999999),
    "anisotropic_3d": ((5.0, 1.0, 1.0), (16, 256, 256), 4, 999999),
    "anisotropic_odd": ((3.0, 0.7, 0.9), (20, 97, 131), 4, 999999),
    "forced_stages_2d": ((1.5625, 1.5625), (512, 512), 4, 3),
    "forced_past_constraints": ((2.0, 1.0), (6, 40), 4, 5),
}


@pytest.mark.parametrize("case", sorted(TOPOLOGY_CASES))
def test_get_pool_and_conv_props_matches_jax(case):
    from dinounet_tpu.planning.topology import get_pool_and_conv_props as jax_props

    from dinounet_tpu_torch.planning.topology import get_pool_and_conv_props

    got, want = (f(*TOPOLOGY_CASES[case]) for f in (get_pool_and_conv_props, jax_props))
    assert len(got) == len(want) == 5
    for g, w in zip(got[:4], want[:4]):
        assert g == w and type(g) is type(w)
    np.testing.assert_array_equal(got[4], want[4])


def _remove_a_label(folder: str) -> None:
    os.remove(os.path.join(folder, "labelsTr", "case_001.png"))


def _write_label(folder: str, seg: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(seg).save(os.path.join(folder, "labelsTr", "case_002.png"))


BROKEN = {
    "intact": None,
    "missing_label": _remove_a_label,
    "label_outside_labels": lambda f: _write_label(f, np.full((72, 64), 5, np.uint8)),
    "shape_mismatch": lambda f: _write_label(f, np.zeros((70, 64), np.uint8)),
}


@pytest.mark.parametrize("kind", sorted(BROKEN))
def test_verify_dataset_integrity_matches_jax(tmp_path, monkeypatch, kind):
    """Both packages verify the same folder: the same verdict, and the same
    error where it is broken."""
    from dinounet_tpu.planning.verify import verify_dataset_integrity as jax_verify

    from dinounet_tpu_torch.planning.verify import verify_dataset_integrity

    folder = _raw(str(tmp_path), 501, monkeypatch)
    if BROKEN[kind] is not None:
        BROKEN[kind](folder)
    outcomes = []
    for verify in (jax_verify, verify_dataset_integrity):
        try:
            verify(folder, 2)
            outcomes.append(None)
        except (AssertionError, RuntimeError) as e:
            outcomes.append((type(e), str(e)))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (kind == "intact")


def test_move_plans_between_datasets_matches_jax(tmp_path, monkeypatch, fast_fingerprints):
    moved = {}
    for pkg in PACKAGES:
        root = str(tmp_path / pkg)
        _use_root(root, monkeypatch)
        make_png_dataset(os.path.join(root, "raw"), "Dataset511_Src", n_cases=2, size=(40, 36))
        make_nifti_dataset(os.path.join(root, "raw"), "Dataset512_Tgt", n_cases=2)
        _mod(pkg, "planning.fingerprint").DatasetFingerprintExtractor(511, 1).run()
        _mod(pkg, "planning.planner").ExperimentPlanner(511).plan_experiment()
        move = _mod(pkg, "planning.move_plans_between_datasets").move_plans_between_datasets
        out = move(511, 512, "nnUNetPlans", "movedPlans")
        assert out == os.path.join(root, "pre", "Dataset512_Tgt", "movedPlans.json")
        moved[pkg] = _load(out)
    got = moved["dinounet_tpu_torch"]
    assert got == moved["dinounet_tpu"]
    assert got["dataset_name"] == "Dataset512_Tgt" and got["plans_name"] == "movedPlans"
    assert got["image_reader_writer"] == "NiftiIO"
    assert got["configurations"]["2d"]["data_identifier"] == "movedPlans_2d"


# CLI entry -> (module, function, arguments after the program name, the
# library steps that run before it)
ENTRIES = {
    "plan_and_preprocess": (
        "planning.plan_and_preprocess_api", "plan_and_preprocess_entry",
        ["-d", "501", "-c", "2d", "-np", "2", "-npfp", "2",
         "--verify_dataset_integrity"], ()),
    "extract_fingerprint": (
        "planning.plan_and_preprocess_api", "extract_fingerprint_entry",
        ["-d", "501", "-np", "2", "--verify_dataset_integrity"], ()),
    "plan_experiment": (
        "planning.plan_and_preprocess_api", "plan_experiment_entry",
        ["-d", "501", "-pl", "ResEncUNetPlanner", "-overwrite_target_spacing", "999",
         "0.75", "0.75"], ("fingerprint",)),
    "preprocess": (
        "planning.plan_and_preprocess_api", "preprocess_entry",
        ["-d", "501", "-c", "2d", "-np", "2"], ("fingerprint", "plan")),
    "move_plans": (
        "planning.move_plans_between_datasets", "entry_point_move_plans_between_datasets",
        ["-s", "501", "-t", "513", "-sp", "nnUNetPlans", "-tp", "otherPlans"],
        ("fingerprint", "plan")),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_planning_cli_entries_match_jax(tmp_path, monkeypatch, fast_fingerprints, entry):
    module, function, argv, before = ENTRIES[entry]
    for pkg in PACKAGES:
        root = str(tmp_path / pkg)
        _raw(root, 501, monkeypatch)
        make_png_dataset(os.path.join(root, "raw"), "Dataset513_Other", n_cases=2, seed=3)
        if "fingerprint" in before:
            _mod(pkg, "planning.plan_and_preprocess_api").extract_fingerprints([501], 2)
        if "plan" in before:
            _mod(pkg, "planning.plan_and_preprocess_api").plan_experiments([501])
        monkeypatch.setattr(sys, "argv", [function] + argv)
        getattr(_mod(pkg, module), function)()
    a, b = str(tmp_path / "dinounet_tpu"), str(tmp_path / "dinounet_tpu_torch")
    _assert_same_dataset_folders(a, b, "Dataset501_Toy2d")
    written = os.listdir(os.path.join(b, "pre", "Dataset501_Toy2d"))
    assert "dataset_fingerprint.json" in written
    if entry == "plan_and_preprocess":
        assert {"nnUNetPlans.json", "nnUNetPlans_2d", "gt_segmentations"} <= set(written)
    if entry == "plan_experiment":
        assert "nnUNetResEncUNetPlans.json" in written
    if entry == "move_plans":
        _assert_same_dataset_folders(a, b, "Dataset513_Other")
        assert "otherPlans.json" in os.listdir(os.path.join(b, "pre", "Dataset513_Other"))
