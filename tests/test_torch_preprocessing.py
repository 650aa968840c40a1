"""The port's preprocessing against the JAX package's, on the CPU.

Both are numpy/scipy host code, so the outputs must be equal bit for bit:
``run_case_npy`` over the ZScore (with and without the mask), CT and
rescale normalizations, resampled with and without the separate-z path;
``resample_data_or_seg_to_shape`` for images, segmentations and
probabilities; and ``preprocess_dataset`` on the PNG dataset of
``tests/helpers.py``, from one plans file the JAX planner writes (its patch
and network made tiny): the same ``.npz`` arrays, ``.pkl`` properties and
``gt_segmentations`` files. The raw NIfTI dataset and plans that
``utilities/synthetic_dataset.py`` writes preprocess alike in both packages,
and the inference preprocessing iterators over files and arrays yield the
same items.
"""

import os
import pickle
import shutil

import numpy as np
import pytest

from dinounet_tpu_torch.preprocessing.resampling import (
    resample_data_or_seg_to_shape as port_resample)
from dinounet_tpu_torch.utilities.plans_handler import PlansManager

# the tiny plans of the PNG dataset: 96 x 96 after resampling, 64 x 64 tiles
TARGET_SHAPE = [96, 96]
TINY_PATCH = [64, 64]
TINY_FEATURES = [8, 16, 32, 64]

_INTENSITIES = {"0": {"max": 180.0, "mean": 90.0, "median": 88.0, "min": 5.0,
                      "percentile_00_5": 12.0, "percentile_99_5": 170.0,
                      "std": 30.0}}


def _plans(scheme: str, use_mask: bool, spacing) -> dict:
    return {
        "dataset_name": "Dataset990_Pre", "plans_name": "nnUNetPlans",
        "image_reader_writer": "NiftiIO",
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "foreground_intensity_properties_per_channel": _INTENSITIES,
        "configurations": {"3d_fullres": {
            "data_identifier": "nnUNetPlans_3d_fullres",
            "preprocessor_name": "DefaultPreprocessor", "batch_size": 2,
            "patch_size": [8, 16, 16], "spacing": list(spacing),
            "normalization_schemes": [scheme], "use_mask_for_norm": [use_mask],
            "resampling_fn_data": "resample_data_or_seg_to_shape",
            "resampling_fn_seg": "resample_data_or_seg_to_shape",
            "resampling_fn_data_kwargs": {"is_seg": False, "order": 3, "order_z": 0,
                                          "force_separate_z": None},
            "resampling_fn_seg_kwargs": {"is_seg": True, "order": 1, "order_z": 0,
                                         "force_separate_z": None},
            "resampling_fn_probabilities": "resample_data_or_seg_to_shape",
            "resampling_fn_probabilities_kwargs": {"is_seg": False, "order": 1,
                                                   "order_z": 0,
                                                   "force_separate_z": None},
        }},
    }


DATASET_JSON = {"labels": {"background": 0, "a": 1, "b": 2},
                "channel_names": {"0": "CT"}, "file_ending": ".nii.gz"}


def assert_same_tree(a, b, path="properties"):
    """Bit-for-bit equality of nested dicts, sequences and arrays."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_same_tree(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{path}[{i}]")
    else:
        assert a == b and type(a) is type(b), f"{path}: {a!r} != {b!r}"


# (source spacing, target spacing): 4.0 / 0.9 is past the anisotropy
# threshold of 3, so the first takes the separate-z path
SPACINGS = {"separate_z": ([4.0, 0.9, 0.9], [3.0, 0.75, 0.75]),
            "joint": ([1.5, 0.9, 0.9], [1.2, 0.75, 0.75])}


@pytest.mark.parametrize("resampling", sorted(SPACINGS))
@pytest.mark.parametrize("scheme,use_mask", [("ZScoreNormalization", False),
                                             ("ZScoreNormalization", True),
                                             ("CTNormalization", False),
                                             ("RescaleTo01Normalization", False)])
def test_run_case_npy_matches_jax_bit_for_bit(scheme, use_mask, resampling):
    from dinounet_tpu.preprocessing.preprocessor import DefaultPreprocessor as JaxPre
    from dinounet_tpu.utilities.plans_handler import PlansManager as JaxPlans

    from dinounet_tpu_torch.preprocessing.preprocessor import DefaultPreprocessor

    spacing, target = SPACINGS[resampling]
    plans = _plans(scheme, use_mask, target)
    rng = np.random.default_rng(7)
    data = rng.uniform(0, 200, (1, 6, 20, 18)).astype(np.float32)
    data[:, :, :2] = 0  # a zero border for the nonzero mask
    seg = rng.integers(0, 3, (1, 6, 20, 18)).astype(np.int16)
    outs = []
    for pre, pm in ((JaxPre(verbose=False), JaxPlans(plans)),
                    (DefaultPreprocessor(verbose=False), PlansManager(plans))):
        props = {"spacing": list(spacing)}
        d, s = pre.run_case_npy(data, seg, props, pm, pm.get_configuration("3d_fullres"),
                                DATASET_JSON)
        outs.append((d, s, props))
    (dj, sj, pj), (dp, sp, pp) = outs
    assert dp.shape[1:] == tuple(int(round(a / b * n)) for a, b, n in
                                 zip(spacing, target, data.shape[1:]))
    assert_same_tree(dp, dj, "data")
    assert_same_tree(sp, sj, "seg")
    assert_same_tree(pp, pj)


@pytest.mark.parametrize("kind", ["image", "seg", "probabilities_fp16"])
@pytest.mark.parametrize("resampling", sorted(SPACINGS))
def test_resample_to_shape_matches_jax_bit_for_bit(kind, resampling):
    from dinounet_tpu.preprocessing.resampling import (
        resample_data_or_seg_to_shape as jax_resample)

    spacing, target = SPACINGS[resampling]
    rng = np.random.default_rng(11)
    shape = (2, 5, 17, 15)
    kwargs = {"is_seg": kind == "seg", "order": 1 if kind == "seg" else 3,
              "order_z": 0, "force_separate_z": None}
    if kind == "seg":
        x = rng.integers(0, 3, shape).astype(np.int8)
    elif kind == "image":
        x = rng.standard_normal(shape).astype(np.float32)
    else:
        x = rng.standard_normal(shape).astype(np.float16)
        kwargs["order"] = 1
    new_shape = [int(round(a / b * n)) for a, b, n in zip(target, spacing, shape[1:])]
    got = port_resample(x, new_shape, target, spacing, **kwargs)
    want = jax_resample(x, new_shape, target, spacing, **kwargs)
    assert got.dtype == want.dtype == x.dtype
    assert got.shape == (2, *new_shape)
    assert_same_tree(got, want, kind)


def planned_png_dataset(root: str, n_cases: int = 6) -> str:
    """tests/helpers.py's PNG dataset (Dataset501_Toy2d) under <root>/raw,
    fingerprinted and planned by the JAX package into <root>/pre (the
    nnUNet_* variables must point there), with the 2d configuration cut to
    64 x 64 tiles and a tiny network; returns the plans file."""
    from dinounet_tpu.planning.fingerprint import DatasetFingerprintExtractor
    from dinounet_tpu.planning.planner import ExperimentPlanner
    from dinounet_tpu.utilities.json_export import load_json, save_json

    from tests.helpers import make_png_dataset

    make_png_dataset(os.path.join(root, "raw"), n_cases=n_cases, size=(72, 64))
    DatasetFingerprintExtractor(501, num_processes=1, verbose=False).run()
    ExperimentPlanner(501, force_target_shape=TARGET_SHAPE,
                      force_n_stages=4).plan_experiment()
    plans_file = os.path.join(root, "pre", "Dataset501_Toy2d", "nnUNetPlans.json")
    plans = load_json(plans_file)
    cfg = plans["configurations"]["2d"]
    cfg["patch_size"] = list(TINY_PATCH)
    cfg["batch_size"] = 2
    cfg["architecture"]["arch_kwargs"]["features_per_stage"] = list(TINY_FEATURES)
    save_json(plans, plans_file, sort_keys=False)
    return plans_file


@pytest.fixture()
def nnunet_env(tmp_path, monkeypatch):
    for sub in ("raw", "pre", "res"):
        (tmp_path / sub).mkdir()
    monkeypatch.setenv("nnUNet_raw", str(tmp_path / "raw"))
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path / "pre"))
    monkeypatch.setenv("nnUNet_results", str(tmp_path / "res"))
    return tmp_path


def test_preprocess_dataset_matches_jax(nnunet_env, monkeypatch):
    from dinounet_tpu.planning.plan_and_preprocess_api import (
        preprocess_dataset as jax_preprocess)

    from dinounet_tpu_torch.planning.plan_and_preprocess_api import preprocess_dataset

    planned_png_dataset(str(nnunet_env))
    # the port preprocesses into a second nnUNet_preprocessed holding the
    # same plans file and dataset.json
    shutil.copytree(nnunet_env / "pre", nnunet_env / "pre_port")
    jax_preprocess(501, configurations=["2d"], num_processes=[1])
    monkeypatch.setenv("nnUNet_preprocessed", str(nnunet_env / "pre_port"))
    preprocess_dataset(501, configurations=["2d"], num_processes=[2])

    jax_dir = nnunet_env / "pre" / "Dataset501_Toy2d"
    port_dir = nnunet_env / "pre_port" / "Dataset501_Toy2d"
    names = sorted(os.listdir(jax_dir / "nnUNetPlans_2d"))
    assert names == sorted(os.listdir(port_dir / "nnUNetPlans_2d"))
    assert len(names) == 12  # 6 cases, .npz and .pkl each
    for name in names:
        j, p = jax_dir / "nnUNetPlans_2d" / name, port_dir / "nnUNetPlans_2d" / name
        if name.endswith(".npz"):
            a, b = np.load(j), np.load(p)
            assert sorted(a.files) == sorted(b.files) == ["data", "seg"]
            for k in a.files:
                assert_same_tree(b[k], a[k], f"{name}:{k}")
            assert b["data"].shape[2:] == tuple(TARGET_SHAPE)
        else:
            with open(j, "rb") as f:
                pj = pickle.load(f)
            with open(p, "rb") as f:
                pp = pickle.load(f)
            assert_same_tree(pp, pj, name)
    gt = sorted(os.listdir(jax_dir / "gt_segmentations"))
    assert len(gt) == 6 and gt == sorted(os.listdir(port_dir / "gt_segmentations"))
    for name in gt:
        assert ((jax_dir / "gt_segmentations" / name).read_bytes()
                == (port_dir / "gt_segmentations" / name).read_bytes())


def test_raw_disk_ring_dataset_preprocesses_as_the_jax_package_does(nnunet_env,
                                                                     monkeypatch):
    """The port's raw NIfTI dataset and hand-written plans: both packages'
    preprocess_dataset read them and write the same cases."""
    from dinounet_tpu.planning.plan_and_preprocess_api import (
        preprocess_dataset as jax_preprocess)

    from dinounet_tpu_torch.planning.plan_and_preprocess_api import preprocess_dataset
    from dinounet_tpu_torch.utilities.synthetic_dataset import write_disk_ring_raw_dataset

    arch = {"n_stages": 4, "features_per_stage": TINY_FEATURES,
            "n_conv_per_stage_decoder": [2, 2, 2]}
    raw = write_disk_ring_raw_dataset(str(nnunet_env / "raw"), str(nnunet_env / "pre"),
                                      "Dataset996_RawRing", 4, 1, (50, 50), 0.8, 1.0,
                                      TINY_PATCH, 2, arch, seed=3)
    assert sorted(os.listdir(os.path.join(raw, "imagesTs"))) == ["case_004_0000.nii.gz"]
    shutil.copytree(nnunet_env / "pre", nnunet_env / "pre_port")
    jax_preprocess(996, configurations=["2d"], num_processes=[1])
    monkeypatch.setenv("nnUNet_preprocessed", str(nnunet_env / "pre_port"))
    preprocess_dataset(996, configurations=["2d"], num_processes=[1])
    jax_dir = nnunet_env / "pre" / "Dataset996_RawRing" / "nnUNetPlans_2d"
    port_dir = nnunet_env / "pre_port" / "Dataset996_RawRing" / "nnUNetPlans_2d"
    for i in range(4):
        a, b = np.load(jax_dir / f"case_{i:03d}.npz"), np.load(port_dir / f"case_{i:03d}.npz")
        assert b["data"].shape == (1, 1, 40, 40)  # 50 at 0.8 mm -> 40 at 1.0 mm
        assert set(np.unique(b["seg"])) == {0, 1, 2}
        for k in ("data", "seg"):
            assert_same_tree(b[k], a[k], k)
        with open(jax_dir / f"case_{i:03d}.pkl", "rb") as f:
            pj = pickle.load(f)
        with open(port_dir / f"case_{i:03d}.pkl", "rb") as f:
            assert_same_tree(pickle.load(f), pj)


def test_preprocessing_iterators_match_jax(nnunet_env):
    from dinounet_tpu.inference import data_iterators as jax_iterators
    from dinounet_tpu.utilities.plans_handler import PlansManager as JaxPlans

    from dinounet_tpu_torch.imageio.natural_image import NaturalImage2DIO
    from dinounet_tpu_torch.inference import data_iterators
    from dinounet_tpu_torch.utilities.json_export import load_json

    plans = load_json(planned_png_dataset(str(nnunet_env), n_cases=3))
    raw = nnunet_env / "raw" / "Dataset501_Toy2d"
    dataset_json = load_json(str(raw / "dataset.json"))
    files = [[str(raw / "imagesTr" / f"case_{i:03d}_0000.png")] for i in range(3)]
    ofiles = [f"out_{i}" for i in range(3)]
    jpm, pm = JaxPlans(plans), PlansManager(plans)
    want = list(jax_iterators.preprocessing_iterator_fromfiles(
        files, None, ofiles, jpm, dataset_json, jpm.get_configuration("2d"), 1))
    got = list(data_iterators.preprocessing_iterator_fromfiles(
        files, None, ofiles, pm, dataset_json, pm.get_configuration("2d"), 2))
    assert [g["ofile"] for g in got] == ofiles
    assert_same_tree(got, want, "fromfiles")

    images = [NaturalImage2DIO().read_images(f) for f in files]
    want = list(jax_iterators.preprocessing_iterator_fromnpy(
        [i for i, _ in images], None, [p for _, p in images], None, jpm, dataset_json,
        jpm.get_configuration("2d"), 1))
    got = list(data_iterators.preprocessing_iterator_fromnpy(
        [i for i, _ in images], None, [p for _, p in images], None, pm, dataset_json,
        pm.get_configuration("2d"), 2))
    assert_same_tree(got, want, "fromnpy")
