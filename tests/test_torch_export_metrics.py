"""The port's export and metrics against the JAX package's, on the CPU.

Export: the same fp16 logits of a case preprocessed by the port (resampled,
so export resamples back) go through both packages'
``export_prediction_from_logits`` into NIfTI and PNG files, with and without
the probabilities: the segmentation files hold the same arrays and headers,
the ``.npz`` probabilities and ``.pkl`` properties are equal bit for bit, as
are the in-memory conversion and the cascade's ``resample_and_save``.
Metrics: ``compute_metrics_on_folder`` over NIfTI and PNG folders, labels and
regions, with and without an ignore label, writes the same ``summary.json``
text (NaN where the JAX package has NaN: a label absent from a case), and
``compute_metrics_on_folder2`` / ``compute_metrics_on_folder_simple`` give
the same results.
"""

import copy
import os
import pickle

import numpy as np
import pytest

from dinounet_tpu_torch.imageio.natural_image import NaturalImage2DIO
from dinounet_tpu_torch.imageio.nifti import NiftiIO, read_nifti, write_nifti
from dinounet_tpu_torch.preprocessing.preprocessor import DefaultPreprocessor
from dinounet_tpu_torch.utilities.plans_handler import PlansManager
from tests.test_torch_preprocessing import assert_same_tree

DATASET_JSONS = {
    ".nii.gz": {"labels": {"background": 0, "a": 1, "b": 2},
                "channel_names": {"0": "MRI"}, "file_ending": ".nii.gz"},
    ".png": {"labels": {"background": 0, "a": 1, "b": 2},
             "channel_names": {"0": "rescale_to_0_1"}, "file_ending": ".png"},
}


def _plans(ending: str) -> dict:
    two_d = ending == ".png"
    kwargs = {"order_z": 0, "force_separate_z": None}
    return {
        "dataset_name": "Dataset989_Export", "plans_name": "nnUNetPlans",
        "image_reader_writer": "NaturalImage2DIO" if two_d else "NiftiIO",
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "foreground_intensity_properties_per_channel": {"0": {
            "max": 1.0, "mean": 0.0, "median": 0.0, "min": -1.0,
            "percentile_00_5": -1.0, "percentile_99_5": 1.0, "std": 1.0}},
        "configurations": {"2d": {
            "data_identifier": "nnUNetPlans_2d", "preprocessor_name": "DefaultPreprocessor",
            "batch_size": 2, "patch_size": [32, 32],
            "spacing": [0.7, 0.75] if two_d else [1.0, 1.0],
            "normalization_schemes": ["RescaleTo01Normalization" if two_d
                                      else "ZScoreNormalization"],
            "use_mask_for_norm": [False],
            "resampling_fn_data": "resample_data_or_seg_to_shape",
            "resampling_fn_seg": "resample_data_or_seg_to_shape",
            "resampling_fn_data_kwargs": {"is_seg": False, "order": 3, **kwargs},
            "resampling_fn_seg_kwargs": {"is_seg": True, "order": 1, **kwargs},
            "resampling_fn_probabilities": "resample_data_or_seg_to_shape",
            "resampling_fn_probabilities_kwargs": {"is_seg": False, "order": 1, **kwargs},
        }},
    }


def _raw_case(tmp_path, ending: str) -> str:
    """One raw image: a 40 x 36 slice (NIfTI at 0.8 mm, z 1 mm) or PNG."""
    img = np.random.default_rng(5).uniform(0, 255, (40, 36)).astype(np.uint8)
    path = str(tmp_path / f"case_000_0000{ending}")
    if ending == ".png":
        from PIL import Image

        Image.fromarray(img).save(path)
    else:
        write_nifti(path, img[None].astype(np.float32), (0.8, 0.8, 1.0))
    return path


@pytest.fixture(params=[".nii.gz", ".png"], ids=["nifti", "png"])
def case(request, tmp_path):
    """(ending, plans, dataset.json, properties after preprocessing, fp16
    logits of the preprocessed shape)."""
    ending = request.param
    plans, dataset_json = _plans(ending), DATASET_JSONS[ending]
    pm = PlansManager(plans)
    data, _, props = DefaultPreprocessor(verbose=False).run_case(
        [_raw_case(tmp_path, ending)], None, pm, pm.get_configuration("2d"), dataset_json)
    assert data.shape[2:] != props["shape_before_cropping"][1:]  # export resamples
    logits = np.random.default_rng(6).standard_normal(
        (3, *data.shape[1:])).astype(np.float16) * 3
    return ending, plans, dataset_json, props, logits


def _managers(plans):
    from dinounet_tpu.utilities.plans_handler import PlansManager as JaxPlans

    jpm, ppm = JaxPlans(plans), PlansManager(plans)
    return (jpm, jpm.get_configuration("2d")), (ppm, ppm.get_configuration("2d"))


def _read_seg(path: str):
    if path.endswith(".png"):
        return NaturalImage2DIO().read_seg(path)[0], None
    arr, hdr = read_nifti(path)
    return arr, hdr["raw_header"]


@pytest.mark.parametrize("save_probabilities", [False, True])
def test_export_prediction_writes_the_same_files(case, tmp_path, save_probabilities):
    from dinounet_tpu.inference.export import export_prediction_from_logits as jax_export

    from dinounet_tpu_torch.inference.export import export_prediction_from_logits

    ending, plans, dataset_json, props, logits = case
    (jpm, jcm), (ppm, pcm) = _managers(plans)
    out_j, out_p = str(tmp_path / "jax_case"), str(tmp_path / "port_case")
    jax_export(logits, copy.deepcopy(props), jcm, jpm, dataset_json, out_j,
               save_probabilities)
    export_prediction_from_logits(logits, copy.deepcopy(props), pcm, ppm, dataset_json,
                                  out_p, save_probabilities)
    (aj, hj), (ap, hp) = _read_seg(out_j + ending), _read_seg(out_p + ending)
    assert_same_tree(ap, aj, "segmentation")
    assert hp == hj
    assert ap.shape[-2:] == (40, 36)  # the raw slice's shape
    assert set(np.unique(ap)) <= {0, 1, 2}
    assert os.path.isfile(out_p + ".npz") == save_probabilities
    if save_probabilities:
        pj, pp = np.load(out_j + ".npz"), np.load(out_p + ".npz")
        assert pp.files == pj.files == ["probabilities"]
        assert_same_tree(pp["probabilities"], pj["probabilities"], "probabilities")
        with open(out_j + ".pkl", "rb") as f:
            kj = pickle.load(f)
        with open(out_p + ".pkl", "rb") as f:
            kp = pickle.load(f)
        assert_same_tree(kp, kj)


def test_conversion_and_cascade_resampling_match_jax(case, tmp_path):
    from dinounet_tpu.inference.export import (
        convert_predicted_logits_to_segmentation_with_correct_shape as jax_convert)
    from dinounet_tpu.inference.export import resample_and_save as jax_resample_and_save

    from dinounet_tpu_torch.inference.export import (
        convert_predicted_logits_to_segmentation_with_correct_shape, resample_and_save)

    _, plans, dataset_json, props, logits = case
    (jpm, jcm), (ppm, pcm) = _managers(plans)
    segj, probj = jax_convert(logits, jpm, jcm, jpm.get_label_manager(dataset_json),
                              copy.deepcopy(props), return_probabilities=True)
    segp, probp = convert_predicted_logits_to_segmentation_with_correct_shape(
        logits, ppm, pcm, ppm.get_label_manager(dataset_json), copy.deepcopy(props),
        return_probabilities=True)
    assert_same_tree(segp, segj, "segmentation")
    assert_same_tree(probp, probj, "probabilities")

    target = (1, 30, 28)
    jax_resample_and_save(logits, target, str(tmp_path / "j.npz"), jpm, jcm,
                          copy.deepcopy(props), dataset_json)
    resample_and_save(logits, target, str(tmp_path / "p.npz"), ppm, pcm,
                      copy.deepcopy(props), dataset_json)
    assert_same_tree(np.load(tmp_path / "p.npz")["seg"],
                     np.load(tmp_path / "j.npz")["seg"], "seg")


def _assert_same_results(a, b, path="results"):
    """Equality of metric trees, NaN equal to NaN."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _assert_same_results(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_results(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), path
    else:
        assert a == b and type(a) is type(b), f"{path}: {a!r} != {b!r}"


def _seg_folders(tmp_path, ending: str):
    """gt and prediction folders of three cases (labels 0-3; label 2 absent
    from the second case's gt and prediction, so its Dice there is NaN)."""
    rng = np.random.default_rng(9)
    folders = {k: tmp_path / k for k in ("gt", "pred")}
    for f in folders.values():
        f.mkdir()
    for i in range(3):
        gt = rng.integers(0, 4, (1, 24, 20)).astype(np.uint8)
        pred = np.where(rng.uniform(size=gt.shape) < 0.8, gt,
                        rng.integers(0, 4, gt.shape)).astype(np.uint8)
        if i == 1:
            gt[gt == 2] = 0
            pred[pred == 2] = 1
        for k, arr in (("gt", gt), ("pred", pred)):
            path = str(folders[k] / f"case_{i:03d}{ending}")
            if ending == ".png":
                NaturalImage2DIO().write_seg(arr, path, {})
            else:
                NiftiIO().write_seg(arr, path, {"spacing": [1.0, 0.9, 0.8]})
    return str(folders["gt"]), str(folders["pred"])


@pytest.mark.parametrize("ending", [".nii.gz", ".png"], ids=["nifti", "png"])
@pytest.mark.parametrize("labels,ignore_label", [([1, 2], None), ([1, 2], 3),
                                                 ([(1, 2), 2], None)],
                         ids=["labels", "ignore_label", "regions"])
def test_compute_metrics_on_folder_writes_the_same_summary(tmp_path, ending, labels,
                                                           ignore_label):
    from dinounet_tpu.evaluation.metrics import compute_metrics_on_folder as jax_metrics
    from dinounet_tpu.imageio import reader_writer_registry  # noqa: F401
    from dinounet_tpu.utilities import registry as jax_registry

    from dinounet_tpu_torch.evaluation.metrics import compute_metrics_on_folder
    from dinounet_tpu_torch.utilities import registry

    gt, pred = _seg_folders(tmp_path, ending)
    name = "NaturalImage2DIO" if ending == ".png" else "NiftiIO"
    out_j, out_p = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    want = jax_metrics(gt, pred, out_j, jax_registry.image_readers.get(name)(), ending,
                       labels, ignore_label, num_processes=2)
    got = compute_metrics_on_folder(gt, pred, out_p, registry.image_readers.get(name)(),
                                    ending, labels, ignore_label, num_processes=2)
    with open(out_j) as f:
        text_j = f.read()
    with open(out_p) as f:
        text_p = f.read()
    assert text_p == text_j
    assert "NaN" in text_p  # label 2 is absent from case 1
    _assert_same_results(got, want)


def test_compute_metrics_on_folder2_and_simple_match_jax(tmp_path):
    from dinounet_tpu.evaluation.metrics import compute_metrics_on_folder2 as jax2
    from dinounet_tpu.evaluation.metrics import compute_metrics_on_folder_simple as jax_simple

    from dinounet_tpu_torch.evaluation.metrics import (compute_metrics_on_folder2,
                                                       compute_metrics_on_folder_simple)
    from dinounet_tpu_torch.utilities.json_export import save_json

    gt, pred = _seg_folders(tmp_path, ".png")
    save_json(DATASET_JSONS[".png"], str(tmp_path / "dataset.json"))
    save_json(_plans(".png"), str(tmp_path / "plans.json"))
    args = (gt, pred, str(tmp_path / "dataset.json"), str(tmp_path / "plans.json"))
    want = jax2(*args, output_file=str(tmp_path / "j2.json"), num_processes=1)
    got = compute_metrics_on_folder2(*args, output_file=str(tmp_path / "p2.json"),
                                     num_processes=1)
    _assert_same_results(got, want)
    assert (tmp_path / "p2.json").read_text() == (tmp_path / "j2.json").read_text()
    want = jax_simple(gt, pred, [1, 2], str(tmp_path / "js.json"), num_processes=1)
    got = compute_metrics_on_folder_simple(gt, pred, [1, 2], str(tmp_path / "ps.json"),
                                           num_processes=1)
    _assert_same_results(got, want)
    assert (tmp_path / "ps.json").read_text() == (tmp_path / "js.json").read_text()


@pytest.mark.parametrize("num_processes", [1, 3])
def test_compute_metrics_on_folder_runs_at_most_num_processes_transforms(
        tmp_path, monkeypatch, num_processes):
    """A folder's distance transforms, each a float64 volume, run at most
    `num_processes` at once, however many cases, labels and directions there
    are (here 3 x 3 x 2), and the summary is the JAX package's all the same."""
    import threading
    import time

    from dinounet_tpu.evaluation.metrics import compute_metrics_on_folder as jax_metrics

    from dinounet_tpu_torch.evaluation import metrics

    lock, running, peak = threading.Lock(), [0], [0]
    edt = metrics.distance_transform_edt

    def counted_edt(*args, **kwargs):
        with lock:
            running[0] += 1
            peak[0] = max(peak[0], running[0])
        time.sleep(0.02)
        try:
            return edt(*args, **kwargs)
        finally:
            with lock:
                running[0] -= 1

    monkeypatch.setattr(metrics, "distance_transform_edt", counted_edt)
    gt, pred = _seg_folders(tmp_path, ".nii.gz")
    got = metrics.compute_metrics_on_folder(gt, pred, None, NiftiIO(), ".nii.gz", [1, 2, 3],
                                            num_processes=num_processes)
    assert 1 <= peak[0] <= num_processes
    if num_processes > 1:
        assert peak[0] > 1  # the pool is used
    from dinounet_tpu.imageio.nifti import NiftiIO as JaxNiftiIO
    want = jax_metrics(gt, pred, None, JaxNiftiIO(), ".nii.gz", [1, 2, 3], num_processes=1)
    _assert_same_results(got, want)
