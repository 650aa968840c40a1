"""Dataset integrity verification.

Capability parity with ref: dinounet/experiment_planning/
verify_dataset_integrity.py:32-234: dataset.json schema checks, file presence,
label legality, image/seg shape+spacing consistency per case.

JAX-free copy of ``dinounet_tpu/planning/verify.py``.
"""

import os
from typing import List

import numpy as np

from dinounet_tpu_torch.imageio.reader_writer_registry import determine_reader_writer_from_dataset_json
from dinounet_tpu_torch.planning.dataset_utils import get_filenames_of_train_images_and_targets
from dinounet_tpu_torch.utilities.json_export import load_json


def verify_labels(label_file: str, readerclass, expected_labels: List[int]) -> List[str]:
    rw = readerclass()
    seg, _ = rw.read_seg(label_file)
    found = np.unique(seg)
    problems = []
    unexpected = [int(i) for i in found if i not in expected_labels]
    if unexpected:
        problems.append(f"{label_file}: unexpected labels {unexpected} (expected {expected_labels})")
    if np.any(np.isnan(seg)):
        problems.append(f"{label_file}: NaN values in segmentation")
    return problems


def check_case(image_files: List[str], label_file: str, readerclass) -> List[str]:
    rw = readerclass()
    problems = []
    images, props_img = rw.read_images(image_files)
    seg, props_seg = rw.read_seg(label_file)
    if images.shape[1:] != seg.shape[1:]:
        problems.append(
            f"{label_file}: image shape {images.shape[1:]} != seg shape {seg.shape[1:]}"
        )
    if not np.allclose(props_img["spacing"], props_seg["spacing"], rtol=1e-3):
        problems.append(
            f"{label_file}: image spacing {props_img['spacing']} != seg spacing {props_seg['spacing']}"
        )
    if np.any(np.isnan(images)):
        problems.append(f"{image_files}: NaN values in image")
    return problems


def verify_dataset_integrity(folder: str, num_processes: int = 8) -> None:
    """Raises on the first set of problems found."""
    dataset_json_file = os.path.join(folder, "dataset.json")
    assert os.path.isfile(dataset_json_file), f"dataset.json missing in {folder}"
    dataset_json = load_json(dataset_json_file)

    for required in ("labels", "numTraining", "file_ending"):
        assert required in dataset_json, f"dataset.json is missing required key '{required}'"
    assert (
        "channel_names" in dataset_json or "modality" in dataset_json
    ), "dataset.json needs 'channel_names' (or legacy 'modality')"

    dataset = get_filenames_of_train_images_and_targets(folder, dataset_json)
    assert len(dataset) == dataset_json["numTraining"], (
        f"numTraining ({dataset_json['numTraining']}) does not match the number of cases "
        f"found ({len(dataset)})"
    )

    for k, v in dataset.items():
        for f in v["images"] + [v["label"]]:
            assert os.path.isfile(f), f"Missing file for case {k}: {f}"

    labels = dataset_json["labels"]
    expected_labels = sorted(
        {int(x) for v in labels.values() for x in (v if isinstance(v, (list, tuple)) else [v])}
    )

    readerclass = determine_reader_writer_from_dataset_json(
        dataset_json, dataset[next(iter(dataset))]["images"][0]
    )

    problems: List[str] = []
    for k, v in dataset.items():
        problems += verify_labels(v["label"], readerclass, expected_labels)
        problems += check_case(v["images"], v["label"], readerclass)
    if problems:
        raise RuntimeError(
            "Dataset integrity check failed:\n" + "\n".join(problems)
        )
