"""Raw-dataset folder scanning (imagesTr/labelsTr naming conventions).

Capability parity with ref: dinounet/utilities/utils.py:26-51
(get_identifiers_from_splitted_dataset_folder, create_lists_from_splitted_dataset_folder,
get_filenames_of_train_images_and_targets).

JAX-free copy of ``dinounet_tpu/planning/dataset_utils.py``.
"""

import os
import re
from typing import List, Optional

import numpy as np

from dinounet_tpu_torch.utilities.json_export import load_json


def subfiles(folder: str, suffix: str = None, join: bool = True, sort: bool = True) -> List[str]:
    res = [
        f for f in os.listdir(folder)
        if os.path.isfile(os.path.join(folder, f)) and (suffix is None or f.endswith(suffix))
    ]
    if sort:
        res.sort()
    if join:
        res = [os.path.join(folder, f) for f in res]
    return res


def get_identifiers_from_splitted_dataset_folder(folder: str, file_ending: str) -> List[str]:
    files = subfiles(folder, suffix=file_ending, join=False)
    crop = len(file_ending) + 5  # strip the _XXXX channel index
    return list(np.unique([f[:-crop] for f in files]))


def create_lists_from_splitted_dataset_folder(folder: str, file_ending: str,
                                              identifiers: Optional[List[str]] = None) -> List[List[str]]:
    if identifiers is None:
        identifiers = get_identifiers_from_splitted_dataset_folder(folder, file_ending)
    files = subfiles(folder, suffix=file_ending, join=False, sort=True)
    out = []
    for ident in identifiers:
        p = re.compile(re.escape(ident) + r"_\d\d\d\d" + re.escape(file_ending))
        out.append([os.path.join(folder, f) for f in files if p.fullmatch(f)])
    return out


def get_filenames_of_train_images_and_targets(raw_dataset_folder: str, dataset_json: dict = None) -> dict:
    """-> {case_id: {'images': [...], 'label': ...}}."""
    if dataset_json is None:
        dataset_json = load_json(os.path.join(raw_dataset_folder, "dataset.json"))

    if "dataset" in dataset_json:
        dataset = {k: dict(v) for k, v in dataset_json["dataset"].items()}
        for k, v in dataset.items():
            v["label"] = (
                v["label"] if os.path.isabs(v["label"])
                else os.path.abspath(os.path.join(raw_dataset_folder, v["label"]))
            )
            v["images"] = [
                i if os.path.isabs(i) else os.path.abspath(os.path.join(raw_dataset_folder, i))
                for i in v["images"]
            ]
        return dataset

    file_ending = dataset_json["file_ending"]
    identifiers = get_identifiers_from_splitted_dataset_folder(
        os.path.join(raw_dataset_folder, "imagesTr"), file_ending
    )
    images = create_lists_from_splitted_dataset_folder(
        os.path.join(raw_dataset_folder, "imagesTr"), file_ending, identifiers
    )
    segs = [os.path.join(raw_dataset_folder, "labelsTr", i + file_ending) for i in identifiers]
    return {
        i: {"images": im, "label": se}
        for i, im, se in zip(identifiers, images, segs)
    }
