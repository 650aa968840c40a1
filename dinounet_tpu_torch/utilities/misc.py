"""Cross-validation splits, dataset-name resolution and the results
folder's name (JAX-free copies of ``dinounet_tpu/utilities/misc.py``; ref:
dinounet/utilities/{crossval_split.py,dataset_name_id_conversion.py,
file_path_utilities.py})."""

import os
from typing import List, Union

import numpy as np


def generate_crossval_split(train_identifiers: List[str], seed: int = 12345,
                            n_splits: int = 5) -> List[dict]:
    """The splits of sklearn's KFold(n_splits, shuffle=True,
    random_state=seed), without sklearn: the identifiers are shuffled by
    np.random.RandomState(seed), cut into n_splits consecutive folds (the
    first n % n_splits one longer), and each fold's train and val lists keep
    the identifiers' original order."""
    ids = np.array(train_identifiers)
    n = len(ids)
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[:n % n_splits] += 1
    splits, start = [], 0
    for size in sizes:
        val = np.zeros(n, dtype=bool)
        val[order[start:start + size]] = True
        splits.append({"train": [str(i) for i in ids[~val]],
                       "val": [str(i) for i in ids[val]]})
        start += size
    return splits


def maybe_convert_to_dataset_name(dataset_name_or_id: Union[int, str]) -> str:
    """An integer id (or a 'DatasetXXX_name' string) -> the dataset folder
    name found under nnUNet_raw / nnUNet_preprocessed / nnUNet_results."""
    if isinstance(dataset_name_or_id, str) and dataset_name_or_id.startswith("Dataset"):
        return dataset_name_or_id
    try:
        dataset_id = int(dataset_name_or_id)
    except ValueError:
        raise ValueError("dataset_name_or_id must be an int or a 'DatasetXXX_name' "
                         f"string, got {dataset_name_or_id}")
    from dinounet_tpu_torch import paths

    candidates = set()
    for base_fn in (paths.nnUNet_raw, paths.nnUNet_preprocessed, paths.nnUNet_results):
        try:
            base = base_fn()
        except RuntimeError:
            continue
        if os.path.isdir(base):
            candidates.update(d for d in os.listdir(base)
                              if d.startswith(f"Dataset{dataset_id:03d}_")
                              and os.path.isdir(os.path.join(base, d)))
    if len(candidates) != 1:
        raise RuntimeError(f"found {len(candidates)} datasets with id {dataset_id} "
                           f"in nnUNet_raw/preprocessed/results: {sorted(candidates)}")
    return candidates.pop()


def convert_identifier_to_trained_model_output_folder(
        dataset_name: str, trainer_name: str, plans_identifier: str,
        configuration: str) -> str:
    """results/<dataset>/<Trainer>__<plans>__<config> (ref:
    file_path_utilities.py:19)."""
    from dinounet_tpu_torch import paths

    return os.path.join(paths.nnUNet_results(), dataset_name,
                        f"{trainer_name}__{plans_identifier}__{configuration}")
