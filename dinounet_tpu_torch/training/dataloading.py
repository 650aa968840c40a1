"""Preprocessed-dataset access and infinite 2-D and 3-D patch sampling with
foreground oversampling (numpy, on the host).

JAX-free copy of ``dinounet_tpu/training/dataloading.py`` (ref: dinounet/
training/dataloading/{nnunet_dataset.py,base_data_loader.py,
data_loader_2d.py,utils.py}); the same numpy generator gives the same
batches as the JAX package's loader:
  * nnUNetDataset: case dict over <case>.npz/.pkl, preferring unpacked .npy /
    _seg.npy memmaps, optional previous-stage seg channel (cascade).
  * unpack_dataset: npz -> npy memmaps with broken-file repair.
  * nnUNetDataLoader2D: infinite random sampling where the LAST
    round(batch*oversample_pct) samples of each batch are forced to contain
    foreground via the preprocessed class_locations, on a slice that holds
    the chosen class (ref data_loader_2d.py:41-58).
  * nnUNetDataLoader3D: the same sampling, a patch of the whole volume
    (ref data_loader_3d.py).

The loader emits numpy batches (B, C, *patch) / (B, 1, *patch); the trainer
moves them to the device, where the augmentation runs.
"""

import os
import pickle
from typing import List, Optional, Tuple, Union

import numpy as np

from dinounet_tpu_torch.utilities.label_handling import LabelManager


class nnUNetDataset:
    def __init__(self, folder: str, case_identifiers: Optional[List[str]] = None,
                 folder_with_segs_from_previous_stage: Optional[str] = None):
        if case_identifiers is None:
            case_identifiers = sorted(
                f[:-4] for f in os.listdir(folder) if f.endswith(".npz")
            )
        self.dataset = {}
        for c in case_identifiers:
            self.dataset[c] = {
                "data_file": os.path.join(folder, c + ".npz"),
                "properties_file": os.path.join(folder, c + ".pkl"),
            }
            if folder_with_segs_from_previous_stage is not None:
                self.dataset[c]["seg_from_prev_stage_file"] = os.path.join(
                    folder_with_segs_from_previous_stage, c + ".npz"
                )

    def keys(self):
        return self.dataset.keys()

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, key):
        return self.dataset[key]

    def load_case(self, key: str) -> Tuple[np.ndarray, np.ndarray, dict]:
        entry = self.dataset[key]
        npy_file = entry["data_file"][:-4] + ".npy"
        seg_npy_file = entry["data_file"][:-4] + "_seg.npy"
        if os.path.isfile(npy_file):
            data = np.load(npy_file, mmap_mode="r")
        else:
            data = np.load(entry["data_file"])["data"]
        if os.path.isfile(seg_npy_file):
            seg = np.load(seg_npy_file, mmap_mode="r")
        else:
            seg = np.load(entry["data_file"])["seg"]

        if "seg_from_prev_stage_file" in entry:
            prev_npy = entry["seg_from_prev_stage_file"][:-4] + "_seg.npy"
            if os.path.isfile(prev_npy):
                prev = np.load(prev_npy, mmap_mode="r")
            else:
                prev = np.load(entry["seg_from_prev_stage_file"])["seg"]
            seg = np.vstack((seg[None] if seg.ndim == 3 else seg,
                             prev[None] if prev.ndim == 3 else prev))

        with open(entry["properties_file"], "rb") as f:
            properties = pickle.load(f)
        return data, seg, properties


def _convert_one(npz_file: str, unpack_segmentation: bool, overwrite: bool):
    """ref dataloading/utils.py:13-60 incl. corrupt-file repair by re-extraction."""
    data_npy = npz_file[:-4] + ".npy"
    seg_npy = npz_file[:-4] + "_seg.npy"
    try:
        a = np.load(npz_file)
        if overwrite or not os.path.isfile(data_npy):
            np.save(data_npy, a["data"])
        if unpack_segmentation and (overwrite or not os.path.isfile(seg_npy)):
            np.save(seg_npy, a["seg"])
    except Exception:
        for f in (data_npy, seg_npy):
            if os.path.isfile(f):
                os.remove(f)
        raise


def unpack_dataset(folder: str, unpack_segmentation: bool = True,
                   overwrite_existing: bool = False, num_processes: int = 8):
    npzs = sorted(
        os.path.join(folder, f) for f in os.listdir(folder) if f.endswith(".npz")
    )
    for f in npzs:
        _convert_one(f, unpack_segmentation, overwrite_existing)


class nnUNetDataLoaderBase:
    """ref base_data_loader.py:10-139."""

    def __init__(self, data: nnUNetDataset, batch_size: int, patch_size,
                 final_patch_size, label_manager: LabelManager,
                 oversample_foreground_percent: float = 0.0,
                 sampling_probabilities=None, pad_sides=None,
                 probabilistic_oversampling: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self._data = data
        self.batch_size = batch_size
        self.indices = list(data.keys())
        self.oversample_foreground_percent = oversample_foreground_percent
        self.final_patch_size = np.array(final_patch_size, dtype=int)
        self.patch_size = np.array(patch_size, dtype=int)
        self.list_of_keys = list(data.keys())
        self.need_to_pad = (self.patch_size - self.final_patch_size).astype(int)
        if pad_sides is not None:
            self.need_to_pad += np.array(pad_sides)
        self.sampling_probabilities = sampling_probabilities
        self.annotated_classes_key = tuple(label_manager.all_labels)
        self.has_ignore = label_manager.has_ignore_label
        self.probabilistic_oversampling = probabilistic_oversampling
        self.rng = rng if rng is not None else np.random.default_rng()
        self.data_shape, self.seg_shape = self.determine_shapes()

    def get_do_oversample(self, sample_idx: int) -> bool:
        if self.probabilistic_oversampling:
            return self.rng.uniform() < self.oversample_foreground_percent
        return not sample_idx < round(
            self.batch_size * (1 - self.oversample_foreground_percent)
        )

    def determine_shapes(self):
        data, seg, _ = self._data.load_case(self.indices[0])
        return (
            (self.batch_size, data.shape[0], *self.patch_size),
            (self.batch_size, seg.shape[0], *self.patch_size),
        )

    def get_indices(self) -> List[str]:
        return list(
            self.rng.choice(self.list_of_keys, self.batch_size, replace=True,
                            p=self.sampling_probabilities)
        )

    def get_bbox(self, data_shape, force_fg: Union[bool, None], class_locations,
                 overwrite_class=None):
        """ref base_data_loader.py:65-139."""
        need_to_pad = self.need_to_pad.copy()
        dim = len(data_shape)
        for d in range(dim):
            if need_to_pad[d] + data_shape[d] < self.patch_size[d]:
                need_to_pad[d] = self.patch_size[d] - data_shape[d]

        lbs = [-need_to_pad[i] // 2 for i in range(dim)]
        ubs = [
            data_shape[i] + need_to_pad[i] // 2 + need_to_pad[i] % 2 - self.patch_size[i]
            for i in range(dim)
        ]

        if not force_fg and not self.has_ignore:
            bbox_lbs = [int(self.rng.integers(lbs[i], ubs[i] + 1)) for i in range(dim)]
        else:
            if not force_fg and self.has_ignore:
                selected_class = self.annotated_classes_key
                if len(class_locations[selected_class]) == 0:
                    selected_class = None
            elif force_fg:
                assert class_locations is not None
                eligible = [k for k in class_locations.keys() if len(class_locations[k]) > 0]
                tmp = [k == self.annotated_classes_key if isinstance(k, tuple) else False
                       for k in eligible]
                if any(tmp) and len(eligible) > 1:
                    eligible.pop(int(np.where(tmp)[0][0]))
                if len(eligible) == 0:
                    selected_class = None
                else:
                    selected_class = (
                        eligible[self.rng.choice(len(eligible))]
                        if (overwrite_class is None or overwrite_class not in eligible)
                        else overwrite_class
                    )
            else:
                raise RuntimeError("invalid force_fg/has_ignore combination")
            voxels = class_locations[selected_class] if selected_class is not None else None
            if voxels is not None and len(voxels) > 0:
                sel = voxels[self.rng.choice(len(voxels))]
                bbox_lbs = [
                    max(lbs[i], sel[i + 1] - self.patch_size[i] // 2) for i in range(dim)
                ]
            else:
                bbox_lbs = [int(self.rng.integers(lbs[i], ubs[i] + 1)) for i in range(dim)]

        bbox_ubs = [bbox_lbs[i] + self.patch_size[i] for i in range(dim)]
        return bbox_lbs, bbox_ubs

    def _crop_and_pad(self, data, seg, bbox_lbs, bbox_ubs, shape):
        dim = len(shape)
        valid_lbs = [max(0, bbox_lbs[i]) for i in range(dim)]
        valid_ubs = [min(shape[i], bbox_ubs[i]) for i in range(dim)]
        slicer = tuple([slice(None)] + [slice(i, j) for i, j in zip(valid_lbs, valid_ubs)])
        data = data[slicer]
        seg = seg[slicer]
        padding = [(-min(0, bbox_lbs[i]), max(bbox_ubs[i] - shape[i], 0)) for i in range(dim)]
        data = np.pad(np.asarray(data), ((0, 0), *padding), "constant", constant_values=0)
        seg = np.pad(np.asarray(seg), ((0, 0), *padding), "constant", constant_values=-1)
        return data, seg


class nnUNetDataLoader2D(nnUNetDataLoaderBase):
    """ref data_loader_2d.py:6-88: class-aware slice selection + bbox crop."""

    def generate_train_batch(self) -> dict:
        selected_keys = self.get_indices()
        data_all = np.zeros(self.data_shape, dtype=np.float32)
        seg_all = np.zeros(self.seg_shape, dtype=np.int16)
        case_properties = []

        for j, key in enumerate(selected_keys):
            force_fg = self.get_do_oversample(j)
            data, seg, properties = self._data.load_case(key)
            case_properties.append(properties)

            if not force_fg:
                selected_class = self.annotated_classes_key if self.has_ignore else None
            else:
                eligible = [
                    k for k in properties["class_locations"].keys()
                    if len(properties["class_locations"][k]) > 0
                ]
                tmp = [k == self.annotated_classes_key if isinstance(k, tuple) else False
                       for k in eligible]
                if any(tmp) and len(eligible) > 1:
                    eligible.pop(int(np.where(tmp)[0][0]))
                selected_class = (
                    eligible[self.rng.choice(len(eligible))] if len(eligible) > 0 else None
                )

            if selected_class is not None:
                locs = properties["class_locations"][selected_class]
                selected_slice = locs[self.rng.choice(len(locs))][1]
            else:
                selected_slice = self.rng.choice(data.shape[1])

            data2d = data[:, selected_slice]
            seg2d = seg[:, selected_slice]

            class_locations = None
            if selected_class is not None:
                locs = properties["class_locations"][selected_class]
                class_locations = {
                    selected_class: locs[locs[:, 1] == selected_slice][:, (0, 2, 3)]
                }

            shape = data2d.shape[1:]
            bbox_lbs, bbox_ubs = self.get_bbox(
                shape, force_fg if selected_class is not None else None,
                class_locations, overwrite_class=selected_class,
            )
            d, s = self._crop_and_pad(data2d, seg2d, bbox_lbs, bbox_ubs, shape)
            data_all[j] = d
            seg_all[j] = s

        return {"data": data_all, "seg": seg_all, "properties": case_properties,
                "keys": selected_keys}


class nnUNetDataLoader3D(nnUNetDataLoaderBase):
    """ref data_loader_3d.py:6-56: a bbox crop of the whole volume."""

    def generate_train_batch(self) -> dict:
        selected_keys = self.get_indices()
        data_all = np.zeros(self.data_shape, dtype=np.float32)
        seg_all = np.zeros(self.seg_shape, dtype=np.int16)
        case_properties = []

        for j, key in enumerate(selected_keys):
            force_fg = self.get_do_oversample(j)
            data, seg, properties = self._data.load_case(key)
            case_properties.append(properties)
            shape = data.shape[1:]
            bbox_lbs, bbox_ubs = self.get_bbox(
                shape, force_fg, properties.get("class_locations"))
            data_all[j], seg_all[j] = self._crop_and_pad(data, seg, bbox_lbs,
                                                         bbox_ubs, shape)

        return {"data": data_all, "seg": seg_all, "properties": case_properties,
                "keys": selected_keys}
