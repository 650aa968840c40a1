"""New-style merged patch loader over the new dataset backends.

Counterpart of ``dinounet_tpu/training/data_loader.py`` (host code): one
seed gives the same batches in both packages, whichever backend stores the
cases. Capability parity with the reference's `nnUNetDataLoader`
(ref dinounet/training/dataloading/data_loader.py:19-221), which its own
trainer does not use yet but which is public surface. Differences from the
legacy loaders in dataloading.py (the trainer's path):

  * works over `nnUNetBaseDataset` backends (nnunet_dataset.py) whose
    load_case returns (data, seg, seg_prev, properties) with the
    previous-stage segmentation kept separate (vstacked here, ref :183);
  * one class for 2-D and 3-D: a 2-D patch size becomes pseudo-3-D
    (1, h, w) internally and the singleton axis is squeezed before
    returning (ref :38-43, :196-198);
  * the ignore-label "annotated" key is ``tuple([-1] + all_labels)``
    (ref :64);
  * crop-and-pad uses value 0 for data and -1 for seg over the bbox, which
    may extend past the image bounds (ref :180-183).

The reference runs batchgenerators transforms inside the loader (torch,
thread-limited, ref :199-219); here ``transforms`` is an optional callable
``(data (B, C, *patch) f32, seg (B, C, *patch) i16) -> (data, target)``
hook — the trainer applies augmentation on the device after upload
(training/augmentation.py), so the hook exists for API parity and host-side
use, not for the hot path.
"""

import warnings
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from dinounet_tpu_torch.training.nnunet_dataset import nnUNetBaseDataset


def crop_and_pad_nd(arr: np.ndarray, bbox: Sequence[Sequence[int]],
                    pad_value=0) -> np.ndarray:
    """Crop the trailing len(bbox) dims of `arr` to [lb, ub) boxes that may
    extend beyond the array bounds; out-of-bounds voxels become pad_value
    (ref: acvl_utils crop_and_pad_nd as used at data_loader.py:180-183)."""
    n_lead = arr.ndim - len(bbox)
    slices = [slice(None)] * n_lead
    pads = [(0, 0)] * n_lead
    for (lb, ub), size in zip(bbox, arr.shape[n_lead:]):
        slices.append(slice(max(lb, 0), min(ub, size)))
        pads.append((max(0, -lb), max(0, ub - size)))
    out = arr[tuple(slices)]
    if any(p != (0, 0) for p in pads):
        out = np.pad(out, pads, mode="constant", constant_values=pad_value)
    return out


class nnUNetDataLoader:
    """Infinite sampler of (batch, channels, *patch) training patches with
    nnU-Net foreground oversampling, over a new-style dataset backend."""

    def __init__(self,
                 data: nnUNetBaseDataset,
                 batch_size: int,
                 patch_size: Union[List[int], Tuple[int, ...], np.ndarray],
                 final_patch_size: Union[List[int], Tuple[int, ...],
                                         np.ndarray],
                 label_manager,
                 oversample_foreground_percent: float = 0.0,
                 sampling_probabilities: Optional[np.ndarray] = None,
                 pad_sides: Optional[Sequence[int]] = None,
                 probabilistic_oversampling: bool = False,
                 transforms=None,
                 seed: Optional[int] = None):
        self._data = data
        self.batch_size = batch_size
        if len(patch_size) == 2:
            # NOTE: the reference's 2-D branch overwrites final_patch_size
            # with patch_size (ref data_loader.py:38-40), making need_to_pad
            # zero for 2-D — unlike its legacy 2-D loader, which keeps the
            # enlarged sampling patch. Kept byte-faithful to the reference
            # (this loader is its dormant new-style surface).
            final_patch_size = (1, *patch_size)
            patch_size = (1, *patch_size)
            self.patch_size_was_2d = True
        else:
            self.patch_size_was_2d = False
        self.indices = list(data.identifiers)
        self.oversample_foreground_percent = oversample_foreground_percent
        self.final_patch_size = tuple(final_patch_size)
        self.patch_size = tuple(patch_size)
        self.need_to_pad = (np.array(self.patch_size)
                            - np.array(self.final_patch_size)).astype(int)
        if pad_sides is not None:
            if self.patch_size_was_2d:
                pad_sides = (0, *pad_sides)
            self.need_to_pad += np.array(pad_sides, int)
        self.pad_sides = pad_sides
        self.data_shape, self.seg_shape = self.determine_shapes()
        self.sampling_probabilities = sampling_probabilities
        self.annotated_classes_key = tuple([-1] + list(label_manager.all_labels))
        self.has_ignore = label_manager.has_ignore_label
        self.probabilistic_oversampling = probabilistic_oversampling
        self.transforms = transforms
        self._rng = np.random.default_rng(seed)

    def get_do_oversample(self, sample_idx: int) -> bool:
        if self.probabilistic_oversampling:
            return bool(self._rng.uniform()
                        < self.oversample_foreground_percent)
        # last round(bs * p) samples of each batch are forced-foreground
        return not sample_idx < round(
            self.batch_size * (1 - self.oversample_foreground_percent))

    def determine_shapes(self):
        data, seg, seg_prev, _ = self._data.load_case(self._data.identifiers[0])
        channels_seg = seg.shape[0] + (1 if seg_prev is not None else 0)
        return ((self.batch_size, data.shape[0], *self.patch_size),
                (self.batch_size, channels_seg, *self.patch_size))

    def get_indices(self) -> List[str]:
        return list(self._rng.choice(self.indices, self.batch_size,
                                     replace=True,
                                     p=self.sampling_probabilities))

    def get_bbox(self, data_shape, force_fg: bool, class_locations,
                 overwrite_class=None):
        """ref data_loader.py:94-165: pad bounds so final patches reach the
        borders, then either a uniform random bbox or one centered on a
        sampled voxel of a chosen (foreground / annotated) class."""
        need_to_pad = self.need_to_pad.copy()
        dim = len(data_shape)
        for d in range(dim):
            if need_to_pad[d] + data_shape[d] < self.patch_size[d]:
                need_to_pad[d] = self.patch_size[d] - data_shape[d]
        lbs = [-need_to_pad[i] // 2 for i in range(dim)]
        ubs = [data_shape[i] + need_to_pad[i] // 2 + need_to_pad[i] % 2
               - self.patch_size[i] for i in range(dim)]

        selected_class = None
        use_class = force_fg or self.has_ignore
        if use_class:
            if not force_fg and self.has_ignore:
                selected_class = self.annotated_classes_key
                if len(class_locations[selected_class]) == 0:
                    warnings.warn("Warning! No annotated pixels in image!")
                    selected_class = None
            else:
                assert class_locations is not None, \
                    "if force_fg is set class_locations cannot be None"
                eligible = [k for k in class_locations.keys()
                            if len(class_locations[k]) > 0]
                is_annot = [k == self.annotated_classes_key
                            if isinstance(k, tuple) else False
                            for k in eligible]
                if any(is_annot) and len(eligible) > 1:
                    eligible.pop(int(np.where(is_annot)[0][0]))
                if len(eligible) == 0:
                    selected_class = None
                elif overwrite_class is not None and overwrite_class in eligible:
                    selected_class = overwrite_class
                else:
                    selected_class = eligible[
                        int(self._rng.integers(len(eligible)))]

        if selected_class is not None:
            voxels = class_locations[selected_class]
            sel = voxels[int(self._rng.integers(len(voxels)))]
            bbox_lbs = [max(lbs[i], sel[i + 1] - self.patch_size[i] // 2)
                        for i in range(dim)]
        else:
            bbox_lbs = [int(self._rng.integers(lbs[i], ubs[i] + 1))
                        for i in range(dim)]
        bbox_ubs = [bbox_lbs[i] + self.patch_size[i] for i in range(dim)]
        return bbox_lbs, bbox_ubs

    def generate_train_batch(self) -> dict:
        selected_keys = self.get_indices()
        data_all = np.zeros(self.data_shape, dtype=np.float32)
        seg_all = np.zeros(self.seg_shape, dtype=np.int16)

        for j, key in enumerate(selected_keys):
            force_fg = self.get_do_oversample(j)
            data, seg, seg_prev, properties = self._data.load_case(key)
            shape = data.shape[1:]
            bbox_lbs, bbox_ubs = self.get_bbox(
                shape, force_fg, properties["class_locations"])
            bbox = [[lb, ub] for lb, ub in zip(bbox_lbs, bbox_ubs)]
            data_all[j] = crop_and_pad_nd(data, bbox, 0)
            seg_cropped = crop_and_pad_nd(seg, bbox, -1)
            if seg_prev is not None:
                # exported prev-stage segs are channel-less (ref :183 adds
                # the channel axis); tolerate an explicit 1-channel form too
                prev = crop_and_pad_nd(seg_prev, bbox, -1)
                if prev.ndim == seg_cropped.ndim - 1:
                    prev = prev[None]
                seg_cropped = np.vstack((seg_cropped, prev))
            seg_all[j] = seg_cropped

        if self.patch_size_was_2d:
            data_all = data_all[:, :, 0]
            seg_all = seg_all[:, :, 0]

        if self.transforms is not None:
            data_all, seg_all = self.transforms(data_all, seg_all)
        return {"data": data_all, "target": seg_all, "keys": selected_keys}

    def __next__(self):
        return self.generate_train_batch()

    def __iter__(self):
        return self
