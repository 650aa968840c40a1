"""Label / region handling.

Capability parity with ref: dinounet/utilities/label_handling/label_handling.py:21-322.
Numpy-based (host side).
"""

from typing import List, Tuple, Union

import numpy as np


class LabelManager:
    """Understands the dataset.json 'labels' dict.

    Two modes:
      - plain labels: {'background': 0, 'organ': 1, ...}; inference nonlin is softmax,
        segmentation = argmax.
      - overlapping regions: values may be tuples/lists of label ints;
        ``regions_class_order`` gives the label painted for each region channel in
        order; inference nonlin is sigmoid, thresholded at 0.5.
    An optional 'ignore' label is excluded from training/eval losses.
    """

    def __init__(self, label_dict: dict, regions_class_order: Union[List[int], None],
                 force_use_labels: bool = False, inference_nonlin=None):
        self._label_dict = label_dict
        self._regions_class_order = regions_class_order
        self._force_use_labels = force_use_labels
        self._sanity_check(label_dict)

        if force_use_labels:
            self._has_regions = False
        else:
            self._has_regions = any(
                isinstance(v, (tuple, list)) and len(v) > 1 for v in label_dict.values()
            )
        self._ignore_label = self._determine_ignore_label()
        self._all_labels = self._get_all_labels()
        self._regions = self._get_regions()
        if self.has_regions:
            assert regions_class_order is not None, (
                "regions_class_order is required when region-based training is used"
            )
            assert len(regions_class_order) == len(self._regions)
        self.inference_nonlin = inference_nonlin

    def _sanity_check(self, label_dict: dict):
        if "background" not in label_dict:
            raise RuntimeError("Background label not declared (needs to be named 'background')")
        bg = label_dict["background"]
        if isinstance(bg, (tuple, list)):
            raise RuntimeError("Background label must be one integer, not a region")
        if int(bg) != 0:
            raise RuntimeError("Background label must be 0")

    def _get_all_labels(self) -> List[int]:
        all_labels = []
        for k, r in self._label_dict.items():
            if k == "ignore":
                continue
            if isinstance(r, (tuple, list)):
                all_labels.extend(int(x) for x in r)
            else:
                all_labels.append(int(r))
        return sorted(set(all_labels))

    def _get_regions(self):
        if not self._has_regions:
            return None
        regions = []
        for k, r in self._label_dict.items():
            if k == "ignore":
                continue
            if isinstance(r, (tuple, list)):
                r = tuple(int(x) for x in r)
                if len(r) == 1:
                    r = r[0]
            else:
                r = int(r)
            if r == 0 or r == (0,):
                continue
            regions.append(r)
        assert len(self._regions_class_order or []) in (0, len(regions)) or True
        return regions

    def _determine_ignore_label(self):
        ig = self._label_dict.get("ignore")
        if ig is not None:
            assert not isinstance(ig, (tuple, list)), "ignore label must be an int"
            ig = int(ig)
        return ig

    @property
    def has_regions(self) -> bool:
        return self._has_regions

    @property
    def has_ignore_label(self) -> bool:
        return self._ignore_label is not None

    @property
    def all_regions(self):
        return self._regions

    @property
    def all_labels(self) -> List[int]:
        return self._all_labels

    @property
    def ignore_label(self):
        return self._ignore_label

    @staticmethod
    def filter_background(classes_or_regions):
        return [
            c for c in classes_or_regions
            if not (
                (isinstance(c, (tuple, list)) and 0 in c) or (not isinstance(c, (tuple, list)) and c == 0)
            )
        ]

    @property
    def foreground_regions(self):
        return self.filter_background(self.all_regions) if self.has_regions else None

    @property
    def foreground_labels(self):
        return self.filter_background(self.all_labels)

    @property
    def num_segmentation_heads(self) -> int:
        return len(self.foreground_regions) if self.has_regions else len(self.all_labels)

    # ---- inference-side conversions (numpy) ----

    def apply_inference_nonlin(self, logits: np.ndarray) -> np.ndarray:
        logits = logits.astype(np.float32, copy=False)
        if self.has_regions:
            return 1.0 / (1.0 + np.exp(-logits))
        m = logits.max(0, keepdims=True)
        e = np.exp(logits - m)
        return e / e.sum(0, keepdims=True)

    def convert_probabilities_to_segmentation(self, probs: np.ndarray) -> np.ndarray:
        if self.has_regions:
            seg = np.zeros(probs.shape[1:], dtype=np.uint8 if max(self.all_labels) < 255 else np.uint16)
            for i, lab in enumerate(self._regions_class_order):
                seg[probs[i] > 0.5] = lab
            return seg
        return probs.argmax(0).astype(
            np.uint8 if max(self.all_labels) < 255 else np.uint16
        )

    def convert_logits_to_segmentation(self, logits: np.ndarray) -> np.ndarray:
        return self.convert_probabilities_to_segmentation(self.apply_inference_nonlin(logits))

    def revert_cropping_on_probabilities(self, probs: np.ndarray, bbox: List[List[int]],
                                         original_shape: Tuple[int, ...]) -> np.ndarray:
        out = np.zeros((probs.shape[0], *original_shape), dtype=probs.dtype)
        if not self.has_regions:
            out[0] = 1.0  # background probability outside the crop
        slices = tuple([slice(None)] + [slice(b[0], b[1]) for b in bbox])
        out[slices] = probs
        return out


def convert_labelmap_to_one_hot(segmentation: np.ndarray, all_labels: List[int],
                                output_dtype=np.float32) -> np.ndarray:
    """One-hot encode, one channel per entry of all_labels.

    ref: label_handling.py:248.
    """
    out = np.zeros((len(all_labels), *segmentation.shape), dtype=output_dtype)
    for i, lab in enumerate(all_labels):
        out[i] = segmentation == lab
    return out


def determine_num_input_channels(plans_manager, configuration_manager, dataset_json: dict) -> int:
    """Image channels (+ one-hot previous-stage channels for cascades).

    ref: label_handling.py:283.
    """
    label_manager = plans_manager.get_label_manager(dataset_json)
    num_modalities = len(dataset_json.get("channel_names", dataset_json.get("modality", {})))
    if configuration_manager.previous_stage_name is not None:
        num_fg = len(label_manager.foreground_labels)
        return num_modalities + num_fg
    return num_modalities
