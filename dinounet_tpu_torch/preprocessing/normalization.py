"""Intensity normalization schemes.

Capability parity with ref: dinounet/preprocessing/normalization/
default_normalization_schemes.py:8-97 and map_channel_name_to_normalization.py.

JAX-free copy of ``dinounet_tpu/preprocessing/normalization.py``.
"""

from abc import ABC, abstractmethod
from typing import Type

import numpy as np


class ImageNormalization(ABC):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = None

    def __init__(self, use_mask_for_norm: bool = None, intensityproperties: dict = None,
                 target_dtype=np.float32):
        assert use_mask_for_norm is None or isinstance(use_mask_for_norm, bool)
        self.use_mask_for_norm = use_mask_for_norm
        assert isinstance(intensityproperties, dict)
        self.intensityproperties = intensityproperties
        self.target_dtype = target_dtype

    @abstractmethod
    def run(self, image: np.ndarray, seg: np.ndarray = None) -> np.ndarray:
        ...


class ZScoreNormalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = True

    def run(self, image, seg=None):
        image = image.astype(self.target_dtype, copy=False)
        if self.use_mask_for_norm:
            # seg < 0 encodes the cropped-away 'outside' region; normalize inside only
            mask = seg >= 0
            mean = image[mask].mean()
            std = image[mask].std()
            image[mask] = (image[mask] - mean) / max(std, 1e-8)
        else:
            mean = image.mean()
            std = image.std()
            image -= mean
            image /= max(std, 1e-8)
        return image


class CTNormalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image, seg=None):
        assert self.intensityproperties, "CTNormalization requires intensity properties"
        lower = self.intensityproperties["percentile_00_5"]
        upper = self.intensityproperties["percentile_99_5"]
        image = image.astype(self.target_dtype, copy=False)
        np.clip(image, lower, upper, out=image)
        image -= self.intensityproperties["mean"]
        image /= max(self.intensityproperties["std"], 1e-8)
        return image


class NoNormalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image, seg=None):
        return image.astype(self.target_dtype, copy=False)


class RescaleTo01Normalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image, seg=None):
        image = image.astype(self.target_dtype, copy=False)
        image -= image.min()
        image /= np.clip(image.max(), a_min=1e-8, a_max=None)
        return image


class RGBTo01Normalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image, seg=None):
        assert image.min() >= 0 and image.max() <= 255, (
            "RGB images must be uint8-valued in [0, 255]"
        )
        image = image.astype(self.target_dtype, copy=False)
        image /= 255.0
        return image


channel_name_to_normalization_mapping = {
    "CT": CTNormalization,
    "noNorm": NoNormalization,
    "zscore": ZScoreNormalization,
    "rescale_to_0_1": RescaleTo01Normalization,
    "rgb_to_0_1": RGBTo01Normalization,
}

_by_class_name = {
    cls.__name__: cls
    for cls in (ZScoreNormalization, CTNormalization, NoNormalization,
                RescaleTo01Normalization, RGBTo01Normalization)
}


def get_normalization_scheme(channel_name: str) -> Type[ImageNormalization]:
    """Channel name -> scheme; unknown names default to z-score (ref behavior)."""
    return channel_name_to_normalization_mapping.get(channel_name, ZScoreNormalization)


def get_normalization_scheme_by_name(class_name: str) -> Type[ImageNormalization]:
    """Resolve scheme class names stored in plans.json configurations."""
    return _by_class_name[class_name]
