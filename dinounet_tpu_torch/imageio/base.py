"""Reader/writer contract.

Capability parity with ref: dinounet/imageio/base_reader_writer.py:22-106:
images come back as a float32 (c, x, y, z) stack with axis-aligned
``properties['spacing']`` (length 3); 2-D images are encoded as (c, 1, X, Y)
with a dummy leading spacing of ~999 so the planner treats the first axis as
out-of-plane.

JAX-free copy of ``dinounet_tpu/imageio/base.py``.
"""

from abc import ABC, abstractmethod
from typing import List, Tuple, Union

import numpy as np


class BaseReaderWriter(ABC):
    supported_file_endings: List[str] = []

    @staticmethod
    def _check_all_same(items) -> bool:
        return all(
            np.array_equal(np.asarray(i, dtype=object), np.asarray(items[0], dtype=object))
            if isinstance(i, (tuple, list, np.ndarray)) else i == items[0]
            for i in items
        )

    @abstractmethod
    def read_images(self, image_fnames: Union[List[str], Tuple[str, ...]]) -> Tuple[np.ndarray, dict]:
        """-> ((c, x, y, z) float32 array, {'spacing': [a, b, c], ...})."""

    @abstractmethod
    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        ...

    @abstractmethod
    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict) -> None:
        ...
