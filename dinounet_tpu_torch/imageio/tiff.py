"""3-D multipage TIFF IO with a .json spacing sidecar.

Capability parity with ref: dinounet/imageio/tif_reader_writer.py:23 (Tiff3DIO):
each .tif volume has a sibling <name>.json carrying {"spacing": [a, b, c]}.
tifffile is not in this image; PIL's multipage TIFF support covers the format.

JAX-free copy of ``dinounet_tpu/imageio/tiff.py``, with PIL imported where a
file is read or written (see ``natural_image.py``).
"""

import os
from typing import List, Tuple, Union

import numpy as np

from dinounet_tpu_torch.imageio.base import BaseReaderWriter
from dinounet_tpu_torch.imageio.natural_image import pil_image
from dinounet_tpu_torch.utilities.json_export import load_json, save_json


class Tiff3DIO(BaseReaderWriter):
    supported_file_endings = [".tif", ".tiff"]

    @staticmethod
    def _sidecar(fname: str) -> str:
        base = fname
        for end in (".tif", ".tiff"):
            if fname.endswith(end):
                base = fname[: -len(end)]
        return base + ".json"

    def _read_volume(self, fname: str) -> np.ndarray:
        Image = pil_image()
        from PIL import ImageSequence

        with Image.open(fname) as img:
            frames = [np.asarray(frame) for frame in ImageSequence.Iterator(img)]
        return np.stack(frames, axis=0)

    def read_images(self, image_fnames: Union[List[str], Tuple[str, ...]]) -> Tuple[np.ndarray, dict]:
        images, spacings = [], []
        for f in image_fnames:
            vol = self._read_volume(f)
            assert vol.ndim == 3, f"Tiff3DIO expects 3-D volumes, got {vol.shape} in {f}"
            images.append(vol[None])
            sidecar = self._sidecar(f)
            if not os.path.isfile(sidecar):
                raise RuntimeError(f"Missing spacing sidecar {sidecar} for {f}")
            spacings.append(tuple(float(s) for s in load_json(sidecar)["spacing"]))
        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"Input images have mismatched shapes: {[i.shape for i in images]}")
        if not self._check_all_same(spacings):
            raise RuntimeError(f"Input images have mismatched spacings: {spacings}")
        return np.vstack(images).astype(np.float32), {"spacing": list(spacings[0])}

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images((seg_fname,))

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict) -> None:
        assert seg.ndim == 3
        frames = [pil_image().fromarray(s.astype(np.uint8, copy=False)) for s in seg]
        frames[0].save(output_fname, save_all=True, append_images=frames[1:])
        save_json({"spacing": list(properties["spacing"])}, self._sidecar(output_fname))
