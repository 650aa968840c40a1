"""2-D natural image IO (png/bmp) via PIL.

Capability parity with ref: dinounet/imageio/natural_image_reader_writer.py:22
(NaturalImage2DIO; skimage.io replaced by PIL which is available here). Lossy
formats (jpg) are intentionally unsupported — segmentation maps must round-trip.

JAX-free copy of ``dinounet_tpu/imageio/natural_image.py``. PIL is imported
where a file is read or written, not at import, so the registry, the
preprocessor and the predictor import without it; a PNG dataset on a machine
without PIL fails at its first read with an ImportError that names PIL.
"""

from typing import List, Tuple, Union

import numpy as np

from dinounet_tpu_torch.imageio.base import BaseReaderWriter


def pil_image():
    """PIL's ``Image`` module, imported on first use."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading or writing natural images (.png, .bmp, .tif) "
                          "needs PIL (Pillow), which is not installed") from e
    return Image


class NaturalImage2DIO(BaseReaderWriter):
    supported_file_endings = [".png", ".bmp", ".tif"]

    def read_images(self, image_fnames: Union[List[str], Tuple[str, ...]]) -> Tuple[np.ndarray, dict]:
        images = []
        for f in image_fnames:
            npy_img = np.asarray(pil_image().open(f))
            if npy_img.ndim == 3:
                assert npy_img.shape[-1] in (3, 4), (
                    f"3-dim image must be RGB(A); got shape {npy_img.shape}"
                )
                images.append(npy_img.transpose((2, 0, 1))[:, None])
            elif npy_img.ndim == 2:
                images.append(npy_img[None, None])
            else:
                raise RuntimeError(f"Unsupported image ndim {npy_img.ndim} in {f}")
        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"Input images have mismatched shapes: {[i.shape for i in images]}")
        return np.vstack(images).astype(np.float32), {"spacing": (999, 1, 1)}

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images((seg_fname,))

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict) -> None:
        arr = seg[0] if seg.ndim == 3 else seg
        pil_image().fromarray(arr.astype(np.uint8, copy=False)).save(output_fname)
