"""Host-side codecs of the port, JAX-free copies of
``dinounet_tpu/compression/``:

  * ``minimsgpack`` -- the msgpack subset that the Blosc2 frame headers and
    the JAX package's converted DINOv3 backbones (flax msgpack files) are
    written in;
  * ``blosc1_chunk`` -- the Blosc chunk codec (zstd through ``zstandard``,
    imported on first use, or zlib; byte shuffle; the Blosc2 extended header
    and its all-zero special chunk);
  * ``b2nd`` -- the ``.b2nd`` contiguous-frame container: ``B2NDArray``
    (lazy slices over the mapped file's chunks), ``open_b2nd``,
    ``save_b2nd``;
  * ``blosc2_shim`` -- the python-blosc2 names that
    ``training/nnunet_dataset.py::nnUNetDatasetBlosc2`` calls, over ``b2nd``,
    for where python-blosc2 is not installed.
"""

from dinounet_tpu_torch.compression.b2nd import B2NDArray, open_b2nd, save_b2nd  # noqa: F401
