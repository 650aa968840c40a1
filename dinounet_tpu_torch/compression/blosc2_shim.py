"""python-blosc2-compatible module surface over the pure-Python engine.

Counterpart of ``dinounet_tpu/compression/blosc2_shim.py``.

Exposes exactly the names the Blosc2 dataset backend uses
(ref dinounet/training/dataloading/nnunet_dataset.py:9-11,229-295):
``open``, ``asarray``, ``set_nthreads``, ``Codec``, ``Filter``,
``SplitMode``. training/nnunet_dataset.py imports this module when the real
python-blosc2 is absent, so ``nnUNetDatasetBlosc2`` executes either way.

Enum values match python-blosc2's (blosc2/blosc2-ext constants) so code
passing ``blosc2.Codec.ZSTD`` round-trips through either implementation.
"""

import enum

import numpy as np

from dinounet_tpu_torch.compression.b2nd import B2NDArray, save_b2nd


class Codec(enum.IntEnum):
    BLOSCLZ = 0
    LZ4 = 1
    LZ4HC = 2
    ZLIB = 4
    ZSTD = 5


class Filter(enum.IntEnum):
    NOFILTER = 0
    SHUFFLE = 1
    BITSHUFFLE = 2
    DELTA = 3
    TRUNC_PREC = 4


class SplitMode(enum.IntEnum):
    ALWAYS_SPLIT = 1
    NEVER_SPLIT = 2
    AUTO_SPLIT = 3
    FORWARD_COMPAT_SPLIT = 4


_CODEC_NAMES = {Codec.ZSTD: "zstd", Codec.ZLIB: "zlib"}


def set_nthreads(n: int) -> int:
    """No-op: the pure-Python engine is single-threaded by construction
    (the loader pipeline parallelizes over cases, matching the backend's
    own set_nthreads(1) policy)."""
    return 1


def open(urlpath: str, mode: str = "r", dparams=None, mmap_mode=None,
         **_kwargs) -> B2NDArray:
    if mode not in ("r", "rb"):
        raise NotImplementedError("the shim opens b2nd files read-only")
    return B2NDArray(urlpath)


def asarray(array: np.ndarray, urlpath: str = None, chunks=None, blocks=None,
            cparams=None, **_kwargs):
    if urlpath is None:
        raise NotImplementedError("the shim only writes to a urlpath")
    cparams = dict(cparams or {})
    codec = cparams.get("codec", Codec.ZSTD)
    codec_name = _CODEC_NAMES.get(Codec(codec) if not isinstance(codec, str)
                                  else codec, None)
    if codec_name is None:
        raise ValueError(f"codec {codec!r} not available in the pure-Python "
                         f"engine (zstd/zlib only)")
    clevel = int(cparams.get("clevel", 8))
    save_b2nd(np.asarray(array), urlpath, chunks=chunks, blocks=blocks,
              clevel=clevel, codec=codec_name)
    return B2NDArray(urlpath)
