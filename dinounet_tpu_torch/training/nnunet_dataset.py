"""New-style preprocessed-dataset backends (Numpy / Blosc2).

Counterpart of ``dinounet_tpu/training/nnunet_dataset.py``, host code with
the same names, files and answers. Capability parity with the reference's newer dataset classes, which its own
trainer does not use yet but which are public surface
(ref dinounet/training/dataloading/nnunet_dataset.py:122-418):

  * nnUNetBaseDataset       — the backend interface (:122-164)
  * nnUNetDatasetNumpy      — .npz/.npy(+memmap) backend (:167-222)
  * nnUNetDatasetBlosc2     — .b2nd compressed-chunk backend (:225-401);
                              runs on python-blosc2 when installed, else on
                              the in-tree pure-Python b2nd engine
                              (dinounet_tpu_torch/compression; zstd via
                              zstandard where it is installed, zlib always)
  * comp_blosc2_params      — cache-aware chunk/block sizing (:311-401),
                              pure math, usable without blosc2
  * infer_dataset_class     — pick the backend from the folder contents (:404-418)

Unlike the legacy ``nnUNetDataset`` (dataloading.py), ``load_case`` here
returns a 4-tuple ``(data, seg, seg_prev, properties)`` with the
previous-stage segmentation kept separate — the new-style contract.
"""

import math
import os
import pickle
from abc import ABC, abstractmethod
from typing import List, Optional, Sequence, Tuple, Type

import numpy as np

try:  # prefer the real package when a deployment installs it
    import blosc2  # type: ignore
    _BLOSC2_IMPL = "python-blosc2"
except ImportError:
    # fall back to the in-tree pure-Python engine (compression/): same
    # .b2nd container, zstd via zstandard where it is installed, the blosc
    # chunk layer held against libblosc (tests/test_torch_b2nd.py)
    from dinounet_tpu_torch.compression import blosc2_shim as blosc2
    _BLOSC2_IMPL = "dinounet_tpu_torch.compression"


def _load_pickle(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def _write_pickle(obj, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


class nnUNetBaseDataset(ABC):
    """Backend interface: a folder of preprocessed cases addressed by identifier."""

    def __init__(self, folder: str, identifiers: Optional[List[str]] = None,
                 folder_with_segs_from_previous_stage: Optional[str] = None):
        if identifiers is None:
            identifiers = self.get_identifiers(folder)
        self.source_folder = folder
        self.folder_with_segs_from_previous_stage = folder_with_segs_from_previous_stage
        self.identifiers = sorted(identifiers)

    def __getitem__(self, identifier: str):
        return self.load_case(identifier)

    def __len__(self) -> int:
        return len(self.identifiers)

    def keys(self):
        return list(self.identifiers)

    @abstractmethod
    def load_case(self, identifier: str) -> Tuple[np.ndarray, np.ndarray,
                                                  Optional[np.ndarray], dict]:
        """Returns (data, seg, seg_from_previous_stage_or_None, properties)."""

    @staticmethod
    @abstractmethod
    def save_case(data: np.ndarray, seg: np.ndarray, properties: dict,
                  output_filename_truncated: str) -> None:
        ...

    @staticmethod
    @abstractmethod
    def get_identifiers(folder: str) -> List[str]:
        ...

    @staticmethod
    def unpack_dataset(folder: str, overwrite_existing: bool = False,
                       num_processes: int = 8, verify: bool = True) -> None:
        """Optional ahead-of-time decompression; no-op unless a backend needs it."""


class nnUNetDatasetNumpy(nnUNetBaseDataset):
    """Cases stored as <id>.npz (+ optional unpacked <id>.npy / <id>_seg.npy memmaps)."""

    @staticmethod
    def _load_array(folder: str, identifier: str, npz_key: str,
                    npy_suffix: str) -> np.ndarray:
        npy = os.path.join(folder, identifier + npy_suffix)
        if os.path.isfile(npy):
            return np.load(npy, mmap_mode="r")
        return np.load(os.path.join(folder, identifier + ".npz"))[npz_key]

    def load_case(self, identifier: str):
        data = self._load_array(self.source_folder, identifier, "data", ".npy")
        seg = self._load_array(self.source_folder, identifier, "seg", "_seg.npy")
        seg_prev = None
        if self.folder_with_segs_from_previous_stage is not None:
            seg_prev = self._load_array(
                self.folder_with_segs_from_previous_stage, identifier, "seg", ".npy")
        properties = _load_pickle(os.path.join(self.source_folder, identifier + ".pkl"))
        return data, seg, seg_prev, properties

    @staticmethod
    def save_case(data: np.ndarray, seg: np.ndarray, properties: dict,
                  output_filename_truncated: str) -> None:
        np.savez_compressed(output_filename_truncated + ".npz", data=data, seg=seg)
        _write_pickle(properties, output_filename_truncated + ".pkl")

    @staticmethod
    def save_seg(seg: np.ndarray, output_filename_truncated: str) -> None:
        np.savez_compressed(output_filename_truncated + ".npz", seg=seg)

    @staticmethod
    def get_identifiers(folder: str) -> List[str]:
        return sorted(f[:-4] for f in os.listdir(folder) if f.endswith(".npz"))

    @staticmethod
    def unpack_dataset(folder: str, overwrite_existing: bool = False,
                       num_processes: int = 8, verify: bool = True) -> None:
        from dinounet_tpu_torch.training.dataloading import unpack_dataset
        unpack_dataset(folder, unpack_segmentation=True,
                       overwrite_existing=overwrite_existing,
                       num_processes=num_processes)


class nnUNetDatasetBlosc2(nnUNetBaseDataset):
    """Cases stored as <id>.b2nd / <id>_seg.b2nd blosc2 NDim containers.

    Uses python-blosc2 when installed, otherwise the in-tree pure-Python
    engine (dinounet_tpu_torch/compression) — same container format, lazy
    block-granular patch reads either way.
    """

    def __init__(self, folder: str, identifiers: Optional[List[str]] = None,
                 folder_with_segs_from_previous_stage: Optional[str] = None):
        super().__init__(folder, identifiers, folder_with_segs_from_previous_stage)
        blosc2.set_nthreads(1)

    @staticmethod
    def _open(path: str):
        # single-threaded decompression: the loader pipeline parallelizes over
        # cases, not within one read
        return blosc2.open(urlpath=path, mode="r", dparams={"nthreads": 1},
                           mmap_mode="r")

    def load_case(self, identifier: str):
        data = self._open(os.path.join(self.source_folder, identifier + ".b2nd"))
        seg = self._open(os.path.join(self.source_folder, identifier + "_seg.b2nd"))
        seg_prev = None
        if self.folder_with_segs_from_previous_stage is not None:
            seg_prev = self._open(os.path.join(
                self.folder_with_segs_from_previous_stage, identifier + ".b2nd"))
        properties = _load_pickle(os.path.join(self.source_folder, identifier + ".pkl"))
        return data, seg, seg_prev, properties

    @staticmethod
    def save_case(data: np.ndarray, seg: np.ndarray, properties: dict,
                  output_filename_truncated: str, chunks=None, blocks=None,
                  chunks_seg=None, blocks_seg=None, clevel: int = 8,
                  codec=None) -> None:
        blosc2.set_nthreads(1)
        if chunks_seg is None:
            chunks_seg = chunks
        if blocks_seg is None:
            blocks_seg = blocks
        cparams = {"codec": codec if codec is not None else blosc2.Codec.ZSTD,
                   "clevel": clevel}
        blosc2.asarray(np.ascontiguousarray(data),
                       urlpath=output_filename_truncated + ".b2nd",
                       chunks=chunks, blocks=blocks, cparams=cparams)
        blosc2.asarray(np.ascontiguousarray(seg),
                       urlpath=output_filename_truncated + "_seg.b2nd",
                       chunks=chunks_seg, blocks=blocks_seg, cparams=cparams)
        _write_pickle(properties, output_filename_truncated + ".pkl")

    @staticmethod
    def save_seg(seg: np.ndarray, output_filename_truncated: str,
                 chunks_seg=None, blocks_seg=None) -> None:
        blosc2.asarray(np.ascontiguousarray(seg),
                       urlpath=output_filename_truncated + ".b2nd",
                       chunks=chunks_seg, blocks=blocks_seg)

    @staticmethod
    def get_identifiers(folder: str) -> List[str]:
        return sorted(f[:-5] for f in os.listdir(folder)
                      if f.endswith(".b2nd") and not f.endswith("_seg.b2nd"))


def comp_blosc2_params(
        image_size: Sequence[int],
        patch_size: Sequence[int],
        bytes_per_pixel: int = 4,
        l1_cache_size_per_core_in_bytes: int = 32768,
        l3_cache_size_per_core_in_bytes: int = 1441792,
        safety_factor: float = 0.8,
) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Cache-aware (blocks, chunks) for blosc2 NDim storage of one case.

    Same sizing policy as the reference (nnunet_dataset.py:311-401): a block
    is a per-axis power-of-two cover of the patch shrunk until it fits the L1
    budget (one decompression touches one core), and a chunk tiles blocks
    outward until it hits the L3 budget, the image bounds, or ~1.5x the patch
    on average — so one patch read decompresses O(1) chunks. Pure math; does
    not need blosc2 itself.

    image_size is (c, x, y, z); patch_size is spatial-only ((x, y) -> (1, x, y)).
    """
    image_size = tuple(int(i) for i in image_size)
    patch = [int(p) for p in patch_size]
    if len(patch) == 2:
        patch = [1] + patch
    if len(image_size) != 4 or len(patch) != 3:
        raise ValueError("image_size must be (c,x,y,z) and patch_size 2-D/3-D")
    channels = image_size[0]
    l1_budget = l1_cache_size_per_core_in_bytes * safety_factor
    l3_budget = l3_cache_size_per_core_in_bytes * safety_factor

    def pow2_ceil(v: int) -> int:
        return 2 ** max(0, math.ceil(math.log2(v)))

    # block: power-of-two cover of the patch, shrunk (largest patch-relative
    # axis first, never to 0) until the uncompressed block fits in L1
    spatial = [pow2_ceil(p) for p in patch]
    while channels * np.prod(spatial) * bytes_per_pixel > l1_budget:
        order = np.argsort([s / p for s, p in zip(spatial, patch)])[::-1]
        ax = next((a for a in order if spatial[a] > 1), None)
        if ax is None:
            # channels alone exceed the budget: (c, 1, 1, 1) is the minimal
            # block — settle for it rather than raising
            break
        spatial[ax] = 2 ** max(0, math.floor(math.log2(spatial[ax] - 1)))
        spatial[ax] = min(spatial[ax], image_size[ax + 1])
    blocks = tuple(min(i, j) for i, j in zip(image_size, (channels, *spatial)))

    # chunk: grow from the block toward the image (most-behind axis first,
    # 2-D patches never grow along z) until the L3 budget / image bounds /
    # ~1.5x-patch-average cap
    chunks = list(blocks)
    while np.prod(chunks) * bytes_per_pixel < l3_budget:
        growable = [a for a in range(3)
                    if chunks[a + 1] < image_size[a + 1] and patch[a] != 1]
        if not growable:
            break
        ax = min(growable, key=lambda a: chunks[a + 1] / blocks[a + 1])
        chunks[ax + 1] = min(chunks[ax + 1] + blocks[ax + 1], image_size[ax + 1])
        if np.mean([c / p for c, p in zip(chunks[1:], patch)]) > 1.5:
            chunks[ax + 1] -= blocks[ax + 1]
            break
    chunks = tuple(min(i, j) for i, j in zip(image_size, chunks))
    return blocks, chunks


file_ending_dataset_mapping = {
    "npz": nnUNetDatasetNumpy,
    "b2nd": nnUNetDatasetBlosc2,
}


def infer_dataset_class(folder: str) -> Type[nnUNetBaseDataset]:
    """Pick the backend from the folder's data-file endings (ref :410-418)."""
    endings = {f.rsplit(".", 1)[-1] for f in os.listdir(folder)
               if os.path.isfile(os.path.join(folder, f)) and "." in f}
    endings -= {"pkl", "npy"}  # sidecars / unpacked memmaps
    if len(endings) != 1:
        raise RuntimeError(
            f"found file endings {sorted(endings)} in {folder}; cannot infer "
            f"the dataset backend (expected exactly one of "
            f"{sorted(file_ending_dataset_mapping)})")
    ending = endings.pop()
    if ending not in file_ending_dataset_mapping:
        raise RuntimeError(f"no dataset backend for file ending '{ending}'")
    return file_ending_dataset_mapping[ending]
