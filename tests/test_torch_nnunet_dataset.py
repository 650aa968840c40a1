"""The port's new-style dataset backends and merged loader
(``training/nnunet_dataset.py``, ``training/data_loader.py``) against the
JAX package's.

The cases of tests/test_nnunet_dataset.py and tests/test_new_data_loader.py
run on the port's classes; and the two packages are held to each other:
each reads the ``.npz`` / ``.npy`` and ``.b2nd`` folders that the other
wrote, bit for bit; ``comp_blosc2_params`` and ``infer_dataset_class`` give
the JAX package's answers; ``nnUNetDataLoader`` gives the JAX loader's
batches bit for bit from one seed, over either backend, in 2-D and 3-D, with
a previous stage and with an ignore label.
"""

import os

import numpy as np
import pytest

from dinounet_tpu.training import data_loader as jax_loader
from dinounet_tpu.training import nnunet_dataset as jax_ds
from dinounet_tpu_torch.training.data_loader import crop_and_pad_nd, nnUNetDataLoader
from dinounet_tpu_torch.training.nnunet_dataset import (comp_blosc2_params,
                                                        file_ending_dataset_mapping,
                                                        infer_dataset_class,
                                                        nnUNetDatasetBlosc2,
                                                        nnUNetDatasetNumpy)

BACKENDS = {"numpy": (nnUNetDatasetNumpy, jax_ds.nnUNetDatasetNumpy),
            "blosc2": (nnUNetDatasetBlosc2, jax_ds.nnUNetDatasetBlosc2)}


def _make_case(rng, shape=(2, 1, 8, 9)):
    data = rng.standard_normal(shape).astype(np.float32)
    seg = rng.integers(0, 3, (1,) + shape[1:]).astype(np.int8)
    return data, seg, {"spacing": [999.0, 1.0, 1.0], "class_locations": {}}


def _read(x):
    return np.asarray(x[...])


# ------------------------------------------------------------------ backends


def test_numpy_round_trip_and_identifiers(tmp_path):
    rng = np.random.default_rng(0)
    cases = {}
    for name in ("caseB", "caseA"):
        cases[name] = _make_case(rng)
        nnUNetDatasetNumpy.save_case(*cases[name], str(tmp_path / name))
    assert nnUNetDatasetNumpy.get_identifiers(str(tmp_path)) == ["caseA", "caseB"]
    ds = nnUNetDatasetNumpy(str(tmp_path))
    assert ds.keys() == ["caseA", "caseB"] and len(ds) == 2
    data, seg, seg_prev, props = ds["caseA"]
    np.testing.assert_array_equal(data, cases["caseA"][0])
    np.testing.assert_array_equal(seg, cases["caseA"][1])
    assert seg_prev is None and props["spacing"] == cases["caseA"][2]["spacing"]


def test_numpy_unpack_then_memmap(tmp_path):
    data, seg, props = _make_case(np.random.default_rng(1))
    nnUNetDatasetNumpy.save_case(data, seg, props, str(tmp_path / "c"))
    nnUNetDatasetNumpy.unpack_dataset(str(tmp_path))
    assert os.path.isfile(tmp_path / "c.npy") and os.path.isfile(tmp_path / "c_seg.npy")
    loaded, seg_l, _, _ = nnUNetDatasetNumpy(str(tmp_path)).load_case("c")
    assert isinstance(loaded, np.memmap)
    np.testing.assert_array_equal(np.asarray(loaded), data)
    np.testing.assert_array_equal(np.asarray(seg_l), seg)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_previous_stage_seg(tmp_path, backend):
    cls = BACKENDS[backend][0]
    rng = np.random.default_rng(2)
    cur, prev = tmp_path / "cur", tmp_path / "prev"
    cur.mkdir(), prev.mkdir()
    data, seg, props = _make_case(rng)
    cls.save_case(data, seg, props, str(cur / "c"))
    prev_seg = rng.integers(0, 2, seg.shape).astype(np.int8)
    cls.save_seg(prev_seg, str(prev / "c"))
    out = cls(str(cur), folder_with_segs_from_previous_stage=str(prev)).load_case("c")
    assert len(out) == 4
    np.testing.assert_array_equal(_read(out[2]), prev_seg)


def test_blosc2_round_trip_and_lazy_patch_read(tmp_path):
    data, seg, props = _make_case(np.random.default_rng(5), shape=(2, 12, 40, 48))
    blocks, chunks = comp_blosc2_params(data.shape, (16, 16), data.itemsize)
    nnUNetDatasetBlosc2.save_case(data, seg, props, str(tmp_path / "c"), chunks=chunks,
                                  blocks=blocks)
    assert nnUNetDatasetBlosc2.get_identifiers(str(tmp_path)) == ["c"]
    loaded, seg_l, seg_prev, props_l = nnUNetDatasetBlosc2(str(tmp_path)).load_case("c")
    assert seg_prev is None and props_l["spacing"] == props["spacing"]
    np.testing.assert_array_equal(_read(loaded), data)
    np.testing.assert_array_equal(_read(seg_l), seg)
    np.testing.assert_array_equal(loaded[:, 2:9, 5:21, 30:46], data[:, 2:9, 5:21, 30:46])


def test_blosc2_default_codec_is_zstd_clevel8(tmp_path):
    """The default file is the JAX package's, byte for byte (zstd, clevel 8)."""
    data, seg, props = _make_case(np.random.default_rng(7), shape=(1, 4, 32, 32))
    nnUNetDatasetBlosc2.save_case(data, seg, props, str(tmp_path / "c"))
    jax_ds.nnUNetDatasetBlosc2.save_case(data, seg, props, str(tmp_path / "j"))
    raw = (tmp_path / "c.b2nd").read_bytes()
    assert raw[2:10] == b"b2frame\x00" and raw[26] == (5 | 8 << 4)
    assert raw == (tmp_path / "j.b2nd").read_bytes()
    assert (tmp_path / "c_seg.b2nd").read_bytes() == (tmp_path / "j_seg.b2nd").read_bytes()


@pytest.mark.parametrize("backend, unpacked", [("numpy", False), ("numpy", True),
                                               ("blosc2", False)])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_folders_read_across_packages(tmp_path, writer, backend, unpacked):
    """A folder one package wrote (cases, a previous stage's segmentations,
    unpacked ``.npy`` where asked) is read by the other bit for bit, with
    the same identifiers and properties."""
    port_cls, jax_cls = BACKENDS[backend]
    write, read = (port_cls, jax_cls) if writer == "port" else (jax_cls, port_cls)
    rng = np.random.default_rng(11)
    cur, prev = tmp_path / "cur", tmp_path / "prev"
    cur.mkdir(), prev.mkdir()
    cases = {}
    for name in ("b", "a"):
        data, seg, props = _make_case(rng, shape=(2, 5, 17, 23))
        props["class_locations"] = {1: np.argwhere(seg == 1)[:7]}
        write.save_case(data, seg, props, str(cur / name))
        write.save_seg(seg[0], str(prev / name))
        cases[name] = (data, seg, seg[0], props)
    if unpacked:
        write.unpack_dataset(str(cur))
    ds = read(str(cur), folder_with_segs_from_previous_stage=str(prev))
    assert ds.keys() == ["a", "b"]
    for name, (data, seg, seg_prev, props) in cases.items():
        got = ds.load_case(name)
        for g, want in zip(got[:3], (data, seg, seg_prev)):
            g = _read(g)
            assert g.dtype == want.dtype and g.shape == want.shape
            np.testing.assert_array_equal(g, want)
        np.testing.assert_array_equal(got[3]["class_locations"][1],
                                      props["class_locations"][1])


# --------------------------------------------------------------- infer class


def _folder(tmp_path, kind):
    if kind == "npz":
        nnUNetDatasetNumpy.save_case(*_make_case(np.random.default_rng(3)),
                                     str(tmp_path / "c"))
    elif kind == "npz+npy":
        nnUNetDatasetNumpy.save_case(*_make_case(np.random.default_rng(4)),
                                     str(tmp_path / "c"))
        np.save(str(tmp_path / "c.npy"), np.zeros(3))  # unpacked memmap: a sidecar
    elif kind == "b2nd":
        (tmp_path / "c.b2nd").write_bytes(b"")
        (tmp_path / "c.pkl").write_bytes(b"")
    elif kind == "mixed":
        (tmp_path / "a.npz").write_bytes(b"")
        (tmp_path / "b.b2nd").write_bytes(b"")
    elif kind == "unknown":
        (tmp_path / "a.nii").write_bytes(b"")
    return str(tmp_path)


@pytest.mark.parametrize("kind, want", [("npz", "nnUNetDatasetNumpy"),
                                        ("npz+npy", "nnUNetDatasetNumpy"),
                                        ("b2nd", "nnUNetDatasetBlosc2"),
                                        ("mixed", "cannot infer"),
                                        ("unknown", "no dataset backend")])
def test_infer_dataset_class_gives_jax_answer(tmp_path, kind, want):
    folder = _folder(tmp_path, kind)
    answers = []
    for infer in (infer_dataset_class, jax_ds.infer_dataset_class):
        try:
            answers.append(infer(folder).__name__)
        except RuntimeError as e:
            answers.append(str(e))
    assert answers[0] == answers[1] and want in answers[0]
    if not want.startswith("nn"):
        return
    assert infer_dataset_class(folder) is file_ending_dataset_mapping[
        "b2nd" if kind == "b2nd" else "npz"]


def test_mapping_table():
    assert file_ending_dataset_mapping["npz"] is nnUNetDatasetNumpy
    assert file_ending_dataset_mapping["b2nd"] is nnUNetDatasetBlosc2


# ---------------------------------------------------------- comp_blosc2_params


@pytest.mark.parametrize("image_size, patch, bytes_per_pixel", [
    ((1, 1, 512, 512), (512, 512), 4),
    ((4, 128, 128, 128), (96, 96, 96), 4),
    ((2, 33, 207, 64), (28, 160, 56), 4),
    ((1, 1, 9, 9), (4, 4), 4),
    ((1, 64, 512, 512), (256, 256), 4),
    ((1, 160, 192, 192), (128, 128, 128), 4),
    ((1, 160, 192, 192), (128, 128, 128), 1),
    ((3, 256, 256, 256), (128, 128, 128), 2),
    ((1, 1, 640, 640), (512, 512), 4),
    ((64, 8, 8, 8), (4, 4, 4), 8),
])
def test_comp_blosc2_params_gives_jax_answer(image_size, patch, bytes_per_pixel):
    blocks, chunks = comp_blosc2_params(image_size, patch, bytes_per_pixel)
    assert (blocks, chunks) == jax_ds.comp_blosc2_params(image_size, patch, bytes_per_pixel)
    assert len(blocks) == len(chunks) == 4
    assert np.prod(blocks) * bytes_per_pixel <= 32768 * 0.8 or blocks[1:] == (1, 1, 1)
    for a in range(1, 4):
        assert 1 <= blocks[a] <= chunks[a] <= image_size[a]
        assert chunks[a] == image_size[a] or chunks[a] % blocks[a] == 0
    if len(patch) == 2:
        assert blocks[1] == chunks[1] == 1


# ------------------------------------------------------------------- loader


class _Labels:
    all_labels = [1, 2]
    has_ignore_label = False


class _LabelsIgnore:
    all_labels = [1]
    has_ignore_label = True


def _write_cases(folder, cls, shape, n_cases=3, with_ignore=False, prev=None, seed=0):
    """n_cases cases of `shape` (C, X, Y, Z) written by `cls`, their class
    locations capped at 100 voxels; a previous stage's channel-less
    segmentations in `prev` where given."""
    rng = np.random.default_rng(seed)
    for i in range(n_cases):
        data = rng.normal(size=shape).astype(np.float32)
        seg = rng.integers(0, 3, size=(1,) + shape[1:]).astype(np.int8)
        locs = {c: np.argwhere(seg == c)[:100] for c in (1, 2)}
        if with_ignore:
            locs[(-1, 1)] = np.argwhere(seg >= 0)[:100]
        props = {"class_locations": locs, "spacing": [999, 1.0, 1.0]}
        cls.save_case(data, seg, props, os.path.join(folder, f"case_{i:03d}"))
        if prev is not None:
            cls.save_seg(rng.integers(0, 3, size=shape[1:]).astype(np.int8),
                         os.path.join(prev, f"case_{i:03d}"))


@pytest.mark.parametrize("variant", ["plain", "prev_stage", "ignore", "pad", "probabilistic"])
@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_loader_batches_equal_jax(tmp_path, backend, dims, variant):
    """Four batches of the port's loader over the port's backend, and of the
    JAX loader over the JAX backend, from one seed on one folder: equal bit
    for bit, keys included."""
    port_cls, jax_cls = BACKENDS[backend]
    shape = (2, 1, 30, 26) if dims == 2 else (1, 14, 12, 16)
    patch = (16, 16) if dims == 2 else (8, 8, 8)
    if variant == "pad":  # a patch beyond the image on an axis: padded
        patch = (16, 40) if dims == 2 else (8, 20, 8)
    cur, prev = str(tmp_path / "cur"), str(tmp_path / "prev")
    os.makedirs(cur), os.makedirs(prev)
    _write_cases(cur, port_cls, shape, with_ignore=variant == "ignore",
                 prev=prev if variant == "prev_stage" else None)
    folders = dict(folder=cur, folder_with_segs_from_previous_stage=(
        prev if variant == "prev_stage" else None))
    labels = _LabelsIgnore() if variant == "ignore" else _Labels()
    kw = dict(batch_size=4, patch_size=patch, final_patch_size=patch, label_manager=labels,
              oversample_foreground_percent=0.33, seed=5,
              probabilistic_oversampling=variant == "probabilistic")
    if dims == 3 and variant == "plain":  # the sampling patch larger than the final one
        kw.update(patch_size=(10, 10, 10), pad_sides=(1, 0, 2))
    ours = nnUNetDataLoader(port_cls(**folders), **kw)
    theirs = jax_loader.nnUNetDataLoader(jax_cls(**folders), **kw)
    for _ in range(4):
        a, b = next(ours), next(theirs)
        assert list(a["keys"]) == list(b["keys"])
        for k in ("data", "target"):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
    channels = 2 if variant == "prev_stage" else 1
    assert a["target"].shape == (4, channels, *kw["patch_size"][-dims:])
    if variant == "pad":
        assert (a["target"] == -1).any()


def test_loader_batches_equal_across_backends(tmp_path):
    """The same cases stored by each backend give the same batches."""
    batches = {}
    for name, (cls, _) in BACKENDS.items():
        os.makedirs(tmp_path / name)
        _write_cases(str(tmp_path / name), cls, (1, 1, 24, 24), n_cases=2, seed=11)
        dl = nnUNetDataLoader(cls(str(tmp_path / name)), batch_size=4, patch_size=(16, 16),
                              final_patch_size=(16, 16), label_manager=_Labels(),
                              oversample_foreground_percent=0.33, seed=0)
        batches[name] = next(dl)
    a, b = batches["numpy"], batches["blosc2"]
    assert list(a["keys"]) == list(b["keys"])
    np.testing.assert_array_equal(a["data"], b["data"])
    np.testing.assert_array_equal(a["target"], b["target"])


@pytest.mark.parametrize("seed", range(4))
def test_crop_and_pad_nd_equals_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, 7, 9, 5)).astype(np.float32)
    # boxes that overlap each axis (as the loader's do), reaching past
    # either side
    sizes = (4, 12, 3)
    bbox = [[lb, lb + size] for lb, size in
            ((int(rng.integers(1 - size, n)), size) for n, size in zip(a.shape[1:], sizes))]
    got = crop_and_pad_nd(a, bbox, -3)
    np.testing.assert_array_equal(got, jax_loader.crop_and_pad_nd(a, bbox, -3))
    assert got.shape == (2, 4, 12, 3)


def test_crop_and_pad_nd():
    a = np.arange(16, dtype=np.float32).reshape(1, 4, 4)
    out = crop_and_pad_nd(a, [[-1, 3], [2, 6]], pad_value=-7)
    assert out.shape == (1, 4, 4)
    assert (out[0, 0] == -7).all() and (out[0, :, -2:] == -7).all()
    assert out[0, 1, 0] == a[0, 0, 2]


def test_oversampling_forces_foreground(tmp_path):
    _write_cases(str(tmp_path), nnUNetDatasetNumpy, (1, 1, 24, 24))
    dl = nnUNetDataLoader(nnUNetDatasetNumpy(str(tmp_path)), batch_size=3, patch_size=(8, 8),
                          final_patch_size=(8, 8), label_manager=_Labels(),
                          oversample_foreground_percent=0.33, seed=1)
    assert [dl.get_do_oversample(i) for i in range(3)] == [False, False, True]
    for _ in range(5):
        assert (next(dl)["target"][-1] > 0).any()


def test_ignore_label_key_and_transforms_hook(tmp_path):
    _write_cases(str(tmp_path), nnUNetDatasetNumpy, (1, 1, 24, 24), with_ignore=True)
    calls = []

    def tf(data, seg):
        calls.append(data.shape)
        return data * 2.0, seg

    dl = nnUNetDataLoader(nnUNetDatasetNumpy(str(tmp_path)), batch_size=2, patch_size=(8, 8),
                          final_patch_size=(8, 8), label_manager=_LabelsIgnore(),
                          transforms=tf, seed=2)
    assert dl.annotated_classes_key == (-1, 1)
    batch = next(dl)
    assert calls == [(2, 1, 8, 8)] and batch["data"].shape == (2, 1, 8, 8)
