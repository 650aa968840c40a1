"""The port's image readers and writers against the JAX package's, on the CPU.

Each format (NIfTI .nii.gz and .nii, MetaImage .mha, NRRD .nrrd, PNG, and
3-D TIFF with its spacing sidecar) is written by one package and read by
both, then written again by the same package from the properties it read
back (the template path: NIfTI headers, ITK geometry) and read by both once
more. Arrays must be equal and the properties dicts equal, field by field.
The registries resolve the same names (the reference's aliases included) to
the same classes, and the dataset.json rule picks the same reader.
"""

import numpy as np
import pytest

from dinounet_tpu_torch.imageio import reader_writer_registry as port_rw

_DIRECTION = tuple(float(v) for v in np.eye(3).ravel())
_SPACING = [2.5, 0.8, 0.7]  # (z, y, x)
# (reader/writer, file ending, whether the format holds 3-D volumes)
FORMATS = [("NiftiIO", ".nii.gz", True), ("NiftiIO", ".nii", True),
           ("SitkFormatsIO", ".mha", True), ("SitkFormatsIO", ".nrrd", True),
           ("NaturalImage2DIO", ".png", False), ("Tiff3DIO", ".tif", True)]


def _first_properties(io_name: str) -> dict:
    if io_name == "SitkFormatsIO":
        return {"sitk_stuff": {"spacing": tuple(_SPACING[::-1]),
                               "origin": (1.5, -2.0, 3.25), "direction": _DIRECTION},
                "spacing": list(_SPACING)}
    if io_name == "NaturalImage2DIO":
        return {}
    return {"spacing": list(_SPACING)}


def _assert_same(a, b, path="properties"):
    """Deep equality of properties: dicts, sequences, arrays, bytes, numbers."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and type(a) is type(b), path
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b and type(a) is type(b), f"{path}: {a!r} != {b!r}"


def _io_pair(io_name):
    from dinounet_tpu.imageio import reader_writer_registry as jax_rw  # noqa: F401
    from dinounet_tpu.utilities import registry as jax_registry

    from dinounet_tpu_torch.utilities import registry as port_registry

    return (jax_registry.image_readers.get(io_name)(),
            port_registry.image_readers.get(io_name)())


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("io_name,ending,volume", FORMATS,
                         ids=[f[1].lstrip(".") for f in FORMATS])
def test_written_by_one_package_read_alike_by_both(tmp_path, io_name, ending, volume,
                                                   writer):
    jax_io, port_io = _io_pair(io_name)
    write_io = jax_io if writer == "jax" else port_io
    shape = (3, 12, 10) if volume else (1, 12, 10)
    seg = np.random.default_rng(0).integers(0, 4, shape).astype(np.uint8)

    src = str(tmp_path / f"src{ending}")
    write_io.write_seg(seg, src, _first_properties(io_name))
    (a_jax, p_jax), (a_port, p_port) = jax_io.read_seg(src), port_io.read_seg(src)
    assert a_port.dtype == a_jax.dtype == np.float32
    np.testing.assert_array_equal(a_port, a_jax)
    np.testing.assert_array_equal(a_port[0], seg)
    _assert_same(p_port, p_jax)

    # written again from what the writer's side read back
    again = str(tmp_path / f"again{ending}")
    read_back = p_jax if writer == "jax" else p_port
    write_io.write_seg(a_jax[0].astype(np.uint8), again, read_back)
    (b_jax, q_jax), (b_port, q_port) = jax_io.read_seg(again), port_io.read_seg(again)
    np.testing.assert_array_equal(b_port, b_jax)
    np.testing.assert_array_equal(b_port, a_port)
    _assert_same(q_port, q_jax)


def test_registries_resolve_the_same_names():
    from dinounet_tpu.imageio import reader_writer_registry as jax_rw
    from dinounet_tpu.utilities import registry as jax_registry

    from dinounet_tpu_torch.utilities import registry as port_registry

    names = sorted(jax_registry.image_readers.keys())
    assert names == sorted(port_registry.image_readers.keys())
    for n in names:
        assert (port_registry.image_readers.get(n).__name__
                == jax_registry.image_readers.get(n).__name__), n
    for dataset_json in ({"file_ending": ".png"}, {"file_ending": ".nii.gz"},
                         {"file_ending": ".mha"}, {"file_ending": ".tif"},
                         {"file_ending": ".nii.gz", "overwrite_image_reader_writer":
                          "SimpleITKIO"}):
        assert (port_rw.determine_reader_writer_from_dataset_json(dataset_json).__name__
                == jax_rw.determine_reader_writer_from_dataset_json(dataset_json).__name__)
