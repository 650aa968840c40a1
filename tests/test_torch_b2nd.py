"""The port's pure-Python Blosc2 NDim engine (``dinounet_tpu_torch/compression``)
against the JAX package's and against libblosc.

The cases of tests/test_b2nd.py run on the port's engine (the repeated
oracle and codec cases as parametrised ones), and the two packages are held
to each other: the same chunk and the same ``.b2nd`` file, byte for byte,
from one array, and each reads the other's files. The libblosc oracle cases
skip where ``libblosc.so.1`` is absent, as the JAX package's do.
"""

import ctypes
import ctypes.util
import struct
import subprocess
import sys

import numpy as np
import pytest

from dinounet_tpu.compression import blosc1_chunk as jax_chunk
from dinounet_tpu.compression.b2nd import open_b2nd as jax_open_b2nd
from dinounet_tpu.compression.b2nd import save_b2nd as jax_save_b2nd
from dinounet_tpu_torch.compression import blosc1_chunk, blosc2_shim
from dinounet_tpu_torch.compression import minimsgpack as mp
from dinounet_tpu_torch.compression.b2nd import B2NDArray, open_b2nd, save_b2nd


def _load_libblosc():
    path = ctypes.util.find_library("blosc") or "libblosc.so.1"
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.blosc_init()
    lib.blosc_set_nthreads(1)
    return lib


_LIBBLOSC = _load_libblosc()
needs_libblosc = pytest.mark.skipif(_LIBBLOSC is None, reason="libblosc.so.1 not present")

try:
    import blosc2 as real_blosc2  # noqa: F401
except ImportError:
    real_blosc2 = None

CASE_NAMES = ("f32", "i16", "u8", "f64", "zeros")


def _cases(rng):
    return [
        ((rng.standard_normal(1000) * 10).astype(np.float32), "f32"),
        ((rng.standard_normal(333) * 100).astype(np.int16), "i16"),
        (rng.integers(0, 4, 5000).astype(np.uint8), "u8"),
        ((rng.standard_normal(129)).astype(np.float64), "f64"),
        (np.zeros(777, np.float32), "zeros"),
    ]


def _case(seed: int, name: str) -> np.ndarray:
    return dict((n, a) for a, n in _cases(np.random.default_rng(seed)))[name]


# ------------------------------------------------------------- libblosc oracle


@needs_libblosc
@pytest.mark.parametrize("name", CASE_NAMES)
def test_our_chunks_decompress_with_libblosc(name):
    arr = _case(0, name)
    data = arr.tobytes()
    chunk = blosc1_chunk.compress_chunk(data, arr.itemsize, blocksize=4096, clevel=8,
                                        shuffle=True, codec="zstd")
    out = ctypes.create_string_buffer(len(data))
    assert _LIBBLOSC.blosc_decompress(bytes(chunk), out, len(data)) == len(data)
    assert out.raw == data


@needs_libblosc
@pytest.mark.parametrize("compressor, clevel, shuffle", [
    ("zstd", 8, 1),   # the cases of the JAX oracle's zstd test
    ("zlib", 6, 0),   # zlib, unshuffled
    ("zstd", 0, 1),   # clevel 0: stored raw with the MEMCPYED flag
])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_libblosc_chunks_decompress_with_ours(compressor, clevel, shuffle, name):
    arr = _case(1, name)
    data = arr.tobytes()
    _LIBBLOSC.blosc_set_compressor(compressor.encode())
    try:
        comp = ctypes.create_string_buffer(len(data) + 16)
        n = _LIBBLOSC.blosc_compress(clevel, shuffle, arr.itemsize, len(data), data, comp,
                                     len(data) + 16)
    finally:
        _LIBBLOSC.blosc_set_compressor(b"zstd")
    assert n > 0
    if clevel == 0:
        assert n == len(data) + 16
    assert blosc1_chunk.decompress_chunk(comp.raw[:n]) == data


@needs_libblosc
def test_split_codec_chunks_fail_loudly():
    """blosclz splits blocks into typesize streams; the engine has no
    blosclz and must say so, never return wrong bytes."""
    _LIBBLOSC.blosc_set_compressor(b"blosclz")
    try:
        data = np.arange(4096, dtype=np.int32).tobytes()
        comp = ctypes.create_string_buffer(len(data) + 16)
        n = _LIBBLOSC.blosc_compress(9, 1, 4, len(data), data, comp, len(data) + 16)
    finally:
        _LIBBLOSC.blosc_set_compressor(b"zstd")
    assert n > 0
    with pytest.raises(ValueError, match="codec"):
        blosc1_chunk.decompress_chunk(comp.raw[:n])


# ------------------------------------------------------------------ chunk codec


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_chunk_round_trip_and_equal_to_jax(codec, shuffle, name):
    """Each round trip, and the port's chunk is the JAX package's, byte for
    byte, each decoding the other's."""
    arr = _case(3, name)
    data = arr.tobytes()
    kw = dict(blocksize=1000, clevel=5, shuffle=shuffle, codec=codec)
    chunk = blosc1_chunk.compress_chunk(data, arr.itemsize, **kw)
    assert blosc1_chunk.decompress_chunk(chunk) == data
    assert chunk == jax_chunk.compress_chunk(data, arr.itemsize, **kw)
    assert jax_chunk.decompress_chunk(chunk) == data


def test_incompressible_streams_stored_raw():
    data = np.random.default_rng(4).bytes(10000)
    chunk = blosc1_chunk.compress_chunk(data, 1, blocksize=2048)
    assert blosc1_chunk.decompress_chunk(chunk) == data
    assert len(chunk) <= len(data) + blosc1_chunk.MAX_OVERHEAD + 4 * 5 + 4 * 5


def test_short_last_block():
    data = np.arange(1001, dtype=np.uint8).astype(np.uint8).tobytes()
    chunk = blosc1_chunk.compress_chunk(data, 1, blocksize=256)
    assert blosc1_chunk.decompress_chunk(chunk) == data


def test_decompress_block_matches_full():
    data = (np.random.default_rng(5).standard_normal(4000) * 7).astype(np.float32).tobytes()
    chunk = blosc1_chunk.compress_chunk(data, 4, blocksize=1024)
    got = b"".join(blosc1_chunk.decompress_block(chunk, i)
                   for i in range((len(data) + 1023) // 1024))
    assert got == data


def test_blocksize_realigned_to_typesize():
    data = np.arange(100, dtype=np.float64).tobytes()
    assert blosc1_chunk.decompress_chunk(
        blosc1_chunk.compress_chunk(data, 8, blocksize=100)) == data


def test_expected_nbytes_mismatch_raises():
    chunk = blosc1_chunk.compress_chunk(b"abcd" * 10, 1, blocksize=40)
    with pytest.raises(ValueError, match="nbytes"):
        blosc1_chunk.decompress_chunk(chunk, expected_nbytes=7)


def test_blosc2_special_zero_chunk():
    """The 32-byte-header special-values chunk b2nd writes for all-zero
    chunks decodes to zeros, whole and a block at a time."""
    nbytes, typesize = 4096, 4
    header = struct.pack("<BBBBiii", 2, 1, 4 << 5, typesize, nbytes, 1024, 32)
    chunk = header + bytes(15) + bytes([2 << 4])  # special=2 (zeros) at byte 31
    assert blosc1_chunk.decompress_chunk(chunk) == bytes(nbytes)
    assert blosc1_chunk.decompress_block(chunk, 1) == bytes(1024)


def test_bad_typesize_rejected():
    with pytest.raises(ValueError, match="typesize"):
        blosc1_chunk.compress_chunk(b"x" * 600, 300, blocksize=600)


def test_zstd_is_imported_only_by_the_zstd_codec(tmp_path):
    """With ``zstandard`` hidden: the engine imports, zlib chunks and files
    round-trip, zstd chunks and a zstd ``.b2nd`` file that the JAX engine
    wrote (with ``zstandard``) read through the port's own decoder, equal to
    what was written, and only writing a zstd chunk raises, naming the
    package."""
    rng = np.random.default_rng(3)
    b2nd_array = (rng.standard_normal((3, 20, 30)) * 5).astype(np.float32)
    jax_save_b2nd(b2nd_array, str(tmp_path / "jax.b2nd"), chunks=(2, 8, 16),
                  blocks=(1, 4, 8))
    np.save(tmp_path / "want.npy", b2nd_array)
    payload = rng.standard_normal(2000).astype(np.float32).tobytes()
    (tmp_path / "chunk.bin").write_bytes(
        bytes(jax_chunk.compress_chunk(payload, 4, 4096, codec="zstd")))
    (tmp_path / "payload.bin").write_bytes(payload)
    code = (
        "import sys, tempfile, os\n"
        "sys.modules['zstandard'] = None\n"
        "import numpy as np\n"
        "from dinounet_tpu_torch.compression import blosc1_chunk, blosc2_shim\n"
        "from dinounet_tpu_torch.training import nnunet_dataset, data_loader\n"
        "from dinounet_tpu_torch.compression.b2nd import open_b2nd, save_b2nd\n"
        "data = np.arange(500, dtype=np.float32).tobytes()\n"
        "assert blosc1_chunk.decompress_chunk(blosc1_chunk.compress_chunk(\n"
        "    data, 4, 256, codec='zlib')) == data\n"
        "a = np.arange(600, dtype=np.int16).reshape(20, 30)\n"
        "p = os.path.join(tempfile.mkdtemp(), 'x.b2nd')\n"
        "save_b2nd(a, p, chunks=(8, 16), blocks=(4, 8), codec='zlib')\n"
        "assert (open_b2nd(p)[3:17, 2:29] == a[3:17, 2:29]).all()\n"
        f"chunk = {bytes(jax_chunk.compress_chunk(b'abcd' * 64, 4, 256))!r}\n"
        "assert blosc1_chunk.decompress_chunk(chunk) == b'abcd' * 64\n"
        f"root = {str(tmp_path)!r}\n"
        "big = open(os.path.join(root, 'chunk.bin'), 'rb').read()\n"
        "want = open(os.path.join(root, 'payload.bin'), 'rb').read()\n"
        "assert blosc1_chunk.decompress_chunk(big) == want\n"
        "got = open_b2nd(os.path.join(root, 'jax.b2nd'))[:]\n"
        "assert np.array_equal(got, np.load(os.path.join(root, 'want.npy')))\n"
        "try:\n"
        "    blosc1_chunk.compress_chunk(data, 4, 256)\n"
        "except RuntimeError as e:\n"
        "    assert 'zstandard' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('a zstd chunk was written without zstandard')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


# ----------------------------------------------------------------- msgpack


def test_msgpack_round_trip_values():
    values = [None, True, False, 0, 5, 127, 128, -1, -32, -33, 2 ** 31 - 1, -(2 ** 31),
              2 ** 40, "b2nd", "x" * 40, b"\x00\x01", b"y" * 300, [1, "two", [3]],
              {"a": 1, "b": [2]}]
    for v in values:
        got, end = mp.unpack_from(mp.pack(v))
        assert got == v and end == len(mp.pack(v)), v
    ext, _ = mp.unpack_from(mp.pack(mp.Ext(7, bytes(16))))
    assert ext.code == 7 and bytes(ext.data) == bytes(16)


@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_msgpack_fixed_width_ints(width):
    b = mp.pack_fixed_int(3, width)
    assert len(b) == 1 + width and mp.unpack_from(b)[0] == 3


# ---------------------------------------------------------------- container


CONTAINERS = [
    (np.float32, (2, 37, 53, 41), (1, 16, 32, 32), (1, 8, 16, 16)),
    (np.int8, (1, 64, 64), None, None),
    (np.uint16, (100,), (7,), (3,)),
    (np.float64, (5, 5), (5, 5), (5, 5)),
    (np.int32, (13, 17), (4, 9), (4, 5)),
]


@pytest.mark.parametrize("dtype,shape,chunks,blocks", CONTAINERS)
def test_round_trip_and_lazy_slices(tmp_path, dtype, shape, chunks, blocks):
    rng = np.random.default_rng(6)
    a = (rng.standard_normal(shape) * 50).astype(dtype)
    path = str(tmp_path / "x.b2nd")
    save_b2nd(a, path, chunks=chunks, blocks=blocks)
    b = open_b2nd(path)
    assert b.shape == a.shape and b.dtype == a.dtype
    np.testing.assert_array_equal(b[...], a)
    for _ in range(20):
        key = tuple(slice(int(rng.integers(0, s)), int(rng.integers(1, s + 1)))
                    for s in shape)
        np.testing.assert_array_equal(b[key], a[key])
    b.close()


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
@pytest.mark.parametrize("dtype,shape,chunks,blocks", CONTAINERS)
def test_files_equal_to_jax_and_read_across(tmp_path, dtype, shape, chunks, blocks, codec):
    """One array written by both packages gives one file, byte for byte;
    each package reads the other's file, whole and in slices, bit for bit."""
    rng = np.random.default_rng(7)
    a = (rng.standard_normal(shape) * 50).astype(dtype)
    ours, theirs = str(tmp_path / "ours.b2nd"), str(tmp_path / "jax.b2nd")
    save_b2nd(a, ours, chunks=chunks, blocks=blocks, codec=codec)
    jax_save_b2nd(a, theirs, chunks=chunks, blocks=blocks, codec=codec)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    keys = [...] + [tuple(slice(int(rng.integers(0, s)), int(rng.integers(1, s + 1)))
                          for s in shape) for _ in range(5)]
    for reader, path in ((open_b2nd, theirs), (jax_open_b2nd, ours)):
        b = reader(path)
        for key in keys:
            got = b[key]
            assert got.dtype == a.dtype
            np.testing.assert_array_equal(got, a[key])
        b.close()


def test_integer_indexing_squeezes(tmp_path):
    a = np.arange(2 * 6 * 7, dtype=np.float32).reshape(2, 6, 7)
    path = str(tmp_path / "x.b2nd")
    save_b2nd(a, path, chunks=(1, 4, 4), blocks=(1, 2, 2))
    b = open_b2nd(path)
    np.testing.assert_array_equal(b[1], a[1])
    np.testing.assert_array_equal(b[0, 2:5], a[0, 2:5])
    np.testing.assert_array_equal(b[-1, 3, 2:4], a[-1, 3, 2:4])
    assert b[1, 2, 3] == a[1, 2, 3]
    b.close()


def test_partial_leading_key_and_len(tmp_path):
    a = np.arange(60, dtype=np.int16).reshape(3, 4, 5)
    path = str(tmp_path / "x.b2nd")
    save_b2nd(a, path)
    b = open_b2nd(path)
    assert len(b) == 3
    np.testing.assert_array_equal(b[1:3], a[1:3])
    np.testing.assert_array_equal(b[:, 1:3], a[:, 1:3])
    b.close()


def test_step_and_fancy_indexing_rejected(tmp_path):
    path = str(tmp_path / "x.b2nd")
    save_b2nd(np.zeros((4, 4), np.float32), path)
    b = open_b2nd(path)
    with pytest.raises(IndexError, match="step 1"):
        b[::2]
    with pytest.raises(IndexError):
        b[[0, 1]]
    with pytest.raises(IndexError, match="too many"):
        b[0, 0, 0]
    b.close()


def test_non_b2nd_file_rejected(tmp_path):
    path = tmp_path / "x.b2nd"
    path.write_bytes(b"\x90" + b"not a frame" + bytes(100))
    with pytest.raises(ValueError, match="magic"):
        open_b2nd(str(path))


def test_header_fixed_offsets(tmp_path):
    """The header honours the cframe spec's fixed offsets."""
    a = np.arange(1000, dtype=np.float32).reshape(10, 100)
    path = str(tmp_path / "x.b2nd")
    save_b2nd(a, path, chunks=(4, 64), blocks=(2, 32))
    raw = open(path, "rb").read()
    assert raw[2:10] == b"b2frame\x00"
    assert struct.unpack_from(">q", raw, 16)[0] == len(raw)  # frame length
    assert struct.unpack_from(">q", raw, 30)[0] >= a.nbytes  # padded nbytes
    assert struct.unpack_from(">i", raw, 48)[0] == 4  # typesize
    assert struct.unpack_from(">i", raw, 53)[0] == 2 * 32 * 4  # blocksize
    assert struct.unpack_from(">i", raw, 11)[0] < len(raw)  # header length


def test_all_zero_array(tmp_path):
    a = np.zeros((3, 50, 50), np.float32)
    path = str(tmp_path / "x.b2nd")
    save_b2nd(a, path, chunks=(1, 32, 32), blocks=(1, 16, 16))
    b = open_b2nd(path)
    np.testing.assert_array_equal(b[...], a)
    b.close()


# --------------------------------------------------------------------- shim


def test_shim_asarray_open_round_trip(tmp_path):
    a = (np.random.default_rng(7).standard_normal((2, 30, 40)) * 5).astype(np.float32)
    path = str(tmp_path / "x.b2nd")
    out = blosc2_shim.asarray(a, urlpath=path, chunks=(1, 16, 16), blocks=(1, 8, 8),
                              cparams={"codec": blosc2_shim.Codec.ZSTD, "clevel": 8})
    assert isinstance(out, B2NDArray)
    b = blosc2_shim.open(urlpath=path, mode="r", dparams={"nthreads": 1}, mmap_mode="r")
    np.testing.assert_array_equal(b[...], a)
    np.testing.assert_array_equal(b[:, 3:19, 7:33], a[:, 3:19, 7:33])
    b.close()


def test_shim_unavailable_codec_rejected(tmp_path):
    with pytest.raises(ValueError, match="codec"):
        blosc2_shim.asarray(np.zeros(4), urlpath=str(tmp_path / "x.b2nd"),
                            cparams={"codec": blosc2_shim.Codec.LZ4})


def test_shim_enum_values_match_python_blosc2():
    assert blosc2_shim.Codec.ZSTD == 5 and blosc2_shim.Codec.ZLIB == 4
    assert blosc2_shim.Filter.SHUFFLE == 1
    assert blosc2_shim.set_nthreads(8) == 1


def test_shim_write_requires_urlpath():
    with pytest.raises(NotImplementedError):
        blosc2_shim.asarray(np.zeros(4))
    with pytest.raises(NotImplementedError):
        blosc2_shim.open("x.b2nd", mode="w")


@pytest.mark.skipif(real_blosc2 is None, reason="python-blosc2 not installed")
def test_real_blosc2_reads_and_writes_across(tmp_path):
    a = (np.random.default_rng(8).standard_normal((2, 33, 47)) * 9).astype(np.float32)
    real = str(tmp_path / "real.b2nd")
    real_blosc2.asarray(a, urlpath=real, chunks=(1, 16, 32), blocks=(1, 8, 16),
                        cparams={"codec": real_blosc2.Codec.ZSTD, "clevel": 8})
    np.testing.assert_array_equal(open_b2nd(real)[...], a)
    ours = str(tmp_path / "ours.b2nd")
    save_b2nd(a, ours, chunks=(1, 16, 32), blocks=(1, 8, 16))
    np.testing.assert_array_equal(real_blosc2.open(urlpath=ours, mode="r")[...], a)
