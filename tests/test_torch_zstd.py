"""The port's Zstandard decoders against the ``zstandard`` package.

Both decoders -- the pure-Python reference (``compression/zstd.py``) and
the host C++ one (``csrc/zstd_decode.cpp`` through
``compression/zstd_native.py``) -- must give ``zstandard.decompress``'s
bytes on every frame here: levels -5, 1, 3 and 19, with and without the
content checksum, raw and RLE blocks, multi-block frames, windows over
128 KiB, frames without a content size, frames back to back and skippable
frames, and the real frames of an orbax checkpoint (its OCDBT manifests
and nodes, its zarr chunks). Corrupt and truncated frames raise in both;
dictionaries are refused. The hashes (xxHash64 in both languages, CRC-32C)
are held to published check values.
"""

import os
import struct

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from dinounet_tpu_torch.compression import ocdbt, zstd, zstd_native
from dinounet_tpu_torch.ops import _build
from tests.torch_threads import one_torch_thread  # noqa: F401

FIXTURE_ARRAYS = os.path.join(os.path.dirname(__file__), "fixtures", "jax_checkpoint",
                              "DinoUNetTrainer__nnUNetPlans__2d", "fold_1",
                              "checkpoint_final.pth", "arrays")
LEVELS = (-5, 1, 3, 19)


def _payloads():
    rng = np.random.default_rng(0)
    weights = rng.standard_normal(6000).astype(np.float32).tobytes()  # Huffman literals
    text = b"the quick brown fox jumps over the lazy dog; " * 400 + bytes(range(256))
    small = rng.integers(0, 5, 20000).astype(np.uint8).tobytes()  # FSE-coded sequences
    noise = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()  # raw blocks
    return {"weights": weights, "text": text, "small_alphabet": small, "noise": noise,
            "zeros": bytes(5000), "one": b"x", "empty": b""}


PAYLOADS = _payloads()


def _decoders(frame: bytes, size: int):
    return {"plain": zstd.decompress(frame),
            "native": zstd_native.decompress(frame, size)}


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_both_decoders_equal_zstandard(name, level, checksum):
    data = PAYLOADS[name]
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    want = zstandard.ZstdDecompressor().decompress(frame)
    assert want == data
    for decoder, got in _decoders(frame, len(data)).items():
        assert got == want, decoder


def _large_frames():
    """Frames of several blocks, and one whose matches reach 200 KiB back
    (its window is over 128 KiB)."""
    rng = np.random.default_rng(1)
    unit = rng.integers(0, 256, 200 * 1024, dtype=np.uint8).tobytes()
    far = unit + unit[:150 * 1024]
    blocks = (b"".join(bytes([i]) * 700 + bytes(range(i, i + 40)) for i in range(200))
              * 3)
    return {
        "far_matches": (zstandard.ZstdCompressor(level=19).compress(far), far),
        "multi_block": (zstandard.ZstdCompressor(level=3).compress(blocks), blocks),
        "rle_blocks": (zstandard.ZstdCompressor(level=1).compress(bytes(400 * 1024)),
                       bytes(400 * 1024)),
    }


@pytest.mark.parametrize("name", ["far_matches", "multi_block", "rle_blocks"])
def test_large_frames(name):
    frame, data = _large_frames()[name]
    header, _ = zstd.frame_header(frame)
    if name == "far_matches":
        assert header["window"] > 128 * 1024
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    for decoder, got in _decoders(frame, len(data)).items():
        assert got == data, decoder


def _stream(data: bytes, level: int = 3) -> bytes:
    """A frame without a content size, written in pieces."""
    import io

    out = io.BytesIO()
    with zstandard.ZstdCompressor(level=level, write_checksum=True).stream_writer(
            out, closefd=False, size=-1) as w:
        for i in range(0, len(data), 3000):
            w.write(data[i:i + 3000])
    return out.getvalue()


def test_frames_back_to_back_skippable_and_without_a_size():
    a, b = PAYLOADS["text"], PAYLOADS["weights"]
    skippable = struct.pack("<II", 0x184D2A53, 5) + b"hello"
    frames = (zstandard.ZstdCompressor(level=1).compress(a) + skippable
              + _stream(b) + struct.pack("<II", 0x184D2A50, 0))
    assert zstd.frame_header(_stream(b))[0]["content_size"] is None
    for decoder, got in _decoders(frames, len(a) + len(b)).items():
        assert got == a + b, decoder


def _orbax_frames():
    """Every zstd frame of the committed orbax directory: its manifests'
    and its B+tree roots' bodies, and the values they hold (zarr chunks)."""
    frames = []
    for directory in (FIXTURE_ARRAYS, os.path.join(FIXTURE_ARRAYS, "ocdbt.process_0")):
        with open(os.path.join(directory, "manifest.ocdbt"), "rb") as f:
            frames.append(f.read()[14:-4])  # magic, length, version, compression
        store = ocdbt.OcdbtStore(directory)
        _, path, _, offset, length = store._root
        with open(os.path.join(directory, path), "rb") as f:
            f.seek(offset)
            frames.append(f.read(length)[14:-4])
    values = store.read_many([k for k in store.keys() if not k.endswith("/.zarray")])
    frames += list(values.values())
    assert all(f[:4] == bytes.fromhex("28b52ffd") for f in frames)
    return frames


def test_orbax_frames_decode_as_zstandard_decodes_them():
    frames = _orbax_frames()
    assert len(frames) > 600
    for frame in frames:
        want = zstandard.ZstdDecompressor().decompressobj().decompress(frame)
        assert zstd.decompress(frame) == want
    dests = [np.empty(len(zstandard.ZstdDecompressor().decompressobj().decompress(f)), np.uint8)
             for f in frames]
    zstd_native.decode_into(frames, dests, threads=4)
    for frame, dest in zip(frames, dests):
        assert dest.tobytes() == zstandard.ZstdDecompressor().decompressobj().decompress(frame)


def _corruptions():
    rng = np.random.default_rng(4)
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
        PAYLOADS["weights"] + PAYLOADS["text"])
    cases = [frame[:n] for n in (3, 5, 8, 20, len(frame) // 2, len(frame) - 5,
                                 len(frame) - 1)]
    for pos in rng.integers(6, len(frame), 12):
        bad = bytearray(frame)
        bad[pos] ^= 0x5A
        cases.append(bytes(bad))
    cases.append(b"\x00\x01\x02\x03junk")
    cases.append(frame + b"\x28\xb5")  # trailing bytes
    return frame, cases


@pytest.mark.parametrize("decoder", ["plain", "native"])
def test_corrupt_and_truncated_frames_raise(decoder):
    frame, cases = _corruptions()
    size = len(PAYLOADS["weights"] + PAYLOADS["text"])
    for i, bad in enumerate(cases):
        with pytest.raises(zstd.ZstdError):
            zstd_native.decompress(bad, size, decoder)
            raise AssertionError(f"case {i} decoded")
    # a frame that decodes to less than its destination is an error, not short data
    with pytest.raises(zstd.ZstdError):
        zstd_native.decompress(frame, size + 1, decoder)


def test_dictionaries_are_refused():
    dictionary = zstandard.train_dictionary(1024, [PAYLOADS["text"][i:i + 300]
                                                   for i in range(0, 15000, 150)])
    frame = zstandard.ZstdCompressor(dict_data=dictionary).compress(PAYLOADS["text"])
    for decoder in ("plain", "native"):
        with pytest.raises(zstd.ZstdError, match="dictionar"):
            zstd_native.decompress(frame, len(PAYLOADS["text"]), decoder)


@settings(max_examples=30, deadline=None)
@given(st.lists(st.binary(min_size=0, max_size=300), min_size=0, max_size=12),
       st.integers(0, 5), st.sampled_from(LEVELS), st.booleans())
def test_random_buffers(pieces, repeats, level, checksum):
    data = b"".join(p * (1 + repeats % (i + 1)) for i, p in enumerate(pieces))
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    for decoder, got in _decoders(frame, len(data)).items():
        assert got == data, decoder


def test_hashes():
    """xxHash64 of "" is 0xef46db3751d8e999 (the reference's check value) in
    both languages and equal on other buffers; CRC-32C of "123456789" is
    0xe3069283 in both."""
    assert zstd.xxh64(b"") == zstd_native.xxh64(b"") == 0xEF46DB3751D8E999
    for n in (1, 7, 31, 32, 33, 1000):
        data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
        assert zstd.xxh64(data) == zstd_native.xxh64(data)
    assert ocdbt.crc32c(b"123456789") == zstd_native.crc32c(b"123456789") == 0xE3069283


def test_the_library_builds_from_the_source_and_its_failure_raises(tmp_path, monkeypatch):
    """The library is at the path of the source's hash (built at first use);
    a source the compiler refuses raises with the compiler's output, and the
    native decoder raises rather than running the plain one."""
    zstd_native.library()
    assert _build.host_library_path(zstd_native.SOURCE).is_file()
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        _build.host_library("broken.cpp")

    def fails(source):
        raise RuntimeError("no compiler")

    monkeypatch.setattr(_build, "host_library", fails)
    frame = zstandard.ZstdCompressor().compress(b"abc")
    with pytest.raises(RuntimeError, match="no compiler"):
        zstd_native.decompress(frame, 3)
    assert zstd_native.decompress(frame, 3, "plain") == b"abc"


def test_the_fixture_weights_frame():
    """The committed level-1 frame of fp32 weights (the card's rate is taken
    on it) decodes in both to zstandard's bytes, the digest the fixture
    records."""
    import hashlib
    import json

    root = os.path.join(os.path.dirname(__file__), "fixtures", "jax_checkpoint")
    with open(os.path.join(root, "weights_l1.zst"), "rb") as f:
        frame = f.read()
    with open(os.path.join(root, "sha256.json")) as f:
        digest = json.load(f)["weights_l1"]
    want = zstandard.ZstdDecompressor().decompress(frame)
    assert hashlib.sha256(want).hexdigest() == digest
    for decoder, got in _decoders(frame, len(want)).items():
        assert got == want, decoder
