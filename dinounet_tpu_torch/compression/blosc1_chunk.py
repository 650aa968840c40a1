"""Blosc chunk codec in pure Python (zstd / zlib backends).

Counterpart of ``dinounet_tpu/compression/blosc1_chunk.py``: the same bytes
for the same input, and each reads the other's chunks. Two things differ.
zstd chunks are decoded by the port's own decoder (the host C++ one of
``compression/zstd_native.py``), so reading needs no ``zstandard`` package;
and ``zstandard`` is imported only where a zstd chunk is written, so the
port imports on a machine without that package, where writing a zstd chunk
raises ``RuntimeError`` naming it. zlib chunks need only the standard
library.

A Blosc chunk is the compression unit inside every Blosc2 container:

  | 16-byte header | int32 bstarts[nblocks] | block 0 | block 1 | ... |

header (little-endian, as libblosc.so.1 v1.21.3 writes it; the oracle cases
of tests/test_torch_b2nd.py hold the two against each other where the
library is installed):
  byte 0   version            (2 = Blosc1 format; Blosc2 reads it natively)
  byte 1   versionlz          (codec format version, 1)
  byte 2   flags              bit0 byte-shuffle, bit1 memcpy, bit2 bitshuffle,
                              bit3 delta, bit4 block-not-split,
                              bits5-7 codec format (0 blosclz, 1 lz4/lz4hc,
                              2 snappy, 3 zlib, 4 zstd)
  byte 3   typesize
  bytes 4-7   nbytes          (uncompressed size)
  bytes 8-11  blocksize
  bytes 12-15 cbytes          (total compressed size incl. header)

Each block holds its streams as [int32 csize | payload]...; a block is split
into `typesize` streams only by the "fast" codecs (blosclz/lz4) — flags bit4
records the choice so decompression never guesses (split policy probed:
blosclz/lz4 split, zlib/zstd don't, matching c-blosc >= 1.21). A stream that
did not compress is stored raw with csize == stream nbytes.

Blosc2-format chunks (32-byte extended header: bytes 16-21 filter codes,
22 udcodec, 23 compcode meta, 24-29 filter meta, 31 blosc2 flags) are
detected via the bstarts position and decoded too, including the
special-values encoding (all-zero chunks) that b2nd uses for padding.

The byte-shuffle filter is the numpy transpose it is defined as: within each
block, element bytes are regrouped so byte i of every element is contiguous.
"""

import struct
import zlib
from typing import Tuple

import numpy as np

from dinounet_tpu_torch.compression import zstd_native

# flags bits
_SHUFFLE = 0x01
_MEMCPYED = 0x02
_BITSHUFFLE = 0x04
_DELTA = 0x08
_NOT_SPLIT = 0x10

_CODEC_ZSTD = 4  # flags bits 5-7 "format" id
_CODEC_ZLIB = 3

# blosc2 extended-header special-values run (blosc2_flags >> 4): 1 uninit,
# 2 zeros, 3 nans
_SPECIAL_ZERO = 2
_SPECIAL_NAN = 3
_SPECIAL_UNINIT = 1

MAX_OVERHEAD = 16


def _zstandard():
    """The ``zstandard`` module, imported on first use (writing zstd only)."""
    try:
        import zstandard
    except ImportError as e:
        raise RuntimeError(
            "writing Blosc zstd chunks needs the zstandard package, which is not "
            "installed here (reading them does not); zlib-coded chunks "
            "(codec='zlib') need only the standard library") from e
    return zstandard


def _shuffle(data: bytes, typesize: int) -> bytes:
    if typesize <= 1 or len(data) % typesize:
        return data
    a = np.frombuffer(data, np.uint8).reshape(-1, typesize)
    return np.ascontiguousarray(a.T).tobytes()


def _unshuffle(data: bytes, typesize: int) -> bytes:
    if typesize <= 1 or len(data) % typesize:
        return data
    a = np.frombuffer(data, np.uint8).reshape(typesize, -1)
    return np.ascontiguousarray(a.T).tobytes()


def compress_chunk(data: bytes, typesize: int, blocksize: int,
                   clevel: int = 8, shuffle: bool = True,
                   codec: str = "zstd") -> bytes:
    """Compress one buffer into a Blosc1-format chunk (zstd or zlib)."""
    nbytes = len(data)
    if nbytes == 0 or blocksize <= 0:
        raise ValueError("empty input or bad blocksize")
    if typesize < 1 or typesize > 255:
        raise ValueError(f"typesize {typesize} out of the format's 1..255")
    blocksize = min(blocksize, nbytes)
    if typesize > 1 and blocksize % typesize:
        blocksize -= blocksize % typesize
        blocksize = max(blocksize, typesize)
    nblocks = (nbytes + blocksize - 1) // blocksize

    if codec == "zstd":
        cctx = _zstandard().ZstdCompressor(level=clevel)
        compress = cctx.compress
        codec_flag = _CODEC_ZSTD << 5
    elif codec == "zlib":
        compress = lambda b: zlib.compress(b, min(clevel, 9))  # noqa: E731
        codec_flag = _CODEC_ZLIB << 5
    else:
        raise ValueError(f"unsupported codec {codec!r} (zstd/zlib available)")

    flags = codec_flag | _NOT_SPLIT  # zstd/zlib blocks are never split
    if shuffle and typesize > 1:
        flags |= _SHUFFLE

    bstarts = []
    blocks = []
    offset = MAX_OVERHEAD + 4 * nblocks
    for i in range(nblocks):
        raw = data[i * blocksize:(i + 1) * blocksize]
        if flags & _SHUFFLE:
            raw = _shuffle(raw, typesize)
        comp = compress(raw)
        if len(comp) >= len(raw):
            comp = raw  # stored raw; signalled by csize == stream nbytes
        blob = struct.pack("<i", len(comp)) + comp
        bstarts.append(offset)
        blocks.append(blob)
        offset += len(blob)

    cbytes = offset
    header = struct.pack("<BBBBiii", 2, 1, flags, typesize,
                         nbytes, blocksize, cbytes)
    return header + struct.pack(f"<{nblocks}i", *bstarts) + b"".join(blocks)


def chunk_info(chunk) -> Tuple[int, int, int, int, int, int]:
    """(nbytes, blocksize, cbytes, typesize, flags, header_len)."""
    version, _versionlz, flags, typesize, nbytes, blocksize, cbytes = \
        struct.unpack_from("<BBBBiii", chunk, 0)
    if version > 6:
        raise ValueError(f"unsupported blosc chunk version {version}")
    header_len = MAX_OVERHEAD
    if not flags & _MEMCPYED:
        nblocks = (nbytes + blocksize - 1) // blocksize if blocksize else 0
        if nblocks and cbytes > MAX_OVERHEAD:
            first = struct.unpack_from("<i", chunk, MAX_OVERHEAD)[0]
            # Blosc2 extended header: bstarts begin at 32, not 16.  For a
            # 16-byte header the first bstart is 16 + 4*nblocks.
            if first != MAX_OVERHEAD + 4 * nblocks and cbytes >= 32:
                header_len = 32
    elif cbytes == 32 + nbytes or (cbytes == 32 and nbytes > 0):
        header_len = 32
    return nbytes, blocksize, cbytes, typesize, flags, header_len


def _decompress_stream(payload: bytes, flags: int, out_nbytes: int) -> bytes:
    if len(payload) == out_nbytes:
        return payload  # stored raw
    codec = (flags >> 5) & 0x7
    if codec == _CODEC_ZSTD:
        return zstd_native.decompress(payload, out_nbytes)
    if codec == _CODEC_ZLIB:
        return zlib.decompress(payload)
    raise ValueError(
        f"codec format {codec} is not implemented (only zstd and zlib are)")


def _special_fill(chunk, nbytes: int, typesize: int) -> bytes:
    blosc2_flags = chunk[31]
    special = (blosc2_flags >> 4) & 0x7
    if special in (_SPECIAL_ZERO, _SPECIAL_UNINIT):
        return bytes(nbytes)
    if special == _SPECIAL_NAN:
        if typesize == 4:
            return np.full(nbytes // 4, np.nan, np.float32).tobytes()
        if typesize == 8:
            return np.full(nbytes // 8, np.nan, np.float64).tobytes()
    raise ValueError(f"unsupported special-values chunk (flags 0x{blosc2_flags:02x})")


def decompress_chunk(chunk, expected_nbytes: int = None) -> bytes:
    """Decompress one Blosc1/Blosc2 chunk to bytes."""
    nbytes, blocksize, cbytes, typesize, flags, header_len = chunk_info(chunk)
    if expected_nbytes is not None and nbytes != expected_nbytes:
        raise ValueError(f"chunk nbytes {nbytes} != expected {expected_nbytes}")
    if flags & _MEMCPYED:
        return bytes(chunk[header_len:header_len + nbytes])
    if header_len == 32 and cbytes <= 32 + 4:
        return _special_fill(chunk, nbytes, typesize)
    if flags & (_BITSHUFFLE | _DELTA):
        raise ValueError("bitshuffle/delta filters not implemented")

    nblocks = (nbytes + blocksize - 1) // blocksize
    bstarts = struct.unpack_from(f"<{nblocks}i", chunk, header_len)
    out = bytearray(nbytes)
    for i in range(nblocks):
        block_nbytes = min(blocksize, nbytes - i * blocksize)
        raw = _decompress_block_at(chunk, bstarts[i], flags, typesize,
                                   block_nbytes, blocksize)
        out[i * blocksize:i * blocksize + block_nbytes] = raw
    return bytes(out)


def _decompress_block_at(chunk, offset: int, flags: int, typesize: int,
                         block_nbytes: int, blocksize: int) -> bytes:
    # c-blosc never splits a leftover (short last) block, regardless of codec
    split = (typesize > 1 and not flags & _NOT_SPLIT
             and block_nbytes == blocksize
             and block_nbytes % typesize == 0)
    nstreams = typesize if split else 1
    stream_nbytes = block_nbytes // nstreams
    parts = []
    pos = offset
    for _ in range(nstreams):
        csize = struct.unpack_from("<i", chunk, pos)[0]
        pos += 4
        parts.append(_decompress_stream(bytes(chunk[pos:pos + csize]),
                                        flags, stream_nbytes))
        pos += csize
    raw = b"".join(parts)
    if flags & _SHUFFLE:
        raw = _unshuffle(raw, typesize)
    return raw


def decompress_block(chunk, iblock: int) -> bytes:
    """Decompress a single block of a chunk (partial reads)."""
    nbytes, blocksize, _cbytes, typesize, flags, header_len = chunk_info(chunk)
    if flags & _MEMCPYED:
        start = header_len + iblock * blocksize
        return bytes(chunk[start:start + min(blocksize, nbytes - iblock * blocksize)])
    if header_len == 32 and struct.unpack_from("<i", chunk, 12)[0] <= 36:
        return _special_fill(chunk, min(blocksize, nbytes - iblock * blocksize),
                             typesize)
    nblocks = (nbytes + blocksize - 1) // blocksize
    if not 0 <= iblock < nblocks:
        raise IndexError(iblock)
    bstart = struct.unpack_from("<i", chunk, header_len + 4 * iblock)[0]
    block_nbytes = min(blocksize, nbytes - iblock * blocksize)
    return _decompress_block_at(chunk, bstart, flags, typesize, block_nbytes,
                                blocksize)
