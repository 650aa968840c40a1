"""Blosc2 NDim (.b2nd) container: contiguous frame + b2nd metalayer.

Counterpart of ``dinounet_tpu/compression/b2nd.py``: one array written by
either package gives the same file, byte for byte, and each reads the
other's files (tests/test_torch_b2nd.py).

The on-disk format is the Blosc2 "contiguous frame" (cframe):

    | header | chunk 0 | ... | chunk N-1 | chunk-offsets chunk | trailer |

with an ``b2nd`` metalayer in the header carrying (shape, chunkshape,
blockshape, dtype). Field layout follows c-blosc2's frame spec
(README_CFRAME_FORMAT.rst / frame.c): the chunk layer below it is held
byte for byte against libblosc where that library is installed, and the
container's fixed offsets are checked structurally (msgpack-walked); a
cross-check against python-blosc2 runs wherever that package imports.

Array semantics (matching blosc2 NDim):
  * the array is tiled by ``chunks``; each chunk is tiled by ``blocks``;
  * a chunk's buffer holds its blocks in row-major grid order, each block
    row-major and zero-padded to the full blockshape; edge chunks are
    padded to the full chunkshape (so every chunk has the same nbytes);
  * one Blosc chunk per array chunk, blocksize == prod(blocks)*itemsize.

The reader is lazy: ``B2NDArray`` mmaps the file, keeps the chunk-offsets
table, and ``__getitem__`` decompresses only the blocks that intersect the
requested slice — the property the reference's patch loader relies on
(ref dinounet/training/dataloading/nnunet_dataset.py:229-253: open once,
read one patch bbox per case).
"""

import mmap
import os
import struct
from typing import Optional, Sequence, Tuple

import numpy as np

from dinounet_tpu_torch.compression import blosc1_chunk
from dinounet_tpu_torch.compression import minimsgpack as mp

_MAGIC = "b2frame\x00"

# frame header general-flags byte: same constants c-blosc2 writes
_FLAGS0 = 0x00
# codec byte: compcode | clevel << 4 (compcode 5 = zstd in blosc2's tables)
_COMPCODE_ZSTD = 5
_FILTER_SHUFFLE = 1


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class _Layout:
    """Chunk/block grid arithmetic shared by reader and writer."""

    def __init__(self, shape, chunks, blocks, itemsize):
        self.shape = tuple(int(s) for s in shape)
        self.chunks = tuple(int(c) for c in chunks)
        self.blocks = tuple(int(b) for b in blocks)
        self.itemsize = itemsize
        self.ndim = len(self.shape)
        if not (self.ndim == len(self.chunks) == len(self.blocks)):
            raise ValueError("shape/chunks/blocks rank mismatch")
        if any(b > c for b, c in zip(self.blocks, self.chunks)):
            raise ValueError(f"blocks {self.blocks} exceed chunks {self.chunks}")
        self.chunk_grid = tuple(_ceil_div(s, c)
                                for s, c in zip(self.shape, self.chunks))
        self.block_grid = tuple(_ceil_div(c, b)
                                for c, b in zip(self.chunks, self.blocks))
        # chunk buffer is padded so full blocks tile it exactly
        self.ext_chunks = tuple(g * b
                                for g, b in zip(self.block_grid, self.blocks))
        self.nchunks = int(np.prod(self.chunk_grid)) if self.ndim else 1
        self.blocks_per_chunk = int(np.prod(self.block_grid))
        self.block_nbytes = int(np.prod(self.blocks)) * itemsize
        self.chunk_nbytes = self.blocks_per_chunk * self.block_nbytes


def _pack_b2nd_meta(layout: _Layout, dtype: np.dtype) -> bytes:
    """b2nd metalayer payload: msgpack
    [version, ndim, shape(i64...), chunks(i32...), blocks(i32...),
     dtype_format, dtype_str]; dtype_format 0 = NumPy str() repr."""
    out = bytearray()
    out += bytes([0x97])  # fixarray(7)
    out += mp.pack(0)
    out += mp.pack(layout.ndim)
    out += bytes([0x90 | layout.ndim])
    for s in layout.shape:
        out += mp.pack_fixed_int(s, 8)
    for dims in (layout.chunks, layout.blocks):
        out += bytes([0x90 | layout.ndim])
        for d in dims:
            out += mp.pack_fixed_int(d, 4)
    out += mp.pack(0)
    out += mp.pack(str(dtype))
    return bytes(out)


def _parse_b2nd_meta(payload) -> Tuple[tuple, tuple, tuple, np.dtype]:
    meta, _ = mp.unpack_from(payload, 0)
    if not isinstance(meta, list) or len(meta) < 5:
        raise ValueError("bad b2nd metalayer")
    _version, ndim, shape, chunks, blocks = meta[:5]
    dtype = np.dtype(meta[6]) if len(meta) >= 7 else np.dtype("uint8")
    if not (len(shape) == len(chunks) == len(blocks) == ndim):
        raise ValueError("b2nd metalayer rank mismatch")
    return tuple(shape), tuple(chunks), tuple(blocks), dtype


def _build_header(layout: _Layout, dtype: np.dtype, cbytes: int,
                  clevel: int) -> bytes:
    """Frame header per the cframe spec's fixed offsets."""
    meta_payload = _pack_b2nd_meta(layout, dtype)
    nbytes = layout.nchunks * layout.chunk_nbytes

    # metalayers section: int16 idx-size, map name -> int32 offset, contents
    content_marker = b"\xc6" + struct.pack(">I", len(meta_payload))
    map_part = bytearray()
    map_part += bytes([0x81])          # fixmap(1)
    map_part += mp.pack("b2nd")
    # offset of the metalayer content, relative to the frame start; filled
    # below once the fixed part's size is known
    offset_pos = len(map_part) + 1
    map_part += mp.pack_fixed_int(0, 4)

    head = bytearray()
    head += bytes([0x90 | 14])                      # 0: fixarray
    head += bytes([0xA8]) + _MAGIC.encode()         # 1: magic
    head += mp.pack_fixed_int(0, 4)                 # 10: header length (below)
    head += mp.pack_fixed_int(0, 8)                 # 15: frame length (below)
    head += bytes([0xA4, _FLAGS0,                   # 24: flags fixstr(4)
                   (_COMPCODE_ZSTD | (min(clevel, 15) << 4)) & 0xFF, 0, 0])
    head += mp.pack_fixed_int(nbytes, 8)            # 29: uncompressed bytes
    head += mp.pack_fixed_int(cbytes, 8)            # 38: compressed bytes
    head += mp.pack_fixed_int(layout.itemsize, 4)   # 47: typesize
    head += mp.pack_fixed_int(layout.block_nbytes, 4)   # 52: blocksize
    head += mp.pack_fixed_int(layout.chunk_nbytes, 4)   # 57: chunksize
    head += mp.pack_fixed_int(1, 2)                 # 62: compress nthreads
    head += mp.pack_fixed_int(1, 2)                 # 65: decompress nthreads
    head += b"\xc2"                                 # 68: has_vlmetalayers
    head += bytes([0xD8, 0])                        # 69: filter pipeline ext16
    filters = bytearray(16)
    filters[5] = _FILTER_SHUFFLE                    # last slot applies last
    head += filters                                 # 71..86
    assert len(head) == 87, len(head)

    head += mp.pack_fixed_int(len(map_part), 2)     # 87: metalayers idx size
    content_off = len(head) + len(map_part)
    struct.pack_into(">i", map_part, offset_pos, content_off)
    head += map_part
    head += content_marker + meta_payload

    header_len = len(head)
    struct.pack_into(">i", head, 11, header_len)
    return bytes(head)


class _Header:
    __slots__ = ("header_len", "frame_len", "nbytes", "cbytes", "typesize",
                 "blocksize", "chunksize", "meta")

    @classmethod
    def parse(cls, buf) -> "_Header":
        if buf[1] != 0xA8 or bytes(buf[2:10]) != _MAGIC.encode():
            raise ValueError("not a blosc2 contiguous frame (magic mismatch)")
        self = cls()
        # fixed-offset fields (every writer emits fixed-width ints here)
        self.header_len = struct.unpack_from(">i", buf, 11)[0]
        self.frame_len = struct.unpack_from(">q", buf, 16)[0]
        self.nbytes = struct.unpack_from(">q", buf, 30)[0]
        self.cbytes = struct.unpack_from(">q", buf, 39)[0]
        self.typesize = struct.unpack_from(">i", buf, 48)[0]
        self.blocksize = struct.unpack_from(">i", buf, 53)[0]
        self.chunksize = struct.unpack_from(">i", buf, 58)[0]
        # metalayers: int16 idx size at 87, then map name -> offset
        self.meta = {}
        if self.header_len > 89:
            names, _ = mp.unpack_from(buf, 90)
            if isinstance(names, dict):
                for name, off in names.items():
                    payload, _ = mp.unpack_from(buf, off)
                    self.meta[name] = payload
        return self


def _build_trailer(has_meta: bool = False) -> bytes:
    """Minimal frame trailer: [version, vlmetalayers, trailer_len, fingerprint]."""
    out = bytearray()
    out += bytes([0x94])      # fixarray(4)
    out += mp.pack(1)         # trailer version
    out += bytes([0x80])      # empty vlmetalayers map
    out += b"\xce" + struct.pack(">I", 0)   # trailer length (filled below)
    out += bytes([0xD8, 0]) + bytes(16)     # fingerprint ext16 (unused)
    struct.pack_into(">I", out, len(out) - 18 - 4, len(out))
    return bytes(out)


def save_b2nd(array: np.ndarray, path: str,
              chunks: Optional[Sequence[int]] = None,
              blocks: Optional[Sequence[int]] = None,
              clevel: int = 8, codec: str = "zstd") -> None:
    """Write a numpy array as a .b2nd contiguous frame (zstd + shuffle)."""
    array = np.ascontiguousarray(array)
    if array.ndim == 0:
        array = array.reshape(1)
    if chunks is None:
        chunks = _default_chunks(array.shape, array.itemsize)
    chunks = tuple(min(int(c), s) for c, s in zip(chunks, array.shape))
    if blocks is None:
        blocks = _default_blocks(chunks, array.itemsize)
    blocks = tuple(min(int(b), c) for b, c in zip(blocks, chunks))
    layout = _Layout(array.shape, chunks, blocks, array.itemsize)

    chunks_blobs = []
    for ci in np.ndindex(*layout.chunk_grid):
        buf = _gather_chunk(array, layout, ci)
        chunks_blobs.append(blosc1_chunk.compress_chunk(
            buf, min(array.itemsize, 255), layout.block_nbytes,
            clevel=clevel, shuffle=True, codec=codec))
    cbytes = sum(len(b) for b in chunks_blobs)

    header = _build_header(layout, array.dtype, cbytes, clevel)
    # chunk-offsets chunk: int64 offsets of each chunk relative to the start
    # of the chunks section, stored as an uncompressed special chunk
    offsets = np.zeros(layout.nchunks, np.int64)
    pos = 0
    for i, blob in enumerate(chunks_blobs):
        offsets[i] = pos
        pos += len(blob)
    coffsets = blosc1_chunk.compress_chunk(
        offsets.tobytes(), 8, max(len(offsets) * 8, 8), clevel=5,
        shuffle=False, codec=codec)
    trailer = _build_trailer()

    frame_len = len(header) + cbytes + len(coffsets) + len(trailer)
    header = bytearray(header)
    struct.pack_into(">q", header, 16, frame_len)
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        f.write(header)
        for blob in chunks_blobs:
            f.write(blob)
        f.write(coffsets)
        f.write(trailer)
    os.replace(tmp, path)


def _gather_chunk(array: np.ndarray, layout: _Layout, ci) -> bytes:
    """One chunk's buffer: blocks in grid order, zero-padded to blockshape."""
    ndim = layout.ndim
    chunk_origin = [ci[d] * layout.chunks[d] for d in range(ndim)]
    out = np.zeros((layout.blocks_per_chunk,) + layout.blocks, array.dtype)
    for bi_flat, bi in enumerate(np.ndindex(*layout.block_grid)):
        src_slices, dst_slices, empty = [], [], False
        for d in range(ndim):
            start = chunk_origin[d] + bi[d] * layout.blocks[d]
            stop = min(start + layout.blocks[d],
                       chunk_origin[d] + layout.chunks[d],
                       layout.shape[d])
            if stop <= start:
                empty = True
                break
            src_slices.append(slice(start, stop))
            dst_slices.append(slice(0, stop - start))
        if not empty:
            out[bi_flat][tuple(dst_slices)] = array[tuple(src_slices)]
    return out.tobytes()


def _default_chunks(shape, itemsize, target=1 << 20):
    chunks = list(shape)
    while int(np.prod(chunks)) * itemsize > target:
        d = int(np.argmax(chunks))
        if chunks[d] == 1:
            break
        chunks[d] = _ceil_div(chunks[d], 2)
    return tuple(chunks)


def _default_blocks(chunks, itemsize, target=1 << 15):
    return _default_chunks(chunks, itemsize, target)


class B2NDArray:
    """Lazy .b2nd reader: mmap + per-block decompression on slicing."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        self._map = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._header = _Header.parse(self._map)
        if "b2nd" not in self._header.meta:
            raise ValueError(f"{path}: frame has no b2nd metalayer")
        shape, chunks, blocks, dtype = _parse_b2nd_meta(
            self._header.meta["b2nd"])
        self.dtype = dtype
        self.layout = _Layout(shape, chunks, blocks, dtype.itemsize)
        if self.layout.chunk_nbytes != self._header.chunksize:
            raise ValueError(f"{path}: chunksize mismatch "
                             f"({self.layout.chunk_nbytes} vs header "
                             f"{self._header.chunksize})")
        coff_pos = self._header.header_len + self._header.cbytes
        raw = blosc1_chunk.decompress_chunk(
            memoryview(self._map)[coff_pos:])
        self._chunk_offsets = np.frombuffer(raw, np.int64)
        if len(self._chunk_offsets) < self.layout.nchunks:
            raise ValueError(f"{path}: offsets table too short")

    # -- container interface ------------------------------------------------
    @property
    def shape(self):
        return self.layout.shape

    @property
    def chunks(self):
        return self.layout.chunks

    @property
    def blocks(self):
        return self.layout.blocks

    @property
    def ndim(self):
        return self.layout.ndim

    def __len__(self):
        return self.shape[0] if self.ndim else 0

    def close(self):
        self._map.close()
        self._file.close()

    def __getitem__(self, key) -> np.ndarray:
        starts, stops, squeeze = self._normalize_key(key)
        out_shape = tuple(b - a for a, b in zip(starts, stops))
        out = np.zeros(out_shape, self.dtype)
        lay = self.layout
        c_lo = [a // c for a, c in zip(starts, lay.chunks)]
        c_hi = [_ceil_div(b, c) if b > a else a // c + 1
                for a, b, c in zip(starts, stops, lay.chunks)]
        for ci in np.ndindex(*[hi - lo for lo, hi in zip(c_lo, c_hi)]):
            self._read_chunk_region(
                tuple(lo + i for lo, i in zip(c_lo, ci)), starts, stops, out)
        if any(squeeze):
            out = out.reshape([n for n, s in zip(out_shape, squeeze)
                               if not s])
        return out

    def _normalize_key(self, key):
        if key is Ellipsis:
            key = (slice(None),) * self.ndim
        if not isinstance(key, tuple):
            key = (key,)
        if Ellipsis in key:
            i = key.index(Ellipsis)
            key = key[:i] + (slice(None),) * (self.ndim - len(key) + 1) \
                + key[i + 1:]
        key = key + (slice(None),) * (self.ndim - len(key))
        if len(key) != self.ndim:
            raise IndexError(f"too many indices for {self.ndim}-d array")
        starts, stops, squeeze = [], [], []
        for k, n in zip(key, self.shape):
            if isinstance(k, (int, np.integer)):
                k = int(k)
                if k < 0:
                    k += n
                if not 0 <= k < n:
                    raise IndexError(f"index {k} out of bounds for size {n}")
                starts.append(k)
                stops.append(k + 1)
                squeeze.append(True)
            elif isinstance(k, slice):
                a, b, step = k.indices(n)
                if step != 1:
                    raise IndexError("b2nd slicing supports step 1 only")
                starts.append(a)
                stops.append(max(a, b))
                squeeze.append(False)
            else:
                raise IndexError(f"unsupported index {k!r}")
        return starts, stops, squeeze

    def _read_chunk_region(self, ci, starts, stops, out):
        lay = self.layout
        flat = int(np.ravel_multi_index(ci, lay.chunk_grid))
        base = self._header.header_len + int(self._chunk_offsets[flat])
        chunk = memoryview(self._map)[base:]
        chunk_origin = [c * s for c, s in zip(ci, lay.chunks)]
        # intersection of the request with this chunk, in chunk coordinates
        lo = [max(a - o, 0) for a, o in zip(starts, chunk_origin)]
        hi = [min(b - o, c) for b, o, c in zip(stops, chunk_origin, lay.chunks)]
        if any(h <= l for l, h in zip(lo, hi)):
            return
        b_lo = [l // b for l, b in zip(lo, lay.blocks)]
        b_hi = [_ceil_div(h, b) for h, b in zip(hi, lay.blocks)]
        for bi in np.ndindex(*[h - l for l, h in zip(b_lo, b_hi)]):
            bidx = tuple(l + i for l, i in zip(b_lo, bi))
            bflat = int(np.ravel_multi_index(bidx, lay.block_grid))
            raw = blosc1_chunk.decompress_block(chunk, bflat)
            block = np.frombuffer(raw, self.dtype).reshape(lay.blocks)
            borigin = [b * s for b, s in zip(bidx, lay.blocks)]
            src, dst = [], []
            for d in range(lay.ndim):
                l = max(lo[d], borigin[d])
                h = min(hi[d], borigin[d] + lay.blocks[d])
                src.append(slice(l - borigin[d], h - borigin[d]))
                dst.append(slice(l + chunk_origin[d] - starts[d],
                                 h + chunk_origin[d] - starts[d]))
            out[tuple(dst)] = block[tuple(src)]


def open_b2nd(path: str) -> B2NDArray:
    return B2NDArray(path)
