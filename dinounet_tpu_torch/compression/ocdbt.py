"""A read-only OCDBT key-value store (tensorstore's "ocdbt" format).

Orbax writes a checkpoint's arrays into an OCDBT database: a copy-on-write
B+tree whose manifest, nodes and values live in files under the store's
directory. The JAX package's sharded checkpoints (its
``training/checkpointing.py::save_checkpoint_sharded``) have one at
``arrays/``: a root ``manifest.ocdbt`` whose tree points into the per-process
databases ``ocdbt.process_<i>/``, each with its own manifest (a directory
with a process manifest alone is read through that).

Every file the reader parses (a manifest or a B+tree node) is

  | magic u32 big-endian | length u64 | version varint | compression varint |
  | body (a zstd frame where compression is 1) | CRC-32C u32 of the rest |

magic 0x0cdb3a2a for a manifest, 0x0cdb20de for a B+tree node. The CRC-32C
(Castagnoli; ``zlib.crc32`` is another polynomial) is verified for each.

manifest body: config (uuid[16], manifest kind, max inline value bytes, max
  decoded node bytes (varints), version tree arity log2 (u8), compression
  method (varint; zstd adds its level as i32)), then for a single-file
  manifest the data-file table, the inline versions (count; then per
  version, column by column: generation, root height (u8), data file,
  offset, length, three statistics, commit time (u64)) and the references
  to older version-tree nodes, which a reader of the latest version skips.
data-file table: count; path prefix lengths (from the second file on,
  shared with the previous path); suffix lengths; base-path lengths; the
  suffixes. A path is relative to the base path of the file that holds the
  table (the root manifest's directory to begin with).
B+tree node body: height (u8), data-file table, entry count, key prefix
  lengths (from the second entry on), key suffix lengths, for an interior
  node the subtree common prefix lengths, the key suffixes; then a leaf has
  value lengths, value kinds (0 inline, 1 in a data file), the data file
  and offset of each out-of-line value, and the inline values end to end;
  an interior node has each child's data file, offset, length and three
  statistics. A child's keys omit its entry's subtree common prefix.

``OcdbtStore(directory).keys()`` lists the keys, ``read(key)`` returns a
value, ``read_many(keys)`` reads values grouped by data file and ordered by
offset. Files are read by ``pread`` (values) or whole only where they are
nodes; a data file is never read whole.
"""

import os
import struct
from typing import Dict, Iterable, List, Optional, Tuple

from dinounet_tpu_torch.compression import zstd, zstd_native

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_MANIFEST_LIMIT = 1 << 30  # a manifest's decoded bytes at most

_CRC_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli, reflected), as tensorstore checks its files."""
    crc ^= 0xFFFFFFFF
    table = _CRC_TABLE
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class OcdbtError(ValueError):
    """A malformed, corrupt or unsupported OCDBT file."""


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            if self.pos >= len(self.data):
                raise OcdbtError(f"{self.what}: truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))


def _prefixed(r: _Reader, n: int, extra_columns: int = 0):
    """n prefix-compressed byte strings: (strings, extra varint columns read
    between the suffix lengths and the suffixes)."""
    prefix = r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    columns = [r.varints(n) for _ in range(extra_columns)]
    out, prev = [], b""
    for i in range(n):
        p = prefix[i - 1] if i else 0
        if p > len(prev):
            raise OcdbtError(f"{r.what}: prefix longer than the previous string")
        prev = prev[:p] + r.take(suffix[i])
        out.append(prev)
    return out, columns


def _data_file_table(r: _Reader, base: str) -> List[Tuple[str, str]]:
    """The table's (path, base path) pairs, each joined to `base`, the base
    path of the file that holds the table."""
    paths, (base_lengths,) = _prefixed(r, r.varint(), extra_columns=1)
    out = []
    for path, blen in zip(paths, base_lengths):
        if blen > len(path):
            raise OcdbtError(f"{r.what}: base path longer than its path")
        path = path.decode()
        out.append((base + path, base + path[:blen]))
    return out


class OcdbtStore:
    """The latest version of the OCDBT database at `directory`.

    decoder: "native" (the host C++ decoder; the read paths) or "plain"
    (the pure-Python reference; the tests)."""

    def __init__(self, directory: str, decoder: str = "native"):
        self.directory = os.path.abspath(directory)
        self.decoder = decoder
        manifest = os.path.join(self.directory, "manifest.ocdbt")
        if not os.path.isfile(manifest):
            processes = sorted(d for d in os.listdir(self.directory)
                               if d.startswith("ocdbt.process_"))
            if len(processes) != 1:
                raise OcdbtError(f"{self.directory}: no manifest.ocdbt, and "
                                 f"{len(processes)} process databases")
            self.directory = os.path.join(self.directory, processes[0])
            manifest = os.path.join(self.directory, "manifest.ocdbt")
        self._entries: Optional[Dict[bytes, tuple]] = None
        self._max_node_bytes = _MANIFEST_LIMIT  # until the manifest says
        self._root = self._read_manifest(manifest)

    # ------------------------------------------------------------- files

    def _file_body(self, raw: bytes, magic: int, what: str) -> bytes:
        if len(raw) < 18:
            raise OcdbtError(f"{what}: shorter than a header")
        got_magic, length = struct.unpack_from(">I", raw)[0], struct.unpack_from("<Q", raw, 4)[0]
        if got_magic != magic:
            raise OcdbtError(f"{what}: magic 0x{got_magic:08x}, expected 0x{magic:08x}")
        if length != len(raw):
            raise OcdbtError(f"{what}: length field {length} != {len(raw)} bytes read")
        want = struct.unpack_from("<I", raw, length - 4)[0]
        got = self._crc(raw[:length - 4])
        if got != want:
            raise OcdbtError(f"{what}: CRC-32C 0x{got:08x} != stored 0x{want:08x}")
        r = _Reader(raw[:length - 4], what)
        r.pos = 12
        version, compression = r.varint(), r.varint()
        if version != 0:
            raise OcdbtError(f"{what}: format version {version} is not supported")
        body = raw[r.pos:length - 4]
        if compression == 0:
            return body
        if compression != 1:
            raise OcdbtError(f"{what}: compression format {compression} is not supported")
        size = zstd.frames_content_size(body)
        if size is None:
            return zstd_native.decompress_bounded(body, self._max_node_bytes, self.decoder)
        return zstd_native.decompress(body, size, self.decoder)

    def _crc(self, data: bytes) -> int:
        if self.decoder == "plain":
            return crc32c(data)
        return zstd_native.crc32c(data)

    def _pread(self, path: str, offset: int, length: int) -> bytes:
        fd = os.open(os.path.join(self.directory, path), os.O_RDONLY)
        try:
            out = os.pread(fd, length, offset)
        finally:
            os.close(fd)
        if len(out) != length:
            raise OcdbtError(f"{path}: {length} bytes at {offset} run past its end")
        return out

    # ---------------------------------------------------------- manifest

    def _read_manifest(self, path: str):
        with open(path, "rb") as f:
            raw = f.read()
        r = _Reader(self._file_body(raw, MANIFEST_MAGIC, path), path)
        r.take(16)  # uuid
        kind = r.varint()
        r.varint()  # max inline value bytes
        self._max_node_bytes = r.varint()
        r.u8()  # version tree arity log2
        if r.varint() == 1:
            r.take(4)  # zstd level
        if kind != 0:
            raise OcdbtError(f"{path}: a numbered manifest (kind {kind}) is not supported")
        files = _data_file_table(r, "")
        n = r.varint()
        if n == 0:
            return None
        generation = r.varints(n)
        height = list(r.take(n))
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(n), r.varints(n), r.varints(n)  # statistics
        r.u64s(n)  # commit times
        latest = max(range(n), key=generation.__getitem__)
        if file_id[latest] >= len(files):
            raise OcdbtError(f"{path}: data file {file_id[latest]} not in its table")
        return (height[latest], *files[file_id[latest]], offset[latest], length[latest])

    # -------------------------------------------------------------- tree

    def _node(self, path: str, offset: int, length: int, base: str):
        raw = self._pread(path, offset, length)
        what = f"{path}@{offset}"
        r = _Reader(self._file_body(raw, NODE_MAGIC, what), what)
        height = r.u8()
        files = _data_file_table(r, base)
        n = r.varint()
        if height == 0:
            keys, _ = _prefixed(r, n)
            lengths, kinds = r.varints(n), r.varints(n)
            outside = [i for i in range(n) if kinds[i] == 1]
            if any(k not in (0, 1) for k in kinds):
                raise OcdbtError(f"{what}: unknown value kind")
            ids, offsets = r.varints(len(outside)), r.varints(len(outside))
            values = {}
            for j, i in enumerate(outside):
                if ids[j] >= len(files):
                    raise OcdbtError(f"{what}: data file {ids[j]} not in its table")
                values[i] = ("file", files[ids[j]][0], offsets[j], lengths[i])
            for i in range(n):
                if kinds[i] == 0:
                    values[i] = ("inline", r.take(lengths[i]))
            if r.pos != len(r.data):
                raise OcdbtError(f"{what}: {len(r.data) - r.pos} bytes after the values")
            return height, [(keys[i], values[i]) for i in range(n)]
        keys, (common,) = _prefixed(r, n, extra_columns=1)
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        r.varints(n), r.varints(n), r.varints(n)  # statistics
        children = []
        for i in range(n):
            if ids[i] >= len(files) or common[i] > len(keys[i]):
                raise OcdbtError(f"{what}: bad child reference")
            children.append((keys[i][:common[i]], *files[ids[i]], offsets[i], lengths[i]))
        return height, children

    def _walk(self):
        entries: Dict[bytes, tuple] = {}
        if self._root is None:
            return entries
        height, path, base, offset, length = self._root
        stack = [(b"", path, base, offset, length, height)]
        while stack:
            prefix, path, base, offset, length, want = stack.pop()
            height, items = self._node(path, offset, length, base)
            if height != want:
                raise OcdbtError(f"{path}@{offset}: height {height}, expected {want}")
            if height == 0:
                for key, value in items:
                    entries[prefix + key] = value
            else:
                for common, child, child_base, off, ln in items:
                    stack.append((prefix + common, child, child_base, off, ln, height - 1))
        return entries

    def _index(self) -> Dict[bytes, tuple]:
        if self._entries is None:
            self._entries = self._walk()
        return self._entries

    # --------------------------------------------------------------- API

    def keys(self) -> List[str]:
        return sorted(k.decode() for k in self._index())

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._index()

    def read(self, key: str) -> bytes:
        return self.read_many([key])[key]

    def value_location(self, key: str) -> tuple:
        """("inline", bytes) or ("file", path, offset, length) of a key."""
        try:
            return self._index()[key.encode()]
        except KeyError:
            raise KeyError(f"{key!r} is not in the OCDBT store at {self.directory}") from None

    def read_many(self, keys: Iterable[str]) -> Dict[str, bytes]:
        """Values of `keys`, read file by file in offset order."""
        out, by_file = {}, {}
        for key in keys:
            loc = self.value_location(key)
            if loc[0] == "inline":
                out[key] = loc[1]
            else:
                by_file.setdefault(loc[1], []).append((loc[2], loc[3], key))
        for path, spans in by_file.items():
            fd = os.open(os.path.join(self.directory, path), os.O_RDONLY)
            try:
                for offset, length, key in sorted(spans):
                    data = os.pread(fd, length, offset)
                    if len(data) != length:
                        raise OcdbtError(f"{path}: value of {key!r} runs past its end")
                    out[key] = data
            finally:
                os.close(fd)
        return out
