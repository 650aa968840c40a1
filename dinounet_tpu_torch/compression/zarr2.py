"""zarr v2 arrays over a key-value store (the arrays of an orbax checkpoint).

An array is a ``<prefix>/.zarray`` JSON record (shape, chunks, dtype,
compressor, fill value, order, dimension separator) and one value per chunk
at ``<prefix>/<i>.<j>...`` (zarr v2 storage spec): the chunk's elements in C
order, whole even where the chunk passes the array's edge, compressed as a
whole by the compressor (here zstd, or none). Orbax writes every chunk
(``store_array_data_equal_to_fill_value``), so a missing chunk is an error
unless the array has a fill value.

``ZarrArray(store, prefix).read_region(index)`` decodes only the chunks that
overlap a region (a tuple of slices, step 1): a chunk that lies whole and
contiguous inside the output is decoded straight into its place, any other
into a scratch buffer from which its overlap is copied, at most one such
buffer a decoding thread at a time. ``bfloat16`` arrays come back as
``torch.bfloat16`` tensors from their uint16 bits.
"""

import json
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dinounet_tpu_torch.compression import zstd_native

_DTYPES = {
    "bfloat16": torch.bfloat16, "<f2": torch.float16, "<f4": torch.float32,
    "<f8": torch.float64, "<i1": torch.int8, "|i1": torch.int8, "<i2": torch.int16,
    "<i4": torch.int32, "<i8": torch.int64, "|b1": torch.bool, "|u1": torch.uint8,
}


class ZarrError(ValueError):
    """A zarr v2 array this reader does not take, or a missing chunk."""


class ZarrArray:
    def __init__(self, store, prefix: str):
        self.store, self.prefix = store, prefix.rstrip("/")
        self.threads = zstd_native.default_threads()
        meta = json.loads(bytes(store.read(f"{self.prefix}/.zarray")))
        if meta.get("zarr_format") != 2:
            raise ZarrError(f"{prefix}: zarr format {meta.get('zarr_format')}, not 2")
        if meta["dtype"] not in _DTYPES:
            raise ZarrError(f"{prefix}: dtype {meta['dtype']!r} is not supported")
        if meta.get("order", "C") != "C":
            raise ZarrError(f"{prefix}: only C-order chunks are supported")
        if meta.get("filters"):
            raise ZarrError(f"{prefix}: filters {meta['filters']} are not supported")
        compressor = meta.get("compressor")
        if compressor is not None and compressor.get("id") != "zstd":
            raise ZarrError(f"{prefix}: compressor {compressor.get('id')!r} is not supported")
        self.compressed = compressor is not None
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = _DTYPES[meta["dtype"]]
        self.itemsize = torch.empty((), dtype=self.dtype).element_size()
        self.separator = meta.get("dimension_separator", ".")
        self.fill_value = meta.get("fill_value")
        if len(self.chunks) != len(self.shape):
            raise ZarrError(f"{prefix}: chunks {self.chunks} do not match shape {self.shape}")

    def chunk_key(self, index: Tuple[int, ...]) -> str:
        return f"{self.prefix}/" + (self.separator.join(map(str, index)) if index else "0")

    def read(self) -> torch.Tensor:
        return self.read_region(tuple(slice(0, n) for n in self.shape))

    def read_region(self, index: Sequence[slice]) -> torch.Tensor:
        """The region `index` (one slice a dim, step 1) as a new contiguous
        tensor."""
        box = []
        for s, n in zip(index, self.shape):
            start, stop, step = s.indices(n)
            if step != 1:
                raise ZarrError("read_region takes slices of step 1")
            box.append((start, max(stop, start)))
        if len(box) != len(self.shape):
            raise ZarrError(f"{len(index)} slices for {len(self.shape)} dims")
        out = torch.empty(tuple(b - a for a, b in box), dtype=self.dtype)
        if out.numel() == 0:
            return out
        grids = [range(a // c, (b - 1) // c + 1) for (a, b), c in zip(box, self.chunks)]
        todo = list(np.ndindex(*[len(g) for g in grids])) if grids else [()]
        chunk_ids = [tuple(g[i] for g, i in zip(grids, t)) for t in todo]
        batch, scratch = [], 0
        for cid in chunk_ids:
            batch.append(cid)
            scratch += self._direct_offset(*self._slices(cid, box), out) is None
            if scratch >= self.threads:
                self._read_batch(batch, box, out)
                batch, scratch = [], 0
        if batch:
            self._read_batch(batch, box, out)
        return out

    def _slices(self, cid, box):
        """(the chunk's part inside the region, that part's place in the
        region's output)."""
        lo = [c * n for c, n in zip(cid, self.chunks)]
        inner = tuple(slice(max(a, l) - l, min(b, l + n) - l)
                      for (a, b), l, n in zip(box, lo, self.chunks))
        outer = tuple(slice(max(a, l) - a, min(b, l + n) - a)
                      for (a, b), l, n in zip(box, lo, self.chunks))
        return inner, outer

    def _read_batch(self, chunk_ids, box, out: torch.Tensor) -> None:
        """Decode a batch of chunks in one call: those that lie whole and
        contiguous in `out` straight into it, the others (at most one a
        thread) into scratch buffers, then copy their overlaps."""
        keys = [self.chunk_key(c) for c in chunk_ids]
        present = [k for k in keys if k in self.store]
        values = self.store.read_many(present)
        out_bytes = out.view(-1).view(torch.uint8)
        chunk_n = math.prod(self.chunks)
        sources, dests, copies = [], [], []
        for cid, key in zip(chunk_ids, keys):
            inner, outer = self._slices(cid, box)
            if key not in values:
                if self.fill_value is None:
                    raise ZarrError(f"chunk {key} is missing and the array has no fill value")
                out[outer] = self.fill_value
                continue
            offset = self._direct_offset(inner, outer, out)
            if offset is not None:
                dest = out_bytes[offset:offset + chunk_n * self.itemsize]
                scratch = None
            else:
                scratch = torch.empty(self.chunks, dtype=self.dtype)
                dest = scratch.view(-1).view(torch.uint8)
            if self.compressed:
                sources.append(values[key])
                dests.append(dest)
            else:
                raw = values[key]
                if len(raw) != dest.numel():
                    raise ZarrError(f"chunk {key}: {len(raw)} bytes, expected {dest.numel()}")
                dest.copy_(torch.frombuffer(bytearray(raw), dtype=torch.uint8))
            if scratch is not None:
                copies.append((outer, scratch, inner))
        if sources:
            zstd_native.decode_into(sources, dests, threads=self.threads)
        for outer, scratch, inner in copies:
            out[outer] = scratch[inner]

    def _direct_offset(self, inner, outer, out: torch.Tensor) -> Optional[int]:
        """The byte offset in `out` where the chunk can be decoded in place:
        the chunk lies whole inside the region and its elements are
        contiguous there (every dim after the first whole in both)."""
        if any(s.start != 0 or s.stop != n for s, n in zip(inner, self.chunks)):
            return None
        for d in range(1, len(self.chunks)):
            if self.chunks[d] != out.shape[d]:
                return None
        if not self.chunks:
            return 0
        row = math.prod(out.shape[1:]) if out.dim() > 1 else 1
        return outer[0].start * row * self.itemsize
