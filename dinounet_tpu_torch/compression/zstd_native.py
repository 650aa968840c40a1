"""The host C++ Zstandard decoder (``csrc/zstd_decode.cpp``) through ctypes.

The decoder that the read paths use: ``decode_into`` decodes a list of zstd
buffers, each straight into its destination (a contiguous CPU tensor or a
writable numpy array, often a slice of a larger one), over a pool of
threads, with the GIL released for the call. The library is built at first
use by the host compiler (``ops/_build.py::host_library``); a build that
fails raises with the compiler's output, and nothing falls back to the
pure-Python decoder (``compression/zstd.py``), which only the tests and an
explicit ``decoder="plain"`` select.
"""

import ctypes
import os
from typing import Sequence

import numpy as np

from dinounet_tpu_torch.compression import zstd as plain
from dinounet_tpu_torch.ops import _build

SOURCE = "zstd_decode.cpp"
_P, _U64 = ctypes.c_void_p, ctypes.c_uint64


def library() -> ctypes.CDLL:
    lib = _build.host_library(SOURCE)
    lib.zstd_decode_many.argtypes = [ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.zstd_decode_many.restype = ctypes.c_int
    lib.zstd_xxh64.argtypes = [_P, _U64]
    lib.zstd_xxh64.restype = _U64
    lib.zstd_crc32c.argtypes = [_P, _U64]
    lib.zstd_crc32c.restype = ctypes.c_uint32
    return lib


def default_threads() -> int:
    return max(1, len(os.sched_getaffinity(0)))


def _byte_view(buffer) -> np.ndarray:
    """A uint8 numpy view of a bytes-like object, a numpy array or a CPU
    tensor, sharing its memory."""
    if hasattr(buffer, "data_ptr"):  # a torch tensor
        if buffer.device.type != "cpu" or not buffer.is_contiguous():
            raise ValueError("the destination must be a contiguous CPU tensor")
        return buffer.view(-1).view(dtype=__import__("torch").uint8).numpy()
    if isinstance(buffer, np.ndarray):
        if not buffer.flags.c_contiguous:
            raise ValueError("the destination must be a C-contiguous array")
        return buffer.reshape(-1).view(np.uint8)
    return np.frombuffer(buffer, np.uint8)


def decode_into(sources: Sequence, destinations: Sequence, decoder: str = "native",
                threads: int = 0) -> None:
    """Decode ``sources[i]`` (a run of zstd frames) into ``destinations[i]``,
    which it must fill exactly. ``decoder="plain"`` runs the pure-Python
    reference instead. Raises ``ZstdError`` for corrupt input."""
    if len(sources) != len(destinations):
        raise ValueError("one destination per source")
    srcs = [_byte_view(s) for s in sources]
    dsts = [_byte_view(d) for d in destinations]
    for d in dsts:
        if not d.flags.writeable:
            raise ValueError("a destination is read-only")
    if decoder == "plain":
        for i, (s, d) in enumerate(zip(srcs, dsts)):
            out = plain.decompress(s, max_output_size=len(d))
            if len(out) != len(d):
                raise plain.ZstdError(f"job {i}: decoded to fewer bytes than its "
                                      "destination holds")
            d[:] = np.frombuffer(out, np.uint8)
        return
    if decoder != "native":
        raise ValueError(f"decoder must be 'native' or 'plain', not {decoder!r}")
    DecodeJobs(srcs, dsts).run(threads)


class DecodeJobs:
    """Sources and their destinations prepared for the library once (the
    pointer and length arrays built, the buffers kept alive), so that
    ``run`` is the C call alone: what a rate of the decoder times."""

    def __init__(self, sources: Sequence, destinations: Sequence):
        self.srcs = [_byte_view(s) for s in sources]
        self.dsts = [_byte_view(d) for d in destinations]
        n = self.n = len(self.srcs)
        if n != len(self.dsts):
            raise ValueError("one destination per source")
        if not all(d.flags.writeable for d in self.dsts):
            raise ValueError("a destination is read-only")
        self.src_ptr = (_P * n)(*[s.ctypes.data for s in self.srcs])
        self.src_len = (_U64 * n)(*[s.nbytes for s in self.srcs])
        self.dst_ptr = (_P * n)(*[d.ctypes.data for d in self.dsts])
        self.dst_len = (_U64 * n)(*[d.nbytes for d in self.dsts])
        self.written = (ctypes.c_int64 * n)()
        self.nbytes = sum(d.nbytes for d in self.dsts)

    def run(self, threads: int = 0, exact: bool = True) -> list:
        """Decode every job; the bytes each wrote (with `exact`, each its
        destination's size)."""
        if self.n == 0:
            return []
        err = ctypes.create_string_buffer(512)
        failed = library().zstd_decode_many(
            self.n, self.src_ptr, self.src_len, self.dst_ptr, self.dst_len, self.written,
            int(exact), threads or default_threads(), err, len(err))
        if failed:
            raise plain.ZstdError(f"{failed} of {self.n} zstd buffers failed: "
                                  f"{err.value.decode(errors='replace')}")
        return list(self.written)


def decompress(data, size: int, decoder: str = "native") -> bytes:
    """One buffer of frames that decodes to exactly `size` bytes."""
    out = np.empty(size, np.uint8)
    decode_into([data], [out], decoder)
    return out.tobytes()


def decompress_bounded(data, limit: int, decoder: str = "native") -> bytes:
    """One buffer of frames whose decoded size is not known (a frame that
    does not state it), at most `limit` bytes: decoded into a buffer that
    doubles until the frames fit."""
    if decoder == "plain":
        return plain.decompress(data, max_output_size=limit)
    cap = min(limit, max(1 << 16, 8 * len(data)))
    while True:
        out = np.empty(cap, np.uint8)
        try:
            n = DecodeJobs([data], [out]).run(1, exact=False)[0]
            return out[:n].tobytes()
        except plain.ZstdError as e:
            if "larger than its destination" not in str(e) or cap >= limit:
                raise
            cap = min(limit, 2 * cap)


def xxh64(data) -> int:
    """xxHash64 from the library (the tests hold it against the Python one)."""
    view = _byte_view(data)
    return library().zstd_xxh64(view.ctypes.data, view.nbytes)


def crc32c(data) -> int:
    """CRC-32C from the library (the OCDBT files' checksum)."""
    view = _byte_view(data)
    return library().zstd_crc32c(view.ctypes.data, view.nbytes)
