"""Minimal msgpack encoder/decoder.

Counterpart of ``dinounet_tpu/compression/minimsgpack.py``. The Blosc2
contiguous-frame header, metalayers and trailer are msgpack structures
(c-blosc2 README_CFRAME_FORMAT.rst), and so are flax's checkpoint files
(``flax.serialization.msgpack_serialize``: every array an ext value, those
over 64 KiB as ext 32). The machines the port runs on have no msgpack
package, and the subset needed is small: nil/bool/int/float/str/bin/array/
map/ext with fixed-width (big-endian, as msgpack mandates) integer forms.

``unpack_from`` copies nothing it returns: a ``bin`` or ``ext`` payload is a
slice of the buffer it was given, so a ``memoryview`` over an ``mmap`` of a
multi-GB file is decoded without reading the payloads (``bytes`` input
gives ``bytes`` slices, as before).
"""

import struct
from typing import Any, Tuple


class Ext:
    """msgpack ext value (used for the frame fingerprint / filter pipeline)."""

    def __init__(self, code: int, data):
        self.code = code
        self.data = data  # bytes, or a memoryview into the decoded buffer

    def __eq__(self, other):
        return (isinstance(other, Ext) and self.code == other.code
                and self.data == other.data)

    def __repr__(self):
        return f"Ext({self.code}, {self.data!r})"


def _pack_int(value: int, width: int, signed: bool) -> bytes:
    fmt = {1: "b", 2: "h", 4: "i", 8: "q"}[width]
    return struct.pack(">" + (fmt if signed else fmt.upper()), value)


def pack_fixed_int(value: int, width: int) -> bytes:
    """Signed int at a FIXED width (0xd0..0xd3 markers). Frame headers use
    fixed-width fields so every offset is static regardless of the value."""
    marker = {1: 0xD0, 2: 0xD1, 4: 0xD2, 8: 0xD3}[width]
    return bytes([marker]) + _pack_int(value, width, signed=True)


def pack(obj: Any) -> bytes:
    if obj is None:
        return b"\xc0"
    if obj is True:
        return b"\xc3"
    if obj is False:
        return b"\xc2"
    if isinstance(obj, int):
        if 0 <= obj < 128:
            return bytes([obj])
        if -32 <= obj < 0:
            return struct.pack("b", obj)
        for width in (1, 2, 4, 8):
            if -(1 << (8 * width - 1)) <= obj < (1 << (8 * width - 1)):
                return pack_fixed_int(obj, width)
        raise ValueError(f"int out of range: {obj}")
    if isinstance(obj, str):
        b = obj.encode()
        if len(b) < 32:
            return bytes([0xA0 | len(b)]) + b
        if len(b) < 256:
            return b"\xd9" + bytes([len(b)]) + b
        return b"\xda" + struct.pack(">H", len(b)) + b
    if isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        if len(b) < 256:
            return b"\xc4" + bytes([len(b)]) + b
        if len(b) < (1 << 16):
            return b"\xc5" + struct.pack(">H", len(b)) + b
        return b"\xc6" + struct.pack(">I", len(b)) + b
    if isinstance(obj, Ext):
        n = len(obj.data)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            return bytes([fixed[n], obj.code & 0xFF]) + obj.data
        if n < 256:
            return b"\xc7" + bytes([n, obj.code & 0xFF]) + obj.data
        raise ValueError("ext too long")
    if isinstance(obj, (list, tuple)):
        if len(obj) < 16:
            head = bytes([0x90 | len(obj)])
        else:
            head = b"\xdc" + struct.pack(">H", len(obj))
        return head + b"".join(pack(x) for x in obj)
    if isinstance(obj, dict):
        if len(obj) < 16:
            head = bytes([0x80 | len(obj)])
        else:
            head = b"\xde" + struct.pack(">H", len(obj))
        return head + b"".join(pack(k) + pack(v) for k, v in obj.items())
    raise TypeError(f"cannot msgpack {type(obj)}")


def unpack_from(buf, offset: int = 0) -> Tuple[Any, int]:
    """Decode one msgpack value; returns (value, next_offset)."""
    b = buf[offset]
    offset += 1
    if b < 0x80:
        return b, offset
    if b >= 0xE0:
        return b - 0x100, offset
    if 0x80 <= b <= 0x8F or b == 0xDE or b == 0xDF:
        if b == 0xDE:
            n = struct.unpack_from(">H", buf, offset)[0]
            offset += 2
        elif b == 0xDF:
            n = struct.unpack_from(">I", buf, offset)[0]
            offset += 4
        else:
            n = b & 0x0F
        out = {}
        for _ in range(n):
            k, offset = unpack_from(buf, offset)
            v, offset = unpack_from(buf, offset)
            out[k] = v
        return out, offset
    if 0x90 <= b <= 0x9F or b == 0xDC or b == 0xDD:
        if b == 0xDC:
            n = struct.unpack_from(">H", buf, offset)[0]
            offset += 2
        elif b == 0xDD:
            n = struct.unpack_from(">I", buf, offset)[0]
            offset += 4
        else:
            n = b & 0x0F
        out = []
        for _ in range(n):
            v, offset = unpack_from(buf, offset)
            out.append(v)
        return out, offset
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return bytes(buf[offset:offset + n]).decode(), offset + n
    if b == 0xC0:
        return None, offset
    if b == 0xC2:
        return False, offset
    if b == 0xC3:
        return True, offset
    if b in (0xC4, 0xC5, 0xC6):
        width = {0xC4: "B", 0xC5: ">H", 0xC6: ">I"}[b]
        if b == 0xC4:
            n = buf[offset]
            offset += 1
        else:
            n = struct.unpack_from(width, buf, offset)[0]
            offset += 2 if b == 0xC5 else 4
        return buf[offset:offset + n], offset + n
    if b in (0xC7, 0xC8, 0xC9):
        if b == 0xC7:
            n = buf[offset]
            offset += 1
        elif b == 0xC8:
            n = struct.unpack_from(">H", buf, offset)[0]
            offset += 2
        else:
            n = struct.unpack_from(">I", buf, offset)[0]
            offset += 4
        code = struct.unpack_from("b", buf, offset)[0]
        offset += 1
        return Ext(code, buf[offset:offset + n]), offset + n
    if 0xD4 <= b <= 0xD8:
        n = 1 << (b - 0xD4)
        code = struct.unpack_from("b", buf, offset)[0]
        offset += 1
        return Ext(code, buf[offset:offset + n]), offset + n
    if 0xCC <= b <= 0xCF:
        width = 1 << (b - 0xCC)
        fmt = {1: ">B", 2: ">H", 4: ">I", 8: ">Q"}[width]
        return struct.unpack_from(fmt, buf, offset)[0], offset + width
    if 0xD0 <= b <= 0xD3:
        width = 1 << (b - 0xD0)
        fmt = {1: ">b", 2: ">h", 4: ">i", 8: ">q"}[width]
        return struct.unpack_from(fmt, buf, offset)[0], offset + width
    if b in (0xD9, 0xDA, 0xDB):
        if b == 0xD9:
            n = buf[offset]
            offset += 1
        elif b == 0xDA:
            n = struct.unpack_from(">H", buf, offset)[0]
            offset += 2
        else:
            n = struct.unpack_from(">I", buf, offset)[0]
            offset += 4
        return bytes(buf[offset:offset + n]).decode(), offset + n
    if b == 0xCA:
        return struct.unpack_from(">f", buf, offset)[0], offset + 4
    if b == 0xCB:
        return struct.unpack_from(">d", buf, offset)[0], offset + 8
    raise ValueError(f"unsupported msgpack marker 0x{b:02x} at {offset - 1}")
