"""A Zstandard decoder in pure Python (RFC 8878), and xxHash64.

The plain decoder of the port: the reference that the host C++ decoder
(``csrc/zstd_decode.cpp``, loaded by ``compression/zstd_native.py``) is held
against in the tests. Nothing on a read path calls it; it runs at a few MB/s.
Neither decoder needs the ``zstandard`` package, which the card's machine
does not have.

It decodes every frame the format defines without a dictionary: raw, RLE
and compressed blocks; raw, RLE, Huffman (one and four streams) and treeless
literals; sequences with predefined, RLE, FSE-compressed and repeated tables
and the three repeat offsets; the frame header's window and content size;
the content checksum (xxHash64, verified); frames back to back and skippable
frames. A frame that names a dictionary is refused. Corrupt or truncated
input raises ``ZstdError``; nothing is ever returned short.
"""

import struct
from typing import List, Optional, Sequence, Tuple

ZSTD_MAGIC = 0xFD2FB528
_SKIPPABLE_MASK, _SKIPPABLE = 0xFFFFFFF0, 0x184D2A50
MAX_BLOCK = 1 << 17
_M64 = (1 << 64) - 1


class ZstdError(ValueError):
    """Corrupt, truncated or unsupported Zstandard input."""


# ------------------------------------------------------------------ xxHash64

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data, seed: int = 0) -> int:
    """xxHash64 of `data` (the hash whose low 32 bits close a zstd frame)."""
    data = memoryview(data).cast("B")
    n, i = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed & _M64,
             (seed - _P1) & _M64]
        stripes = n // 32
        lanes = struct.unpack_from(f"<{4 * stripes}Q", data)
        for s in range(0, 4 * stripes, 4):
            v[0] = _round(v[0], lanes[s])
            v[1] = _round(v[1], lanes[s + 1])
            v[2] = _round(v[2], lanes[s + 2])
            v[3] = _round(v[3], lanes[s + 3])
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for x in v:
            h = (((h ^ _round(0, x)) * _P1) + _P4) & _M64
        i = 32 * stripes
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round(0, struct.unpack_from("<Q", data, i)[0])
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (struct.unpack_from("<I", data, i)[0] * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# --------------------------------------------------------------- bitstreams


class _ForwardBits:
    """Little-endian bits read from the low end up (FSE table headers)."""

    def __init__(self, data, start: int, end: int):
        self.data, self.pos, self.end = data, start * 8, end * 8
        self.base = start

    def peek(self, n: int) -> int:
        byte, shift = self.pos >> 3, self.pos & 7
        chunk = int.from_bytes(self.data[byte:min(byte + 8, self.end >> 3)], "little")
        return (chunk >> shift) & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.pos += n
        if self.pos > self.end:
            raise ZstdError("FSE table description runs past its input")

    def bytes_used(self) -> int:
        return (self.pos + 7) // 8 - self.base


class _BackwardBits:
    """A zstd backward bitstream: read from the last byte's highest set bit
    (the end marker) down; reads past the start are zeros and drive `left`
    below 0, which the callers take as overflow."""

    def __init__(self, data):
        data = bytes(data)
        if not data or data[-1] == 0:
            raise ZstdError("a backward bitstream lacks its end marker")
        self.value = int.from_bytes(data, "little")
        self.left = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        left = self.left - n
        self.left = left
        if left >= 0:
            return (self.value >> left) & ((1 << n) - 1)
        if left + n <= 0:
            return 0
        return (self.value & ((1 << (left + n)) - 1)) << -left


# --------------------------------------------------------------------- FSE


def _read_fse_counts(data, start: int, end: int, max_symbol: int,
                     max_log: int) -> Tuple[List[int], int, int]:
    """An FSE table description -> (normalized counts, accuracy log, bytes)."""
    if start >= end:
        raise ZstdError("empty FSE table description")
    bits = _ForwardBits(data, start, end)
    log = (bits.peek(4)) + 5
    bits.skip(4)
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above the maximum {max_log}")
    remaining = (1 << log) + 1
    threshold, nbits = 1 << log, log + 1
    counts: List[int] = []
    previous_zero = False
    while remaining > 1:
        if previous_zero:
            n = 0
            while True:
                flag = bits.peek(2)
                bits.skip(2)
                n += flag
                if flag != 3:
                    break
            counts.extend([0] * n)
            if len(counts) > max_symbol + 1:
                raise ZstdError("FSE table description names too many symbols")
        if len(counts) > max_symbol:
            raise ZstdError("FSE table description names too many symbols")
        top = (2 * threshold - 1) - remaining
        value = bits.peek(nbits)
        if (value & (threshold - 1)) < top:
            count = value & (threshold - 1)
            bits.skip(nbits - 1)
        else:
            count = value & (2 * threshold - 1)
            if count >= threshold:
                count -= top
            bits.skip(nbits)
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        previous_zero = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1:
        raise ZstdError("FSE table description does not sum to its size")
    return counts, log, bits.bytes_used()


def _build_fse(counts: Sequence[int], log: int):
    """Decoding table: per state (symbol, bits to read, base of next state)."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    next_state = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbols[high] = s
            high -= 1
            next_state[s] = 1
        else:
            next_state[s] = c
    pos, step, mask = 0, (size >> 1) + (size >> 3) + 3, size - 1
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("corrupt FSE distribution")
    nbits, base = [0] * size, [0] * size
    for u in range(size):
        s = symbols[u]
        ns = next_state[s]
        next_state[s] += 1
        nb = log - (ns.bit_length() - 1)
        nbits[u] = nb
        base[u] = (ns << nb) - size
    return symbols, nbits, base, log


def _rle_fse(symbol: int):
    return [symbol], [0], [0], 0


_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
               2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
               -1, -1, -1, -1, -1]
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               -1, -1, -1, -1, -1]
_PREDEFINED = {"ll": (_LL_DEFAULT, 6), "ml": (_ML_DEFAULT, 6), "of": (_OF_DEFAULT, 5)}
_LIMITS = {"ll": (35, 9), "ml": (52, 9), "of": (31, 8)}

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512,
                              1024, 2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259,
                                 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                       16]


# ----------------------------------------------------------------- Huffman


def _huffman_weights(data, pos: int, end: int) -> Tuple[List[int], int]:
    """A Huffman tree description -> (weights of symbols 0..n-2, bytes)."""
    if pos >= end:
        raise ZstdError("truncated Huffman tree description")
    header = data[pos]
    if header >= 128:
        n = header - 127
        size = 1 + (n + 1) // 2
        if pos + size > end:
            raise ZstdError("truncated Huffman weights")
        weights = []
        for i in range(n):
            b = data[pos + 1 + i // 2]
            weights.append(b >> 4 if i % 2 == 0 else b & 15)
        return weights, size
    size = 1 + header
    if header == 0 or pos + size > end:
        raise ZstdError("truncated Huffman weights")
    counts, log, used = _read_fse_counts(data, pos + 1, pos + size, 255, 6)
    symbols, nbits, base, log = _build_fse(counts, log)
    bits = _BackwardBits(data[pos + 1 + used:pos + size])
    s1, s2 = bits.read(log), bits.read(log)
    weights = []
    while True:
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
        weights.append(symbols[s1])
        s1 = base[s1] + bits.read(nbits[s1])
        if bits.left < 0:
            weights.append(symbols[s2])
            break
        weights.append(symbols[s2])
        s2 = base[s2] + bits.read(nbits[s2])
        if bits.left < 0:
            weights.append(symbols[s1])
            break
    return weights, size


def _build_huffman(weights: List[int]):
    """(lookup of `max_bits` bits -> symbol, symbol -> code length, max_bits)."""
    if any(w > 11 for w in weights):
        raise ZstdError("Huffman weight above 11")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("Huffman weights are all zero")
    max_bits = total.bit_length()  # the power of two above the sum
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise ZstdError("Huffman weights do not complete a tree")
    weights = weights + [rest.bit_length()]
    if max_bits > 11:
        raise ZstdError("Huffman code longer than 11 bits")
    table = [0] * (1 << max_bits)
    lengths = [0] * 256
    pos = 0
    for w in range(1, max(weights) + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                span = 1 << (w - 1)
                table[pos:pos + span] = [s] * span
                pos += span
                lengths[s] = max_bits + 1 - w
    return table, lengths, max_bits


def _huffman_stream(data, n: int, huff, out: bytearray) -> None:
    table, lengths, max_bits = huff
    bits = _BackwardBits(data)
    value, left = bits.value, bits.left
    mask = (1 << max_bits) - 1
    for _ in range(n):
        if left >= max_bits:
            s = table[(value >> (left - max_bits)) & mask]
        else:
            s = table[((value & ((1 << left) - 1)) << (max_bits - left)) & mask if left > 0 else 0]
        out.append(s)
        left -= lengths[s]
    if left != 0:
        raise ZstdError("Huffman stream does not end on its marker")


# ---------------------------------------------------------------- blocks


class _FrameState:
    def __init__(self):
        self.huffman = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.reps = [1, 4, 8]


def _literals(data, pos: int, end: int, state: _FrameState) -> Tuple[bytes, int]:
    if pos >= end:
        raise ZstdError("truncated literals section")
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, hl = b0 >> 3, 1
        elif fmt == 1:
            size, hl = (b0 >> 4) + (data[pos + 1] << 4), 2
        else:
            size, hl = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12), 3
        if pos + hl > end:
            raise ZstdError("truncated literals header")
        pos += hl
        if size > MAX_BLOCK:
            raise ZstdError("literals larger than a block")
        if kind == 0:
            if pos + size > end:
                raise ZstdError("truncated raw literals")
            return bytes(data[pos:pos + size]), pos + size
        if pos >= end:
            raise ZstdError("truncated RLE literals")
        return bytes([data[pos]]) * size, pos + 1
    hl = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    if pos + hl > end:
        raise ZstdError("truncated literals header")
    h = int.from_bytes(data[pos:pos + hl], "little")
    if fmt in (0, 1):
        regen, comp = (h >> 4) & 0x3FF, (h >> 14) & 0x3FF
    elif fmt == 2:
        regen, comp = (h >> 4) & 0x3FFF, (h >> 18) & 0x3FFF
    else:
        regen, comp = (h >> 4) & 0x3FFFF, (h >> 22) & 0x3FFFF
    streams = 1 if fmt == 0 else 4
    pos += hl
    if regen > MAX_BLOCK or pos + comp > end:
        raise ZstdError("truncated or oversized compressed literals")
    stop = pos + comp
    if kind == 2:
        weights, used = _huffman_weights(data, pos, stop)
        state.huffman = _build_huffman(weights)
        pos += used
    elif state.huffman is None:
        raise ZstdError("treeless literals with no Huffman table before them")
    out = bytearray()
    if streams == 1:
        _huffman_stream(data[pos:stop], regen, state.huffman, out)
    else:
        if pos + 6 > stop:
            raise ZstdError("truncated jump table")
        s1, s2, s3 = struct.unpack_from("<3H", data, pos)
        pos += 6
        s4 = stop - pos - s1 - s2 - s3
        if s4 < 1:
            raise ZstdError("jump table exceeds the literals")
        share = (regen + 3) // 4
        if 3 * share > regen:
            raise ZstdError("four literal streams with too few literals")
        for size, n in zip((s1, s2, s3, s4), (share, share, share, regen - 3 * share)):
            _huffman_stream(data[pos:pos + size], n, state.huffman, out)
            pos += size
    return bytes(out), stop


def _sequence_table(data, pos: int, end: int, mode: int, kind: str,
                    state: _FrameState):
    if mode == 0:
        counts, log = _PREDEFINED[kind]
        table = _build_fse(counts, log)
    elif mode == 1:
        if pos >= end:
            raise ZstdError("truncated RLE sequence table")
        if data[pos] > _LIMITS[kind][0]:
            raise ZstdError(f"RLE {kind} symbol out of range")
        table = _rle_fse(data[pos])
        pos += 1
    elif mode == 2:
        max_symbol, max_log = _LIMITS[kind]
        counts, log, used = _read_fse_counts(data, pos, end, max_symbol, max_log)
        table = _build_fse(counts, log)
        pos += used
    else:
        table = state.tables[kind]
        if table is None:
            raise ZstdError(f"repeated {kind} table with none before it")
    state.tables[kind] = table
    return pos


def _compressed_block(data, pos: int, end: int, state: _FrameState,
                      out: bytearray, frame_start: int) -> None:
    literals, pos = _literals(data, pos, end, state)
    if pos >= end:
        raise ZstdError("truncated sequences section")
    b0 = data[pos]
    if b0 == 0:
        count, pos = 0, pos + 1
    elif b0 < 128:
        count, pos = b0, pos + 1
    elif b0 < 255:
        if pos + 2 > end:
            raise ZstdError("truncated sequence count")
        count, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        if pos + 3 > end:
            raise ZstdError("truncated sequence count")
        count, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if count == 0:
        if pos != end:
            raise ZstdError("bytes after a block with no sequences")
        out += literals
        return
    if pos >= end:
        raise ZstdError("truncated sequence modes")
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    for kind, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        pos = _sequence_table(data, pos, end, (modes >> shift) & 3, kind, state)
    if pos >= end:
        raise ZstdError("truncated sequence bitstream")
    bits = _BackwardBits(data[pos:end])
    ll_sym, ll_nb, ll_base, ll_log = state.tables["ll"]
    of_sym, of_nb, of_base, of_log = state.tables["of"]
    ml_sym, ml_nb, ml_base, ml_log = state.tables["ml"]
    ll_state, of_state, ml_state = bits.read(ll_log), bits.read(of_log), bits.read(ml_log)
    reps = state.reps
    lit = 0
    read = bits.read
    for i in range(count):
        of_code, ll_code, ml_code = of_sym[of_state], ll_sym[ll_state], ml_sym[ml_state]
        if of_code > 31:
            raise ZstdError("offset code above 31")
        offset = (1 << of_code) + read(of_code)
        ml = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        if offset > 3:
            offset -= 3
            reps[2], reps[1], reps[0] = reps[1], reps[0], offset
        else:
            idx = offset - 1 if ll else offset
            if idx == 0:
                offset = reps[0]
            elif idx == 3:
                offset = reps[0] - 1
                if offset == 0:
                    raise ZstdError("repeat offset 1 - 1 is zero")
                reps[2], reps[1], reps[0] = reps[1], reps[0], offset
            else:
                offset = reps[idx]
                if idx == 2:
                    reps[2] = reps[1]
                reps[1], reps[0] = reps[0], offset
        if lit + ll > len(literals):
            raise ZstdError("a sequence takes more literals than there are")
        out += literals[lit:lit + ll]
        lit += ll
        start = len(out) - offset
        if start < frame_start:
            raise ZstdError("match offset reaches before the frame")
        if offset >= ml:
            out += out[start:start + ml]
        else:
            piece = out[start:]
            out += (piece * (ml // offset + 1))[:ml]
        if i + 1 < count:
            ll_state = ll_base[ll_state] + read(ll_nb[ll_state])
            ml_state = ml_base[ml_state] + read(ml_nb[ml_state])
            of_state = of_base[of_state] + read(of_nb[of_state])
        if bits.left < 0:
            raise ZstdError("sequence bitstream overrun")
    if bits.left != 0:
        raise ZstdError("sequence bitstream not consumed to its start")
    out += literals[lit:]


def frame_header(data, pos: int = 0) -> Tuple[dict, int]:
    """Frame header at `pos` -> ({window, content_size, checksum}, header end)."""
    end = len(data)
    if pos + 5 > end:
        raise ZstdError("truncated frame header")
    if struct.unpack_from("<I", data, pos)[0] != ZSTD_MAGIC:
        raise ZstdError("not a zstd frame (bad magic)")
    fhd = data[pos + 4]
    p = pos + 5
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    window = None
    if not single:
        if p >= end:
            raise ZstdError("truncated frame header")
        wd = data[p]
        p += 1
        log = 10 + (wd >> 3)
        window = (1 << log) + ((1 << log) >> 3) * (wd & 7)
    dict_size = (0, 1, 2, 4)[dict_flag]
    if p + dict_size > end:
        raise ZstdError("truncated frame header")
    dict_id = int.from_bytes(data[p:p + dict_size], "little")
    p += dict_size
    if dict_id:
        raise ZstdError(f"frame needs dictionary {dict_id}; dictionaries are not supported")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if p + fcs_size > end:
        raise ZstdError("truncated frame header")
    content_size = None
    if fcs_size:
        content_size = int.from_bytes(data[p:p + fcs_size], "little")
        if fcs_size == 2:
            content_size += 256
    p += fcs_size
    if single:
        window = content_size
    return {"window": window, "content_size": content_size, "checksum": bool(checksum)}, p


def _frame(data, pos: int, out: bytearray) -> int:
    header, pos = frame_header(data, pos)
    end = len(data)
    frame_start = len(out)
    block_max = min(header["window"], MAX_BLOCK)
    state = _FrameState()
    while True:
        if pos + 3 > end:
            raise ZstdError("truncated block header")
        bh = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = bh & 1, (bh >> 1) & 3, bh >> 3
        if kind == 0:
            if size > block_max or pos + size > end:
                raise ZstdError("truncated or oversized raw block")
            out += data[pos:pos + size]
            pos += size
        elif kind == 1:
            if size > block_max or pos >= end:
                raise ZstdError("truncated or oversized RLE block")
            out += bytes([data[pos]]) * size
            pos += 1
        elif kind == 2:
            if size > block_max or pos + size > end:
                raise ZstdError("truncated or oversized compressed block")
            before = len(out)
            _compressed_block(data, pos, pos + size, state, out, frame_start)
            if len(out) - before > block_max:
                raise ZstdError("block decodes to more than its maximum")
            pos += size
        else:
            raise ZstdError("reserved block type")
        if last:
            break
    produced = len(out) - frame_start
    if header["content_size"] is not None and produced != header["content_size"]:
        raise ZstdError(f"frame decodes to {produced} bytes, its header says "
                        f"{header['content_size']}")
    if header["checksum"]:
        if pos + 4 > end:
            raise ZstdError("truncated content checksum")
        want = struct.unpack_from("<I", data, pos)[0]
        if xxh64(out[frame_start:]) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
        pos += 4
    return pos


def decompress(data, max_output_size: Optional[int] = None) -> bytes:
    """Every frame of `data`, back to back, skippable frames skipped."""
    data = bytes(data)
    out = bytearray()
    pos, end = 0, len(data)
    if end == 0:
        raise ZstdError("empty input")
    while pos < end:
        if pos + 4 > end:
            raise ZstdError("trailing bytes after the last frame")
        magic = struct.unpack_from("<I", data, pos)[0]
        if magic & _SKIPPABLE_MASK == _SKIPPABLE:
            if pos + 8 > end:
                raise ZstdError("truncated skippable frame")
            size = struct.unpack_from("<I", data, pos + 4)[0]
            if pos + 8 + size > end:
                raise ZstdError("truncated skippable frame")
            pos += 8 + size
            continue
        pos = _frame(data, pos, out)
        if max_output_size is not None and len(out) > max_output_size:
            raise ZstdError(f"output exceeds {max_output_size} bytes")
    return bytes(out)



def _frame_end(data, pos: int) -> Tuple[Optional[int], int]:
    """(content size or None, end) of the frame at `pos`, its blocks walked
    by their headers, not decoded."""
    header, p = frame_header(data, pos)
    while True:
        if p + 3 > len(data):
            raise ZstdError("truncated block header")
        bh = int.from_bytes(data[p:p + 3], "little")
        p += 3 + (1 if (bh >> 1) & 3 == 1 else bh >> 3)
        if bh & 1:
            break
    p += 4 if header["checksum"] else 0
    if p > len(data):
        raise ZstdError("truncated frame")
    return header["content_size"], p


def frames_content_size(data) -> Optional[int]:
    """What the frames of `data` decode to by their headers, or None where a
    frame does not state its size."""
    total, pos = 0, 0
    while pos < len(data):
        if pos + 8 <= len(data) and (struct.unpack_from("<I", data, pos)[0]
                                     & _SKIPPABLE_MASK) == _SKIPPABLE:
            pos += 8 + struct.unpack_from("<I", data, pos + 4)[0]
            continue
        size, pos = _frame_end(data, pos)
        if size is None:
            return None
        total += size
    return total
