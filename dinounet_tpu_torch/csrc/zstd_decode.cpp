// Zstandard decoder for the host (RFC 8878), with a plain C interface.
//
// The fast decoder of the port's checkpoint and .b2nd readers; the pure
// Python one (compression/zstd.py) is its reference in the tests. Host C++,
// built by the host compiler (ops/_build.py::host_library): decompression is
// a serial walk of bitstreams and the GPU takes no part in it.
//
// zstd_decode_many decodes a list of buffers, each a run of frames (skippable
// frames skipped), straight into caller-given destinations (a slice of a
// tensor), spread over a pool of threads; ctypes releases the GIL for the
// call. Frames naming a dictionary are refused. Corrupt or truncated input
// fails the job with a message; a job that decodes to another size than its
// destination's fails too, so nothing is returned short.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* what) { throw Error(what); }

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint32_t load24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

constexpr size_t kMaxBlock = 1 << 17;

// ------------------------------------------------------------------ xxHash64

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxround(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxround(v1, load64(p));
      v2 = xxround(v2, load64(p + 8));
      v3 = xxround(v3, load64(p + 16));
      v4 = xxround(v4, load64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xxround(0, v)) * P1 + P4;
  } else {
    h = P5;
  }
  h += n;
  while (p + 8 <= end) {
    h ^= xxround(0, load64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(load32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// --------------------------------------------------------------- bitstreams

// Backward bitstream: bits are read from the end marker down. left() counts
// the bits not yet read and goes below 0 when reads pass the start (those
// bits read as zeros), which the callers take as overflow.
struct BackBits {
  const uint8_t* start;
  const uint8_t* ptr;
  uint64_t container;
  unsigned consumed;
  int valid;  // real bits in a full container: 64, or 8 * size below 8 bytes

  BackBits(const uint8_t* src, size_t size) {
    if (size == 0 || src[size - 1] == 0) fail("a backward bitstream lacks its end marker");
    start = src;
    int marker = highbit(src[size - 1]);
    if (size >= 8) {
      ptr = src + size - 8;
      container = load64(ptr);
      valid = 64;
    } else {
      ptr = src;
      container = 0;
      for (size_t i = 0; i < size; ++i) container |= uint64_t(src[i]) << (8 * i);
      container <<= 8 * (8 - size);
      valid = int(8 * size);
    }
    consumed = 8 - marker;
  }
  inline int64_t left() const { return int64_t(8) * (ptr - start) + valid - int64_t(consumed); }
  inline void refill() {
    size_t avail = size_t(ptr - start);
    if (avail == 0) return;
    size_t nb = consumed >> 3;
    if (nb > avail) nb = avail;
    ptr -= nb;
    consumed -= unsigned(nb * 8);
    container = load64(ptr);
  }
  inline uint64_t peek(unsigned n) const {  // 1 <= n <= 56 after a refill
    if (consumed >= 64) return 0;
    return (container << consumed) >> (64 - n);
  }
  inline void skip(unsigned n) { consumed += n; }
  inline uint64_t read(unsigned n) {
    if (n == 0) return 0;
    uint64_t v = peek(n);
    skip(n);
    return v;
  }
};

// ---------------------------------------------------------------------- FSE

struct FseEntry {
  uint32_t base;  // sequence tables: the value's base; weight tables: symbol
  uint16_t next;  // base of the next state
  uint8_t nbits;  // state bits to read
  uint8_t extra;  // sequence tables: the value's extra bits
};

struct FseTable {
  int log = -1;
  std::vector<FseEntry> e;
  bool valid() const { return log >= 0; }
};

// Normalized counts from an FSE table description; returns the bytes used.
size_t read_counts(const uint8_t* src, size_t size, int max_symbol, int max_log,
                   std::vector<int>& counts, int& log) {
  if (size == 0) fail("empty FSE table description");
  size_t bitpos = 0, bitend = size * 8;
  auto peek = [&](unsigned n) -> uint32_t {
    size_t byte = bitpos >> 3;
    uint64_t v = 0;
    for (size_t i = 0; i < 8 && byte + i < size; ++i) v |= uint64_t(src[byte + i]) << (8 * i);
    return uint32_t((v >> (bitpos & 7)) & ((1ull << n) - 1));
  };
  auto skip = [&](unsigned n) {
    bitpos += n;
    if (bitpos > bitend) fail("FSE table description runs past its input");
  };
  log = int(peek(4)) + 5;
  skip(4);
  if (log > max_log) fail("FSE accuracy log above its maximum");
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  counts.clear();
  bool previous_zero = false;
  while (remaining > 1) {
    if (previous_zero) {
      int n = 0;
      for (;;) {
        uint32_t flag = peek(2);
        skip(2);
        n += int(flag);
        if (flag != 3) break;
      }
      counts.insert(counts.end(), n, 0);
      if (int(counts.size()) > max_symbol + 1) fail("FSE table names too many symbols");
    }
    if (int(counts.size()) > max_symbol) fail("FSE table names too many symbols");
    int top = (2 * threshold - 1) - remaining;
    uint32_t value = peek(unsigned(nbits));
    int count;
    if (int(value & uint32_t(threshold - 1)) < top) {
      count = int(value & uint32_t(threshold - 1));
      skip(unsigned(nbits - 1));
    } else {
      count = int(value & uint32_t(2 * threshold - 1));
      if (count >= threshold) count -= top;
      skip(unsigned(nbits));
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    counts.push_back(count);
    previous_zero = count == 0;
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("FSE table description does not sum to its size");
  return (bitpos + 7) / 8;
}

// base / extra: per-symbol value tables of a sequence code (null: symbol).
void build_fse(const std::vector<int>& counts, int log, const uint32_t* base,
               const uint8_t* extra, FseTable& t) {
  int size = 1 << log;
  std::vector<uint16_t> symbols(size);
  std::vector<uint32_t> next(counts.size());
  int high = size - 1;
  for (size_t s = 0; s < counts.size(); ++s) {
    if (counts[s] == -1) {
      symbols[high--] = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(counts[s]);
    }
  }
  int pos = 0, step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  for (size_t s = 0; s < counts.size(); ++s) {
    for (int i = 0; i < counts[s]; ++i) {
      symbols[pos] = uint16_t(s);
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  }
  if (pos != 0) fail("corrupt FSE distribution");
  t.log = log;
  t.e.resize(size);
  for (int u = 0; u < size; ++u) {
    uint16_t s = symbols[u];
    uint32_t ns = next[s]++;
    int nb = log - highbit(ns);
    t.e[u].nbits = uint8_t(nb);
    t.e[u].next = uint16_t((ns << nb) - uint32_t(size));
    t.e[u].base = base ? base[s] : s;
    t.e[u].extra = extra ? extra[s] : 0;
  }
}

const int kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                            2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

uint32_t kLLBase[36], kMLBase[53], kOFBase[32];
uint8_t kLLBits[36], kMLBits[53], kOFBits[32];

struct Tables {
  Tables() {
    const uint32_t ll_hi[20] = {16, 18, 20, 22, 24, 28, 32, 40, 48, 64,
                                128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
    const uint8_t ll_hi_bits[20] = {1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
    for (int i = 0; i < 16; ++i) kLLBase[i] = i, kLLBits[i] = 0;
    for (int i = 0; i < 20; ++i) kLLBase[16 + i] = ll_hi[i], kLLBits[16 + i] = ll_hi_bits[i];
    const uint32_t ml_hi[21] = {35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
    const uint8_t ml_hi_bits[21] = {1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
    for (int i = 0; i < 32; ++i) kMLBase[i] = i + 3, kMLBits[i] = 0;
    for (int i = 0; i < 21; ++i) kMLBase[32 + i] = ml_hi[i], kMLBits[32 + i] = ml_hi_bits[i];
    // offsets: the code is the number of extra bits, the base its power of 2
    for (int i = 0; i < 32; ++i) kOFBase[i] = 1u << i, kOFBits[i] = uint8_t(i);
  }
};
const Tables kTables;

enum Kind { LL = 0, OF = 1, ML = 2 };
const int kMaxSymbol[3] = {35, 31, 52}, kMaxLog[3] = {9, 8, 9};

FseTable make_predefined(Kind k) {
  FseTable t;
  std::vector<int> counts;
  if (k == LL) counts.assign(kLLDefault, kLLDefault + 36);
  if (k == OF) counts.assign(kOFDefault, kOFDefault + 29);
  if (k == ML) counts.assign(kMLDefault, kMLDefault + 53);
  const uint32_t* base[3] = {kLLBase, kOFBase, kMLBase};
  const uint8_t* extra[3] = {kLLBits, kOFBits, kMLBits};
  build_fse(counts, k == OF ? 5 : 6, base[k], extra[k], t);
  return t;
}

// ------------------------------------------------------------------ Huffman

struct Huffman {
  int max_bits = 0;
  std::vector<uint16_t> table;  // symbol | code length << 8
  bool valid() const { return max_bits > 0; }
};

size_t huffman_weights(const uint8_t* src, size_t size, std::vector<uint8_t>& w) {
  if (size == 0) fail("truncated Huffman tree description");
  uint32_t header = src[0];
  w.clear();
  if (header >= 128) {
    size_t n = header - 127, used = 1 + (n + 1) / 2;
    if (used > size) fail("truncated Huffman weights");
    for (size_t i = 0; i < n; ++i) {
      uint8_t b = src[1 + i / 2];
      w.push_back(i % 2 == 0 ? b >> 4 : b & 15);
    }
    return used;
  }
  size_t used = 1 + header;
  if (header == 0 || used > size) fail("truncated Huffman weights");
  std::vector<int> counts;
  int log;
  size_t head = read_counts(src + 1, header, 255, 6, counts, log);
  FseTable t;
  build_fse(counts, log, nullptr, nullptr, t);
  if (head >= header) fail("truncated Huffman weight stream");
  BackBits bits(src + 1 + head, header - head);
  uint32_t s1 = uint32_t(bits.read(unsigned(log))), s2 = uint32_t(bits.read(unsigned(log)));
  for (;;) {
    if (w.size() > 255) fail("too many Huffman weights");
    bits.refill();
    w.push_back(uint8_t(t.e[s1].base));
    s1 = t.e[s1].next + uint32_t(bits.read(t.e[s1].nbits));
    if (bits.left() < 0) {
      w.push_back(uint8_t(t.e[s2].base));
      break;
    }
    w.push_back(uint8_t(t.e[s2].base));
    s2 = t.e[s2].next + uint32_t(bits.read(t.e[s2].nbits));
    if (bits.left() < 0) {
      w.push_back(uint8_t(t.e[s1].base));
      break;
    }
  }
  return used;
}

void build_huffman(std::vector<uint8_t>& w, Huffman& h) {
  uint32_t total = 0;
  for (uint8_t x : w) {
    if (x > 11) fail("Huffman weight above 11");
    if (x) total += 1u << (x - 1);
  }
  if (total == 0) fail("Huffman weights are all zero");
  int max_bits = highbit(total) + 1;
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("Huffman weights do not complete a tree");
  if (max_bits > 11) fail("Huffman code longer than 11 bits");
  w.push_back(uint8_t(highbit(rest) + 1));
  if (w.size() > 256) fail("too many Huffman symbols");
  h.max_bits = max_bits;
  h.table.assign(size_t(1) << max_bits, 0);
  size_t pos = 0;
  for (int weight = 1; weight <= 12; ++weight) {
    for (size_t s = 0; s < w.size(); ++s) {
      if (w[s] != weight) continue;
      size_t span = size_t(1) << (weight - 1);
      uint16_t entry = uint16_t(s | ((max_bits + 1 - weight) << 8));
      for (size_t i = 0; i < span; ++i) h.table[pos + i] = entry;
      pos += span;
    }
  }
}

void huffman_stream(const uint8_t* src, size_t size, size_t n, const Huffman& h, uint8_t* out) {
  BackBits bits(src, size);
  const unsigned mb = unsigned(h.max_bits);
  const uint16_t* table = h.table.data();
  size_t i = 0;
  for (; i + 4 <= n; i += 4) {  // 4 symbols of at most 11 bits per refill
    bits.refill();
    for (int k = 0; k < 4; ++k) {
      uint16_t e = table[bits.peek(mb)];
      out[i + k] = uint8_t(e);
      bits.skip(e >> 8);
    }
  }
  bits.refill();
  for (; i < n; ++i) {
    uint16_t e = table[bits.peek(mb)];
    out[i] = uint8_t(e);
    bits.skip(e >> 8);
  }
  if (bits.left() != 0) fail("Huffman stream does not end on its marker");
}

// four streams decoded in step, so their lookups overlap
void huffman_streams4(const uint8_t* src, const size_t sizes[4], const size_t ns[4],
                      const Huffman& h, uint8_t* out) {
  BackBits b0(src, sizes[0]), b1(src + sizes[0], sizes[1]),
      b2(src + sizes[0] + sizes[1], sizes[2]), b3(src + sizes[0] + sizes[1] + sizes[2], sizes[3]);
  BackBits* bits[4] = {&b0, &b1, &b2, &b3};
  uint8_t* o[4] = {out, out + ns[0], out + ns[0] + ns[1], out + ns[0] + ns[1] + ns[2]};
  const unsigned mb = unsigned(h.max_bits);
  const uint16_t* table = h.table.data();
  size_t common = ns[3];  // the shortest stream
  size_t i = 0;
  for (; i + 4 <= common; i += 4) {
    b0.refill(), b1.refill(), b2.refill(), b3.refill();
    for (int k = 0; k < 4; ++k) {
      uint16_t e0 = table[b0.peek(mb)], e1 = table[b1.peek(mb)], e2 = table[b2.peek(mb)],
               e3 = table[b3.peek(mb)];
      o[0][i + k] = uint8_t(e0), o[1][i + k] = uint8_t(e1), o[2][i + k] = uint8_t(e2),
      o[3][i + k] = uint8_t(e3);
      b0.skip(e0 >> 8), b1.skip(e1 >> 8), b2.skip(e2 >> 8), b3.skip(e3 >> 8);
    }
  }
  for (int s = 0; s < 4; ++s) {
    BackBits& b = *bits[s];
    size_t j = i;
    for (; j + 4 <= ns[s]; j += 4) {
      b.refill();
      for (int k = 0; k < 4; ++k) {
        uint16_t e = table[b.peek(mb)];
        o[s][j + k] = uint8_t(e);
        b.skip(e >> 8);
      }
    }
    b.refill();
    for (; j < ns[s]; ++j) {
      uint16_t e = table[b.peek(mb)];
      o[s][j] = uint8_t(e);
      b.skip(e >> 8);
    }
    if (b.left() != 0) fail("Huffman stream does not end on its marker");
  }
}

// -------------------------------------------------------------------- frames

struct Frame {
  Huffman huffman;
  FseTable tables[3];
  uint32_t reps[3] = {1, 4, 8};
};

struct Decoder {
  std::vector<uint8_t> literals = std::vector<uint8_t>(kMaxBlock + 32);
  FseTable predefined[3] = {make_predefined(LL), make_predefined(OF), make_predefined(ML)};
  std::vector<int> counts;
  std::vector<uint8_t> weights;

  // literals section -> (count, pointer); returns the section's size
  size_t read_literals(const uint8_t* src, size_t size, Frame& f, const uint8_t*& lit,
                       size_t& nlit) {
    if (size == 0) fail("truncated literals section");
    uint32_t b0 = src[0], kind = b0 & 3, fmt = (b0 >> 2) & 3;
    if (kind <= 1) {
      size_t regen, hl;
      if (fmt == 0 || fmt == 2) {
        regen = b0 >> 3, hl = 1;
      } else if (fmt == 1) {
        if (size < 2) fail("truncated literals header");
        regen = (b0 >> 4) + (uint32_t(src[1]) << 4), hl = 2;
      } else {
        if (size < 3) fail("truncated literals header");
        regen = (b0 >> 4) + (uint32_t(src[1]) << 4) + (uint32_t(src[2]) << 12), hl = 3;
      }
      if (regen > kMaxBlock) fail("literals larger than a block");
      nlit = regen;
      if (kind == 0) {
        if (hl + regen > size) fail("truncated raw literals");
        lit = src + hl;
        return hl + regen;
      }
      if (hl + 1 > size) fail("truncated RLE literals");
      std::memset(literals.data(), src[hl], regen);
      lit = literals.data();
      return hl + 1;
    }
    size_t hl = fmt <= 1 ? 3 : fmt == 2 ? 4 : 5;
    if (size < hl) fail("truncated literals header");
    uint64_t h = 0;
    for (size_t i = 0; i < hl; ++i) h |= uint64_t(src[i]) << (8 * i);
    size_t regen, comp;
    if (fmt <= 1) {
      regen = (h >> 4) & 0x3FF, comp = (h >> 14) & 0x3FF;
    } else if (fmt == 2) {
      regen = (h >> 4) & 0x3FFF, comp = (h >> 18) & 0x3FFF;
    } else {
      regen = (h >> 4) & 0x3FFFF, comp = (h >> 22) & 0x3FFFF;
    }
    if (regen > kMaxBlock || hl + comp > size) fail("truncated or oversized compressed literals");
    const uint8_t* p = src + hl;
    const uint8_t* stop = p + comp;
    if (kind == 2) {
      p += huffman_weights(p, comp, weights);
      build_huffman(weights, f.huffman);
    } else if (!f.huffman.valid()) {
      fail("treeless literals with no Huffman table before them");
    }
    uint8_t* out = literals.data();
    if (fmt == 0) {
      huffman_stream(p, size_t(stop - p), regen, f.huffman, out);
    } else {
      if (stop - p < 6) fail("truncated jump table");
      size_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8), s3 = p[4] | (p[5] << 8);
      p += 6;
      if (s1 + s2 + s3 >= size_t(stop - p)) fail("jump table exceeds the literals");
      size_t s4 = size_t(stop - p) - s1 - s2 - s3;
      size_t share = (regen + 3) / 4;
      if (3 * share > regen) fail("four literal streams with too few literals");
      size_t sizes[4] = {s1, s2, s3, s4};
      size_t ns[4] = {share, share, share, regen - 3 * share};
      huffman_streams4(p, sizes, ns, f.huffman, out);
    }
    lit = literals.data();
    nlit = regen;
    return hl + comp;
  }

  size_t read_table(const uint8_t* src, size_t size, int mode, Kind k, Frame& f) {
    const uint32_t* base[3] = {kLLBase, kOFBase, kMLBase};
    const uint8_t* extra[3] = {kLLBits, kOFBits, kMLBits};
    if (mode == 0) {
      f.tables[k] = predefined[k];
      return 0;
    }
    if (mode == 1) {
      if (size < 1) fail("truncated RLE sequence table");
      uint8_t s = src[0];
      if (s > kMaxSymbol[k]) fail("RLE sequence symbol out of range");
      FseTable& t = f.tables[k];
      t.log = 0;
      t.e.assign(1, FseEntry{base[k][s], 0, 0, extra[k][s]});
      return 1;
    }
    if (mode == 2) {
      int log;
      size_t used = read_counts(src, size, kMaxSymbol[k], kMaxLog[k], counts, log);
      build_fse(counts, log, base[k], extra[k], f.tables[k]);
      return used;
    }
    if (!f.tables[k].valid()) fail("repeated sequence table with none before it");
    return 0;
  }

  // one compressed block into out[op..oend); the frame began at frame_start
  uint8_t* block(const uint8_t* src, size_t size, Frame& f, uint8_t* frame_start, uint8_t* op,
                 uint8_t* oend) {
    const uint8_t* lit;
    size_t nlit;
    size_t pos = read_literals(src, size, f, lit, nlit);
    if (pos >= size) fail("truncated sequences section");
    uint32_t b0 = src[pos];
    size_t count;
    if (b0 < 128) {
      count = b0, pos += 1;
    } else if (b0 < 255) {
      if (pos + 2 > size) fail("truncated sequence count");
      count = ((b0 - 128) << 8) + src[pos + 1], pos += 2;
    } else {
      if (pos + 3 > size) fail("truncated sequence count");
      count = src[pos + 1] + (uint32_t(src[pos + 2]) << 8) + 0x7F00, pos += 3;
    }
    const uint8_t* lit_end = lit + nlit;
    if (count == 0) {
      if (pos != size) fail("bytes after a block with no sequences");
      if (size_t(oend - op) < nlit) fail("output larger than its destination");
      std::memcpy(op, lit, nlit);
      return op + nlit;
    }
    if (pos >= size) fail("truncated sequence modes");
    uint32_t modes = src[pos++];
    if (modes & 3) fail("reserved bits set in the sequence modes");
    pos += read_table(src + pos, size - pos, (modes >> 6) & 3, LL, f);
    pos += read_table(src + pos, size - pos, (modes >> 4) & 3, OF, f);
    pos += read_table(src + pos, size - pos, (modes >> 2) & 3, ML, f);
    if (pos >= size) fail("truncated sequence bitstream");
    BackBits bits(src + pos, size - pos);
    const FseEntry* ll_t = f.tables[LL].e.data();
    const FseEntry* of_t = f.tables[OF].e.data();
    const FseEntry* ml_t = f.tables[ML].e.data();
    uint32_t ll_s = uint32_t(bits.read(unsigned(f.tables[LL].log)));
    uint32_t of_s = uint32_t(bits.read(unsigned(f.tables[OF].log)));
    uint32_t ml_s = uint32_t(bits.read(unsigned(f.tables[ML].log)));
    uint32_t* reps = f.reps;
    for (size_t i = 0; i < count; ++i) {
      const FseEntry& oe = of_t[of_s];
      const FseEntry& me = ml_t[ml_s];
      const FseEntry& le = ll_t[ll_s];
      bits.refill();
      if (oe.extra > 31) fail("offset code above 31");
      size_t offset = size_t(oe.base) + bits.read(oe.extra);
      bits.refill();
      size_t ml = me.base + bits.read(me.extra);
      size_t ll = le.base + bits.read(le.extra);
      if (offset > 3) {
        offset -= 3;
        reps[2] = reps[1], reps[1] = reps[0], reps[0] = uint32_t(offset);
      } else {
        size_t idx = ll ? offset - 1 : offset;
        if (idx == 0) {
          offset = reps[0];
        } else if (idx == 3) {
          offset = size_t(reps[0]) - 1;
          if (offset == 0) fail("repeat offset 1 - 1 is zero");
          reps[2] = reps[1], reps[1] = reps[0], reps[0] = uint32_t(offset);
        } else {
          offset = reps[idx];
          if (idx == 2) reps[2] = reps[1];
          reps[1] = reps[0], reps[0] = uint32_t(offset);
        }
      }
      if (ll > size_t(lit_end - lit)) fail("a sequence takes more literals than there are");
      if (ll + ml > size_t(oend - op)) fail("output larger than its destination");
      std::memcpy(op, lit, ll);
      op += ll;
      lit += ll;
      if (offset > size_t(op - frame_start)) fail("match offset reaches before the frame");
      const uint8_t* match = op - offset;
      if (offset >= ml) {
        std::memcpy(op, match, ml);
        op += ml;
      } else if (offset >= 8) {
        uint8_t* end = op + ml;
        while (op + 8 <= end) {  // non-overlapping 8-byte steps
          std::memcpy(op, match, 8);
          op += 8, match += 8;
        }
        while (op < end) *op++ = *match++;
      } else {
        for (size_t k = 0; k < ml; ++k) op[k] = match[k];
        op += ml;
      }
      if (i + 1 < count) {
        bits.refill();
        ll_s = ll_t[ll_s].next + uint32_t(bits.read(ll_t[ll_s].nbits));
        ml_s = ml_t[ml_s].next + uint32_t(bits.read(ml_t[ml_s].nbits));
        of_s = of_t[of_s].next + uint32_t(bits.read(of_t[of_s].nbits));
      }
      if (bits.left() < 0) fail("sequence bitstream overrun");
    }
    if (bits.left() != 0) fail("sequence bitstream not consumed to its start");
    size_t rest = size_t(lit_end - lit);
    if (rest > size_t(oend - op)) fail("output larger than its destination");
    std::memcpy(op, lit, rest);
    return op + rest;
  }

  uint8_t* frame(const uint8_t*& ip, const uint8_t* iend, uint8_t* op, uint8_t* oend) {
    if (iend - ip < 5) fail("truncated frame header");
    uint32_t fhd = ip[4];
    const uint8_t* p = ip + 5;
    uint32_t fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
             dict_flag = fhd & 3;
    if (fhd & 8) fail("reserved bit set in the frame header");
    uint64_t window = 0;
    if (!single) {
      if (p >= iend) fail("truncated frame header");
      uint32_t wd = *p++;
      int log = 10 + int(wd >> 3);
      if (log > 41) fail("window too large");
      window = (uint64_t(1) << log) + ((uint64_t(1) << log) >> 3) * (wd & 7);
    }
    const int dict_sizes[4] = {0, 1, 2, 4};
    int dsize = dict_sizes[dict_flag];
    if (iend - p < dsize) fail("truncated frame header");
    uint32_t dict_id = 0;
    for (int i = 0; i < dsize; ++i) dict_id |= uint32_t(p[i]) << (8 * i);
    p += dsize;
    if (dict_id) fail("frame needs a dictionary; dictionaries are not supported");
    const int fcs_sizes[4] = {0, 2, 4, 8};
    int fsize = fcs_flag == 0 ? (single ? 1 : 0) : fcs_sizes[fcs_flag];
    if (iend - p < fsize) fail("truncated frame header");
    bool has_size = fsize > 0;
    uint64_t content = 0;
    for (int i = 0; i < fsize; ++i) content |= uint64_t(p[i]) << (8 * i);
    if (fsize == 2) content += 256;
    p += fsize;
    if (single) window = content;
    size_t block_max = window < kMaxBlock ? size_t(window) : kMaxBlock;
    uint8_t* frame_start = op;
    Frame f;
    for (;;) {
      if (iend - p < 3) fail("truncated block header");
      uint32_t bh = load24(p);
      p += 3;
      uint32_t last = bh & 1, kind = (bh >> 1) & 3;
      size_t size = bh >> 3;
      if (kind == 3) fail("reserved block type");
      if (size > block_max) fail("block larger than its maximum");
      if (kind == 0) {
        if (size_t(iend - p) < size) fail("truncated raw block");
        if (size_t(oend - op) < size) fail("output larger than its destination");
        std::memcpy(op, p, size);
        op += size, p += size;
      } else if (kind == 1) {
        if (p >= iend) fail("truncated RLE block");
        if (size_t(oend - op) < size) fail("output larger than its destination");
        std::memset(op, *p, size);
        op += size, p += 1;
      } else {
        if (size_t(iend - p) < size) fail("truncated compressed block");
        uint8_t* before = op;
        op = block(p, size, f, frame_start, op, oend);
        if (size_t(op - before) > block_max) fail("block decodes to more than its maximum");
        p += size;
      }
      if (last) break;
    }
    if (has_size && uint64_t(op - frame_start) != content)
      fail("frame decodes to another size than its header states");
    if (checksum) {
      if (iend - p < 4) fail("truncated content checksum");
      uint32_t want = load32(p);
      p += 4;
      if (uint32_t(xxh64(frame_start, size_t(op - frame_start))) != want)
        fail("content checksum mismatch");
    }
    ip = p;
    return op;
  }

  size_t decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
    if (n == 0) fail("empty input");
    const uint8_t* ip = src;
    const uint8_t* iend = src + n;
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    while (ip < iend) {
      if (iend - ip < 4) fail("trailing bytes after the last frame");
      uint32_t magic = load32(ip);
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (iend - ip < 8) fail("truncated skippable frame");
        uint32_t size = load32(ip + 4);
        if (size_t(iend - ip - 8) < size) fail("truncated skippable frame");
        ip += 8 + size_t(size);
        continue;
      }
      if (magic != 0xFD2FB528u) fail("not a zstd frame (bad magic)");
      op = frame(ip, iend, op, oend);
    }
    return size_t(op - dst);
  }
};

void copy_message(const std::string& msg, char* err, int errlen) {
  if (!err || errlen <= 0) return;
  size_t n = msg.size() < size_t(errlen - 1) ? msg.size() : size_t(errlen - 1);
  std::memcpy(err, msg.data(), n);
  err[n] = 0;
}

}  // namespace

extern "C" {

// Decodes job i (src[i], src_len[i]) into dst[i]; with `exact` the job
// succeeds only if it decodes to exactly dst_len[i] bytes, else to at most
// that many (frames that do not state their size). written[i] is the bytes
// written, or -1 on failure. Returns the number of failed jobs; the first
// failure's message (with its job index) goes to err.
int zstd_decode_many(int n, const uint8_t* const* src, const uint64_t* src_len,
                     uint8_t* const* dst, const uint64_t* dst_len, int64_t* written,
                     int exact, int threads, char* err, int errlen) {
  std::atomic<int> next(0), failed(0), first(-1);
  std::vector<std::string> messages(size_t(n > 0 ? n : 0));
  auto work = [&]() {
    Decoder d;
    for (int i; (i = next.fetch_add(1)) < n;) {
      try {
        size_t got = d.decode(src[i], src_len[i], dst[i], dst_len[i]);
        if (exact && got != dst_len[i]) fail("decoded to fewer bytes than its destination holds");
        written[i] = int64_t(got);
      } catch (const std::exception& e) {
        written[i] = -1;
        messages[i] = e.what();
        failed.fetch_add(1);
        int expected = -1;
        while (expected == -1 || i < expected) {
          if (first.compare_exchange_weak(expected, i)) break;
        }
      }
    }
  };
  int t = threads < 1 ? 1 : threads;
  if (t > n) t = n;
  std::vector<std::thread> pool;
  try {
    for (int k = 1; k < t; ++k) pool.emplace_back(work);
  } catch (const std::exception& e) {
    // fewer threads than asked: the remaining ones take the jobs
  }
  work();
  for (auto& th : pool) th.join();
  if (first.load() >= 0) {
    int i = first.load();
    copy_message("job " + std::to_string(i) + ": " + messages[size_t(i)], err, errlen);
  }
  return failed.load();
}

// CRC-32C (Castagnoli, reflected) of a buffer, slicing by 8: the checksum
// of tensorstore's OCDBT files.
uint32_t zstd_crc32c(const uint8_t* p, uint64_t n) {
  static uint32_t table[8][256];
  static std::atomic<bool> ready(false);
  if (!ready.load()) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      table[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int t = 1; t < 8; ++t) table[t][i] = (table[t - 1][i] >> 8) ^ table[0][table[t - 1][i] & 0xFF];
    ready.store(true);
  }
  uint32_t crc = 0xFFFFFFFFu;
  while (n >= 8) {
    uint64_t v = load64(p) ^ crc;
    crc = table[7][v & 0xFF] ^ table[6][(v >> 8) & 0xFF] ^ table[5][(v >> 16) & 0xFF] ^
          table[4][(v >> 24) & 0xFF] ^ table[3][(v >> 32) & 0xFF] ^ table[2][(v >> 40) & 0xFF] ^
          table[1][(v >> 48) & 0xFF] ^ table[0][v >> 56];
    p += 8, n -= 8;
  }
  while (n--) crc = table[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

// xxHash64 of a buffer (seed 0): the tests hold it against the Python one.
uint64_t zstd_xxh64(const uint8_t* src, uint64_t n) { return xxh64(src, size_t(n)); }

}  // extern "C"
