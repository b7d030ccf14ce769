// A Zstandard frame decoder (RFC 8878), for the orbax checkpoint reader:
// TensorStore compresses the OCDBT nodes and the zarr chunks with zstd,
// and neither the zstandard package nor libzstd is assumed.  Host code,
// built with the host C++ compiler by ops/_build.py and loaded with
// ctypes (utils/zstd.py).
//
// It decodes every frame of a buffer (skippable frames are skipped):
// raw, RLE and compressed blocks; literals raw, RLE, Huffman-coded with
// a direct or an FSE-compressed weight table, in one or four streams, and
// treeless (the previous block's table); sequences with predefined, RLE,
// FSE-compressed and repeat tables for literal lengths, match lengths and
// offsets; the repeat offsets; and the XXH64 content checksum, which it
// checks.  A frame that names a dictionary raises, and so does any
// corrupt input (every read is bounds-checked).
//
// C interface: neurst_zstd_decode(src, n, &error) gives a handle (null on
// error, with the message in *error until the next call), whose bytes
// neurst_zstd_size / neurst_zstd_data read and neurst_zstd_free
// releases.

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <stdexcept>
#include <string>
#include <vector>

namespace {

using Bytes = std::vector<uint8_t>;

[[noreturn]] void fail(const std::string& what) {
  throw std::runtime_error("zstd: " + what);
}

int highbit(uint32_t v) {  // index of the highest set bit of v > 0
  int n = 0;
  while (v >>= 1) ++n;
  return n;
}

uint64_t read_le(const uint8_t* p, int bytes) {
  uint64_t v = 0;
  if (bytes == 8) {
    memcpy(&v, p, 8);  // little-endian hosts (x86-64, aarch64)
    return v;
  }
  for (int i = 0; i < bytes; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

// ------------------------------------------------------------------ XXH64

constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (end - p >= 32) {
      v1 = xround(v1, read_le(p, 8));
      v2 = xround(v2, read_le(p + 8, 8));
      v3 = xround(v3, read_le(p + 16, 8));
      v4 = xround(v4, read_le(p + 24, 8));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = P5;
  }
  h += n;
  while (end - p >= 8) {
    h ^= xround(0, read_le(p, 8));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h ^= read_le(p, 4) * P1;
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
  h ^= h >> 32;
  return h;
}

// ----------------------------------------------------------- bit readers

// Little-endian bits from the start of [p, p + n) (FSE table headers);
// bits past the end read as zeros (the caller checks bytes() <= n).
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;
  uint32_t peek(int k) const {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) {
      size_t b = bit + i;
      if (b / 8 < n) v |= uint32_t((p[b / 8] >> (b % 8)) & 1) << i;
    }
    if (bit > 8 * n) fail("truncated FSE table description");
    return v;
  }
  void skip(int k) { bit += k; }
  uint32_t read(int k) {
    uint32_t v = peek(k);
    bit += k;
    return v;
  }
  size_t bytes() const { return (bit + 7) / 8; }
};

// Bits read from the end of [p, p + n) towards its start (Huffman and
// FSE streams): the highest set bit of the last byte marks the end; bits
// past the start read as zeros, which overflowed() tells.
struct BackwardBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t offset = 0;  // bits left
  BackwardBits() = default;
  BackwardBits(const uint8_t* src, size_t len) : p(src), n(len) {
    if (len == 0) fail("empty bitstream");
    uint8_t last = src[len - 1];
    if (last == 0) fail("bitstream without its end mark");
    offset = int64_t(len - 1) * 8 + highbit(last);
  }
  // k <= 32 bits
  uint64_t read(int k) {
    if (k == 0) return 0;
    int64_t start = offset - k;
    offset = start;
    if (start >= 0) {
      size_t byte = size_t(start) >> 3;
      size_t avail = n - byte;
      uint64_t w = read_le(p + byte, avail < 8 ? int(avail) : 8);
      return (w >> (start & 7)) & ((uint64_t(1) << k) - 1);
    }
    uint64_t v = 0;
    for (int i = 0; i < k; ++i) {
      int64_t b = start + i;
      if (b >= 0) v |= uint64_t((p[b / 8] >> (b % 8)) & 1) << i;
    }
    return v;
  }
  bool overflowed() const { return offset < 0; }
};

// ---------------------------------------------------------------- FSE

struct FseTable {
  int log = 0;
  std::vector<uint8_t> symbol, bits;
  std::vector<uint16_t> base;
};

FseTable build_fse(const std::vector<int16_t>& norm, int log) {
  FseTable t;
  t.log = log;
  size_t size = size_t(1) << log;
  t.symbol.assign(size, 0);
  t.bits.assign(size, 0);
  t.base.assign(size, 0);
  std::vector<uint32_t> next(norm.size());
  size_t high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      t.symbol[high--] = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s] < 0 ? 0 : norm[s]);
    }
  }
  size_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.symbol[pos] = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) fail("bad FSE distribution");
  for (size_t u = 0; u < size; ++u) {
    uint32_t state = next[t.symbol[u]]++;
    if (state == 0) fail("bad FSE distribution");
    int nb = log - highbit(state);
    t.bits[u] = uint8_t(nb);
    t.base[u] = uint16_t((state << nb) - size);
  }
  return t;
}

// The normalized counts of an FSE table description at [p, p + n); returns
// the table and sets *used to the bytes it took.
FseTable read_fse(const uint8_t* p, size_t n, int max_symbol, int max_log,
                  size_t* used) {
  ForwardBits in{p, n};
  int log = int(in.read(4)) + 5;
  if (log > max_log) fail("FSE accuracy log too large");
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1;
  std::vector<int16_t> norm;
  bool previous0 = false;
  while (remaining > 1 && int(norm.size()) <= max_symbol) {
    if (previous0) {
      int repeat = int(norm.size());
      uint32_t two;
      while ((two = in.read(2)) == 3) repeat += 3;
      repeat += int(two);
      if (repeat > max_symbol + 1) fail("FSE repeat past the alphabet");
      while (int(norm.size()) < repeat) norm.push_back(0);
      previous0 = false;
      if (int(norm.size()) > max_symbol) break;
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = in.peek(nb - 1);
    if (int(low & (threshold - 1)) < max) {
      count = int(low & (threshold - 1));
      in.skip(nb - 1);
    } else {
      count = int(in.peek(nb) & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      in.skip(nb);
    }
    --count;
    remaining -= count < 0 ? -count : count;
    norm.push_back(int16_t(count));
    previous0 = count == 0;
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("bad FSE table description");
  *used = in.bytes();
  if (*used > n) fail("truncated FSE table description");
  return build_fse(norm, log);
}

FseTable rle_fse(uint8_t symbol) {
  FseTable t;
  t.log = 0;
  t.symbol = {symbol};
  t.bits = {0};
  t.base = {0};
  return t;
}

struct FseState {
  const FseTable* t;
  uint32_t state;
  void init(const FseTable& table, BackwardBits& in) {
    t = &table;
    state = uint32_t(in.read(table.log));
  }
  uint8_t symbol() const { return t->symbol[state]; }
  void update(BackwardBits& in) {
    state = t->base[state] + uint32_t(in.read(t->bits[state]));
  }
};

// ---------------------------------------------------------------- Huffman

struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> symbol, bits;
};

HufTable build_huf(std::vector<uint8_t> weights) {
  // the last symbol's weight makes the total a power of two
  uint32_t total = 0;
  for (uint8_t w : weights) {
    if (w > 11) fail("Huffman weight too large");
    if (w) total += 1u << (w - 1);
  }
  if (total == 0) fail("Huffman weights all zero");
  int max_bits = highbit(total) + 1;
  uint32_t left = (1u << max_bits) - total;
  if (left & (left - 1)) fail("bad Huffman weights");
  weights.push_back(uint8_t(highbit(left) + 1));
  if (max_bits > 11) fail("Huffman code too long");
  HufTable t;
  t.max_bits = max_bits;
  t.symbol.assign(size_t(1) << max_bits, 0);
  t.bits.assign(size_t(1) << max_bits, 0);
  uint32_t start[13] = {0}, count[13] = {0};
  for (uint8_t w : weights) count[w]++;
  uint32_t pos = 0;
  for (int w = 1; w <= max_bits; ++w) {
    start[w] = pos;
    pos += count[w] << (w - 1);
  }
  for (size_t s = 0; s < weights.size(); ++s) {
    int w = weights[s];
    if (!w) continue;
    uint32_t len = 1u << (w - 1);
    for (uint32_t i = 0; i < len; ++i) {
      t.symbol[start[w] + i] = uint8_t(s);
      t.bits[start[w] + i] = uint8_t(max_bits + 1 - w);
    }
    start[w] += len;
  }
  return t;
}

// The tree description at [p, p + n); returns its size in bytes.
size_t read_huf(const uint8_t* p, size_t n, HufTable* out) {
  if (n < 1) fail("truncated Huffman tree");
  uint8_t header = p[0];
  std::vector<uint8_t> weights;
  size_t used;
  if (header >= 128) {
    size_t count = header - 127;
    used = 1 + (count + 1) / 2;
    if (used > n) fail("truncated Huffman weights");
    for (size_t i = 0; i < count; ++i) {
      uint8_t b = p[1 + i / 2];
      weights.push_back(i % 2 ? (b & 15) : (b >> 4));
    }
  } else {
    used = 1 + size_t(header);
    if (used > n || header == 0) fail("truncated Huffman weights");
    size_t table_bytes;
    FseTable fse = read_fse(p + 1, header, 255, 6, &table_bytes);
    BackwardBits in(p + 1 + table_bytes, header - table_bytes);
    FseState s1, s2;
    s1.init(fse, in);
    s2.init(fse, in);
    while (true) {
      if (weights.size() > 255) fail("too many Huffman weights");
      weights.push_back(s1.symbol());
      s1.update(in);
      if (in.overflowed()) {
        weights.push_back(s2.symbol());
        break;
      }
      weights.push_back(s2.symbol());
      s2.update(in);
      if (in.overflowed()) {
        weights.push_back(s1.symbol());
        break;
      }
    }
  }
  if (weights.size() > 255) fail("too many Huffman weights");
  *out = build_huf(weights);
  return used;
}

void huf_stream(const HufTable& t, const uint8_t* p, size_t n, uint8_t* dst,
                size_t count) {
  BackwardBits in(p, n);
  uint32_t mask = (1u << t.max_bits) - 1;
  uint32_t state = uint32_t(in.read(t.max_bits));
  for (size_t i = 0; i < count; ++i) {
    dst[i] = t.symbol[state];
    int nb = t.bits[state];
    state = ((state << nb) | uint32_t(in.read(nb))) & mask;
  }
  if (in.offset != -int64_t(t.max_bits)) fail("Huffman stream length");
}

// ---------------------------------------------------------------- tables

const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {
    0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// ---------------------------------------------------------------- frames

struct FrameState {
  HufTable huf;
  bool has_huf = false;
  FseTable ll, of, ml;
  bool has_ll = false, has_of = false, has_ml = false;
  uint64_t rep[3] = {1, 4, 8};
};

size_t read_literals(const uint8_t* p, size_t n, FrameState& st,
                     Bytes& lit) {
  if (n < 1) fail("truncated literals header");
  int type = p[0] & 3, format = (p[0] >> 2) & 3;
  size_t regen, comp = 0, header;
  if (type < 2) {
    if ((format & 1) == 0) {
      header = 1;
      regen = p[0] >> 3;
    } else if (format == 1) {
      header = 2;
      if (n < 2) fail("truncated literals header");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4);
    } else {
      header = 3;
      if (n < 3) fail("truncated literals header");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
    }
    if (type == 0) {
      if (header + regen > n) fail("truncated raw literals");
      lit.assign(p + header, p + header + regen);
      return header + regen;
    }
    if (header + 1 > n) fail("truncated RLE literals");
    lit.assign(regen, p[header]);
    return header + 1;
  }
  header = format < 2 ? 3 : format == 2 ? 4 : 5;
  if (n < header) fail("truncated literals header");
  uint64_t c = read_le(p, int(header));
  int field = format < 2 ? 10 : format == 2 ? 14 : 18;
  regen = size_t((c >> 4) & ((1u << field) - 1));
  comp = size_t((c >> (4 + field)) & ((1u << field) - 1));
  int streams = format == 0 ? 1 : 4;
  if (header + comp > n) fail("truncated compressed literals");
  const uint8_t* q = p + header;
  size_t left = comp;
  if (type == 2) {
    size_t used = read_huf(q, left, &st.huf);
    st.has_huf = true;
    q += used;
    left -= used;
  } else if (!st.has_huf) {
    fail("treeless literals without a previous table");
  }
  lit.assign(regen, 0);
  if (streams == 1) {
    huf_stream(st.huf, q, left, lit.data(), regen);
  } else {
    if (left < 6) fail("truncated jump table");
    size_t s1 = read_le(q, 2), s2 = read_le(q + 2, 2), s3 = read_le(q + 4, 2);
    if (6 + s1 + s2 + s3 > left) fail("bad jump table");
    size_t s4 = left - 6 - s1 - s2 - s3;
    size_t seg = (regen + 3) / 4;
    if (seg * 3 > regen) fail("bad four-stream literal size");
    const uint8_t* r = q + 6;
    huf_stream(st.huf, r, s1, lit.data(), seg);
    huf_stream(st.huf, r + s1, s2, lit.data() + seg, seg);
    huf_stream(st.huf, r + s1 + s2, s3, lit.data() + 2 * seg, seg);
    huf_stream(st.huf, r + s1 + s2 + s3, s4, lit.data() + 3 * seg,
               regen - 3 * seg);
  }
  return header + comp;
}

size_t read_table(const uint8_t* p, size_t n, int mode, FseTable* t,
                  bool* has, const int16_t* norm, int norm_n, int norm_log,
                  int max_symbol, int max_log) {
  switch (mode) {
    case 0:
      *t = build_fse(std::vector<int16_t>(norm, norm + norm_n), norm_log);
      *has = true;
      return 0;
    case 1:
      if (n < 1) fail("truncated RLE table");
      if (p[0] > max_symbol) fail("RLE symbol past the alphabet");
      *t = rle_fse(p[0]);
      *has = true;
      return 1;
    case 2: {
      size_t used;
      *t = read_fse(p, n, max_symbol, max_log, &used);
      *has = true;
      return used;
    }
    default:
      if (!*has) fail("repeat table without a previous one");
      return 0;
  }
}

void decode_block(const uint8_t* p, size_t n, FrameState& st, Bytes& out,
                  size_t frame_start) {
  Bytes lit;
  size_t pos = read_literals(p, n, st, lit);
  if (pos >= n) fail("truncated sequences section");
  size_t nseq = p[pos];
  if (nseq == 0) {
    pos += 1;
  } else if (nseq < 128) {
    pos += 1;
  } else if (nseq < 255) {
    if (pos + 2 > n) fail("truncated sequence count");
    nseq = ((nseq - 128) << 8) + p[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > n) fail("truncated sequence count");
    nseq = p[pos + 1] + (size_t(p[pos + 2]) << 8) + 0x7F00;
    pos += 3;
  }
  if (nseq == 0) {
    if (pos != n) fail("bytes after an empty sequences section");
    out.insert(out.end(), lit.begin(), lit.end());
    return;
  }
  if (pos >= n) fail("truncated compression modes");
  uint8_t modes = p[pos++];
  if (modes & 3) fail("reserved compression mode bits");
  pos += read_table(p + pos, n - pos, modes >> 6, &st.ll, &st.has_ll,
                    kLLNorm, 36, 6, 35, 9);
  pos += read_table(p + pos, n - pos, (modes >> 4) & 3, &st.of, &st.has_of,
                    kOFNorm, 29, 5, 31, 8);
  pos += read_table(p + pos, n - pos, (modes >> 2) & 3, &st.ml, &st.has_ml,
                    kMLNorm, 53, 6, 52, 9);
  if (pos >= n) fail("truncated sequence bitstream");
  BackwardBits in(p + pos, n - pos);
  FseState ll, of, ml;
  ll.init(st.ll, in);
  of.init(st.of, in);
  ml.init(st.ml, in);
  size_t lit_pos = 0;
  for (size_t i = 0; i < nseq; ++i) {
    uint8_t of_code = of.symbol(), ll_code = ll.symbol(),
            ml_code = ml.symbol();
    if (ll_code > 35 || ml_code > 52 || of_code > 31)
      fail("sequence code past its alphabet");
    uint64_t offset_value = (uint64_t(1) << of_code) + in.read(of_code);
    uint64_t match = kMLBase[ml_code] + in.read(kMLBits[ml_code]);
    uint64_t literals = kLLBase[ll_code] + in.read(kLLBits[ll_code]);
    uint64_t offset;
    if (offset_value > 3) {
      offset = offset_value - 3;
      st.rep[2] = st.rep[1];
      st.rep[1] = st.rep[0];
      st.rep[0] = offset;
    } else {
      uint64_t idx = offset_value - 1 + (literals == 0 ? 1 : 0);
      if (idx == 0) {
        offset = st.rep[0];
      } else {
        offset = idx < 3 ? st.rep[idx] : st.rep[0] - 1;
        if (idx > 1) st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      ll.update(in);
      ml.update(in);
      of.update(in);
    }
    if (lit_pos + literals > lit.size()) fail("literals overrun");
    out.insert(out.end(), lit.begin() + lit_pos,
               lit.begin() + lit_pos + literals);
    lit_pos += literals;
    if (offset == 0 || offset > out.size() - frame_start)
      fail("match offset before the frame");
    size_t from = out.size() - offset;
    for (uint64_t k = 0; k < match; ++k) out.push_back(out[from + k]);
  }
  if (in.offset != 0) fail("sequence bitstream length");
  out.insert(out.end(), lit.begin() + lit_pos, lit.end());
}

size_t decode_frame(const uint8_t* p, size_t n, Bytes& out) {
  size_t pos = 4;
  if (n < 5) fail("truncated frame header");
  uint8_t fhd = p[pos++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
      did_flag = fhd & 3;
  if (fhd & 8) fail("reserved frame header bit");
  if (!single) pos += 1;  // window descriptor: the whole frame is held
  int did_bytes = did_flag == 3 ? 4 : did_flag;
  int fcs_bytes = fcs_flag == 0 ? single : 1 << fcs_flag;
  if (pos + did_bytes + fcs_bytes > n) fail("truncated frame header");
  if (did_bytes && read_le(p + pos, did_bytes) != 0)
    fail("dictionary frames are not supported");
  pos += did_bytes;
  uint64_t content = 0;
  bool has_size = fcs_bytes > 0;
  if (has_size) {
    content = read_le(p + pos, fcs_bytes) + (fcs_bytes == 2 ? 256 : 0);
    pos += fcs_bytes;
  }
  size_t start = out.size();
  FrameState st;
  while (true) {
    if (pos + 3 > n) fail("truncated block header");
    uint32_t bh = uint32_t(read_le(p + pos, 3));
    pos += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 0) {
      if (pos + size > n) fail("truncated raw block");
      out.insert(out.end(), p + pos, p + pos + size);
      pos += size;
    } else if (type == 1) {
      if (pos + 1 > n) fail("truncated RLE block");
      out.insert(out.end(), size, p[pos]);
      pos += 1;
    } else if (type == 2) {
      if (pos + size > n) fail("truncated compressed block");
      decode_block(p + pos, size, st, out, start);
      pos += size;
    } else {
      fail("reserved block type");
    }
    if (last) break;
  }
  if (has_size && out.size() - start != content)
    fail("frame content size mismatch");
  if (checksum) {
    if (pos + 4 > n) fail("truncated content checksum");
    uint32_t want = uint32_t(read_le(p + pos, 4));
    uint32_t got = uint32_t(xxh64(out.data() + start, out.size() - start));
    if (want != got) fail("content checksum mismatch");
    pos += 4;
  }
  return pos;
}

void decode_all(const uint8_t* p, size_t n, Bytes& out) {
  size_t pos = 0;
  if (n == 0) fail("empty input");
  while (pos < n) {
    if (n - pos < 4) fail("truncated frame magic");
    uint32_t magic = uint32_t(read_le(p + pos, 4));
    if (magic == 0xFD2FB528u) {
      pos += decode_frame(p + pos, n - pos, out);
    } else if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - pos < 8) fail("truncated skippable frame");
      size_t size = read_le(p + pos + 4, 4);
      if (n - pos - 8 < size) fail("truncated skippable frame");
      pos += 8 + size;
    } else {
      fail("not a zstd frame");
    }
  }
}

thread_local std::string last_error;

}  // namespace

extern "C" {

void* neurst_zstd_decode(const uint8_t* src, size_t n, const char** error) {
  Bytes* out = new Bytes();
  try {
    decode_all(src, n, *out);
  } catch (const std::exception& e) {
    delete out;
    last_error = e.what();
    *error = last_error.c_str();
    return nullptr;
  }
  return out;
}

size_t neurst_zstd_size(void* handle) {
  return static_cast<Bytes*>(handle)->size();
}

const uint8_t* neurst_zstd_data(void* handle) {
  return static_cast<Bytes*>(handle)->data();
}

void neurst_zstd_free(void* handle) { delete static_cast<Bytes*>(handle); }

}  // extern "C"
