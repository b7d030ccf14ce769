// CRC-32C (Castagnoli) of a byte buffer, for the TFRecord reader's
// record checks (data/recordio.py).  Host code, built with the host C++
// compiler by ops/_build.py and loaded with ctypes.
//
// On x86-64 CPUs with SSE4.2 the bytes go through the crc32 instruction,
// eight at a time (_mm_crc32_u64), in three independent streams over
// three consecutive blocks of kBlock bytes (the instruction takes three
// cycles and a new one can start every cycle), chained by the linear map
// "feed kBlock zero bytes", and the last 0-7 bytes one at a time; elsewhere a
// slicing-by-8 table loop does the words and the byte table the tail.
// Both compute the reflected polynomial 0x82F63B78 with the standard
// initial and final inversion, as google_crc32c does.

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#if defined(__x86_64__)
#include <nmmintrin.h>
#endif

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;
constexpr size_t kBlock = 8192;  // bytes of each of the three streams

struct Tables {
  uint32_t t[8][256];
  // shift[k][b]: the register after kBlock zero bytes from b << 8k
  uint32_t shift[4][256];
  Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ kPoly : c >> 1;
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (uint32_t i = 0; i < 256; ++i)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
    uint32_t images[32];
    for (int bit = 0; bit < 32; ++bit) {
      uint32_t c = 1u << bit;
      for (size_t i = 0; i < kBlock; ++i) c = (c >> 8) ^ t[0][c & 0xFF];
      images[bit] = c;
    }
    for (int k = 0; k < 4; ++k)
      for (uint32_t b = 0; b < 256; ++b) {
        uint32_t c = 0;
        for (int j = 0; j < 8; ++j)
          if (b >> j & 1) c ^= images[8 * k + j];
        shift[k][b] = c;
      }
  }
};

const Tables& tables() {
  static const Tables tab;
  return tab;
}

uint32_t crc_slicing8(const uint8_t* p, size_t n, uint32_t crc) {
  const Tables& tab = tables();
  while (n >= 8) {
    uint64_t word;
    memcpy(&word, p, 8);  // little-endian hosts
    word ^= crc;
    crc = tab.t[7][word & 0xFF] ^ tab.t[6][(word >> 8) & 0xFF] ^
          tab.t[5][(word >> 16) & 0xFF] ^ tab.t[4][(word >> 24) & 0xFF] ^
          tab.t[3][(word >> 32) & 0xFF] ^ tab.t[2][(word >> 40) & 0xFF] ^
          tab.t[1][(word >> 48) & 0xFF] ^ tab.t[0][word >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ tab.t[0][(crc ^ *p++) & 0xFF];
  return crc;
}

// The register after kBlock zero bytes from c (linear in c).
uint32_t shift_block(uint32_t c) {
  const Tables& tab = tables();
  return tab.shift[0][c & 0xFF] ^ tab.shift[1][(c >> 8) & 0xFF] ^
         tab.shift[2][(c >> 16) & 0xFF] ^ tab.shift[3][c >> 24];
}

#if defined(__x86_64__)
__attribute__((target("sse4.2"))) uint32_t crc_sse42(const uint8_t* p,
                                                     size_t n, uint32_t crc) {
  // feeding A || B from s gives shift(feed(s, A)) ^ feed(0, B)
  while (n >= 3 * kBlock) {
    uint64_t a = crc, b = 0, c = 0;
    for (size_t i = 0; i < kBlock; i += 8) {
      uint64_t wa, wb, wc;
      memcpy(&wa, p + i, 8);
      memcpy(&wb, p + kBlock + i, 8);
      memcpy(&wc, p + 2 * kBlock + i, 8);
      a = _mm_crc32_u64(a, wa);
      b = _mm_crc32_u64(b, wb);
      c = _mm_crc32_u64(c, wc);
    }
    crc = shift_block(shift_block(static_cast<uint32_t>(a)) ^
                      static_cast<uint32_t>(b)) ^
          static_cast<uint32_t>(c);
    p += 3 * kBlock;
    n -= 3 * kBlock;
  }
  uint64_t c = crc;
  while (n >= 8) {
    uint64_t word;
    memcpy(&word, p, 8);
    c = _mm_crc32_u64(c, word);
    p += 8;
    n -= 8;
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  while (n--) c32 = _mm_crc32_u8(c32, *p++);
  return c32;
}

bool has_sse42() {
  static const bool yes = __builtin_cpu_supports("sse4.2");
  return yes;
}
#endif

}  // namespace

extern "C" {

// CRC-32C of data[0, n).
uint32_t neurst_crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = 0xFFFFFFFFu;
#if defined(__x86_64__)
  if (has_sse42()) return crc_sse42(data, n, crc) ^ 0xFFFFFFFFu;
#endif
  return crc_slicing8(data, n, crc) ^ 0xFFFFFFFFu;
}

// The same through the table loop alone (for tests of both routes).
uint32_t neurst_crc32c_tables(const uint8_t* data, size_t n) {
  return crc_slicing8(data, n, 0xFFFFFFFFu) ^ 0xFFFFFFFFu;
}

}  // extern "C"
