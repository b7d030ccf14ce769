// Copyright 2026 The NeurST-TPU Authors.
//
// Licensed under the Apache License, Version 2.0 (the "License");
// you may not use this file except in compliance with the License.
// You may obtain a copy of the License at
//
//     http://www.apache.org/licenses/LICENSE-2.0
//
// Unless required by applicable law or agreed to in writing, software
// distributed under the License is distributed on an "AS IS" BASIS,
// WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
// See the License for the specific language governing permissions and
// limitations under the License.
//
// A self-contained FLAC decoder (subset: everything LibriSpeech/MuST-C
// era encoders emit — constant/verbatim/fixed/LPC subframes, rice
// residuals with 4/5-bit parameters, all channel decorrelation modes,
// 8/16/24-bit samples).  Exposed through a minimal C ABI for ctypes;
// the raw-audio datasets stream archive members through this without
// external audio libraries.  Host code, built with the host C++ compiler
// by ops/_build.py (data/audio/flac_io.py loads it).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t len;
  size_t byte_pos = 0;
  int bit_pos = 0;  // 0..7, MSB first
  bool error = false;

  BitReader(const uint8_t* d, size_t l) : data(d), len(l) {}

  inline bool eof() const { return byte_pos >= len; }

  inline uint32_t read_bit() {
    if (byte_pos >= len) { error = true; return 0; }
    uint32_t b = (data[byte_pos] >> (7 - bit_pos)) & 1u;
    if (++bit_pos == 8) { bit_pos = 0; ++byte_pos; }
    return b;
  }

  uint64_t read_bits(int n) {
    uint64_t v = 0;
    while (n > 0) {
      if (byte_pos >= len) { error = true; return 0; }
      int avail = 8 - bit_pos;
      int take = n < avail ? n : avail;
      uint32_t chunk = (data[byte_pos] >> (avail - take)) &
                       ((1u << take) - 1u);
      v = (v << take) | chunk;
      bit_pos += take;
      if (bit_pos == 8) { bit_pos = 0; ++byte_pos; }
      n -= take;
    }
    return v;
  }

  int64_t read_signed(int n) {
    if (n == 0) return 0;
    uint64_t v = read_bits(n);
    uint64_t sign = 1ull << (n - 1);
    if (v & sign) return (int64_t)(v | ~((1ull << n) - 1ull));
    return (int64_t)v;
  }

  // unary-coded quotient for rice codes
  uint32_t read_unary() {
    uint32_t q = 0;
    while (!error && read_bit() == 0) {
      ++q;
      if (q > 1u << 24) { error = true; break; }  // corrupt stream guard
    }
    return q;
  }

  void align_to_byte() {
    if (bit_pos != 0) { bit_pos = 0; ++byte_pos; }
  }
};

// UTF-8-style coded number in frame headers (up to 36 bits)
uint64_t read_utf8_number(BitReader& br) {
  uint64_t b0 = br.read_bits(8);
  int extra = 0;
  uint64_t v = 0;
  if ((b0 & 0x80) == 0) return b0;
  else if ((b0 & 0xE0) == 0xC0) { v = b0 & 0x1F; extra = 1; }
  else if ((b0 & 0xF0) == 0xE0) { v = b0 & 0x0F; extra = 2; }
  else if ((b0 & 0xF8) == 0xF0) { v = b0 & 0x07; extra = 3; }
  else if ((b0 & 0xFC) == 0xF8) { v = b0 & 0x03; extra = 4; }
  else if ((b0 & 0xFE) == 0xFC) { v = b0 & 0x01; extra = 5; }
  else if (b0 == 0xFE) { v = 0; extra = 6; }
  else { br.error = true; return 0; }
  for (int i = 0; i < extra; ++i) {
    uint64_t b = br.read_bits(8);
    if ((b & 0xC0) != 0x80) { br.error = true; return 0; }
    v = (v << 6) | (b & 0x3F);
  }
  return v;
}

const int kBlockSizes[16] = {0,     192,   576,  1152, 2304, 4608, -1, -2,
                             256,   512,   1024, 2048, 4096, 8192,
                             16384, 32768};
const int kSampleRates[16] = {0,     88200, 176400, 192000, 8000,  16000,
                              22050, 24000, 32000,  44100,  48000, 96000,
                              -1,    -2,    -3,     0};

bool decode_residuals(BitReader& br, int order, int block_size,
                      int32_t* out /* length block_size */) {
  // out[0..order) already filled with warmup samples
  uint32_t method = (uint32_t)br.read_bits(2);
  if (method > 1) return false;              // 0: 4-bit rice, 1: 5-bit rice
  int param_bits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t partition_order = (uint32_t)br.read_bits(4);
  uint32_t partitions = 1u << partition_order;
  if (block_size % partitions != 0) return false;
  int samples_per_partition = block_size >> partition_order;
  int idx = order;
  for (uint32_t p = 0; p < partitions; ++p) {
    int count = samples_per_partition - (p == 0 ? order : 0);
    if (count < 0) return false;
    uint32_t rice = (uint32_t)br.read_bits(param_bits);
    if (rice == escape) {
      int raw_bits = (int)br.read_bits(5);
      for (int i = 0; i < count; ++i)
        out[idx++] = (int32_t)br.read_signed(raw_bits);
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t q = br.read_unary();
        uint64_t r = rice ? br.read_bits(rice) : 0;
        uint64_t u = ((uint64_t)q << rice) | r;
        out[idx++] = (int32_t)((u >> 1) ^ (~(u & 1) + 1));  // zigzag
      }
    }
    if (br.error) return false;
  }
  return idx == block_size;
}

const int kFixedCoeffs[5][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0}, {3, -3, 1, 0}, {4, -6, 4, -1}};

bool decode_subframe(BitReader& br, int block_size, int bps,
                     std::vector<int32_t>& out) {
  out.resize(block_size);
  if (br.read_bits(1) != 0) return false;  // padding bit
  uint32_t type = (uint32_t)br.read_bits(6);
  uint32_t wasted = 0;
  if (br.read_bits(1) == 1) {              // wasted bits flag
    wasted = 1 + br.read_unary();
    bps -= (int)wasted;
  }
  if (type == 0) {                          // CONSTANT
    int32_t v = (int32_t)br.read_signed(bps);
    for (int i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {                   // VERBATIM
    for (int i = 0; i < block_size; ++i)
      out[i] = (int32_t)br.read_signed(bps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED
    int order = type & 0x07;
    for (int i = 0; i < order; ++i) out[i] = (int32_t)br.read_signed(bps);
    if (!decode_residuals(br, order, block_size, out.data())) return false;
    const int* c = kFixedCoeffs[order];
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += (int64_t)c[j] * out[i - 1 - j];
      out[i] += (int32_t)pred;
    }
  } else if (type & 0x20) {                 // LPC
    int order = (int)(type & 0x1F) + 1;
    for (int i = 0; i < order; ++i) out[i] = (int32_t)br.read_signed(bps);
    int precision = (int)br.read_bits(4) + 1;
    if (precision == 16) return false;      // 0b1111 is invalid
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    std::vector<int64_t> coeffs(order);
    for (int i = 0; i < order; ++i) coeffs[i] = br.read_signed(precision);
    if (!decode_residuals(br, order, block_size, out.data())) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j)
        pred += coeffs[j] * (int64_t)out[i - 1 - j];
      out[i] += (int32_t)(pred >> shift);
    }
  } else {
    return false;
  }
  if (wasted)
    for (int i = 0; i < block_size; ++i) out[i] <<= wasted;
  return !br.error;
}

}  // namespace

extern "C" {

// Decodes a full FLAC stream.  Returns 0 on success.
// On success, *out_samples is malloc'd interleaved int32 PCM
// (caller frees via flac_free), *out_n = frames per channel.
int flac_decode(const uint8_t* data, size_t len, int32_t** out_samples,
                long long* out_n, int* out_rate, int* out_channels,
                int* out_bps) {
  if (len < 8 || memcmp(data, "fLaC", 4) != 0) return 1;
  size_t pos = 4;
  int rate = 0, channels = 0, bps = 0;
  long long total_samples = 0;
  // metadata blocks
  bool last = false;
  while (!last) {
    if (pos + 4 > len) return 2;
    last = (data[pos] & 0x80) != 0;
    int type = data[pos] & 0x7F;
    uint32_t size = ((uint32_t)data[pos + 1] << 16) |
                    ((uint32_t)data[pos + 2] << 8) | data[pos + 3];
    pos += 4;
    if (pos + size > len) return 2;
    if (type == 0 && size >= 34) {  // STREAMINFO
      const uint8_t* b = data + pos;
      rate = ((int)b[10] << 12) | ((int)b[11] << 4) | (b[12] >> 4);
      channels = ((b[12] >> 1) & 0x7) + 1;
      bps = (((b[12] & 1) << 4) | (b[13] >> 4)) + 1;
      total_samples = ((long long)(b[13] & 0x0F) << 32) |
                      ((long long)b[14] << 24) | ((long long)b[15] << 16) |
                      ((long long)b[16] << 8) | b[17];
    }
    pos += size;
  }
  if (rate == 0 || channels == 0 || channels > 8) return 3;

  std::vector<int32_t> pcm;
  if (total_samples > 0) pcm.reserve((size_t)total_samples * channels);

  BitReader br(data, len);
  br.byte_pos = pos;
  std::vector<std::vector<int32_t>> chan(channels);

  while (br.byte_pos < len) {
    // frame header: sync 11111111 111110xx
    uint64_t sync = br.read_bits(14);
    if (br.eof() || br.error) break;
    if (sync != 0x3FFE) return 4;
    br.read_bits(1);                         // reserved
    br.read_bits(1);                         // blocking strategy
    uint32_t bs_code = (uint32_t)br.read_bits(4);
    uint32_t sr_code = (uint32_t)br.read_bits(4);
    uint32_t ch_code = (uint32_t)br.read_bits(4);
    uint32_t ss_code = (uint32_t)br.read_bits(3);
    br.read_bits(1);                         // reserved
    read_utf8_number(br);                    // frame/sample number
    int block_size;
    if (bs_code == 6) block_size = (int)br.read_bits(8) + 1;
    else if (bs_code == 7) block_size = (int)br.read_bits(16) + 1;
    else if (kBlockSizes[bs_code] > 0) block_size = kBlockSizes[bs_code];
    else return 5;
    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);
    int frame_bps = bps;
    switch (ss_code) {
      case 0: break;
      case 1: frame_bps = 8; break;
      case 2: frame_bps = 12; break;
      case 4: frame_bps = 16; break;
      case 5: frame_bps = 20; break;
      case 6: frame_bps = 24; break;
      default: return 6;
    }
    br.read_bits(8);                         // header CRC-8 (unchecked)

    int nch = channels;
    int assignment = 0;  // 0 independent, 1 L/S, 2 R/S, 3 M/S
    if (ch_code < 8) {
      nch = (int)ch_code + 1;
      if (nch != channels) return 7;
    } else if (ch_code == 8) { assignment = 1; nch = 2; }
    else if (ch_code == 9) { assignment = 2; nch = 2; }
    else if (ch_code == 10) { assignment = 3; nch = 2; }
    else return 7;

    for (int c = 0; c < nch; ++c) {
      int sub_bps = frame_bps;
      // the "side" channel carries one extra bit
      if ((assignment == 1 && c == 1) || (assignment == 2 && c == 0) ||
          (assignment == 3 && c == 1))
        sub_bps += 1;
      if (!decode_subframe(br, block_size, sub_bps, chan[c])) return 8;
    }
    br.align_to_byte();
    br.read_bits(16);                        // frame CRC-16 (unchecked)
    if (br.error) return 9;

    // undo channel decorrelation, interleave
    for (int i = 0; i < block_size; ++i) {
      if (assignment == 0) {
        for (int c = 0; c < nch; ++c) pcm.push_back(chan[c][i]);
      } else if (assignment == 1) {          // left/side
        int32_t left = chan[0][i];
        pcm.push_back(left);
        pcm.push_back(left - chan[1][i]);
      } else if (assignment == 2) {          // right/side
        int32_t right = chan[1][i];
        pcm.push_back(right + chan[0][i]);
        pcm.push_back(right);
      } else {                               // mid/side
        int32_t mid = chan[0][i], side = chan[1][i];
        int64_t m2 = ((int64_t)mid << 1) | (side & 1);
        pcm.push_back((int32_t)((m2 + side) >> 1));
        pcm.push_back((int32_t)((m2 - side) >> 1));
      }
    }
    if (total_samples > 0 &&
        (long long)pcm.size() >= total_samples * channels)
      break;
  }

  long long frames = (long long)pcm.size() / channels;
  int32_t* buf = (int32_t*)malloc(pcm.size() * sizeof(int32_t));
  if (!buf) return 10;
  memcpy(buf, pcm.data(), pcm.size() * sizeof(int32_t));
  *out_samples = buf;
  *out_n = frames;
  *out_rate = rate;
  *out_channels = channels;
  *out_bps = bps;
  return 0;
}

void flac_free(int32_t* p) { free(p); }

}  // extern "C"
