// What the flash-attention forward and backward kernels share: the
// layout constants, the element strides of a [B, T, N, H] view and their
// alignment test, and the attention dropout's keep bits of one 64 x 64
// (query, key) tile (the exponential, fast_exp2, is in mma.cuh).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace neurst {
namespace flash {

constexpr int kHeadDim = 64;
constexpr float kScale = 0.125f;  // kHeadDim^-1/2, the scores' scale
constexpr int kTile = 64;  // query rows and keys of a tile
constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, t, n;
};

// whether the pointer and the b, t, n strides of a bf16 view keep every
// row 16-byte aligned (cp.async and ldmatrix need it)
inline bool aligned16(const void* p, const Strides& s) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && s.b % 8 == 0 &&
         s.t % 8 == 0 && s.n % 8 == 0;
}

// The keep bits of the tile at (q0, k0) of slice bn, by a block of 128
// threads: bits[2 r + h] bit c is whether (query q0 + r, key k0 + 32 h +
// c) is kept, i.e. whether word (i & 3) of Philox at i >> 2 is at least
// `threshold`, for i = (bn Tq + q) Tk + k (csrc/philox.cuh).  Thread
// (r, h) = (tid >> 1, tid & 1) makes one 32-bit word from the 8 Philox
// calls whose groups of four cover its 32 keys (9 when the row does not
// start on a group), unrolled so that the calls' dependent rounds
// interleave; keys at or past `key_end` of the row (the valid length,
// and the causal edge q + 1) and rows at or past Tq stay 0.
template <bool kCausal>
__device__ __forceinline__ void keep_bits(uint32_t* bits, int bn, int t_q,
                                          int t_k, int q0, int k0,
                                          int valid, unsigned threshold,
                                          const DropoutSite& site,
                                          int tid) {
  const int r = tid >> 1, h = tid & 1;
  const int q = q0 + r, c0 = k0 + 32 * h;
  const int key_end = kCausal ? min(valid, q + 1) : valid;
  uint32_t word = 0u;
  if (q < t_q && c0 < key_end) {
    const unsigned long long base =
        (static_cast<unsigned long long>(bn) * t_q + q) * t_k + c0;
    // key c0 + c is word (phase + c) & 3 of group (base >> 2) + ((phase
    // + c) >> 2)
    const int phase = static_cast<int>(base & 3);
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      if (j == 8 && phase == 0) break;
      const uint4 w = dropout_words((base >> 2) + j, site);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * j + e - phase;
        if (c >= 0 && c < 32 && word_of(w, e) >= threshold)
          word |= 1u << c;
      }
    }
  }
  bits[tid] = word;
}

}  // namespace flash
}  // namespace neurst
