// Counter-based Philox4x32-10 (Salmon et al., SC'11) and the port's
// dropout mask, shared by the dropout, fused-FFN and flash-attention
// kernels.  Its plain twin is `philox4x32_10` / `dropout_words` in
// neurst_tpu_torch/ops/fused_dropout.py, which computes the same words
// with int64 tensor ops; kernel and plain version agree bitwise.
//
// The mask of a tensor is a function of its ABSOLUTE element index i:
// element i reads word (i & 3) of philox(counter = ((i >> 2) low,
// (i >> 2) high, stream, micro), key = (k0, k1)) and is kept when that
// word >= threshold.  Kernels that tile a tensor differently (flash
// forward, dq and dk/dv) therefore regenerate the same mask.  The TPU
// kernels seed their hardware generator per tile instead
// (neurst_tpu/ops/flash_attention.py:77-93, fused_ffn.py:108-118).

#pragma once

#include <cuda_runtime.h>

namespace neurst {

// the dropout site: key words, stream (layer x site) and micro-batch,
// and the first element group of the tensor (a shard's rows start at
// element 4 * group of the single-rank tensor; 0 unsharded)
struct DropoutSite {
  unsigned k0, k1, stream, micro;
  unsigned long long group;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0,
                                               unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned lo0 = 0xD2511F53u * c.x;
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// the four words of element group g (elements 4g .. 4g + 3) of the
// site's tensor
__device__ __forceinline__ uint4 dropout_words(unsigned long long g,
                                               const DropoutSite& s) {
  g += s.group;
  return philox4x32_10(
      make_uint4(static_cast<unsigned>(g), static_cast<unsigned>(g >> 32),
                 s.stream, s.micro),
      s.k0, s.k1);
}

__device__ __forceinline__ unsigned word_of(const uint4& w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

// whether element i is kept; threshold 0 keeps everything
__device__ __forceinline__ bool dropout_keep(unsigned long long i,
                                             const DropoutSite& s,
                                             unsigned threshold) {
  if (threshold == 0u) return true;
  return word_of(dropout_words(i >> 2, s), static_cast<int>(i & 3)) >=
         threshold;
}

}  // namespace neurst
