// Inverted dropout for Hopper (sm_90a), plain C interface: one
// elementwise kernel, y = keep ? x * scale : 0, with the mask drawn in
// registers (csrc/philox.cuh), so no mask tensor reaches device memory.
// The backward is the same kernel on the output gradient with the same
// site: the same words, the same mask.
//
// Replaces: neurst_tpu/ops/fused_dropout.py:_mask_kernel (the Pallas call
// at :93), which streams hardware-PRNG bytes and leaves the compare and
// the multiply to XLA, fused into the producer (:113-132).  On this card
// one pass that reads x, draws the mask and writes y is the same function
// in one launch.  The caller chooses the threshold and the scale: at the
// sites the TPU path sends through `fused_dropout` the rate is quantized
// to 1/256 (threshold t8 << 24, scale 1 / (1 - t8 / 256),
// fused_dropout.py:107-110); elsewhere threshold round(rate * 2^32) and
// scale 1 / (1 - rate).  y = round(float(x) * scale) in float32.
//
// What bounds it on an H100: bytes.  x [30000, 256] bf16 is read once and
// y written once, 30.7 MB, ~9 us at 3.35 TB/s; one Philox4x32-10 (ten
// rounds of two 32-bit multiplies) serves four elements, ~0.4 G integer
// instructions at that shape, below the memory time.  Each thread owns
// element groups 4g .. 4g + 3 (one Philox call), in a grid-stride loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
               unsigned threshold, float scale, neurst::DropoutSite site) {
  const long long groups = (n + 3) >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       g < groups; g += stride) {
    const uint4 w = neurst::dropout_words(
        static_cast<unsigned long long>(g), site);
    const long long i0 = g << 2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = i0 + j;
      if (i < n) {
        const bool keep = neurst::word_of(w, j) >= threshold;
        y[i] = keep ? from_float<T>(to_float(x[i]) * scale)
                    : from_float<T>(0.f);
      }
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  x and y hold n
// contiguous elements of one dtype: 0 = float32, 1 = bfloat16.
extern "C" int neurst_fused_dropout(const void* x, void* y, long long n,
                                    unsigned threshold, float scale,
                                    unsigned k0, unsigned k1,
                                    unsigned stream_id, unsigned micro,
                                    int dtype, void* stream) {
  if (n <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (n + 3) >> 2;
  // enough blocks for every SM several times over; the loop covers the rest
  const long long blocks =
      groups / kThreads + 1 < 132 * 16 ? groups / kThreads + 1 : 132 * 16;
  const neurst::DropoutSite site{k0, k1, stream_id, micro};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dropout_kernel<float><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, threshold,
        scale, site);
  else
    dropout_kernel<__nv_bfloat16>
        <<<static_cast<int>(blocks), kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<__nv_bfloat16*>(y), n, threshold, scale, site);
  return static_cast<int>(cudaGetLastError());
}
