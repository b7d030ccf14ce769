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
// What bounds it on an H100: bytes, with the Philox work close behind.
// x [30000, 256] bf16 is read once and y written once, 30.7 MB, ~9 us at
// 3.35 TB/s; one Philox4x32-10 (ten rounds of two 32-bit multiplies and
// their high halves) serves four elements, ~1.9 M calls at that shape,
// which take about as long again on the card's integer units.  A design
// that loads and stores one scalar at a time is bound by the issue of
// those instructions and runs the integer work after each load returns.
// So each thread owns 16-byte vectors (8 bf16 elements, two Philox
// groups; or 4 float32, one group) and keeps kUnroll of them in flight:
// it issues their loads first, draws their words while the loads are
// out, and writes each vector back with one 16-byte store.  The grid is
// the card's resident blocks (a grid-stride loop covers the rest).
//
// Alignment: y is the wrapper's fresh allocation, 16-byte aligned.  x
// may be an offset view (`x.contiguous()` of a slice): its vectors are
// then gathered from scalar loads, with the same words and stores.  The
// elements past the last whole vector are a scalar tail.  Element i
// reads word i & 3 of group i >> 2 whatever the path, so every path is
// bitwise equal to the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte vectors in flight per thread

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;  // elements per 16-byte vector
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};

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

// keep ? v * scale : 0, rounded once to T
__device__ __forceinline__ float drop1(float v, unsigned word,
                                       unsigned threshold, float scale) {
  return word >= threshold ? v * scale : 0.f;
}

// the vector of elements 4g .. 4g + 3 (float32) under group g's words
__device__ __forceinline__ uint4 drop_vec(uint4 v, unsigned long long e0,
                                          unsigned threshold, float scale,
                                          const neurst::DropoutSite& site,
                                          float) {
  const uint4 w = neurst::dropout_words(e0 >> 2, site);
  return make_uint4(
      __float_as_uint(drop1(__uint_as_float(v.x), w.x, threshold, scale)),
      __float_as_uint(drop1(__uint_as_float(v.y), w.y, threshold, scale)),
      __float_as_uint(drop1(__uint_as_float(v.z), w.z, threshold, scale)),
      __float_as_uint(drop1(__uint_as_float(v.w), w.w, threshold, scale)));
}

// two bf16 (lo, hi) of one 32-bit word under two mask words
__device__ __forceinline__ unsigned drop_pair(unsigned p, unsigned w_lo,
                                              unsigned w_hi,
                                              unsigned threshold,
                                              float scale) {
  const float lo = __uint_as_float(p << 16);
  const float hi = __uint_as_float(p & 0xFFFF0000u);
  const __nv_bfloat162 r = __floats2bfloat162_rn(
      drop1(lo, w_lo, threshold, scale), drop1(hi, w_hi, threshold, scale));
  return *reinterpret_cast<const unsigned*>(&r);
}

// the vector of elements 8v .. 8v + 7 (bf16) under groups 2v, 2v + 1
__device__ __forceinline__ uint4 drop_vec(uint4 v, unsigned long long e0,
                                          unsigned threshold, float scale,
                                          const neurst::DropoutSite& site,
                                          __nv_bfloat16) {
  const uint4 a = neurst::dropout_words(e0 >> 2, site);
  const uint4 b = neurst::dropout_words((e0 >> 2) + 1, site);
  return make_uint4(drop_pair(v.x, a.x, a.y, threshold, scale),
                    drop_pair(v.y, a.z, a.w, threshold, scale),
                    drop_pair(v.z, b.x, b.y, threshold, scale),
                    drop_pair(v.w, b.z, b.w, threshold, scale));
}

// x's 16-byte vector at element e0: one load when x is aligned, else
// gathered from scalar loads
template <typename T, bool kAligned>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ x,
                                          long long e0) {
  if (kAligned) return __ldcs(reinterpret_cast<const uint4*>(x + e0));
  uint4 v;
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int j = 0; j < Vec<T>::n; ++j) e[j] = x[e0 + j];
  return v;
}

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
               unsigned threshold, float scale, neurst::DropoutSite site) {
  constexpr int V = Vec<T>::n;
  const long long vecs = n / V;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long v0 = first; v0 < vecs; v0 += kUnroll * stride) {
    uint4 in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v < vecs) in[u] = load_vec<T, kAligned>(x, v * V);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v < vecs)
        __stcs(reinterpret_cast<uint4*>(y + v * V),
               drop_vec(in[u], static_cast<unsigned long long>(v * V),
                        threshold, scale, site, T()));
    }
  }
  // the tail: fewer than V elements past the last whole vector
  const long long i = vecs * V + first;
  if (i < n) {
    const unsigned long long e = static_cast<unsigned long long>(i);
    const uint4 w = neurst::dropout_words(e >> 2, site);
    y[i] = from_float<T>(drop1(to_float(x[i]),
                               neurst::word_of(w, static_cast<int>(e & 3)),
                               threshold, scale));
  }
}

// resident blocks of the card (every SM full), computed once per kernel
template <typename Kernel>
int resident_blocks(Kernel kernel) {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

template <typename T, bool kAligned>
cudaError_t launch(const void* x, void* y, long long n, unsigned threshold,
                   float scale, const neurst::DropoutSite& site,
                   cudaStream_t s) {
  auto kernel = dropout_kernel<T, kAligned>;
  static const int resident = resident_blocks(kernel);
  if (resident <= 0) return cudaErrorInvalidDevice;
  // one vector a thread and the tail's threads, at most the resident
  // blocks
  const long long threads = n / Vec<T>::n + Vec<T>::n;
  long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, threshold, scale,
      site);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long n, unsigned threshold,
                   float scale, const neurst::DropoutSite& site,
                   cudaStream_t s) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0
             ? launch<T, true>(x, y, n, threshold, scale, site, s)
             : launch<T, false>(x, y, n, threshold, scale, site, s);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  x and y hold n
// contiguous elements of one dtype: 0 = float32, 1 = bfloat16; y is
// 16-byte aligned, x at least element-aligned.
extern "C" int neurst_fused_dropout(const void* x, void* y, long long n,
                                    unsigned threshold, float scale,
                                    unsigned k0, unsigned k1,
                                    unsigned stream_id, unsigned micro,
                                    int dtype, void* stream) {
  if (n <= 0 || (dtype != 0 && dtype != 1) ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const neurst::DropoutSite site{k0, k1, stream_id, micro};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch<float>(x, y, n, threshold, scale, site, s)
          : launch<__nv_bfloat16>(x, y, n, threshold, scale, site, s);
  return static_cast<int>(err);
}
