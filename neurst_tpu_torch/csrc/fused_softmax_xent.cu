// Label-smoothed softmax cross entropy over logits already in memory, for
// Hopper (sm_90a), plain C interface: a forward kernel (one pass over each
// row's logits) and an elementwise backward kernel.
//
// Replaces: neurst_tpu/ops/fused_ce.py:_fwd_kernel (the Pallas call at
// :135) and :_bwd_kernel (the call at :161).  Same function, on z [R, V]
// in float32 from the logits' dtype: the forward keeps the online (max,
// sumexp) and the sum of z of a row, reads z at the row's label (0 when
// the label lies outside [0, V), as the TPU kernel's one-hot does), and
// writes lse = m + log(max(l, 1e-37)) and
//   xent = -(c - low)(z_y - lse) - low (sum z - V lse)         (:99-102)
// the backward writes, in the logits' dtype,
//   dz = g ((c - low)(p - onehot) + low (V p - 1)), p = exp(z - lse)
//                                                                (:116-120)
// The caller passes c - low, as the TPU kernel forms it from Python
// floats.
//
// Design.  The TPU kernel walks (64-row, 4096-column) blocks with the
// online statistics in VMEM scratch across its sequential vocabulary
// axis.  Here the forward gives each row one block of 256 threads: each
// thread streams 16-byte vectors of the row (8 bf16 or 4 float32 values)
// and keeps its own online max, sumexp and sum of z in registers; a warp
// shuffle and then a block reduction through shared memory combine the
// threads'.  Rows are independent, so no block waits on another and no
// scratch carries across blocks.  The backward is elementwise over a 2-D
// grid of (rows, vocabulary tiles of 256 vectors).  A vocabulary that is
// not a multiple of the vector width (or a base that is not 16-byte
// aligned) takes the same kernels with one element per load.
//
// What bounds it on an H100: bytes.  The forward reads R V logits once
// and writes 8 bytes a row; the backward reads them once more and writes
// dz once.  At [32768, 32768] bf16 that is 2.1 GB (0.64 ms at 3.35 TB/s)
// forward and 4.3 GB (1.28 ms) backward; one expf per element (the
// backward's too) is below that time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1.0e30f;

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

// VEC consecutive elements of p as float32; VEC > 1 needs 16-byte aligned p
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_float(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_float<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
}

// (m, s) <- the online pair of two partial (max, sumexp) pairs
__device__ __forceinline__ void combine(float& m, float& s, float m2,
                                        float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void warp_reduce(float& m, float& s, float& sz) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    sz += __shfl_xor_sync(0xffffffffu, sz, off);
    combine(m, s, m2, s2);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
softmax_xent_fwd_kernel(const T* __restrict__ z,
                        const int* __restrict__ labels,
                        float* __restrict__ xent, float* __restrict__ lse,
                        int vocab, float c_minus_low, float low) {
  const long long row = blockIdx.x;
  const T* zr = z + row * vocab;
  float m = kNegInf, s = 0.f, sz = 0.f;
  for (int i = threadIdx.x * VEC; i < vocab; i += kThreads * VEC) {
    float v[VEC];
    load_vec<T, VEC>(zr + i, v);
    float vmax = v[0];
#pragma unroll
    for (int k = 1; k < VEC; ++k) vmax = fmaxf(vmax, v[k]);
    if (vmax > m) {
      s *= expf(m - vmax);
      m = vmax;
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s += expf(v[k] - m);
      sz += v[k];
    }
  }
  warp_reduce(m, s, sz);
  __shared__ float part[3][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part[0][warp] = m;
    part[1][warp] = s;
    part[2][warp] = sz;
  }
  __syncthreads();
  if (warp != 0) return;
  m = lane < kWarps ? part[0][lane] : kNegInf;
  s = lane < kWarps ? part[1][lane] : 0.f;
  sz = lane < kWarps ? part[2][lane] : 0.f;
  warp_reduce(m, s, sz);
  if (lane == 0) {
    const int y = labels[row];
    const float zy = (y >= 0 && y < vocab) ? to_float(zr[y]) : 0.f;
    const float l = m + logf(fmaxf(s, 1e-37f));
    xent[row] = -c_minus_low * (zy - l) -
                low * (sz - static_cast<float>(vocab) * l);
    lse[row] = l;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
softmax_xent_bwd_kernel(const T* __restrict__ z,
                        const int* __restrict__ labels,
                        const float* __restrict__ lse,
                        const float* __restrict__ g, T* __restrict__ dz,
                        int vocab, float c_minus_low, float low) {
  const long long row = blockIdx.x;
  const int col = (blockIdx.y * kThreads + threadIdx.x) * VEC;
  if (col >= vocab) return;
  const long long at = row * vocab + col;
  const float l = lse[row], gr = g[row];
  const int y = labels[row];
  const float v_f = static_cast<float>(vocab);
  float v[VEC];
  load_vec<T, VEC>(z + at, v);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float p = expf(v[k] - l);
    const float onehot = (col + k == y) ? 1.f : 0.f;
    v[k] = gr * (c_minus_low * (p - onehot) + low * (v_f * p - 1.f));
  }
  store_vec<T, VEC>(dz + at, v);
}

template <typename T>
int launch_fwd(const void* z, const int* labels, float* xent, float* lse,
               int rows, int vocab, float c_minus_low, float low,
               cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = vocab % kVec == 0 &&
                   reinterpret_cast<unsigned long long>(z) % 16 == 0;
  const T* zt = static_cast<const T*>(z);
  if (vec)
    softmax_xent_fwd_kernel<T, kVec><<<rows, kThreads, 0, s>>>(
        zt, labels, xent, lse, vocab, c_minus_low, low);
  else
    softmax_xent_fwd_kernel<T, 1><<<rows, kThreads, 0, s>>>(
        zt, labels, xent, lse, vocab, c_minus_low, low);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* z, const int* labels, const float* lse,
               const float* g, void* dz, int rows, int vocab,
               float c_minus_low, float low, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = vocab % kVec == 0 &&
                   reinterpret_cast<unsigned long long>(z) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(dz) % 16 == 0;
  const int per_block = kThreads * (vec ? kVec : 1);
  const dim3 grid(rows, (vocab + per_block - 1) / per_block);
  const T* zt = static_cast<const T*>(z);
  T* dzt = static_cast<T*>(dz);
  if (vec)
    softmax_xent_bwd_kernel<T, kVec><<<grid, kThreads, 0, s>>>(
        zt, labels, lse, g, dzt, vocab, c_minus_low, low);
  else
    softmax_xent_bwd_kernel<T, 1><<<grid, kThreads, 0, s>>>(
        zt, labels, lse, g, dzt, vocab, c_minus_low, low);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int rows, int vocab, int dtype) {
  // the backward's grid puts vocabulary tiles on y (at most 65535)
  return rows <= 0 || vocab <= 0 || vocab > 65535 * kThreads ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  z [rows, vocab]
// contiguous, dtype 0 = float32, 1 = bfloat16; labels [rows] int32; xent
// and lse [rows] float32.
extern "C" int neurst_softmax_xent_fwd(const void* z, const int* labels,
                                       float* xent, float* lse, int rows,
                                       int vocab, float c_minus_low,
                                       float low, int dtype, void* stream) {
  if (bad_shape(rows, vocab, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_fwd<float>(z, labels, xent, lse, rows, vocab,
                                        c_minus_low, low, s)
                    : launch_fwd<__nv_bfloat16>(z, labels, xent, lse, rows,
                                                vocab, c_minus_low, low, s);
}

// dz [rows, vocab] in z's dtype from lse and g [rows] float32.
extern "C" int neurst_softmax_xent_bwd(const void* z, const int* labels,
                                       const float* lse, const float* g,
                                       void* dz, int rows, int vocab,
                                       float c_minus_low, float low,
                                       int dtype, void* stream) {
  if (bad_shape(rows, vocab, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_bwd<float>(z, labels, lse, g, dz, rows, vocab,
                                 c_minus_low, low, s)
             : launch_bwd<__nv_bfloat16>(z, labels, lse, g, dz, rows, vocab,
                                         c_minus_low, low, s);
}
