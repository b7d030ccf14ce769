// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: neurst_tpu/ops/flash_attention.py:_fwd_kernel (the Pallas
// FlashAttention-2 forward behind `_fwd_impl`).  Same function: for every
// (batch, head) slice, o = dropout(softmax(q k^T * H^-1/2 + mask)) v and
// the row log-sum-exp, where key positions >= length[b] (and, when
// causal, key > query) are masked.  All statistics and both products
// accumulate in float32; P is rounded to the value dtype before P.V, as
// the TPU kernel does (flash_attention.py:156-159).  A row with no valid
// key gives o = 0 and lse = NEG_INF (:166-170).
//
// Attention dropout (training) runs in the kernel, as on the TPU
// (:147-155): the normaliser l sums the UN-dropped p, and P.V takes
// pd = keep ? p / (1 - rate) : 0.  The mask of element (bn, q, k) is
// csrc/philox.cuh's mask at the absolute index (bn Tq + q) Tk + k, so the
// dq and dk/dv kernels, which tile differently, and the plain version
// regenerate it bit for bit.  threshold 0 (inference) skips it.
//
// What bounds it on an H100: at the main path's shape (64 slices of
// 256 x 64, bf16) with every key valid one call moves 8.4 MB (q, k, v, o)
// and does 1.07 GFLOP, so the card's bound is memory, ~2.5 us at
// 3.35 TB/s; keys past a row's length are neither read nor multiplied,
// so ragged lengths lower both terms alike.  This first
// design does not reach it: it runs the products as float32 FMA loops
// out of shared memory (no tensor cores), so it is bound by shared-memory
// loads and FMA issue.  What the design does about memory: each q/k/v
// element is read from device memory once per (q-tile, k-tile) pair and
// the [T_q, T_k] probability matrix never leaves the SM.  Making it fast
// (mma.sync / wgmma on bf16 tiles, TMA loads) is later work.
//
// Layout: q [B, Tq, N, H], k/v [B, Tk, N, H] with arbitrary element
// strides over B, T and N (the head dim must be contiguous), so the
// fused qkv projection's slices need no copy.  o is written contiguous
// [B, Tq, N, H]; lse is [B, N, Tq] float32.
//
// Grid: (ceil(Tq / 64), B * N); 256 threads, 4 per query row.  Thread
// (row, sub) owns key columns sub + 4 j of each 32-key tile and output
// dims sub + 4 i, which keeps its shared-memory reads on distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 32;   // keys per tile
constexpr int kThreads = 256;
constexpr int kColsPerThread = kBlockN / 4;
constexpr int kDimsPerThread = kHeadDim / 4;
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

struct Strides {
  long long b, t, n;
};

template <typename T, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 T* __restrict__ o, float* __restrict__ lse, int n_heads,
                 int t_q, int t_k, Strides qs_, Strides ks_, Strides vs_,
                 float scale, unsigned threshold, float inv_keep,
                 neurst::DropoutSite site) {
  __shared__ float q_tile[kBlockM][kHeadDim + 1];
  __shared__ float k_tile[kBlockN][kHeadDim + 1];
  __shared__ float v_tile[kBlockN][kHeadDim];
  __shared__ float p_tile[kBlockM][kBlockN + 1];

  const int bn = blockIdx.y;
  const int b = bn / n_heads;
  const int n = bn % n_heads;
  const int q0 = blockIdx.x * kBlockM;
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int q_row = q0 + row;
  const int valid = min(max(lengths[b], 0), t_k);

  const T* q_base = q + b * qs_.b + n * qs_.n;
  const T* k_base = k + b * ks_.b + n * ks_.n;
  const T* v_base = v + b * vs_.b + n * vs_.n;

  for (int i = tid; i < kBlockM * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim, h = i % kHeadDim;
    const int t = q0 + r;
    q_tile[r][h] = t < t_q ? to_float(q_base[t * qs_.t + h]) : 0.f;
  }

  // keys past `valid` (and, causally, past the tile's last row) are
  // masked for every row of the block: those tiles would change nothing
  int kv_end = valid;
  if (kCausal) kv_end = min(kv_end, q0 + kBlockM);

  float m = kNegInf, l = 0.f;
  float acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kBlockN) {
    __syncthreads();  // the previous tile is consumed; q_tile is loaded
    for (int i = tid; i < kBlockN * kHeadDim; i += kThreads) {
      const int r = i / kHeadDim, h = i % kHeadDim;
      const int t = k0 + r;
      const bool in = t < t_k;
      k_tile[r][h] = in ? to_float(k_base[t * ks_.t + h]) : 0.f;
      v_tile[r][h] = in ? to_float(v_base[t * vs_.t + h]) : 0.f;
    }
    __syncthreads();

    float s[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int h = 0; h < kHeadDim; ++h) {
      const float qv = q_tile[row][h];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        s[j] = fmaf(qv, k_tile[sub + 4 * j][h], s[j]);
    }

    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int col = k0 + sub + 4 * j;
      const bool ok = col < valid && (!kCausal || col <= q_row);
      s[j] = ok ? s[j] * scale : kNegInf;
      m_cur = fmaxf(m_cur, s[j]);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 2));
    const float m_new = fmaxf(m, m_cur);

    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int col = k0 + sub + 4 * j;
      const bool ok = col < valid && (!kCausal || col <= q_row);
      const float p = ok ? expf(s[j] - m_new) : 0.f;
      p_sum += p;
      // the normaliser takes the unrounded, un-dropped p; P.V the
      // dropped p in the value dtype
      float pd = p;
      if (threshold != 0u && ok)
        pd = neurst::dropout_keep(
                 (static_cast<unsigned long long>(bn) * t_q + q_row) * t_k +
                     col,
                 site, threshold)
                 ? p * inv_keep
                 : 0.f;
      p_tile[row][sub + 4 * j] = to_float(from_float<T>(pd));
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 2);
    const float alpha = expf(m - m_new);
    l = l * alpha + p_sum;
    m = m_new;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int c = 0; c < kBlockN; ++c) {
      const float p = p_tile[row][c];
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i)
        acc[i] = fmaf(p, v_tile[c][sub + 4 * i], acc[i]);
    }
  }

  if (q_row < t_q) {
    const float denom = fmaxf(l, 1e-20f);
    T* o_row = o + ((static_cast<long long>(b) * t_q + q_row) * n_heads + n)
                       * kHeadDim;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i)
      o_row[sub + 4 * i] = from_float<T>(acc[i] / denom);
    if (sub == 0)
      lse[static_cast<long long>(bn) * t_q + q_row] =
          l > 0.f ? m + logf(fmaxf(l, 1e-37f)) : kNegInf;
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const int* lengths,
            void* o, float* lse, int batch, int n_heads, int t_q, int t_k,
            Strides qs_, Strides ks_, Strides vs_, bool causal,
            unsigned threshold, float inv_keep,
            const neurst::DropoutSite& site, cudaStream_t stream) {
  const dim3 grid((t_q + kBlockM - 1) / kBlockM, batch * n_heads);
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  if (causal)
    flash_fwd_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, lengths, op, lse, n_heads, t_q, t_k, qs_, ks_, vs_,
        scale, threshold, inv_keep, site);
  else
    flash_fwd_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, lengths, op, lse, n_heads, t_q, t_k, qs_, ks_, vs_,
        scale, threshold, inv_keep, site);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  Strides are in
// elements.  dtype: 0 = float32, 1 = bfloat16.  threshold 0 = no
// dropout; else the dropout site (k0, k1, stream_id, micro) and the
// scale inv_keep = 1 / (1 - rate).
extern "C" int neurst_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths,
    void* o, void* lse, int batch, int n_heads, int t_q, int t_k,
    int head_dim, long long q_sb, long long q_st, long long q_sn,
    long long k_sb, long long k_st, long long k_sn, long long v_sb,
    long long v_st, long long v_sn, int causal, int dtype,
    unsigned threshold, float inv_keep, unsigned k0, unsigned k1,
    unsigned stream_id, unsigned micro, void* stream) {
  if (head_dim != kHeadDim || batch <= 0 || n_heads <= 0 || t_q <= 0 ||
      t_k <= 0 || batch * n_heads > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs_{q_sb, q_st, q_sn}, ks_{k_sb, k_st, k_sn},
      vs_{v_sb, v_st, v_sn};
  const int* len = static_cast<const int*>(lengths);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const neurst::DropoutSite site{k0, k1, stream_id, micro};
  if (dtype == 0)
    launch<float>(q, k, v, len, o, lse_f, batch, n_heads, t_q, t_k, qs_,
                  ks_, vs_, causal != 0, threshold, inv_keep, site, s);
  else
    launch<__nv_bfloat16>(q, k, v, len, o, lse_f, batch, n_heads, t_q, t_k,
                          qs_, ks_, vs_, causal != 0, threshold, inv_keep,
                          site, s);
  return static_cast<int>(cudaGetLastError());
}
