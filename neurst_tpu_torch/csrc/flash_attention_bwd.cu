// Flash-attention backward for Hopper (sm_90a), plain C interface: two
// kernels, dq and dk/dv, no atomics.
//
// Replaces: neurst_tpu/ops/flash_attention.py:_dq_kernel (the Pallas
// call at :435) and :_dkv_kernel (the call at :474), with attention
// dropout 0.  Both recompute p = exp(s - lse) from the forward's row
// log-sum-exp under the forward's mask (key >= length[b] masked, and key >
// query when causal), with s = q k^T * H^-1/2 accumulated in float32.
// p is zeroed AFTER the exp, so a row without keys (lse = NEG_INF) gives
// p = 0 and not exp(0) = 1 (flash_attention.py:216-217).  With
// dp = dO v^T and delta = rowsum(dO o) (computed outside, as the JAX
// package computes it in XLA, :425-427), ds = p (dp - delta) in float32;
// ds and p are rounded to the operand dtype before each product, where
// the TPU kernels round them:
//   dq = round(ds) k * H^-1/2                      (:231-238)
//   dk = round(ds)^T q * H^-1/2, dv = round(p)^T dO (:295-316)
//
// What bounds it on an H100: at the training slice's shape
// ([40, 750, 4, 64] bf16, ~680 valid keys a row) the function reads and
// writes ~0.1 GB but does ~30 (dq) and ~40 (dk/dv) GFLOP, so the card's
// bound is its bf16 tensor-core rate (tens of microseconds).  This first
// design runs the products as float32 FMA loops out of shared memory (no
// tensor cores), so it is bound by FMA issue and shared-memory loads.
// What the design does about that: each thread owns a 4 x 4 tile of the
// 64 x 64 score block and of its output, which halves the shared-memory
// loads per FMA against one value per thread; the [T_q, T_k] matrices
// never leave the SM, and tiles past a row's valid keys are skipped.
// Tensor cores (mma.sync / wgmma on bf16 tiles) are later work.
//
// Layout: q, dO [B, Tq, N, H] and k, v [B, Tk, N, H] with arbitrary
// element strides over B, T and N (the head dim contiguous), so the fused
// qkv projection's slices need no copy; lse and delta [B, N, Tq] float32;
// dq [B, Tq, N, H], dk and dv [B, Tk, N, H] written contiguous.
//
// Grids: dq (ceil(Tq / 64), B * N), one block per 64-row q tile looping
// over k tiles up to the valid length (and the causal edge); dk/dv
// (ceil(Tk / 64), B * N), one block per 64-key tile looping over q tiles
// from the causal lower bound; a k tile wholly past the length writes
// zeros and returns.  256 threads as a 16 x 16 grid, thread (ty, tx)
// owning rows ty + 16 i and columns tx + 16 j.  Tiles are stored
// transposed ([H][rows], row pitch 65), so both the score loop and the
// accumulation loop read shared memory without bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kTile = 64;     // query rows and keys per tile
constexpr int kThreads = 256;
constexpr int kPitch = kTile + 1;
constexpr float kNegInf = -1.0e30f;

typedef float Row[kPitch];

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

// x rounded to T and back: the operand a product sees
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

struct Strides {
  long long b, t, n;
};

// rows [t0, t0 + kTile) of one (b, n) slice into dst[h][row] (transposed);
// rows at or past t_len read as zero
template <typename T>
__device__ __forceinline__ void load_transposed(Row* dst, const T* base,
                                                long long stride_t, int t0,
                                                int t_len, int tid) {
  for (int i = tid; i < kTile * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim, h = i % kHeadDim;
    const int t = t0 + r;
    dst[h][r] = t < t_len ? to_float(base[t * stride_t + h]) : 0.f;
  }
}

// s = q k^T and dp = dO v^T for the thread's 4 x 4 values of a 64 x 64
// block: rows from qt/dot, columns from kt/vt (all transposed tiles)
__device__ __forceinline__ void scores(const Row* qt, const Row* dot,
                                       const Row* kt, const Row* vt, int ty,
                                       int tx, float (&s)[4][4],
                                       float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int h = 0; h < kHeadDim; ++h) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = qt[h][ty + 16 * i];
      dov[i] = dot[h][ty + 16 * i];
      kv[i] = kt[h][tx + 16 * i];
      vv[i] = vt[h][tx + 16 * i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
}

template <typename T, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const int* __restrict__ lengths, T* __restrict__ dq,
                int n_heads, int t_q, int t_k, Strides qs_, Strides ks_,
                Strides vs_, Strides ds_, float scale) {
  extern __shared__ float smem[];
  Row* qt = reinterpret_cast<Row*>(smem);  // [H][rows]
  Row* dot = qt + kHeadDim;                // [H][rows]
  Row* kt = dot + kHeadDim;                // [H][keys]
  Row* vt = kt + kHeadDim;                 // [H][keys]
  Row* ds_tile = vt + kHeadDim;            // [rows][keys]

  const int bn = blockIdx.y;
  const int b = bn / n_heads;
  const int n = bn % n_heads;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int valid = min(max(lengths[b], 0), t_k);

  const T* k_base = k + b * ks_.b + n * ks_.n;
  const T* v_base = v + b * vs_.b + n * vs_.n;
  load_transposed(qt, q + b * qs_.b + n * qs_.n, qs_.t, q0, t_q, tid);
  load_transposed(dot, dout + b * ds_.b + n * ds_.n, ds_.t, q0, t_q, tid);
  float row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const bool in = r < t_q;
    row_lse[i] = in ? lse[static_cast<long long>(bn) * t_q + r] : 0.f;
    row_delta[i] = in ? delta[static_cast<long long>(bn) * t_q + r] : 0.f;
  }

  // keys past `valid` (and, causally, past the tile's last row) are
  // masked for every row of the block: those tiles add nothing
  int kv_end = valid;
  if (kCausal) kv_end = min(kv_end, q0 + kTile);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed; q/dO are loaded
    load_transposed(kt, k_base, ks_.t, k0, t_k, tid);
    load_transposed(vt, v_base, vs_.t, k0, t_k, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores(qt, dot, kt, vt, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < valid && (!kCausal || col <= row);
        const float p = ok ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        ds_tile[ty + 16 * i][tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - row_delta[i]));
      }
    }
    __syncthreads();

    // acc[row][h] += sum_c ds[row][c] k[c][h], with k[c][h] = kt[h][c]
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dsv[i] = ds_tile[ty + 16 * i][c];
        kv[i] = kt[tx + 16 * i][c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t_q) continue;
    T* out = dq + ((static_cast<long long>(b) * t_q + row) * n_heads + n)
                      * kHeadDim;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[tx + 16 * j] = from_float<T>(acc[i][j] * scale);
  }
}

template <typename T, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const int* __restrict__ lengths, T* __restrict__ dk,
                 T* __restrict__ dv, int n_heads, int t_q, int t_k,
                 Strides qs_, Strides ks_, Strides vs_, Strides ds_,
                 float scale) {
  extern __shared__ float smem[];
  Row* kt = reinterpret_cast<Row*>(smem);  // [H][keys]
  Row* vt = kt + kHeadDim;                 // [H][keys]
  Row* qt = vt + kHeadDim;                 // [H][rows]
  Row* dot = qt + kHeadDim;                // [H][rows]
  Row* p_tile = dot + kHeadDim;            // [rows][keys]
  Row* ds_tile = p_tile + kTile;           // [rows][keys]
  float* lse_tile = reinterpret_cast<float*>(ds_tile + kTile);
  float* delta_tile = lse_tile + kTile;

  const int bn = blockIdx.y;
  const int b = bn / n_heads;
  const int n = bn % n_heads;
  const int k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int valid = min(max(lengths[b], 0), t_k);
  const long long key_stride = static_cast<long long>(n_heads) * kHeadDim;
  T* dk_base = dk + (static_cast<long long>(b) * t_k * n_heads + n)
                        * kHeadDim;
  T* dv_base = dv + (static_cast<long long>(b) * t_k * n_heads + n)
                        * kHeadDim;

  if (k0 >= valid) {  // every key of the tile is masked for every row
    for (int i = tid; i < kTile * kHeadDim; i += kThreads) {
      const int c = k0 + i / kHeadDim, h = i % kHeadDim;
      if (c < t_k) {
        dk_base[c * key_stride + h] = from_float<T>(0.f);
        dv_base[c * key_stride + h] = from_float<T>(0.f);
      }
    }
    return;
  }

  load_transposed(kt, k + b * ks_.b + n * ks_.n, ks_.t, k0, t_k, tid);
  load_transposed(vt, v + b * vs_.b + n * vs_.n, vs_.t, k0, t_k, tid);
  const T* q_base = q + b * qs_.b + n * qs_.n;
  const T* do_base = dout + b * ds_.b + n * ds_.n;

  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causally, rows before k0 attend no key of this tile
  for (int q0 = kCausal ? k0 : 0; q0 < t_q; q0 += kTile) {
    __syncthreads();  // the previous q tile is consumed; k/v are loaded
    load_transposed(qt, q_base, qs_.t, q0, t_q, tid);
    load_transposed(dot, do_base, ds_.t, q0, t_q, tid);
    if (tid < kTile) {
      const int r = q0 + tid;
      const bool in = r < t_q;
      lse_tile[tid] = in ? lse[static_cast<long long>(bn) * t_q + r] : 0.f;
      delta_tile[tid] =
          in ? delta[static_cast<long long>(bn) * t_q + r] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    scores(qt, dot, kt, vt, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok =
            row < t_q && col < valid && (!kCausal || col <= row);
        const float p = ok ? expf(s[i][j] * scale - lse_tile[r]) : 0.f;
        p_tile[r][tx + 16 * j] = round_to<T>(p);
        ds_tile[r][tx + 16 * j] = round_to<T>(p * (dp[i][j] - delta_tile[r]));
      }
    }
    __syncthreads();

    // dv[c][h] += sum_r p[r][c] dO[r][h]; dk[c][h] += sum_r ds[r][c] q[r][h]
    // for keys c = ty + 16 i and dims h = tx + 16 j
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float pv[4], dsv[4], dov[4], qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = p_tile[r][ty + 16 * i];
        dsv[i] = ds_tile[r][ty + 16 * i];
        dov[i] = dot[tx + 16 * i][r];
        qv[i] = qt[tx + 16 * i][r];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= t_k) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dk_base[c * key_stride + tx + 16 * j] =
          from_float<T>(dk_acc[i][j] * scale);
      dv_base[c * key_stride + tx + 16 * j] = from_float<T>(dv_acc[i][j]);
    }
  }
}

constexpr size_t kDqSmem = 5 * kHeadDim * kPitch * sizeof(float);
constexpr size_t kDkvSmem =
    (4 * kHeadDim + 2 * kTile) * kPitch * sizeof(float)
    + 2 * kTile * sizeof(float);

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* lengths;
  int batch, n_heads, t_q, t_k;
  Strides qs, ks, vs, ds;
  bool causal;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
}

template <typename T, bool kCausal>
cudaError_t launch_dq(const Args& a, void* dq) {
  auto kernel = flash_dq_kernel<T, kCausal>;
  cudaError_t err = prepare(kernel, kDqSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_q + kTile - 1) / kTile, a.batch * a.n_heads);
  kernel<<<grid, kThreads, kDqSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.lengths, static_cast<T*>(dq), a.n_heads, a.t_q, a.t_k,
      a.qs, a.ks, a.vs, a.ds, 1.0f / sqrtf(static_cast<float>(kHeadDim)));
  return cudaGetLastError();
}

template <typename T, bool kCausal>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  auto kernel = flash_dkv_kernel<T, kCausal>;
  cudaError_t err = prepare(kernel, kDkvSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_k + kTile - 1) / kTile, a.batch * a.n_heads);
  kernel<<<grid, kThreads, kDkvSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.lengths, static_cast<T*>(dk), static_cast<T*>(dv),
      a.n_heads, a.t_q, a.t_k, a.qs, a.ks, a.vs, a.ds,
      1.0f / sqrtf(static_cast<float>(kHeadDim)));
  return cudaGetLastError();
}

bool bad_args(int batch, int n_heads, int t_q, int t_k, int head_dim,
              int dtype) {
  return head_dim != kHeadDim || batch <= 0 || n_heads <= 0 || t_q <= 0 ||
         t_k <= 0 || batch * n_heads > 65535 || (dtype != 0 && dtype != 1);
}

Args make_args(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               const void* lengths, int batch, int n_heads, int t_q,
               int t_k, const long long* strides, int causal,
               void* stream) {
  return Args{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              static_cast<const int*>(lengths), batch, n_heads, t_q, t_k,
              Strides{strides[0], strides[1], strides[2]},
              Strides{strides[3], strides[4], strides[5]},
              Strides{strides[6], strides[7], strides[8]},
              Strides{strides[9], strides[10], strides[11]}, causal != 0,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Both entry points return the cudaError_t of the launch (0 on success).
// `strides` holds 12 element strides: (b, t, n) of q, k, v and dO, in
// that order.  dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the
// outputs share it).
extern "C" int neurst_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* lengths, void* dq,
    int batch, int n_heads, int t_q, int t_k, int head_dim,
    const long long* strides, int causal, int dtype, void* stream) {
  if (bad_args(batch, n_heads, t_q, t_k, head_dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, dout, lse, delta, lengths, batch,
                           n_heads, t_q, t_k, strides, causal, stream);
  cudaError_t err;
  if (dtype == 0)
    err = a.causal ? launch_dq<float, true>(a, dq)
                   : launch_dq<float, false>(a, dq);
  else
    err = a.causal ? launch_dq<__nv_bfloat16, true>(a, dq)
                   : launch_dq<__nv_bfloat16, false>(a, dq);
  return static_cast<int>(err);
}

extern "C" int neurst_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* lengths, void* dk,
    void* dv, int batch, int n_heads, int t_q, int t_k, int head_dim,
    const long long* strides, int causal, int dtype, void* stream) {
  if (bad_args(batch, n_heads, t_q, t_k, head_dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, dout, lse, delta, lengths, batch,
                           n_heads, t_q, t_k, strides, causal, stream);
  cudaError_t err;
  if (dtype == 0)
    err = a.causal ? launch_dkv<float, true>(a, dk, dv)
                   : launch_dkv<float, false>(a, dk, dv);
  else
    err = a.causal ? launch_dkv<__nv_bfloat16, true>(a, dk, dv)
                   : launch_dkv<__nv_bfloat16, false>(a, dk, dv);
  return static_cast<int>(err);
}
