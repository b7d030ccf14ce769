// Fused vocabulary projection + label-smoothed cross entropy for Hopper
// (sm_90a), plain C interface: a forward kernel and a backward in two
// passes.  The [R, V] logits never reach device memory.
//
// Replaces: neurst_tpu/ops/fused_ce.py:_linear_fwd_kernel (the Pallas
// call at :395) and :_linear_bwd_kernel (the call at :434).  Same
// function: z = x W^T accumulated in float32 from the operand dtype, plus
// the float32 bias; the forward keeps the online (max, sumexp, z_label,
// sum z) of each row and returns lse = m + log(max(l, 1e-37)) and
//   xent = -(c - low)(z_y - lse) - low (sum z - V lse)          (:291-296)
// with vocabulary columns >= V at NEG_INF in max and sumexp and 0 in the
// sum.  The backward recomputes z and p = exp(z - lse) and forms
//   dz = g ((c - low)(p - onehot) + low (V p - 1))              (:335-338)
// zeroed on columns >= V and rows >= R; dx = round(dz) W and
// dW = round(dz)^T x accumulate in float32, db = sum dz on the unrounded
// dz (:344-360).  round() is the operand dtype, as `dzc` in the TPU
// kernel.
//
// Why two backward passes: the TPU kernel keeps the whole [V, D] float32
// dW accumulator in VMEM (8 MB at V = 8192, D = 256) across its
// sequential grid.  An H100 block has 227 KB of shared memory and blocks
// run in no order, so the dx pass walks row tiles (each block looping
// over vocab tiles and accumulating its rows of dx in registers) and the
// dW/db pass walks vocab tiles (each block looping over row tiles and
// accumulating its rows of dW in registers).  Each pass recomputes z, so
// the backward does 8 R V D operations where the function needs 6.
//
// What bounds it on an H100: at the training slice's shape (R = 6000
// rows, D = 256, V = 8192, bf16) the function moves ~8 MB but does
// 25 GFLOP forward and 75 GFLOP backward, so the card's bound is its bf16
// tensor-core rate (~0.03 ms forward, ~0.08 ms backward).  This first
// design runs every product as float32 FMA loops out of shared memory (no
// tensor cores), so it is bound by FMA issue and shared-memory loads.
// What it does about that: each thread owns a 4 x 2 (forward, dx pass)
// or 4 x 1 (dW pass) tile of z and a 4 x D/32 tile of its output rows,
// the x tile stays in shared memory for the whole block, and W (4 MB in
// bf16) is re-read from L2 by every block rather than from device
// memory.  Row tiles of 32 give 188 blocks at R = 6000 (two fit an SM),
// the dW pass 256 blocks of 32 vocabulary rows.  Tensor cores and a
// vocabulary split for more blocks are later work.
//
// Layout: x [R, D] and W [V, D] contiguous, of one dtype (float32 or
// bfloat16); bias [V], lse, g and xent [R] float32; labels [R] int32;
// dx [R, D] and dW [V, D] in the operand dtype, db [V] float32.
// D is one of 128, 256, 512.  256 threads as 8 warps; warp ty owns rows
// ty + 8 i of a tile, so a row's softmax statistics reduce with warp
// shuffles.  Shared rows have an odd pitch (D + 1), so the lanes of a
// warp read distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;      // rows per tile
constexpr int kVocab = 64;     // vocabulary columns per tile (fwd, dx)
constexpr int kVocabW = 32;    // vocabulary rows per block (dW pass)
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

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [r0, r0 + n) of a [total, kDim] matrix into dst (pitch kDim + 1);
// rows at or past `total` read as zero
template <typename T, int kDim>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int n, int total, int tid) {
  for (int i = tid; i < n * kDim; i += kThreads) {
    const int r = i / kDim, d = i % kDim;
    const int t = r0 + r;
    dst[r * (kDim + 1) + d] =
        t < total ? to_float(src[static_cast<long long>(t) * kDim + d]) : 0.f;
  }
}

struct Smoothing {
  float confidence, low;
};

// The label-smoothed xent gradient of one logit (before the masks).
__device__ __forceinline__ float dlogit(float z, float lse, float g,
                                        bool is_label, int vocab,
                                        Smoothing sm) {
  const float p = expf(z - lse);
  return g * ((sm.confidence - sm.low) * (p - (is_label ? 1.f : 0.f))
              + sm.low * (vocab * p - 1.f));
}

// z for rows ty + 8 i (i < 4) and columns tx + 32 j (j < 2) of a tile:
// xs [kRows][kDim + 1], ws [kVocab][kDim + 1]
template <int kDim>
__device__ __forceinline__ void logits_4x2(const float* xs, const float* ws,
                                           int ty, int tx,
                                           float (&z)[4][2]) {
  constexpr int kP = kDim + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) z[i][0] = z[i][1] = 0.f;
#pragma unroll 8
  for (int d = 0; d < kDim; ++d) {
    float xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = xs[(ty + 8 * i) * kP + d];
    const float w0 = ws[tx * kP + d];
    const float w1 = ws[(tx + 32) * kP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      z[i][0] = fmaf(xv[i], w0, z[i][0]);
      z[i][1] = fmaf(xv[i], w1, z[i][1]);
    }
  }
}

template <typename T, int kDim>
__global__ void __launch_bounds__(kThreads)
linear_xent_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ bias,
                       const int* __restrict__ labels,
                       float* __restrict__ xent, float* __restrict__ lse,
                       int rows, int vocab, Smoothing sm) {
  extern __shared__ float smem[];
  float* xs = smem;                        // [kRows][kDim + 1]
  float* ws = xs + kRows * (kDim + 1);     // [kVocab][kDim + 1]
  const int tid = threadIdx.x;
  const int ty = tid / 32, tx = tid % 32;
  const int r0 = blockIdx.x * kRows;

  load_rows<T, kDim>(xs, x, r0, kRows, rows, tid);
  int label[4];
  float m[4], l[4], zy[4], sz[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 8 * i;
    label[i] = r < rows ? labels[r] : -1;
    m[i] = kNegInf;
    l[i] = zy[i] = sz[i] = 0.f;
  }

  for (int v0 = 0; v0 < vocab; v0 += kVocab) {
    __syncthreads();  // the previous W tile is consumed; x is loaded
    load_rows<T, kDim>(ws, w, v0, kVocab, vocab, tid);
    __syncthreads();
    float z[4][2];
    logits_4x2<kDim>(xs, ws, ty, tx, z);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = v0 + tx + 32 * j;
      const float b = col < vocab ? bias[col] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        z[i][j] = col < vocab ? z[i][j] + b : kNegInf;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new =
          fmaxf(m[i], warp_max(fmaxf(z[i][0], z[i][1])));
      float e = 0.f, y = 0.f, s = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = v0 + tx + 32 * j;
        e += expf(z[i][j] - m_new);
        if (col == label[i]) y += z[i][j];
        if (col < vocab) s += z[i][j];
      }
      l[i] = l[i] * expf(m[i] - m_new) + warp_sum(e);
      m[i] = m_new;
      zy[i] += warp_sum(y);
      sz[i] += warp_sum(s);
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty + 8 * i;
      if (r >= rows) continue;
      const float row_lse = m[i] + logf(fmaxf(l[i], 1e-37f));
      lse[r] = row_lse;
      xent[r] = -(sm.confidence - sm.low) * (zy[i] - row_lse)
                - sm.low * (sz[i] - vocab * row_lse);
    }
  }
}

// dx pass: one block per 32-row tile, looping over vocabulary tiles.
template <typename T, int kDim>
__global__ void __launch_bounds__(kThreads)
linear_xent_dx_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ bias,
                      const int* __restrict__ labels,
                      const float* __restrict__ lse,
                      const float* __restrict__ g, T* __restrict__ dx,
                      int rows, int vocab, Smoothing sm) {
  constexpr int kP = kDim + 1;
  constexpr int kCols = kDim / 32;         // output dims per thread
  extern __shared__ float smem[];
  float* xs = smem;                        // [kRows][kP]
  float* ws = xs + kRows * kP;             // [kVocab][kP]
  float* dz_tile = ws + kVocab * kP;       // [kRows][kVocab + 1]
  const int tid = threadIdx.x;
  const int ty = tid / 32, tx = tid % 32;
  const int r0 = blockIdx.x * kRows;

  load_rows<T, kDim>(xs, x, r0, kRows, rows, tid);
  int label[4];
  float row_lse[4], row_g[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 8 * i;
    const bool in = r < rows;
    label[i] = in ? labels[r] : -1;
    row_lse[i] = in ? lse[r] : 0.f;
    row_g[i] = in ? g[r] : 0.f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int v0 = 0; v0 < vocab; v0 += kVocab) {
    __syncthreads();  // the previous W and dz tiles are consumed
    load_rows<T, kDim>(ws, w, v0, kVocab, vocab, tid);
    __syncthreads();
    float z[4][2];
    logits_4x2<kDim>(xs, ws, ty, tx, z);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = v0 + tx + 32 * j;
      const bool col_ok = col < vocab;
      const float b = col_ok ? bias[col] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = col_ok && r0 + ty + 8 * i < rows;
        const float dz = ok ? dlogit(z[i][j] + b, row_lse[i], row_g[i],
                                     col == label[i], vocab, sm)
                            : 0.f;
        dz_tile[(ty + 8 * i) * (kVocab + 1) + tx + 32 * j] =
            round_to<T>(dz);
      }
    }
    __syncthreads();
    // dx[row][d] += sum_c dz[row][c] W[c][d] for dims d = tx + 32 j
#pragma unroll 2
    for (int c = 0; c < kVocab; ++c) {
      float dzv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dzv[i] = dz_tile[(ty + 8 * i) * (kVocab + 1) + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float wv = ws[c * kP + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dzv[i], wv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 8 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      dx[static_cast<long long>(r) * kDim + tx + 32 * j] =
          from_float<T>(acc[i][j]);
  }
}

// dW/db pass: one block per 32 vocabulary rows, looping over row tiles.
template <typename T, int kDim>
__global__ void __launch_bounds__(kThreads)
linear_xent_dw_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ bias,
                      const int* __restrict__ labels,
                      const float* __restrict__ lse,
                      const float* __restrict__ g, T* __restrict__ dw,
                      float* __restrict__ db, int rows, int vocab,
                      Smoothing sm) {
  constexpr int kP = kDim + 1;
  constexpr int kCols = kDim / 32;
  extern __shared__ float smem[];
  float* ws = smem;                          // [kVocabW][kP]
  float* xs = ws + kVocabW * kP;             // [kRows][kP]
  float* dz_tile = xs + kRows * kP;          // [kRows][kVocabW + 1]
  float* row_lse = dz_tile + kRows * (kVocabW + 1);
  float* row_g = row_lse + kRows;
  int* row_label = reinterpret_cast<int*>(row_g + kRows);
  float* db_part = reinterpret_cast<float*>(row_label + kRows);  // [8][32]
  const int tid = threadIdx.x;
  const int ty = tid / 32, tx = tid % 32;
  const int v0 = blockIdx.x * kVocabW;
  const int col = v0 + tx;                   // this thread's z column
  const bool col_ok = col < vocab;
  const float b = col_ok ? bias[col] : 0.f;

  load_rows<T, kDim>(ws, w, v0, kVocabW, vocab, tid);
  float acc[4][kCols];                       // dW rows ty + 8 i
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  float db_acc = 0.f;

  for (int r0 = 0; r0 < rows; r0 += kRows) {
    __syncthreads();  // the previous x and dz tiles are consumed
    load_rows<T, kDim>(xs, x, r0, kRows, rows, tid);
    if (tid < kRows) {
      const int r = r0 + tid;
      const bool in = r < rows;
      row_lse[tid] = in ? lse[r] : 0.f;
      row_g[tid] = in ? g[r] : 0.f;
      row_label[tid] = in ? labels[r] : -1;
    }
    __syncthreads();
    // z for rows ty + 8 i and column tx
    float z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int d = 0; d < kDim; ++d) {
      const float wv = ws[tx * kP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        z[i] = fmaf(xs[(ty + 8 * i) * kP + d], wv, z[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = ty + 8 * i;
      const bool ok = col_ok && r0 + lr < rows;
      const float dz = ok ? dlogit(z[i] + b, row_lse[lr], row_g[lr],
                                   col == row_label[lr], vocab, sm)
                          : 0.f;
      db_acc += dz;
      dz_tile[lr * (kVocabW + 1) + tx] = round_to<T>(dz);
    }
    __syncthreads();
    // dW[c][d] += sum_r dz[r][c] x[r][d] for vocab rows c = ty + 8 i
#pragma unroll 2
    for (int r = 0; r < kRows; ++r) {
      float dzv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dzv[i] = dz_tile[r * (kVocabW + 1) + ty + 8 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float xv = xs[r * kP + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dzv[i], xv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = v0 + ty + 8 * i;
    if (c >= vocab) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      dw[static_cast<long long>(c) * kDim + tx + 32 * j] =
          from_float<T>(acc[i][j]);
  }
  db_part[ty * 32 + tx] = db_acc;
  __syncthreads();
  if (tid < 32 && col_ok) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) s += db_part[k * 32 + tid];
    db[col] = s;
  }
}

template <int kDim>
constexpr size_t fwd_smem() {
  return (kRows + kVocab) * (kDim + 1) * sizeof(float);
}
template <int kDim>
constexpr size_t dx_smem() {
  return fwd_smem<kDim>() + kRows * (kVocab + 1) * sizeof(float);
}
template <int kDim>
constexpr size_t dw_smem() {
  return ((kVocabW + kRows) * (kDim + 1) + kRows * (kVocabW + 1)
          + 3 * kRows + kThreads) * sizeof(float);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
}

struct Args {
  const void *x, *w;
  const float* bias;
  const int* labels;
  int rows, vocab;
  Smoothing sm;
  cudaStream_t stream;
};

template <typename T, int kDim>
cudaError_t launch_fwd(const Args& a, float* xent, float* lse) {
  auto kernel = linear_xent_fwd_kernel<T, kDim>;
  cudaError_t err = set_smem(kernel, fwd_smem<kDim>());
  if (err != cudaSuccess) return err;
  kernel<<<(a.rows + kRows - 1) / kRows, kThreads, fwd_smem<kDim>(),
           a.stream>>>(static_cast<const T*>(a.x),
                       static_cast<const T*>(a.w), a.bias, a.labels, xent,
                       lse, a.rows, a.vocab, a.sm);
  return cudaGetLastError();
}

template <typename T, int kDim>
cudaError_t launch_dx(const Args& a, const float* lse, const float* g,
                      void* dx) {
  auto kernel = linear_xent_dx_kernel<T, kDim>;
  cudaError_t err = set_smem(kernel, dx_smem<kDim>());
  if (err != cudaSuccess) return err;
  kernel<<<(a.rows + kRows - 1) / kRows, kThreads, dx_smem<kDim>(),
           a.stream>>>(static_cast<const T*>(a.x),
                       static_cast<const T*>(a.w), a.bias, a.labels, lse, g,
                       static_cast<T*>(dx), a.rows, a.vocab, a.sm);
  return cudaGetLastError();
}

template <typename T, int kDim>
cudaError_t launch_dw(const Args& a, const float* lse, const float* g,
                      void* dw, float* db) {
  auto kernel = linear_xent_dw_kernel<T, kDim>;
  cudaError_t err = set_smem(kernel, dw_smem<kDim>());
  if (err != cudaSuccess) return err;
  kernel<<<(a.vocab + kVocabW - 1) / kVocabW, kThreads, dw_smem<kDim>(),
           a.stream>>>(static_cast<const T*>(a.x),
                       static_cast<const T*>(a.w), a.bias, a.labels, lse, g,
                       static_cast<T*>(dw), db, a.rows, a.vocab, a.sm);
  return cudaGetLastError();
}

bool bad_args(int rows, int vocab, int dim, int dtype) {
  return rows <= 0 || vocab <= 0 ||
         (dim != 128 && dim != 256 && dim != 512) ||
         (dtype != 0 && dtype != 1);
}

// Calls F<T, kDim>::run for the runtime dtype and dim.
template <template <typename, int> class F, typename... A>
cudaError_t dispatch(int dtype, int dim, A... args) {
  if (dtype == 0) {
    if (dim == 128) return F<float, 128>::run(args...);
    if (dim == 256) return F<float, 256>::run(args...);
    return F<float, 512>::run(args...);
  }
  if (dim == 128) return F<__nv_bfloat16, 128>::run(args...);
  if (dim == 256) return F<__nv_bfloat16, 256>::run(args...);
  return F<__nv_bfloat16, 512>::run(args...);
}

template <typename T, int kDim>
struct Fwd {
  static cudaError_t run(Args a, float* xent, float* lse) {
    return launch_fwd<T, kDim>(a, xent, lse);
  }
};
template <typename T, int kDim>
struct Dx {
  static cudaError_t run(Args a, const float* lse, const float* g,
                         void* dx) {
    return launch_dx<T, kDim>(a, lse, g, dx);
  }
};
template <typename T, int kDim>
struct Dw {
  static cudaError_t run(Args a, const float* lse, const float* g, void* dw,
                         float* db) {
    return launch_dw<T, kDim>(a, lse, g, dw, db);
  }
};

Args make_args(const void* x, const void* w, const void* bias,
               const void* labels, int rows, int vocab, float confidence,
               float low_confidence, void* stream) {
  return Args{x, w, static_cast<const float*>(bias),
              static_cast<const int*>(labels), rows, vocab,
              Smoothing{confidence, low_confidence},
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Each entry point returns the cudaError_t of its launch (0 on success).
// dtype: 0 = float32, 1 = bfloat16 (x, W, dx and dW share it).
extern "C" int neurst_linear_xent_fwd(const void* x, const void* w,
                                      const void* bias, const void* labels,
                                      void* xent, void* lse, int rows,
                                      int vocab, int dim, float confidence,
                                      float low_confidence, int dtype,
                                      void* stream) {
  if (bad_args(rows, vocab, dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(x, w, bias, labels, rows, vocab, confidence,
                           low_confidence, stream);
  return static_cast<int>(dispatch<Fwd>(dtype, dim, a,
                                        static_cast<float*>(xent),
                                        static_cast<float*>(lse)));
}

extern "C" int neurst_linear_xent_dx(const void* x, const void* w,
                                     const void* bias, const void* labels,
                                     const void* lse, const void* g,
                                     void* dx, int rows, int vocab, int dim,
                                     float confidence, float low_confidence,
                                     int dtype, void* stream) {
  if (bad_args(rows, vocab, dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(x, w, bias, labels, rows, vocab, confidence,
                           low_confidence, stream);
  return static_cast<int>(dispatch<Dx>(dtype, dim, a,
                                       static_cast<const float*>(lse),
                                       static_cast<const float*>(g), dx));
}

extern "C" int neurst_linear_xent_dw(const void* x, const void* w,
                                     const void* bias, const void* labels,
                                     const void* lse, const void* g,
                                     void* dw, void* db, int rows, int vocab,
                                     int dim, float confidence,
                                     float low_confidence, int dtype,
                                     void* stream) {
  if (bad_args(rows, vocab, dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(x, w, bias, labels, rows, vocab, confidence,
                           low_confidence, stream);
  return static_cast<int>(dispatch<Dw>(dtype, dim, a,
                                       static_cast<const float*>(lse),
                                       static_cast<const float*>(g), dw,
                                       static_cast<float*>(db)));
}
