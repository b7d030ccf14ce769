// Fused vocabulary projection + label-smoothed cross entropy for Hopper
// (sm_90a), plain C interface: a forward in one launch, or two for bf16
// where the vocabulary splits, and a backward in three launches (bf16)
// or two (float32).  The [R, V] logits never reach device memory.
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
// Why the grid differs from the TPU's: the TPU kernels walk a sequential
// grid and keep whole operands in VMEM (the backward its [V, D] float32
// dW accumulator, 8 MB at V = 8192, D = 256).  An H100 block has 227 KB
// of shared memory and blocks run in no order, so each pass splits the
// vocabulary of a row tile over blocks where the tiles alone leave SMs
// idle, and merges the splits' float32 partials in a fixed order; dW is
// a product over rows that another pass splits over blocks.
//
// What bounds it on an H100: at the training slice's shape (R = 6000
// rows, D = 256, V = 8192, bf16) the function moves ~8 MB but does
// 25 GFLOP forward and 75 GFLOP backward, so the card's bound is its bf16
// tensor-core rate (~0.03 ms forward, ~0.08 ms backward).
//
// bf16 runs on the tensor cores (the section below gives the tiles):
// mma.sync fed by 16-byte cp.async into 128-byte-swizzled tiles read by
// ldmatrix, through one chunk loop over (row tile, vocabulary split)
// blocks.  The forward computes z, folds it into each row's running
// statistics in registers and writes lse and xent, or float32 partials
// of the statistics that a combine kernel merges in split order.  The
// backward takes three launches: a dx pass that computes z and dz once,
// writes round(dz) [R, Vp] to a scratch buffer and the float32 dx and db
// partials; a dW pass, round(dz)^T x, over row splits
// (csrc/row_product.cuh); and a sum of the partials in a fixed order.
// Two calls give the same bits.  The backward thus does the 6 R V D
// operations the function needs, at the price of the dz round trip
// (2 x 98 MB at the slice's shape).
//
// float32 (the card-vs-CPU checks) runs every product as float32 FMA
// loops out of shared memory (no tensor cores), bound by FMA issue and
// shared-memory loads: each thread owns a 4 x 2 (forward, dx pass) or
// 4 x 1 (dW pass) tile of z and a 4 x D/32 tile of its output rows, the
// x tile stays in shared memory for the whole block, and W is re-read
// from L2 by every block.  Row tiles of 32 give 188 blocks at R = 6000
// (two fit an SM); the dW/db pass walks 32 vocabulary rows a block over
// all row tiles and recomputes z, so that backward does 8 R V D
// operations.
//
// Layout: x [R, D] and W [V, D] contiguous, of one dtype (float32 or
// bfloat16; bf16 16-byte aligned); bias [V], lse, g and xent [R]
// float32; labels [R] int32; dx [R, D] and dW [V, D] in the operand
// dtype, db [V] float32.  D is one of 128, 256, 512.  The FMA kernels:
// 256 threads as 8 warps; warp ty owns rows ty + 8 i of a tile, so a
// row's softmax statistics reduce with warp shuffles.  Shared rows have
// an odd pitch (D + 1), so the lanes of a warp read distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "row_product.cuh"

namespace {

using namespace neurst;

constexpr int kThreads = 256;
constexpr int kRows = 32;      // rows per tile
constexpr int kVocab = 64;     // vocabulary columns per tile (fwd, dx)
constexpr int kVocabW = 32;    // vocabulary rows per block (dW pass)
constexpr float kNegInf = -1.0e30f;

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

// ------------------------------------------------------ bf16: tensor cores
//
// Both bf16 passes over the logits walk (row tile, vocabulary split)
// blocks of 8 warps through one chunk loop (xent_chunks): x [R][D] comes
// in once, and the split's vocabulary streams in 64-row chunks W_c
// [64][D], each with its 64 bias values, through a 2-stage cp.async ring,
// so chunk j + 1's copies overlap chunk j's work.  Per chunk
//   P1  z [R][64] = x W_c^T (k = D): warps 4 (rows) x 2 (columns); x by
//       ldsm_a, W_c (an [n][k] tile) by ldsm_b;
// then the pass's own step on P1's accumulators.
// (a) The forward's step adds the bias and folds the chunk into the
// running (max, sum-exp, z_label, sum z) of the rows each thread holds in
// the accumulator layout, in registers (exp on the special-function
// unit; no shuffle and no barrier).  The block ends by merging those
// over the quad's lanes, then over the two column warps through shared
// memory, in a fixed order.  With one split it writes lse and xent; with
// S > 1 it writes the statistics as float32 partials [S][R] that the
// combine kernel merges in split order.  R is 128 rows at every D: at
// D 512, where x and a ring of two whole chunks would take 256 KB of
// shared memory, each chunk's W comes through the ring in two parts of
// 256 columns.  A thread holds P1's 32 accumulators and 16 statistics.
// (b) The backward's dx pass: its step forms dz from z + bias, lse,
// label and g (exp on the special-function unit), zero on columns >= V
// and rows >= R, into a swizzled [R][64] tile as round(dz), which goes
// out to the dz buffer [R][Vp] by 16-byte stores; the chunk's db partial
// sums the unrounded dz by warp shuffles, then the 4 row warps, in a
// fixed order;
//   P2  dx [R][D] += round(dz) W_c (k = 64): warps 2 x 4; dz by ldsm_a,
//       W_c (the same tile, read as [k][n]) by ldsm_trans.
// The block ends by writing its float32 dx partial [S][R][D].  R is 128,
// or 64 at D 512 (128 rows would need 256 accumulators a thread): 128
// accumulators a thread at D 256 and 512.
// (c) The dW pass: dW [Vp][D] = round(dz)^T x, a product over rows in
// row splits (csrc/row_product.cuh), as the fused-FFN backward's dW1.
// (d) The sum kernel adds the dx and dW partials in split order and the
// db partials in tile order, and rounds dx and dW.
// The splits S of (a) and (b) are picked so that the (tile, split) blocks
// fill the card with the fewest chunk steps (ops/_plan.py).  The forward
// walks ceil(V / 64) chunks, the dx pass Vp / 64: Vp is V rounded up to
// the dW pass's 128-row tiles, so the dz columns >= V are written as
// zeros.  W rows >= V stage as zeros and their bias as 0.
constexpr int kXentThreads = 256;
constexpr int kXentChunk = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kXentStages = 2;

// The chunk loop's shared memory: x [R][D] as D / 64 swizzled panels,
// the ring's W parts, each [64][D / KS] of a chunk (KS parts a chunk,
// D / 64 / KS panels each), then a ring of two bias chunks [64] float32.
template <int D, int R, int KS = 1>
struct XentStage {
  static constexpr int kPart = D / KS;  // W columns (k) a ring stage
  static constexpr int kXBytes = R * D * 2;
  static constexpr int kXPanel = R * 128;
  static constexpr int kWBytes = kXentChunk * kPart * 2;
  static constexpr int kWPanel = kXentChunk * 128;
  static constexpr int kBiasOff = kXBytes + kXentStages * kWBytes;
  static constexpr int kBytes = kBiasOff + 2 * kXentChunk * 4;
  static constexpr int kMt1 = R / 4 / 16;  // m tiles a warp, P1
  // the W part of ring step s (part s % KS of chunk s / KS)
  __device__ static uint32_t w_tile(uint32_t base, int s) {
    return base + kXBytes + (s % kXentStages) * kWBytes;
  }
  // the bias of chunk j
  __device__ static int bias_off(int j) {
    return kBiasOff + (j % 2) * kXentChunk * 4;
  }
};

// The chunk loop of one (row tile, vocabulary split) block: chunks
// [c0, c0 + n_chunks) of W and bias against rows [r0, r0 + R) of x, both
// staged from `base` as XentStage lays them out (x rows >= `rows` and W
// rows >= `vocab` as zeros, their bias as 0).  A chunk's W comes through
// the ring in KS parts of D / KS columns (k), so a tile of more rows fits
// beside a ring of two parts.  After each chunk's P1 it calls
// body(acc1, j): acc1[mi][nt][2 hh + e] is x W^T (no bias) of row
// 16 (kMt1 wm + mi) + g + 8 hh of the tile and column 32 wn + 8 nt +
// 2 t + e of the chunk (warp = wm + 4 wn, lane = 4 g + t).  With KS = 1
// the ring stage of chunk j (Stage::w_tile(base, j)) holds all of W_c
// while body runs.
template <int D, int R, int KS, typename Body>
__device__ __forceinline__ void xent_chunks(
    uint32_t base, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
    int r0, int rows, int vocab, int c0, int n_chunks, Body&& body) {
  using S = XentStage<D, R, KS>;
  constexpr int kMt1 = S::kMt1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int steps = n_chunks * KS;
  auto load_step = [&](int st) {  // addresses recomputed each step
    const int ot = opaque(tid);
    const int j = st / KS, p = st % KS;
    const int v0 = (c0 + j) * kXentChunk;
    load_panels_async<kXentThreads, kXentChunk, S::kPart>(
        S::w_tile(base, st), w, D, v0, p * S::kPart, vocab, ot);
    if (p == 0 && ot < kXentChunk) {
      const bool in = v0 + ot < vocab;
      cp_async4(base + S::bias_off(j) + 4 * ot, in ? bias + v0 + ot : bias,
                in);
    }
  };
  load_panels_async<kXentThreads, R, D>(base, x, D, r0, 0, rows, tid);
  if (steps > 0) load_step(0);
  cp_async_commit();

  float acc1[kMt1][4][4];
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<0>();  // step st (and x) landed
    __syncthreads();     // ... for every thread; step st - 1 is consumed
    if (st + 1 < steps) load_step(st + 1);
    cp_async_commit();
    const uint32_t wc = S::w_tile(base, st);
    const uint32_t xp = base + (st % KS) * (S::kPart / 64) * S::kXPanel;

    // P1: z [R r][64 v] = x W_c^T.  Its k loop is unrolled by 8:
    // unrolled whole, its fragment prefetch beside the dx pass's dz step
    // spilled 20-68 bytes at D 256.
    if (st % KS == 0) {
#pragma unroll
      for (int mi = 0; mi < kMt1; ++mi) zero(acc1[mi]);
    }
#pragma unroll 8
    for (int kk = 0; kk < S::kPart / 16; ++kk) {
      uint32_t a[kMt1][4];
#pragma unroll
      for (int mi = 0; mi < kMt1; ++mi)
        ldsm_a(a[mi], xp + (kk >> 2) * S::kXPanel, 16 * (kMt1 * wm + mi),
               2 * (kk & 3), lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_b(b, wc + (kk >> 2) * S::kWPanel, 32 * wn + 16 * np,
               2 * (kk & 3), lane);
#pragma unroll
        for (int mi = 0; mi < kMt1; ++mi) {
          mma_bf16(acc1[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc1[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
    if (st % KS == KS - 1) body(acc1, st / KS);
  }
  cp_async_wait<0>();
}

// ---- (a) forward

// The bf16 forward's row tile: 128 rows, with W through the ring in two
// parts a chunk at D 512, where x [128][512] and two whole chunks would
// take 256 KB of shared memory (ops/fused_ce.py: _FWD_ROWS mirrors it)
constexpr int kFwdRows = 128;
template <int D>
constexpr int fwd_parts() {
  return D == 512 ? 2 : 1;
}

// A row's softmax statistics over some of its columns, as a float4:
// (m, l, z_label, sum z) with m = max z log2 e and l = sum 2^(z log2 e -
// m) over the columns < V, (-1e30, 0, 0, 0) over none.  a merged with b,
// in that order.
__device__ __forceinline__ float4 merge_stats(float4 a, float4 b) {
  const float m = fmaxf(a.x, b.x);
  return make_float4(
      m, fmaf(a.y, fast_exp2(a.x - m), b.y * fast_exp2(b.x - m)), a.z + b.z,
      a.w + b.w);
}

// lse = m ln 2 + log(max(l, 1e-37)) and xent from a row's statistics
__device__ __forceinline__ void finish_row(float4 s, int vocab, Smoothing sm,
                                           float* xent, float* lse) {
  const float row_lse = fmaf(s.x, kLn2, logf(fmaxf(s.y, 1e-37f)));
  *lse = row_lse;
  *xent = -(sm.confidence - sm.low) * (s.z - row_lse) -
          sm.low * (s.w - vocab * row_lse);
}

template <int D, int R, int KS>
__global__ void __launch_bounds__(kXentThreads, 1)
linear_xent_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w,
                            const float* __restrict__ bias,
                            const int* __restrict__ labels,
                            float* __restrict__ xent,
                            float* __restrict__ lse,
                            float4* __restrict__ part, int rows, int vocab,
                            Smoothing sm) {
  using S = XentStage<D, R, KS>;
  constexpr int kMt1 = S::kMt1, kN = 2 * kMt1;  // rows a thread holds
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t base = smem_addr(smem_tc);
  float4* red = reinterpret_cast<float4*>(smem_tc + S::kBytes);  // [2][R]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int r0 = blockIdx.x * R;
  const int chunks = (vocab + kXentChunk - 1) / kXentChunk;
  const int per_split = (chunks + gridDim.y - 1) / gridDim.y;
  const int c0 = blockIdx.y * per_split;
  const int n_chunks = max(0, min(chunks, c0 + per_split) - c0);

  // this thread's row i = 2 mi + hh is 16 (kMt1 wm + mi) + g + 8 hh
  int label[kN];
  float m[kN], l[kN], zy[kN], sz[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int r = r0 + 16 * (kMt1 * wm + i / 2) + g + 8 * (i % 2);
    label[i] = r < rows ? labels[r] : -1;
    m[i] = kNegInf;
    l[i] = zy[i] = sz[i] = 0.f;
  }

  xent_chunks<D, R, KS>(
      base, x, w, bias, r0, rows, vocab, c0, n_chunks,
      [&](float (&acc1)[kMt1][4][4], int j) {
        const float* bias_c =
            reinterpret_cast<const float*>(smem_tc + S::bias_off(j));
        // column k = 8 nt + e of this thread is col0 + k of the vocabulary
        const int col0 = (c0 + j) * kXentChunk + 32 * wn + 2 * t;
        float b[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            b[nt][e] = bias_c[32 * wn + 8 * nt + 2 * t + e];
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          float z2[8];  // z log2 e, -1e30 on columns >= V
          float zmax = m[i];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int k = 8 * nt + e;
              // columns >= V: zero W rows and bias, so z = 0 in sum z
              const float z = acc1[i / 2][nt][2 * (i % 2) + e] + b[nt][e];
              sz[i] += z;
              zy[i] += col0 + k == label[i] ? z : 0.f;
              z2[2 * nt + e] = col0 + k < vocab ? z * kLog2e : kNegInf;
              zmax = fmaxf(zmax, z2[2 * nt + e]);
            }
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < 8; ++k) s += fast_exp2(z2[k] - zmax);
          // no column < V yet: (m, l) stay (-1e30, 0)
          l[i] = zmax == kNegInf ? 0.f : fmaf(l[i], fast_exp2(m[i] - zmax), s);
          m[i] = zmax;
        }
      });

  // merge over the quad's lanes (the same rows, other columns), then the
  // two column warps, in that order
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    float4 s = make_float4(m[i], l[i], zy[i], sz[i]);
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
      s = merge_stats(s, make_float4(__shfl_xor_sync(0xFFFFFFFFu, s.x, o),
                                     __shfl_xor_sync(0xFFFFFFFFu, s.y, o),
                                     __shfl_xor_sync(0xFFFFFFFFu, s.z, o),
                                     __shfl_xor_sync(0xFFFFFFFFu, s.w, o)));
    if (t == 0) red[wn * R + 16 * (kMt1 * wm + i / 2) + g + 8 * (i % 2)] = s;
  }
  __syncthreads();
  const int r = r0 + tid;
  if (tid < R && r < rows) {
    const float4 s = merge_stats(red[tid], red[R + tid]);
    if (gridDim.y == 1)
      finish_row(s, vocab, sm, xent + r, lse + r);
    else
      part[static_cast<long long>(blockIdx.y) * rows + r] = s;
  }
}

// xent and lse of each row from the forward's partials [S][R], merged in
// split order
__global__ void __launch_bounds__(kThreads)
linear_xent_combine_kernel(const float4* __restrict__ part,
                           float* __restrict__ xent, float* __restrict__ lse,
                           int rows, int vocab, int splits, Smoothing sm) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  float4 s = part[r];
  for (int sp = 1; sp < splits; ++sp)
    s = merge_stats(s, part[static_cast<long long>(sp) * rows + r]);
  finish_row(s, vocab, sm, xent + r, lse + r);
}

// ---- (b) backward: the dx pass

template <int D>
struct XentTile {
  static constexpr int kRows = D == 512 ? 64 : 128;
  using Stage = XentStage<D, kRows>;
  static constexpr int kDzBytes = kRows * kXentChunk * 2;  // 1 panel
  static constexpr int kMt2 = kRows / 2 / 16;  // m tiles, P2
  static constexpr int kNt2 = D / 4 / 8;       // n tiles, P2
  static constexpr int kDzOff = Stage::kBytes;
  // each row's (lse log2 e, g), then its label, then the db sums of the
  // 4 row warps
  static constexpr int kRowOff = kDzOff + kDzBytes;
  static constexpr int kLabelOff = kRowOff + kRows * 8;
  static constexpr int kRedOff = kLabelOff + kRows * 4;
  static constexpr size_t kSmem = kRedOff + 4 * kXentChunk * sizeof(float);
};

// dz = g ((c - low)(p - onehot) + low (V p - 1))
//    = g (a p - low - (onehot ? c - low : 0)),  a = c - low + low V;
// the terms are kernel arguments, read from the constant bank rather
// than held in registers
struct DzTerms {
  float a, low, label;
};

template <int D>
__global__ void __launch_bounds__(kXentThreads, 1)
linear_xent_dx_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ bias,
                           const int* __restrict__ labels,
                           const float* __restrict__ lse,
                           const float* __restrict__ grad,
                           __nv_bfloat16* __restrict__ dz,
                           float* __restrict__ dxp, float* __restrict__ dbp,
                           int rows, int vocab, int vpad, DzTerms terms) {
  using Tile = XentTile<D>;
  using Stage = typename Tile::Stage;
  constexpr int kR = Tile::kRows, kMt1 = Stage::kMt1, kMt2 = Tile::kMt2,
                kNt2 = Tile::kNt2;
  // (the FMA kernels declare their dynamic shared memory as float)
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t base = smem_addr(smem_tc);
  const uint32_t dzs = base + Tile::kDzOff;
  float2* row_terms = reinterpret_cast<float2*>(smem_tc + Tile::kRowOff);
  int* row_label = reinterpret_cast<int*>(smem_tc + Tile::kLabelOff);
  float* red = reinterpret_cast<float*>(smem_tc + Tile::kRedOff);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // P1: rows 16 kMt1 wm, columns 32 wn; P2: rows 16 kMt2 wm2, dims
  // D / 4 wn2
  const int wm = warp & 3, wn = warp >> 2;
  const int wm2 = warp & 1, wn2 = warp >> 1;
  const int tile = blockIdx.x, r0 = tile * kR;
  const int chunks = vpad / kXentChunk;
  const int per_split = (chunks + gridDim.y - 1) / gridDim.y;
  const int c0 = blockIdx.y * per_split;
  const int n_chunks = max(0, min(chunks, c0 + per_split) - c0);

  if (tid < kR) {  // read after the loop's first barrier
    const int r = r0 + tid;
    const bool in = r < rows;
    row_terms[tid] = make_float2(in ? lse[r] * kLog2e : 0.f,
                                 in ? grad[r] : 0.f);
    row_label[tid] = in ? labels[r] : -1;
  }

  float acc2[kMt2][kNt2][4];
#pragma unroll
  for (int mi = 0; mi < kMt2; ++mi) zero(acc2[mi]);

  xent_chunks<D, kR, 1>(
      base, x, w, bias, r0, rows, vocab, c0, n_chunks,
      [&](float (&acc1)[kMt1][4][4], int j) {
        const uint32_t wc = Stage::w_tile(base, j);
        const float* bias_c =
            reinterpret_cast<const float*>(smem_tc + Stage::bias_off(j));
        const int v0 = (c0 + j) * kXentChunk;

        // dz into the chunk's tile, rounded; db from the unrounded, each
        // column pair's sums reduced over the warp's rows before the
        // next pair (fewer live registers than reducing all four pairs
        // at once)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int f = 32 * wn + 8 * nt + 2 * t;  // f, f + 1: one word
          bool col_ok[2];
          float b[2], cs[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            col_ok[e] = v0 + f + e < vocab;
            b[e] = bias_c[f + e];
          }
#pragma unroll
          for (int mi = 0; mi < kMt1; ++mi)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = 16 * (kMt1 * wm + mi) + g + 8 * hh;
              const bool row_ok = r0 + r < rows;
              const float2 row = row_terms[r];  // (lse log2 e, g)
              const int label = row_label[r];
              float d[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float z = acc1[mi][nt][2 * hh + e] + b[e];
                const float p = fast_exp2(fmaf(z, kLog2e, -row.x));
                d[e] = row_ok && col_ok[e]
                           ? row.y * (fmaf(terms.a, p, -terms.low) -
                                      (v0 + f + e == label ? terms.label
                                                           : 0.f))
                           : 0.f;
                cs[e] += d[e];
              }
              *reinterpret_cast<uint32_t*>(smem_tc + Tile::kDzOff +
                                           swz(r, f >> 3) + (f & 7) * 2) =
                  pack_bf16(d[0], d[1]);
            }
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              cs[e] += __shfl_xor_sync(0xFFFFFFFFu, cs[e], o);
          if (g == 0)
#pragma unroll
            for (int e = 0; e < 2; ++e) red[wm * kXentChunk + f + e] = cs[e];
        }
        __syncthreads();  // round(dz) and the db sums are in place

        if (tid < kXentChunk) {
          float s = 0.f;
#pragma unroll
          for (int w4 = 0; w4 < 4; ++w4) s += red[w4 * kXentChunk + tid];
          dbp[static_cast<long long>(tile) * vpad + v0 + tid] = s;
        }
#pragma unroll
        for (int q = 0; q < kR * 8 / kXentThreads; ++q) {
          const int i = tid + q * kXentThreads;
          const int r = i >> 3, c = i & 7;
          if (r0 + r < rows)
            *reinterpret_cast<uint4*>(dz +
                                      static_cast<long long>(r0 + r) * vpad +
                                      v0 + 8 * c) =
                *reinterpret_cast<const uint4*>(smem_tc + Tile::kDzOff +
                                                swz(r, c));
        }

        // P2: dx [kR r][D d] += round(dz) W_c
#pragma unroll
        for (int kk = 0; kk < kXentChunk / 16; ++kk) {
          uint32_t a[kMt2][4];
#pragma unroll
          for (int mi = 0; mi < kMt2; ++mi)
            ldsm_a(a[mi], dzs, 16 * (kMt2 * wm2 + mi), 2 * kk, lane);
#pragma unroll
          for (int np = 0; np < kNt2 / 2; ++np) {
            const int d0 = (D / 4) * wn2 + 16 * np;
            uint32_t b[4];
            ldsm_trans(b, wc + (d0 >> 6) * Stage::kWPanel, 16 * kk,
                       (d0 & 63) >> 3, lane);
#pragma unroll
            for (int mi = 0; mi < kMt2; ++mi) {
              mma_bf16(acc2[mi][2 * np], a[mi], b[0], b[1]);
              mma_bf16(acc2[mi][2 * np + 1], a[mi], b[2], b[3]);
            }
          }
        }
      });

  float* part = dxp + static_cast<long long>(blockIdx.y) * rows * D;
#pragma unroll
  for (int mi = 0; mi < kMt2; ++mi)
#pragma unroll
    for (int nt = 0; nt < kNt2; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 16 * (kMt2 * wm2 + mi) + g + 8 * hh;
        const int d = (D / 4) * wn2 + 8 * nt + 2 * t;
        if (r < rows)
          *reinterpret_cast<float2*>(part + static_cast<long long>(r) * D +
                                     d) =
              make_float2(acc2[mi][nt][2 * hh], acc2[mi][nt][2 * hh + 1]);
      }
}

// ---- (d) the backward's sum

// dx [R][D] and dW [V][D] (bf16), db [V] (float32): the sums of the dx
// partials [Sx][R][D] and dW partials [Sw][Vp][D] in split order, four
// values a thread, and of the db partials [T][Vp] in tile order, one warp
// a column (lane l adds tiles l, l + 32, ... in order, then a fixed
// butterfly of shuffles)
__global__ void __launch_bounds__(kThreads)
linear_xent_sum_kernel(const float* __restrict__ dxp,
                       const float* __restrict__ dwp,
                       const float* __restrict__ dbp,
                       __nv_bfloat16* __restrict__ dx,
                       __nv_bfloat16* __restrict__ dw,
                       float* __restrict__ db, int rows, int vocab, int vpad,
                       int dim, int dx_splits, int dw_splits, int tiles) {
  const long long nx = static_cast<long long>(rows) * dim / 4;
  const long long nw = static_cast<long long>(vocab) * dim / 4;
  const long long wstep = static_cast<long long>(vpad) * dim / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long e = first; e < nx + nw; e += stride) {
    const bool is_x = e < nx;
    const float4* src = is_x ? reinterpret_cast<const float4*>(dxp) + e
                             : reinterpret_cast<const float4*>(dwp) + (e - nx);
    const long long step = is_x ? nx : wstep;
    const int n = is_x ? dx_splits : dw_splits;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < n; ++sp) {
      const float4 v = src[sp * step];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const uint2 out = make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
    if (is_x)
      reinterpret_cast<uint2*>(dx)[e] = out;
    else
      reinterpret_cast<uint2*>(dw)[e - nx] = out;
  }
  const int lane = threadIdx.x & 31;
  for (long long c = first >> 5; c < vocab; c += stride >> 5) {
    float s = 0.f;
#pragma unroll 4
    for (int i = lane; i < tiles; i += 32)
      s += dbp[static_cast<long long>(i) * vpad + c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
    if (lane == 0) db[c] = s;
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

// Calls F<T, kDim>::run for the runtime dim.
template <template <typename, int> class F, typename T, typename... A>
cudaError_t dispatch_dim(int dim, A... args) {
  if (dim == 128) return F<T, 128>::run(args...);
  if (dim == 256) return F<T, 256>::run(args...);
  return F<T, 512>::run(args...);
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

// The bf16 backward's scratch (ops/fused_ce.py: bwd_scratch mirrors it):
// Vp, V rounded up to the dW pass's 128-row tiles; T row tiles of the dx
// pass; the float32 partials dx [Sx][R][D], then dW [Sw][Vp][D], then db
// [T][Vp].
int xent_vpad(int vocab) {
  return (vocab + kRpTileM - 1) / kRpTileM * kRpTileM;
}

int xent_tiles(int rows, int dim) {
  const int tile = dim == 512 ? XentTile<512>::kRows : XentTile<256>::kRows;
  return (rows + tile - 1) / tile;
}

struct XentPartials {
  float *dx, *dw, *db;
};

XentPartials xent_partials(const void* partials, int rows, int vocab,
                           int dim, int dx_splits, int dw_splits) {
  XentPartials out;
  out.dx = static_cast<float*>(const_cast<void*>(partials));
  out.dw = out.dx + static_cast<long long>(dx_splits) * rows * dim;
  out.db = out.dw + static_cast<long long>(dw_splits) * xent_vpad(vocab) * dim;
  return out;
}

template <int D>
cudaError_t launch_fwd_bf16(const Args& a, float* xent, float* lse,
                            float4* part, int splits) {
  constexpr int R = kFwdRows, KS = fwd_parts<D>();
  constexpr size_t smem =
      XentStage<D, R, KS>::kBytes + 2 * R * sizeof(float4);
  auto kernel = linear_xent_fwd_bf16_kernel<D, R, KS>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  using bf16 = __nv_bfloat16;
  kernel<<<dim3((a.rows + R - 1) / R, splits), kXentThreads, smem,
           a.stream>>>(static_cast<const bf16*>(a.x),
                       static_cast<const bf16*>(a.w), a.bias, a.labels, xent,
                       lse, part, a.rows, a.vocab, a.sm);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dx_bf16(const Args& a, const float* lse, const float* g,
                           void* dz, const XentPartials& p, int splits) {
  auto kernel = linear_xent_dx_bf16_kernel<D>;
  cudaError_t err = set_smem(kernel, XentTile<D>::kSmem);
  if (err != cudaSuccess) return err;
  using bf16 = __nv_bfloat16;
  kernel<<<dim3(xent_tiles(a.rows, D), splits), kXentThreads,
           XentTile<D>::kSmem, a.stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.w), a.bias,
      a.labels, lse, g, static_cast<bf16*>(dz), p.dx, p.db, a.rows, a.vocab,
      xent_vpad(a.vocab),
      DzTerms{a.sm.confidence - a.sm.low + a.sm.low * a.vocab, a.sm.low,
              a.sm.confidence - a.sm.low});
  return cudaGetLastError();
}

// dW partials [Sw][Vp][D] = round(dz)^T x, in 128 x min(D, 256) tiles
cudaError_t launch_dw_bf16(const void* x, const void* dz, float* dwp,
                           int rows, int vocab, int dim, int splits,
                           cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  const RowProduct p{static_cast<const bf16*>(dz),
                     static_cast<const bf16*>(x), dwp, xent_vpad(vocab), dim,
                     false};
  return dim == 128 ? launch_row_product<128>(p, nullptr, rows, splits, s)
                    : launch_row_product<256>(p, nullptr, rows, splits, s);
}

cudaError_t launch_sum_bf16(const XentPartials& p, void* dx, void* dw,
                            float* db, int rows, int vocab, int dim,
                            int dx_splits, int dw_splits, cudaStream_t s) {
  const long long n = (static_cast<long long>(rows) + vocab) * dim / 4;
  const long long blocks = (n + kThreads - 1) / kThreads;
  linear_xent_sum_kernel<<<static_cast<int>(blocks < 132 * 8 ? blocks
                                                             : 132 * 8),
                           kThreads, 0, s>>>(
      p.dx, p.dw, p.db, static_cast<__nv_bfloat16*>(dx),
      static_cast<__nv_bfloat16*>(dw), db, rows, vocab, xent_vpad(vocab),
      dim, dx_splits, dw_splits, xent_tiles(rows, dim));
  return cudaGetLastError();
}

bool bad_bf16_args(int rows, int vocab, int dim, int dx_splits,
                   int dw_splits, const void* partials) {
  return bad_args(rows, vocab, dim, 1) || dx_splits <= 0 ||
         dx_splits > xent_vpad(vocab) / kXentChunk || dw_splits <= 0 ||
         dw_splits > 65535 || partials == nullptr;
}

}  // namespace

// Each entry point returns the cudaError_t of its launch (0 on success).
// The float32 forward, one launch (dtype 0 only; bf16 takes
// neurst_linear_xent_fwd_bf16).
extern "C" int neurst_linear_xent_fwd(const void* x, const void* w,
                                      const void* bias, const void* labels,
                                      void* xent, void* lse, int rows,
                                      int vocab, int dim, float confidence,
                                      float low_confidence, int dtype,
                                      void* stream) {
  if (bad_args(rows, vocab, dim, dtype) || dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(x, w, bias, labels, rows, vocab, confidence,
                           low_confidence, stream);
  return static_cast<int>(dispatch_dim<Fwd, float>(
      dim, a, static_cast<float*>(xent), static_cast<float*>(lse)));
}

// The bf16 forward, one launch, or two where the vocabulary splits: with
// S = 1 the pass writes xent and lse itself; with S > 1 it writes the
// float32 partials [S][R][4] to `partials` (ops/fused_ce.py: fwd_plan
// sizes them) and neurst_linear_xent_combine_bf16 merges them.
extern "C" int neurst_linear_xent_fwd_bf16(
    const void* x, const void* w, const void* bias, const void* labels,
    void* xent, void* lse, void* partials, int rows, int vocab, int dim,
    int splits, float confidence, float low_confidence, void* stream) {
  if (bad_args(rows, vocab, dim, 1) || splits <= 0 ||
      splits > (vocab + kXentChunk - 1) / kXentChunk ||
      (splits > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(x, w, bias, labels, rows, vocab, confidence,
                           low_confidence, stream);
  float* xentf = static_cast<float*>(xent);
  float* lsef = static_cast<float*>(lse);
  float4* part = static_cast<float4*>(partials);
  cudaError_t err =
      dim == 128   ? launch_fwd_bf16<128>(a, xentf, lsef, part, splits)
      : dim == 256 ? launch_fwd_bf16<256>(a, xentf, lsef, part, splits)
                   : launch_fwd_bf16<512>(a, xentf, lsef, part, splits);
  return static_cast<int>(err);
}

extern "C" int neurst_linear_xent_combine_bf16(const void* partials,
                                               void* xent, void* lse,
                                               int rows, int vocab,
                                               int splits, float confidence,
                                               float low_confidence,
                                               void* stream) {
  if (rows <= 0 || vocab <= 0 || splits <= 1 || partials == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  linear_xent_combine_kernel<<<(rows + kThreads - 1) / kThreads, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(partials), static_cast<float*>(xent),
      static_cast<float*>(lse), rows, vocab, splits,
      Smoothing{confidence, low_confidence});
  return static_cast<int>(cudaGetLastError());
}

// The float32 backward, two launches: dx, then dW and db (dtype 0 only).
extern "C" int neurst_linear_xent_dx(const void* x, const void* w,
                                     const void* bias, const void* labels,
                                     const void* lse, const void* g,
                                     void* dx, int rows, int vocab, int dim,
                                     float confidence, float low_confidence,
                                     int dtype, void* stream) {
  if (bad_args(rows, vocab, dim, dtype) || dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(x, w, bias, labels, rows, vocab, confidence,
                           low_confidence, stream);
  return static_cast<int>(dispatch_dim<Dx, float>(
      dim, a, static_cast<const float*>(lse), static_cast<const float*>(g),
      dx));
}

extern "C" int neurst_linear_xent_dw(const void* x, const void* w,
                                     const void* bias, const void* labels,
                                     const void* lse, const void* g,
                                     void* dw, void* db, int rows, int vocab,
                                     int dim, float confidence,
                                     float low_confidence, int dtype,
                                     void* stream) {
  if (bad_args(rows, vocab, dim, dtype) || dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(x, w, bias, labels, rows, vocab, confidence,
                           low_confidence, stream);
  return static_cast<int>(dispatch_dim<Dw, float>(
      dim, a, static_cast<const float*>(lse), static_cast<const float*>(g),
      dw, static_cast<float*>(db)));
}

// The bf16 backward, three launches: the dx pass (round(dz) into `dz`
// [R, Vp] bf16, the dx and db partials), the dW pass (the dW partials)
// and the sum (dx, dW, db).  `partials` holds Sx R D + Sw Vp D + T Vp
// floats (see XentPartials); Sx splits the vocabulary of the dx pass, Sw
// the rows of the dW pass.
extern "C" int neurst_linear_xent_dx_bf16(
    const void* x, const void* w, const void* bias, const void* labels,
    const void* lse, const void* g, void* dz, void* partials, int rows,
    int vocab, int dim, int dx_splits, int dw_splits, float confidence,
    float low_confidence, void* stream) {
  if (bad_bf16_args(rows, vocab, dim, dx_splits, dw_splits, partials) ||
      dz == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(x, w, bias, labels, rows, vocab, confidence,
                           low_confidence, stream);
  const XentPartials p =
      xent_partials(partials, rows, vocab, dim, dx_splits, dw_splits);
  const float* lsef = static_cast<const float*>(lse);
  const float* gf = static_cast<const float*>(g);
  cudaError_t err =
      dim == 128   ? launch_dx_bf16<128>(a, lsef, gf, dz, p, dx_splits)
      : dim == 256 ? launch_dx_bf16<256>(a, lsef, gf, dz, p, dx_splits)
                   : launch_dx_bf16<512>(a, lsef, gf, dz, p, dx_splits);
  return static_cast<int>(err);
}

extern "C" int neurst_linear_xent_dw_bf16(const void* x, const void* dz,
                                          void* partials, int rows,
                                          int vocab, int dim, int dx_splits,
                                          int dw_splits, void* stream) {
  if (bad_bf16_args(rows, vocab, dim, dx_splits, dw_splits, partials) ||
      dz == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const XentPartials p =
      xent_partials(partials, rows, vocab, dim, dx_splits, dw_splits);
  return static_cast<int>(launch_dw_bf16(x, dz, p.dw, rows, vocab, dim,
                                         dw_splits,
                                         static_cast<cudaStream_t>(stream)));
}

extern "C" int neurst_linear_xent_sum_bf16(const void* partials, void* dx,
                                           void* dw, void* db, int rows,
                                           int vocab, int dim, int dx_splits,
                                           int dw_splits, void* stream) {
  if (bad_bf16_args(rows, vocab, dim, dx_splits, dw_splits, partials))
    return static_cast<int>(cudaErrorInvalidValue);
  const XentPartials p =
      xent_partials(partials, rows, vocab, dim, dx_splits, dw_splits);
  return static_cast<int>(launch_sum_bf16(
      p, dx, dw, static_cast<float*>(db), rows, vocab, dim, dx_splits,
      dw_splits, static_cast<cudaStream_t>(stream)));
}
