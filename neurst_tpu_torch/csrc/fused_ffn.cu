// Fused position-wise FFN, y = dropout(relu(x W1^T + b1)) W2^T + b2, for
// Hopper (sm_90a), plain C interface: a forward kernel and a backward in
// three (a dx pass over row tiles, a dW pass over filter-column tiles and
// row splits, and a deterministic sum of the splits).  bf16 products run
// on the tensor cores (warp-level mma.sync.m16n8k16, float32
// accumulation); float32 runs the same tiling with FMA loops.
//
// Replaces: neurst_tpu/ops/fused_ffn.py:_ffn_fwd_kernel (the Pallas call
// at :232) and :_ffn_bwd_kernel (the call at :262).  Same function:
//   forward  z1 = x W1^T + b1 (float32), h = relu(z1), the inverted
//            dropout of h with the FFN site's mask (csrc/philox.cuh, at
//            the absolute index r F + f), hd = round(h) to the operand
//            dtype, y = hd W2^T + b2 (:121-146); training also writes hd.
//   backward from hd alone, with no recompute of z1 and no mask
//            regeneration: the mask is hd > 0 (:149-205).  dh = (hd > 0)
//            ? (dy W2) * scale : 0 in float32, dW2 = dy^T hd, dW1 =
//            round(dh)^T x, dx = round(dh) W1, db1 = sum dh (unrounded),
//            db2 = sum dy; dy arrives in the operand dtype, as the TPU
//            kernel rounds it (:179), and every product accumulates in
//            float32.  Rows >= R are zeroed at the source (:157-163).
//
// Layouts are nn.Linear's: x [R, D], W1 [F, D], W2 [D, F] of one dtype;
// b1 [F], b2 [D] float32; y, dx [R, D] and hd [R, F] in the operand
// dtype; dW1 [F, D] and dW2 [D, F] in the operand dtype, db1 [F] and db2
// [D] float32.  D is 256, F a multiple of 64.
//
// Why this shape on an H100: the TPU kernel keeps W1, W2 and the float32
// dW1/dW2 (8 MB at D 256, F 2048) resident in VMEM across a sequential
// grid.  A block here has 227 KB of shared memory and blocks run in no
// order, so (a) the forward and the dx pass walk 64-row tiles and stream
// W1/W2 through shared memory in 64-column filter chunks (from L2: 2 MB
// of weights re-read by every block), keeping y (or dx) in registers and
// the hidden chunk in shared memory only; (b) the dW pass gives each
// 512-thread block 64 filter columns and one of S row splits (S chosen by
// the caller so that F / 64 * S is well over 132 blocks; fewer, wider
// column blocks re-read x and dy fewer times), recomputes dh for its columns
// from dy, W2 and hd (D multiply-adds per value, cheap at D 256), and
// keeps its dW1/dW2 columns in registers; (c) a last kernel sums the S
// float32 partials in a fixed order: no atomics, so the gradients are
// deterministic.
//
// What bounds it on an H100: operations.  At R = 30000, D = 256, F = 2048
// the forward does 4 R D F = 63 GFLOP (~64 us at 989 TFLOP/s) against
// ~16 MB of x, y and ~123 MB of hd; the backward 8 R D F (the dW pass's
// recompute adds 2 R D F more).  This first design issues mma.sync from
// operands in shared memory staged by 16-byte vector loads (no TMA, no
// wgmma, no pipelining between the staging and the products), so it is
// bound by the staging (every block re-reads the weights, and every dW
// block x and dy, from L2), shared-memory traffic and the
// synchronisation between stages.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "philox.cuh"

namespace {

using namespace neurst;

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 64;      // rows per tile (forward, dx pass)
constexpr int kCols = 64;      // filter columns per block (dW pass)
constexpr int kDwThreads = 512;  // 16 warps (dW pass)
constexpr int kPad = 8;        // shared-memory row padding, in elements

// Filter chunk of the forward and the dx pass: 64 for bf16; 32 for
// float32, whose operands take twice the shared memory.
template <typename T>
struct Chunk {
  static constexpr int value = 64;
};
template <>
struct Chunk<float> {
  static constexpr int value = 32;
};
// rows per tile of the dW pass
template <typename T>
struct DwRows {
  static constexpr int value = 64;
};
template <>
struct DwRows<float> {
  static constexpr int value = 32;
};

// ---------------------------------------------------------------- forward
template <typename T, int D>
struct FwdSmem {
  static constexpr int BF = Chunk<T>::value;
  static constexpr int kX = D + kPad, kW1 = D + kPad, kW2 = BF + kPad,
                       kH = BF + kPad;
  static constexpr size_t bytes =
      sizeof(T) * (kRows * kX + BF * kW1 + D * kW2 + kRows * kH);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ffn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1,
               const float* __restrict__ b1, const T* __restrict__ w2,
               const float* __restrict__ b2, T* __restrict__ y,
               T* __restrict__ hd, int rows, int filter,
               unsigned threshold, float scale, neurst::DropoutSite site) {
  using S = FwdSmem<T, D>;
  constexpr int BF = S::BF;
  constexpr int NT1 = BF / 16;  // n tiles of the hidden chunk per warp
  constexpr int NT2 = D / 16;   // n tiles of y per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [64][D]
  T* w1s = xs + kRows * S::kX;             // [BF][D]: W1 rows of the chunk
  T* w2s = w1s + BF * S::kW1;              // [D][BF]: W2 columns
  T* hs = w2s + D * S::kW2;                // [64][BF]: hd of the chunk

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3;  // rows 16 wm .. 16 wm + 15 of the tile
  const int wn = warp >> 2;  // column half
  const int r0 = blockIdx.x * kRows;

  load_tile<kThreads>(xs, S::kX, x, D, r0, 0, kRows, D, rows, tid);
  float acc2[NT2][4];
  zero(acc2);

  for (int f0 = 0; f0 < filter; f0 += BF) {
    __syncthreads();  // the previous chunk is consumed
    load_tile<kThreads>(w1s, S::kW1, w1, D, f0, 0, BF, D, filter, tid);
    load_tile<kThreads>(w2s, S::kW2, w2, filter, 0, f0, D, BF, D, tid);
    __syncthreads();

    float acc1[NT1][4];
    zero(acc1);
    const int n1 = wn * (BF / 2);
    warp_gemm<NT1>(acc1, xs + 16 * wm * S::kX, S::kX, w1s + n1 * S::kW1,
                   S::kW1, D, lane);
#pragma unroll
    for (int j = 0; j < NT1; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * wm + g + 8 * half;
        const int f = n1 + 8 * j + 2 * t;  // even: f and f + 1 share a
                                           // Philox call
        const unsigned long long idx =
            static_cast<unsigned long long>(r0 + r) * filter + f0 + f;
        float h[2];
        uint4 words = make_uint4(0u, 0u, 0u, 0u);
        if (threshold != 0u) words = neurst::dropout_words(idx >> 2, site);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          h[e] = fmaxf(acc1[j][2 * half + e] + b1[f0 + f + e], 0.f);
          if (threshold != 0u)
            h[e] = neurst::word_of(words, static_cast<int>(idx & 3) + e) >=
                           threshold
                       ? h[e] * scale
                       : 0.f;
          const T hv = from_float<T>(h[e]);
          hs[r * S::kH + f + e] = hv;
          if (hd != nullptr && r0 + r < rows) hd[idx + e] = hv;
        }
      }
    __syncthreads();
    warp_gemm<NT2>(acc2, hs + 16 * wm * S::kH, S::kH,
                   w2s + wn * (D / 2) * S::kW2, S::kW2, BF, lane);
  }

#pragma unroll
  for (int j = 0; j < NT2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 16 * wm + g + 8 * (i >> 1);
      const int d = wn * (D / 2) + 8 * j + 2 * t + (i & 1);
      if (r < rows)
        y[static_cast<long long>(r) * D + d] =
            from_float<T>(acc2[j][i] + b2[d]);
    }
}

// ---------------------------------------------------------------- dx pass
template <typename T, int D>
struct DxSmem {
  static constexpr int BF = Chunk<T>::value;
  static constexpr int kDy = D + kPad, kW2t = D + kPad, kH = BF + kPad,
                       kW1t = BF + kPad;
  static constexpr size_t bytes =
      sizeof(T) * (kRows * kDy + BF * kW2t + kRows * kH + D * kW1t);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ffn_dx_kernel(const T* __restrict__ w1, const T* __restrict__ w2,
              const T* __restrict__ hd, const T* __restrict__ dy,
              T* __restrict__ dx, int rows, int filter, float scale) {
  using S = DxSmem<T, D>;
  constexpr int BF = S::BF;
  constexpr int NT1 = BF / 16;
  constexpr int NT2 = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* dys = reinterpret_cast<T*>(smem_raw);  // [64][D]
  T* w2t = dys + kRows * S::kDy;            // [BF][D]: W2^T rows
  T* hs = w2t + BF * S::kW2t;               // [64][BF]: hd, then round(dh)
  T* w1t = hs + kRows * S::kH;              // [D][BF]: W1^T

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int r0 = blockIdx.x * kRows;

  load_tile<kThreads>(dys, S::kDy, dy, D, r0, 0, kRows, D, rows, tid);
  float acc2[NT2][4];
  zero(acc2);

  for (int f0 = 0; f0 < filter; f0 += BF) {
    __syncthreads();
    load_tile_t<kThreads>(w2t, S::kW2t, w2, filter, 0, f0, D, BF, D, tid);
    load_tile<kThreads>(hs, S::kH, hd, filter, r0, f0, kRows, BF, rows, tid);
    load_tile_t<kThreads>(w1t, S::kW1t, w1, D, f0, 0, BF, D, filter, tid);
    __syncthreads();

    // dhd = dy W2[:, chunk]; dh = (hd > 0) dhd * scale, in place of hd
    float acc1[NT1][4];
    zero(acc1);
    const int n1 = wn * (BF / 2);
    warp_gemm<NT1>(acc1, dys + 16 * wm * S::kDy, S::kDy,
                   w2t + n1 * S::kW2t, S::kW2t, D, lane);
#pragma unroll
    for (int j = 0; j < NT1; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * wm + g + 8 * (i >> 1);
        const int f = n1 + 8 * j + 2 * t + (i & 1);
        T* h = hs + r * S::kH + f;
        *h = from_float<T>(to_float(*h) > 0.f ? acc1[j][i] * scale : 0.f);
      }
    __syncthreads();
    warp_gemm<NT2>(acc2, hs + 16 * wm * S::kH, S::kH,
                   w1t + wn * (D / 2) * S::kW1t, S::kW1t, BF, lane);
  }

#pragma unroll
  for (int j = 0; j < NT2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 16 * wm + g + 8 * (i >> 1);
      const int d = wn * (D / 2) + 8 * j + 2 * t + (i & 1);
      if (r < rows)
        dx[static_cast<long long>(r) * D + d] = from_float<T>(acc2[j][i]);
    }
}

// ---------------------------------------------------------------- dW pass
template <typename T, int D>
struct DwSmem {
  static constexpr int BR = DwRows<T>::value;
  static constexpr int kW2t = D + kPad, kDy = D + kPad, kT = BR + kPad;
  static constexpr size_t bytes =
      sizeof(T) * (kCols * kW2t + BR * kDy + 2 * D * kT + 2 * kCols * kT) +
      sizeof(float) * kCols * kT;
};

// Block (c, s): filter columns 64 c .. 64 c + 63 over row split s, 16
// warps.  Partials (float32): dw1p [S][F][D], dw2p [S][D][F], db1p [S][F]
// and, from the blocks of column tile 0, db2p [S][D].
template <typename T, int D>
__global__ void __launch_bounds__(kDwThreads)
ffn_dw_kernel(const T* __restrict__ x, const T* __restrict__ w2,
              const T* __restrict__ hd, const T* __restrict__ dy,
              float* __restrict__ dw1p, float* __restrict__ dw2p,
              float* __restrict__ db1p, float* __restrict__ db2p, int rows,
              int filter, float scale) {
  using S = DwSmem<T, D>;
  constexpr int BR = S::BR;
  constexpr int NTA = BR / 32;  // n tiles (rows) per warp of dh^T
  constexpr int NTB = D / 32;   // n tiles (model dims) per warp of dW
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w2t = reinterpret_cast<T*>(smem_raw);  // [64 f][D]
  T* dys = w2t + kCols * S::kW2t;           // [BR][D]
  T* dyt = dys + BR * S::kDy;               // [D][BR]
  T* xt = dyt + D * S::kT;                  // [D][BR]
  T* hdt = xt + D * S::kT;                  // [64 f][BR]
  T* dht = hdt + kCols * S::kT;             // [64 f][BR]: round(dh)^T
  float* dhf = reinterpret_cast<float*>(dht + kCols * S::kT);  // unrounded

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3;   // filter rows 16 wm .. of the block's 64
  const int wn = warp >> 2;  // quarter of the n range
  const int f0 = blockIdx.x * kCols;
  const int split = blockIdx.y, splits = gridDim.y;
  const int tiles = (rows + BR - 1) / BR;
  const int per_split = (tiles + splits - 1) / splits;
  const int tile_end = min(tiles, (split + 1) * per_split);

  load_tile_t<kDwThreads>(w2t, S::kW2t, w2, filter, 0, f0, D, kCols, D,
                             tid);
  float acc_w1[NTB][4], acc_w2[NTB][4];
  zero(acc_w1);
  zero(acc_w2);
  float db1 = 0.f, db2 = 0.f;  // column sums: filter col tid (< 64), dim tid

  for (int tile = split * per_split; tile < tile_end; ++tile) {
    const int r0 = tile * BR;
    __syncthreads();
    constexpr int V = Vec<T>::n;
    for (int i = tid; i < BR * (D / V); i += kDwThreads) {
      const int r = i % BR, d = (i / BR) * V;
      const uint4 v = load_vec(dy, D, r0, r, d, rows);
      *reinterpret_cast<uint4*>(dys + r * S::kDy + d) = v;
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int j = 0; j < V; ++j) dyt[(d + j) * S::kT + r] = e[j];
    }
    load_tile_t<kDwThreads>(xt, S::kT, x, D, r0, 0, BR, D, rows, tid);
    load_tile_t<kDwThreads>(hdt, S::kT, hd, filter, r0, f0, BR, kCols,
                               rows, tid);
    __syncthreads();

    // dh^T [64 f][BR r] = W2^T[chunk] dy^T, masked by hd > 0
    float acc_a[NTA][4];
    zero(acc_a);
    const int na = wn * (BR / 4);
    warp_gemm<NTA>(acc_a, w2t + 16 * wm * S::kW2t, S::kW2t,
                   dys + na * S::kDy, S::kDy, D, lane);
#pragma unroll
    for (int j = 0; j < NTA; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = 16 * wm + g + 8 * (i >> 1);
        const int r = na + 8 * j + 2 * t + (i & 1);
        const float dh =
            to_float(hdt[f * S::kT + r]) > 0.f ? acc_a[j][i] * scale : 0.f;
        dhf[f * S::kT + r] = dh;
        dht[f * S::kT + r] = from_float<T>(dh);
      }
    __syncthreads();

    // dW2^T [64 f][D] += hd^T dy ; dW1 [64 f][D] += round(dh)^T x
    const int nb = wn * (D / 4);
    warp_gemm<NTB>(acc_w2, hdt + 16 * wm * S::kT, S::kT, dyt + nb * S::kT,
                   S::kT, BR, lane);
    warp_gemm<NTB>(acc_w1, dht + 16 * wm * S::kT, S::kT, xt + nb * S::kT,
                   S::kT, BR, lane);
    // the bias sums, row by row in a fixed order
    if (tid < kCols)
      for (int r = 0; r < BR; ++r) db1 += dhf[tid * S::kT + r];
    if (blockIdx.x == 0 && tid < D)
      for (int r = 0; r < BR; ++r) db2 += to_float(dys[r * S::kDy + tid]);
  }

  const long long fd = static_cast<long long>(filter) * D;
#pragma unroll
  for (int j = 0; j < NTB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = f0 + 16 * wm + g + 8 * (i >> 1);
      const int d = wn * (D / 4) + 8 * j + 2 * t + (i & 1);
      dw1p[split * fd + static_cast<long long>(f) * D + d] = acc_w1[j][i];
      dw2p[split * fd + static_cast<long long>(d) * filter + f] =
          acc_w2[j][i];
    }
  if (tid < kCols) db1p[static_cast<long long>(split) * filter + f0 + tid] =
      db1;
  if (blockIdx.x == 0 && tid < D) db2p[split * D + tid] = db2;
}

// dW1, dW2 (operand dtype) and db1, db2 (float32): the sums of the S
// partials, in split order
template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_dw_sum_kernel(const float* __restrict__ dw1p,
                  const float* __restrict__ dw2p,
                  const float* __restrict__ db1p,
                  const float* __restrict__ db2p, T* __restrict__ dw1,
                  T* __restrict__ dw2, float* __restrict__ db1,
                  float* __restrict__ db2, int filter, int dim, int splits) {
  const long long fd = static_cast<long long>(filter) * dim;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < fd; e += stride) {
    float s1 = 0.f, s2 = 0.f;
    for (int s = 0; s < splits; ++s) {
      s1 += dw1p[s * fd + e];
      s2 += dw2p[s * fd + e];
    }
    dw1[e] = from_float<T>(s1);
    dw2[e] = from_float<T>(s2);
    if (e < filter) {
      float b = 0.f;
      for (int s = 0; s < splits; ++s) b += db1p[s * filter + e];
      db1[e] = b;
    }
    if (e < dim) {
      float b = 0.f;
      for (int s = 0; s < splits; ++s) b += db2p[s * dim + e];
      db2[e] = b;
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t launch_fwd(const void* x, const void* w1, const float* b1,
                       const void* w2, const float* b2, void* y, void* hd,
                       int rows, int filter, unsigned threshold, float scale,
                       const neurst::DropoutSite& site, cudaStream_t s) {
  auto kernel = ffn_fwd_kernel<T, D>;
  const size_t bytes = FwdSmem<T, D>::bytes;
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(rows + kRows - 1) / kRows, kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, static_cast<T*>(y), static_cast<T*>(hd),
      rows, filter, threshold, scale, site);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dx(const void* w1, const void* w2, const void* hd,
                      const void* dy, void* dx, int rows, int filter,
                      float scale, cudaStream_t s) {
  auto kernel = ffn_dx_kernel<T, D>;
  const size_t bytes = DxSmem<T, D>::bytes;
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(rows + kRows - 1) / kRows, kThreads, bytes, s>>>(
      static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const T*>(hd), static_cast<const T*>(dy),
      static_cast<T*>(dx), rows, filter, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dw(const void* x, const void* w2, const void* hd,
                      const void* dy, float* partials, int rows, int filter,
                      int splits, float scale, cudaStream_t s) {
  auto kernel = ffn_dw_kernel<T, D>;
  const size_t bytes = DwSmem<T, D>::bytes;
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const long long fd = static_cast<long long>(filter) * D;
  float* dw1p = partials;
  float* dw2p = dw1p + splits * fd;
  float* db1p = dw2p + splits * fd;
  float* db2p = db1p + static_cast<long long>(splits) * filter;
  kernel<<<dim3(filter / kCols, splits), kDwThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w2),
      static_cast<const T*>(hd), static_cast<const T*>(dy), dw1p, dw2p, db1p,
      db2p, rows, filter, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw_sum(const float* partials, void* dw1, void* dw2,
                          float* db1, float* db2, int filter, int dim,
                          int splits, cudaStream_t s) {
  const long long fd = static_cast<long long>(filter) * dim;
  const float* dw1p = partials;
  const float* dw2p = dw1p + splits * fd;
  const float* db1p = dw2p + splits * fd;
  const float* db2p = db1p + static_cast<long long>(splits) * filter;
  const long long blocks = (fd + kThreads - 1) / kThreads;
  ffn_dw_sum_kernel<T><<<static_cast<int>(blocks < 132 * 8 ? blocks
                                                            : 132 * 8),
                         kThreads, 0, s>>>(
      dw1p, dw2p, db1p, db2p, static_cast<T*>(dw1), static_cast<T*>(dw2), db1,
      db2, filter, dim, splits);
  return cudaGetLastError();
}

bool bad_args(int rows, int filter, int dim, int dtype) {
  return rows <= 0 || filter <= 0 || filter % 64 != 0 ||
         dim != 256 || (dtype != 0 && dtype != 1);
}

}  // namespace

// Every entry point returns the cudaError_t of its launch (0 on success).
// dtype: 0 = float32, 1 = bfloat16.  `hd` may be null (inference).
// threshold 0 = no dropout; otherwise the FFN site (k0, k1, stream_id,
// micro) and scale = 1 / (1 - realized rate).
extern "C" int neurst_ffn_fwd(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* y,
                              void* hd, int rows, int filter, int dim,
                              unsigned threshold, float scale, unsigned k0,
                              unsigned k1, unsigned stream_id,
                              unsigned micro, int dtype, void* stream) {
  if (bad_args(rows, filter, dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const neurst::DropoutSite site{k0, k1, stream_id, micro};
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch_fwd<float, 256>(x, w1, b1f, w2, b2f, y, hd, rows,
                                          filter, threshold, scale, site, s)
                 : launch_fwd<__nv_bfloat16, 256>(x, w1, b1f, w2, b2f, y, hd,
                                                  rows, filter, threshold,
                                                  scale, site, s);
  return static_cast<int>(err);
}

// dx [R, D] from hd and dy; scale = 1 / (1 - realized rate), 1 without
// dropout.
extern "C" int neurst_ffn_dx(const void* w1, const void* w2, const void* hd,
                             const void* dy, void* dx, int rows, int filter,
                             int dim, float scale, int dtype, void* stream) {
  if (bad_args(rows, filter, dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch_dx<float, 256>(w1, w2, hd, dy, dx, rows, filter,
                                         scale, s)
                 : launch_dx<__nv_bfloat16, 256>(w1, w2, hd, dy, dx, rows,
                                                 filter, scale, s);
  return static_cast<int>(err);
}

// The float32 partials of `splits` row splits into `partials`
// (2 splits F D + splits (F + D) floats).
extern "C" int neurst_ffn_dw(const void* x, const void* w2, const void* hd,
                             const void* dy, void* partials, int rows,
                             int filter, int dim, int splits, float scale,
                             int dtype, void* stream) {
  if (bad_args(rows, filter, dim, dtype) || splits <= 0 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch_dw<float, 256>(x, w2, hd, dy, p, rows, filter,
                                         splits, scale, s)
                 : launch_dw<__nv_bfloat16, 256>(x, w2, hd, dy, p, rows,
                                                 filter, splits, scale, s);
  return static_cast<int>(err);
}

extern "C" int neurst_ffn_dw_sum(const void* partials, void* dw1, void* dw2,
                                 void* db1, void* db2, int filter, int dim,
                                 int splits, int dtype, void* stream) {
  if (bad_args(1, filter, dim, dtype) || splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(partials);
  float* db1f = static_cast<float*>(db1);
  float* db2f = static_cast<float*>(db2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch_dw_sum<float>(p, dw1, dw2, db1f, db2f, filter, dim,
                                        splits, s)
                 : launch_dw_sum<__nv_bfloat16>(p, dw1, dw2, db1f, db2f,
                                                filter, dim, splits, s);
  return static_cast<int>(err);
}
