// Fused position-wise FFN, y = dropout(relu(x W1^T + b1)) W2^T + b2, for
// Hopper (sm_90a), plain C interface: a forward (one launch, or two where
// a filter split sums its partials) and a backward in three launches (a
// dx pass over row tiles, a dW pass, and a deterministic sum of the dW
// pass's row splits and of the bias partials).  bf16 products run on the
// tensor cores (warp-level mma.sync.m16n8k16, float32 accumulation);
// float32, which only the card-vs-CPU checks run, keeps FMA loops.
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
// [D] float32.  D is 256 or 512 (the dims at which the JAX package's
// gate fuses), F a multiple of 64 (of 128 for bf16).
//
// Why this shape on an H100: the TPU kernel keeps W1, W2 and the float32
// dW1/dW2 (8 MB at D 256, F 2048) resident in VMEM across a sequential
// grid.  A block here has 227 KB of shared memory and blocks run in no
// order, so the forward and the dx pass walk row tiles and stream W1/W2
// through shared memory in 64-column filter chunks (from L2), keeping y
// (or dx) in registers and only a chunk of the hidden in shared memory;
// the dW pass splits its rows over blocks, and a last kernel sums the
// float32 partials in a fixed order: no atomics, so two calls give the
// same bits.
//
// What bounds it on an H100: operations.  At R = 30000, D = 256, F = 2048
// the forward does 4 R D F = 63 GFLOP (~64 us at 989 TFLOP/s) against
// ~16 MB of x, y and ~123 MB of hd; the backward 8 R D F (~127 us).
//
// The bf16 kernels (the sections below give their tiles): every operand
// arrives by 16-byte cp.async into 128-byte-swizzled tiles, in a ring
// deep enough that the next chunk's copies run under this chunk's
// products, so no copy waits between two barriers; fragments come by
// ldmatrix, whose .trans reads the untransposed tiles in the other
// orientation, so nothing is transposed in shared memory.  The forward
// and the dx pass are two chained products through a 64-column chunk of
// the hidden with an elementwise step between them.  The forward takes
// 128 rows a block, so the 2 MB of weights are re-read from L2 once per
// 128 rows, and splits the filter over S blocks a row tile where the
// tiles alone would not fill the card; its hd leaves by 16-byte stores
// from the chunk's tile, and each Philox group is drawn once.  The dx
// pass takes 128 rows a block (64 below one wave of them).  It writes
// round(dh) [R, F] once, so the dW pass is two plain products over rows,
// dW1 = round(dh)^T x and dW2 = dy^T hd (csrc/row_product.cuh), with no
// recompute of dh, and its grid of 128 x 256 tiles x row splits fills the
// card's resident blocks (one an SM) once.  The bias sums come from the
// accumulator fragments by warp shuffles in a fixed order, then one warp
// a column in the sum kernel.  The copies' addresses are recomputed every
// chunk (`opaque`, mma.cuh): held, they take the registers the
// accumulators need.  What bounds them: shared-memory reads of the
// fragments (~384 KB a 64-column chunk) and the latency of each block's
// chunk loop, whose two barriers keep 8 warps an SM in step; in the dW
// pass, the operand traffic from L2 (~740 MB a call at 30000 rows) and
// device memory (dh and hd, 2 x 123 MB, the price of not recomputing dh).
// wgmma, which reads its operands from shared memory without the register
// file, is the next step.  At D 512 the forward and the dx pass take
// 64-row tiles and hold one W1 and one W2 chunk in place of a ring (see
// the D 512 section); the dW pass is the same two products over rows.
//
// The float32 kernels keep FMA loops: the forward and the dx pass over
// 64-row tiles (32-column filter chunks, 16 at D 512); the dW pass gives
// each 512-thread block 64 filter columns, one of S row splits and (at
// D 512) one half of the model dims, recomputes dh for its columns from
// dy, W2 and hd, keeps its dW1/dW2 columns in registers and sums db1
// (and, in column tile 0, db2) row by row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "philox.cuh"
#include "row_product.cuh"

namespace {

using namespace neurst;

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 64;      // rows per tile (forward, float32 dx pass)
constexpr int kCols = 64;      // filter columns per block (float32 dW pass)
constexpr int kDwThreads = 512;  // 16 warps (float32 dW pass)
constexpr int kPad = 8;        // shared-memory row padding, in elements

// Filter chunk of the float32 forward and dx pass (32: float32 operands
// take twice the shared memory of the bf16 kernels' 64; 16 at D 512,
// where a [64][D] tile and W1/W2 chunks of 32 would not fit in 227 KB)
template <int D>
constexpr int kChunkF32 = D > 256 ? 16 : 32;
// rows per tile of the float32 dW pass
constexpr int kDwRowsF32 = 32;

// ---------------------------------------- float32 forward: FMA loops
template <typename T, int D>
struct FwdSmem {
  static constexpr int BF = kChunkF32<D>;
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

// -------------------------------------------- float32 dx pass: FMA loops
template <typename T, int D>
struct DxSmem {
  static constexpr int BF = kChunkF32<D>;
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

// ------------------------------ bf16 chunk steps shared by D 256 and 512
//
// A chunk's hidden [kRows][64] lives in a swizzled tile between the two
// products; P1's accumulators give each thread rows 16 (kMt1 wm + mi) + g
// and + 8 (mi < kMt1, the 4 row warps wm) and columns fc + 8 nt + 2 t and
// + 1 (nt < 4; fc = 32 wn, the warp's first column of the chunk, for the
// 2 column warps wn).

// The chunk's keep bits, bit 4 (kMt1 nt + mi) + 2 hh + e for row
// r + 8 hh, column fc + 8 nt + 2 t + e: drawn ahead of P1, on which
// they do not depend, so the scheduler can run the Philox rounds between
// its products.  The group of columns f & ~3 .. + 3 is drawn once: the
// even lane (words 0, 1) draws it for row r, the odd one (words 2, 3) for
// r + 8, and each hands the other lane the two words it needs.
template <int kMt1>
__device__ __forceinline__ uint32_t draw_keep(
    int r0, int f0, int filter, int wm, int fc, int g, int t,
    unsigned threshold, const neurst::DropoutSite& site) {
  static_assert(kMt1 <= 2, "a 32-bit keep word");
  uint32_t keep = 0u;
  const int odd = t & 1;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int mi = 0; mi < kMt1; ++mi) {
      const int f = fc + 8 * nt + 2 * t;
      const int r = 16 * (kMt1 * wm + mi) + g;
      const unsigned long long idx =
          static_cast<unsigned long long>(r0 + r + 8 * odd) * filter + f0 +
          (f & ~3);
      const uint4 w = neurst::dropout_words(idx >> 2, site);
      const unsigned got0 = __shfl_xor_sync(0xFFFFFFFFu, odd ? w.x : w.z, 1);
      const unsigned got1 = __shfl_xor_sync(0xFFFFFFFFu, odd ? w.y : w.w, 1);
      const unsigned words[4] = {odd ? got0 : w.x, odd ? got1 : w.y,
                                 odd ? w.z : got0, odd ? w.w : got1};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        keep |= static_cast<uint32_t>(words[q] >= threshold)
                << (4 * (kMt1 * nt + mi) + q);
    }
  return keep;
}

// hd = round(dropout(relu(z1 + b1))) from P1's accumulators into the
// chunk's tile
template <int kMt1, bool kDrop>
__device__ __forceinline__ void store_hidden(
    unsigned char* tile, const float (&acc1)[kMt1][4][4],
    const float* __restrict__ b1, int f0, uint32_t keep, float scale,
    int wm, int fc, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int f = fc + 8 * nt + 2 * t;  // f, f + 1: one word
    const float bias0 = b1[f0 + f], bias1 = b1[f0 + f + 1];
#pragma unroll
    for (int mi = 0; mi < kMt1; ++mi) {
      const int r = 16 * (kMt1 * wm + mi) + g;  // rows r and r + 8
      float h[2][2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        h[hh][0] = fmaxf(acc1[mi][nt][2 * hh] + bias0, 0.f);
        h[hh][1] = fmaxf(acc1[mi][nt][2 * hh + 1] + bias1, 0.f);
      }
      if constexpr (kDrop) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            h[hh][e] = (keep >> (4 * (kMt1 * nt + mi) + 2 * hh + e)) & 1u
                           ? h[hh][e] * scale
                           : 0.f;
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(tile + swz(r + 8 * hh, f >> 3) +
                                     (f & 7) * 2) =
            pack_bf16(h[hh][0], h[hh][1]);
    }
  }
}

// dh = (hd > 0) dhd * scale from P1's accumulators, written over the
// chunk's hd tile as round(dh); the column sums of the unrounded dh over
// this warp's rows go to red[wm][64] (warp shuffles, in a fixed order)
template <int kMt1>
__device__ __forceinline__ void store_dh(unsigned char* tile,
                                         const float (&acc1)[kMt1][4][4],
                                         float scale, float* red, int wm,
                                         int fc, int g, int t) {
  float cs[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    cs[nt][0] = cs[nt][1] = 0.f;
#pragma unroll
    for (int mi = 0; mi < kMt1; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * (kMt1 * wm + mi) + g + 8 * h;
        const int f = fc + 8 * nt + 2 * t;  // f, f + 1: one word
        uint32_t* p =
            reinterpret_cast<uint32_t*>(tile + swz(r, f >> 3) + (f & 7) * 2);
        const uint32_t hv = *p;
        const float d0 = __uint_as_float(hv << 16) > 0.f
                             ? acc1[mi][nt][2 * h] * scale
                             : 0.f;
        const float d1 = __uint_as_float(hv & 0xFFFF0000u) > 0.f
                             ? acc1[mi][nt][2 * h + 1] * scale
                             : 0.f;
        cs[nt][0] += d0;
        cs[nt][1] += d1;
        *p = pack_bf16(d0, d1);
      }
  }
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        cs[nt][e] += __shfl_xor_sync(0xFFFFFFFFu, cs[nt][e], o);
  if (g == 0)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        red[wm * 64 + fc + 8 * nt + 2 * t + e] = cs[nt][e];
}

// rows r0 .. r0 + kRows - 1 (those below `rows`) of a chunk's swizzled
// [kRows][64] tile to dst [R][ld] at columns f0 .., by 16-byte stores
template <int kRows, int kThreads>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* dst, int ld,
                                            int r0, int f0, int rows,
                                            const unsigned char* tile,
                                            int tid) {
#pragma unroll
  for (int q = 0; q < kRows * 8 / kThreads; ++q) {
    const int i = tid + q * kThreads;
    const int r = i >> 3, c = i & 7;
    if (r0 + r < rows)
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(r0 + r) * ld +
                                f0 + 8 * c) =
          *reinterpret_cast<const uint4*>(tile + swz(r, c));
  }
}

// The forward's y [R][kD] (bf16, + b2) or, with filter splits, this
// split's float32 partial from P2's accumulators: rows 16 (kMt2 wm2 + mi)
// + g and + 8 of the tile, dims 8 kNt wn2 + 8 nt + 2 t and + 1
template <int kD, int kMt2, int kNt>
__device__ __forceinline__ void store_y(__nv_bfloat16* __restrict__ y,
                                        float* __restrict__ yp,
                                        const float* __restrict__ b2,
                                        const float (&acc2)[kMt2][kNt][4],
                                        int r0, int rows, int wm2, int wn2,
                                        int g, int t) {
  const bool whole = gridDim.y == 1;
  float* part = yp + static_cast<long long>(blockIdx.y) * rows * kD;
#pragma unroll
  for (int mi = 0; mi < kMt2; ++mi)
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 16 * (kMt2 * wm2 + mi) + g + 8 * hh;
        const int d = 8 * kNt * wn2 + 8 * nt + 2 * t;
        if (r >= rows) continue;
        const long long e = static_cast<long long>(r) * kD + d;
        const float v0 = acc2[mi][nt][2 * hh], v1 = acc2[mi][nt][2 * hh + 1];
        if (whole)
          *reinterpret_cast<uint32_t*>(y + e) =
              pack_bf16(v0 + b2[d], v1 + b2[d + 1]);
        else
          *reinterpret_cast<float2*>(part + e) = make_float2(v0, v1);
      }
}

// dx [R][kD] (bf16) from the dx pass's P2 accumulators, laid out as y's
template <int kD, int kMt2, int kNt>
__device__ __forceinline__ void store_dx(__nv_bfloat16* __restrict__ dx,
                                         const float (&acc2)[kMt2][kNt][4],
                                         int r0, int rows, int wm2, int wn2,
                                         int g, int t) {
#pragma unroll
  for (int mi = 0; mi < kMt2; ++mi)
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 16 * (kMt2 * wm2 + mi) + g + 8 * h;
        const int d = 8 * kNt * wn2 + 8 * nt + 2 * t;
        if (r < rows)
          *reinterpret_cast<uint32_t*>(dx + static_cast<long long>(r) * kD +
                                       d) =
              pack_bf16(acc2[mi][nt][2 * h], acc2[mi][nt][2 * h + 1]);
      }
}

// db2 partial of a tile: column d of dy, for d = tid, tid + kThreads, ..,
// summed over the tile's rows in order (rows >= R were staged as zero)
// from dy's swizzled [kRows][64] panels
template <int kD, int kRows, int kThreads>
__device__ __forceinline__ void store_db2(float* __restrict__ db2p,
                                          const unsigned char* dy_tile,
                                          int tile, int tid) {
  for (int d = tid; d < kD; d += kThreads) {
    const unsigned char* col =
        dy_tile + (d >> 6) * (kRows * 128) + (d & 7) * 2;
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < kRows; ++r)
      s += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
          col + swz(r, (d & 63) >> 3)));
    db2p[static_cast<long long>(tile) * kD + d] = s;
  }
}

// ------------------------------------------- bf16 backward: tensor cores
//
// dx pass: one block of 8 warps per 128-row tile (64 below one wave of
// them, see DxTile); dy [128][256] comes in
// once, and the filter streams in 64-column chunks (W2[:, chunk] [256][64],
// W1[chunk, :] [64][256], hd [128][64]) through a 2-stage cp.async ring,
// so chunk j + 1's copies overlap chunk j's products.  Per chunk:
//   P1  dhd [128][64] = dy W2[:, chunk]: warps 4 (rows) x 2 (columns),
//       32 x 32 each; dy by ldsm_a, W2 (a [k][n] tile) by ldsm_trans;
//   dh = (hd > 0) ? dhd * scale : 0 from the accumulators, written over
//       hd in shared memory as round(dh), which then goes out to the dh
//       buffer [R][F] by 16-byte stores; the chunk's db1 partial sums the
//       unrounded dh by warp shuffles, then the 4 row warps, in a fixed
//       order;
//   P2  dx [128][256] += round(dh) W1[chunk, :]: warps 2 x 4, 64 x 64
//       each (128 accumulators a thread for the whole filter); dh by
//       ldsm_a, W1 by ldsm_trans.
// Its last step sums the tile's dy columns into the db2 partial.  Of the
// layouts measured (8 or 16 warps, k loops unrolled 1-16), 8 warps with
// every loop unrolled ran fastest: the fewest fragment re-reads (the
// weights by 4 or 2 row warps, not 8 or 4).

constexpr int kDim = 256;  // D of the D 256 bf16 kernels
constexpr int kDxWarps = 8;
constexpr int kDxThreads = 32 * kDxWarps;
constexpr int kDxChunk = 64;
constexpr int kW2cBytes = kDim * kDxChunk * 2;         // 1 panel
constexpr int kW1cBytes = kDxChunk * kDim * 2;         // 4 panels
constexpr int kW1cPanel = kDxChunk * 128;
constexpr int kDxStages = 2;
// P1: row warps x 2 column warps (32 filter columns each); P2: row warps
// x 4 column warps (64 dims each)
constexpr int kDxRowWarps1 = kDxWarps / 2;
constexpr int kDxRowWarps2 = kDxWarps / 4;
constexpr int kDxRed = kDxRowWarps1 * kDxChunk * 4;  // db1 partial sums

// The dx pass's tile of kRows rows: 128, or 64 where 128-row tiles would
// not fill the card once (the decoder's 6000 rows: 47 blocks for 132
// SMs); the weights are then re-read twice as often, from L2.
template <int kRows>
struct DxTile {
  static constexpr int kDyBytes = kRows * kDim * 2;     // 4 panels
  static constexpr int kDyPanel = kRows * 128;
  static constexpr int kHdBytes = kRows * kDxChunk * 2;  // 1 panel
  static constexpr int kStage = kW2cBytes + kW1cBytes + kHdBytes;
  static constexpr int kMt1 = kRows / kDxRowWarps1 / 16;  // m tiles, P1
  static constexpr int kMt2 = kRows / kDxRowWarps2 / 16;  // m tiles, P2
  static constexpr size_t kSmem = kDyBytes + kDxStages * kStage + kDxRed;
};

template <int kDxRows>
__global__ void __launch_bounds__(kDxThreads, 1)
ffn_dx_bf16_kernel(const __nv_bfloat16* __restrict__ w1,
                   const __nv_bfloat16* __restrict__ w2,
                   const __nv_bfloat16* __restrict__ hd,
                   const __nv_bfloat16* __restrict__ dy,
                   __nv_bfloat16* __restrict__ dx,
                   __nv_bfloat16* __restrict__ dh, float* __restrict__ db1p,
                   float* __restrict__ db2p, int rows, int filter,
                   float scale) {
  using Tile = DxTile<kDxRows>;
  constexpr int kDyBytes = Tile::kDyBytes, kDyPanel = Tile::kDyPanel;
  constexpr int kDxStage = Tile::kStage;
  constexpr int kDxMt1 = Tile::kMt1, kDxMt2 = Tile::kMt2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const uint32_t dy_s = base;
  float* red = reinterpret_cast<float*>(smem + kDyBytes +
                                        kDxStages * kDxStage);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // P1: rows 16 kDxMt1 wm, columns 32 wn; P2: rows 16 kDxMt2 wm2, dims
  // 64 wn2
  const int wm = warp % kDxRowWarps1, wn = warp / kDxRowWarps1;
  const int wm2 = warp % kDxRowWarps2, wn2 = warp / kDxRowWarps2;
  const int tile = blockIdx.x, r0 = tile * kDxRows;
  const int chunks = filter / kDxChunk;

  // The copies' addresses are recomputed from an opaque thread index
  // every chunk: held across the loop, their ten pointers and offsets
  // would take the registers the accumulators need.
  auto load_chunk = [&](int j) {
    const int ot = opaque(tid);
    const uint32_t st = base + kDyBytes + (j % kDxStages) * kDxStage;
    const int f0 = j * kDxChunk;
    load_panels_async<kDxThreads, kDim, kDxChunk>(st, w2, filter, 0, f0,
                                                  kDim, ot);
    load_panels_async<kDxThreads, kDxChunk, kDim>(st + kW2cBytes, w1, kDim,
                                                  f0, 0, filter, ot);
    load_panels_async<kDxThreads, kDxRows, kDxChunk>(
        st + kW2cBytes + kW1cBytes, hd, filter, r0, f0, rows, ot);
  };
  load_panels_async<kDxThreads, kDxRows, kDim>(dy_s, dy, kDim, r0, 0, rows,
                                               tid);
  load_chunk(0);
  cp_async_commit();

  float acc2[kDxMt2][8][4];
#pragma unroll
  for (int mi = 0; mi < kDxMt2; ++mi) zero(acc2[mi]);

  for (int j = 0; j < chunks; ++j) {
    cp_async_wait<0>();  // chunk j (and dy) landed
    __syncthreads();     // ... for every thread; chunk j - 1 is consumed
    if (j + 1 < chunks) load_chunk(j + 1);
    cp_async_commit();
    const int st_off = kDyBytes + (j % kDxStages) * kDxStage;
    const uint32_t w2c = base + st_off;
    const uint32_t w1c = w2c + kW2cBytes;
    const int hs_off = st_off + kW2cBytes + kW1cBytes;
    const uint32_t hs = base + hs_off;
    const int f0 = j * kDxChunk;

    // P1: dhd [128 r][64 f] = dy W2[:, chunk]
    float acc1[kDxMt1][4][4];
#pragma unroll
    for (int mi = 0; mi < kDxMt1; ++mi) zero(acc1[mi]);
#pragma unroll
    for (int kk = 0; kk < kDim / 16; ++kk) {
      uint32_t a[kDxMt1][4];
#pragma unroll
      for (int mi = 0; mi < kDxMt1; ++mi)
        ldsm_a(a[mi], dy_s + (kk >> 2) * kDyPanel,
               16 * (kDxMt1 * wm + mi), 2 * (kk & 3), lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_trans(b, w2c, 16 * kk, 4 * wn + 2 * np, lane);
#pragma unroll
        for (int mi = 0; mi < kDxMt1; ++mi) {
          mma_bf16(acc1[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc1[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }

    // dh = (hd > 0) dhd * scale over hd, rounded; db1 from the unrounded
    store_dh(smem + hs_off, acc1, scale, red, wm, 32 * wn, g, t);
    __syncthreads();  // round(dh) and the db1 sums are in place

    if (tid < kDxChunk) {
      float b = 0.f;
#pragma unroll
      for (int w = 0; w < kDxRowWarps1; ++w) b += red[w * kDxChunk + tid];
      db1p[static_cast<long long>(tile) * filter + f0 + tid] = b;
    }
    store_chunk<kDxRows, kDxThreads>(dh, filter, r0, f0, rows, smem + hs_off,
                                     tid);

    // P2: dx [128 r][256 d] += round(dh) W1[chunk, :]
#pragma unroll
    for (int kk = 0; kk < kDxChunk / 16; ++kk) {
      uint32_t a[kDxMt2][4];
#pragma unroll
      for (int mi = 0; mi < kDxMt2; ++mi)
        ldsm_a(a[mi], hs, 16 * (kDxMt2 * wm2 + mi), 2 * kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_trans(b, w1c + wn2 * kW1cPanel, 16 * kk, 2 * np, lane);
#pragma unroll
        for (int mi = 0; mi < kDxMt2; ++mi) {
          mma_bf16(acc2[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc2[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  store_dx<kDim>(dx, acc2, r0, rows, wm2, wn2, g, t);
  store_db2<kDim, kDxRows, kDxThreads>(db2p, smem, tile, tid);
}

// ------------------------------------------- bf16 forward: tensor cores
//
// One block of 8 warps per (128-row tile, filter split): x [128][256]
// comes in once, and the split's filter streams in 64-column chunks
// (W1[chunk, :] [64][256], W2[:, chunk] [256][64]) through a 2-stage
// cp.async ring, so chunk j + 1's copies overlap chunk j's products.
// Per chunk:
//   P1  z1 [128][64] = x W1[chunk, :]^T: warps 4 (rows) x 2 (columns),
//       32 x 32 each; x by ldsm_a, W1 (an [n][k] tile) by ldsm_b;
//   hd = round(dropout(relu(z1 + b1))) from the accumulators into a
//       swizzled [128][64] tile, with keep bits drawn ahead of P1: lanes
//       2i and 2i + 1 hold the two halves of one Philox group (four
//       columns) in two rows, so each draws the group of one row and
//       hands the other lane the two words it needs, and every group is
//       drawn once.  In training hd then goes out by 16-byte stores from
//       the tile;
//   P2  y [128][256] += hd W2[:, chunk]^T: warps 2 x 4, 64 x 64 each (128
//       accumulators a thread for the whole filter); hd by ldsm_a, W2 (an
//       [n][k] tile) by ldsm_b.
// With one split the block adds b2 and stores y.  Where the row tiles
// alone would leave SMs idle (the decoder's 6000 rows: 47 tiles for 132
// SMs), S blocks share a row tile, each over F / S of the filter, and
// write float32 partials [S][R][256] that ffn_fwd_sum_kernel adds in
// split order (ops/fused_ffn.py: fwd_splits picks S).
constexpr int kFwdRows = 128;
constexpr int kFwdStages = 2;
constexpr int kFwdXBytes = kFwdRows * kDim * 2;      // 4 panels
constexpr int kFwdXPanel = kFwdRows * 128;
constexpr int kFwdStage = kW1cBytes + kW2cBytes;
constexpr int kFwdHBytes = kFwdRows * kDxChunk * 2;  // 1 panel
constexpr size_t kFwdSmem =
    kFwdXBytes + kFwdStages * kFwdStage + kFwdHBytes;
constexpr int kFwdMt1 = kFwdRows / kDxRowWarps1 / 16;  // m tiles, P1
constexpr int kFwdMt2 = kFwdRows / kDxRowWarps2 / 16;  // m tiles, P2

template <bool kDrop>
__global__ void __launch_bounds__(kDxThreads, 1)
ffn_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w1,
                    const float* __restrict__ b1,
                    const __nv_bfloat16* __restrict__ w2,
                    const float* __restrict__ b2,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ yp,
                    __nv_bfloat16* __restrict__ hd, int rows, int filter,
                    unsigned threshold, float scale,
                    neurst::DropoutSite site) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const uint32_t x_s = base;
  constexpr int hs_off = kFwdXBytes + kFwdStages * kFwdStage;
  const uint32_t hs = base + hs_off;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // P1: rows 16 kFwdMt1 wm, columns 32 wn; P2: rows 16 kFwdMt2 wm2, dims
  // 64 wn2
  const int wm = warp % kDxRowWarps1, wn = warp / kDxRowWarps1;
  const int wm2 = warp % kDxRowWarps2, wn2 = warp / kDxRowWarps2;
  const int r0 = blockIdx.x * kFwdRows;
  const int chunks = filter / kDxChunk;
  const int per_split = (chunks + gridDim.y - 1) / gridDim.y;
  const int c0 = blockIdx.y * per_split;
  const int n_chunks = max(0, min(chunks, c0 + per_split) - c0);

  auto load_chunk = [&](int j) {  // addresses recomputed, as in dx
    const int ot = opaque(tid);
    const uint32_t st = base + kFwdXBytes + (j % kFwdStages) * kFwdStage;
    const int f0 = (c0 + j) * kDxChunk;
    load_panels_async<kDxThreads, kDxChunk, kDim>(st, w1, kDim, f0, 0,
                                                  filter, ot);
    load_panels_async<kDxThreads, kDim, kDxChunk>(st + kW1cBytes, w2, filter,
                                                  0, f0, kDim, ot);
  };
  load_panels_async<kDxThreads, kFwdRows, kDim>(x_s, x, kDim, r0, 0, rows,
                                                tid);
  if (n_chunks > 0) load_chunk(0);
  cp_async_commit();

  float acc2[kFwdMt2][8][4];
#pragma unroll
  for (int mi = 0; mi < kFwdMt2; ++mi) zero(acc2[mi]);

  for (int j = 0; j < n_chunks; ++j) {
    cp_async_wait<0>();  // chunk j (and x) landed
    __syncthreads();     // ... for every thread; chunk j - 1 is consumed
    if (j + 1 < n_chunks) load_chunk(j + 1);
    cp_async_commit();
    const uint32_t w1c = base + kFwdXBytes + (j % kFwdStages) * kFwdStage;
    const uint32_t w2c = w1c + kW1cBytes;
    const int f0 = (c0 + j) * kDxChunk;

    uint32_t keep = 0u;  // drawn ahead of P1
    if constexpr (kDrop)
      keep = draw_keep<kFwdMt1>(r0, f0, filter, wm, 32 * wn, g, t,
                                threshold, site);

    // P1: z1 [128 r][64 f] = x W1[chunk, :]^T
    float acc1[kFwdMt1][4][4];
#pragma unroll
    for (int mi = 0; mi < kFwdMt1; ++mi) zero(acc1[mi]);
#pragma unroll
    for (int kk = 0; kk < kDim / 16; ++kk) {
      uint32_t a[kFwdMt1][4];
#pragma unroll
      for (int mi = 0; mi < kFwdMt1; ++mi)
        ldsm_a(a[mi], x_s + (kk >> 2) * kFwdXPanel,
               16 * (kFwdMt1 * wm + mi), 2 * (kk & 3), lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_b(b, w1c + (kk >> 2) * kW1cPanel, 32 * wn + 16 * np,
               2 * (kk & 3), lane);
#pragma unroll
        for (int mi = 0; mi < kFwdMt1; ++mi) {
          mma_bf16(acc1[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc1[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }

    // hd = round(dropout(relu(z1 + b1))) into the chunk's tile
    store_hidden<kFwdMt1, kDrop>(smem + hs_off, acc1, b1, f0, keep, scale,
                                 wm, 32 * wn, g, t);
    __syncthreads();  // hd is in place
    if (hd != nullptr)
      store_chunk<kFwdRows, kDxThreads>(hd, filter, r0, f0, rows,
                                        smem + hs_off, tid);

    // P2: y [128 r][256 d] += hd W2[:, chunk]^T
#pragma unroll
    for (int kk = 0; kk < kDxChunk / 16; ++kk) {
      uint32_t a[kFwdMt2][4];
#pragma unroll
      for (int mi = 0; mi < kFwdMt2; ++mi)
        ldsm_a(a[mi], hs, 16 * (kFwdMt2 * wm2 + mi), 2 * kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_b(b, w2c, 64 * wn2 + 16 * np, 2 * kk, lane);
#pragma unroll
        for (int mi = 0; mi < kFwdMt2; ++mi) {
          mma_bf16(acc2[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc2[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  store_y<kDim>(y, yp, b2, acc2, r0, rows, wm2, wn2, g, t);
}

// ------------------------------------ bf16 forward and dx pass at D 512
//
// The D 256 tiles do not fit at D 512: x [128][512] and a 2-stage ring of
// whole chunks would take 400 KB of shared memory (227 KB a block), and
// y [128][512] in float32 256 registers a thread at 8 warps.  These take
// 64-row tiles (y or dx: 128 accumulators a thread, as at D 256) and hold
// one W1 chunk [64][512] and one W2 chunk [512][64] (64 KB each) in place
// of a ring: each buffer is refilled as soon as the product that reads it
// is done, so chunk j + 1's first operand arrives under chunk j's second
// product and its second operand under chunk j + 1's first.  Warps: P1
// 4 (rows) x 2 (columns), 16 x 32 each; P2 2 x 4, 32 x 128 each.  Each
// tile re-reads all of W1 and W2 (4 MB at F 2048) from L2, ~2.1 GB a call
// at 32768 rows; yet that traffic is not what bounds them: 128-row tiles
// shared by a 2-block cluster (each block half of P1's columns and of
// P2's dims, the hidden exchanged through distributed shared memory),
// which read a quarter of it a row, ran the forward no faster and the dx
// pass 14% slower (PERF.md, PR 9).  As at D 256, the products' issue
// (fragment loads from shared memory, the barriers of each chunk) bounds
// them, at ~190 TFLOP/s.  Shared memory: the forward x 64 KB + W1 and
// W2 chunks 128 KB + hd 8 KB; the dx pass dy 64 KB + 128 KB + two hd /
// dh tiles 16 KB (chunk j + 1's hd lands while chunk j's dh is still
// read) + the db1 sums.
constexpr int kWide = 512;
constexpr int kWideRows = 64;
constexpr int kWideRowBytes = kWideRows * kWide * 2;  // x or dy: 8 panels
constexpr int kWidePanel = kWideRows * 128;
constexpr int kWideWBytes = kDxChunk * kWide * 2;     // a W1 or W2 chunk
constexpr int kWideHBytes = kWideRows * kDxChunk * 2;
constexpr int kWideMt1 = kWideRows / kDxRowWarps1 / 16;  // m tiles, P1
constexpr int kWideMt2 = kWideRows / kDxRowWarps2 / 16;  // m tiles, P2
constexpr int kWideNt2 = kWide / (kDxWarps / kDxRowWarps2) / 8;  // n tiles
constexpr size_t kWideFwdSmem =
    kWideRowBytes + 2 * kWideWBytes + kWideHBytes;
constexpr size_t kWideDxSmem = kWideRowBytes + 2 * kWideWBytes +
                               2 * kWideHBytes +
                               kDxRowWarps1 * kDxChunk * 4;

template <bool kDrop>
__global__ void __launch_bounds__(kDxThreads, 1)
ffn_fwd_bf16_wide_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w1,
                         const float* __restrict__ b1,
                         const __nv_bfloat16* __restrict__ w2,
                         const float* __restrict__ b2,
                         __nv_bfloat16* __restrict__ y,
                         float* __restrict__ yp,
                         __nv_bfloat16* __restrict__ hd, int rows,
                         int filter, unsigned threshold, float scale,
                         neurst::DropoutSite site) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const uint32_t x_s = base;
  const uint32_t w1c = base + kWideRowBytes;  // W1[chunk, :]: 8 panels
  const uint32_t w2c = w1c + kWideWBytes;     // W2[:, chunk]: [512][64]
  constexpr int hs_off = kWideRowBytes + 2 * kWideWBytes;
  const uint32_t hs = base + hs_off;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % kDxRowWarps1, wn = warp / kDxRowWarps1;
  const int wm2 = warp % kDxRowWarps2, wn2 = warp / kDxRowWarps2;
  const int r0 = blockIdx.x * kWideRows;
  const int chunks = filter / kDxChunk;
  const int per_split = (chunks + gridDim.y - 1) / gridDim.y;
  const int c0 = blockIdx.y * per_split;
  const int n_chunks = max(0, min(chunks, c0 + per_split) - c0);

  // addresses recomputed per chunk, as in the D 256 kernels
  auto load_w1 = [&](int j) {
    load_panels_async<kDxThreads, kDxChunk, kWide>(
        w1c, w1, kWide, (c0 + j) * kDxChunk, 0, filter, opaque(tid));
  };
  auto load_w2 = [&](int j) {
    load_panels_async<kDxThreads, kWide, kDxChunk>(
        w2c, w2, filter, 0, (c0 + j) * kDxChunk, kWide, opaque(tid));
  };
  load_panels_async<kDxThreads, kWideRows, kWide>(x_s, x, kWide, r0, 0,
                                                  rows, tid);
  if (n_chunks > 0) load_w1(0);
  cp_async_commit();
  if (n_chunks > 0) load_w2(0);
  cp_async_commit();

  float acc2[kWideMt2][kWideNt2][4];
#pragma unroll
  for (int mi = 0; mi < kWideMt2; ++mi) zero(acc2[mi]);

  for (int j = 0; j < n_chunks; ++j) {
    const int f0 = (c0 + j) * kDxChunk;
    cp_async_wait<1>();  // x and W1 chunk j landed (W2 chunk j may not)
    __syncthreads();     // ... for every thread
    uint32_t keep = 0u;
    if constexpr (kDrop)
      keep = draw_keep<kWideMt1>(r0, f0, filter, wm, 32 * wn, g, t,
                                 threshold, site);

    // P1: z1 [64 r][64 f] = x W1[chunk, :]^T
    float acc1[kWideMt1][4][4];
#pragma unroll
    for (int mi = 0; mi < kWideMt1; ++mi) zero(acc1[mi]);
#pragma unroll
    for (int kk = 0; kk < kWide / 16; ++kk) {
      uint32_t a[kWideMt1][4];
#pragma unroll
      for (int mi = 0; mi < kWideMt1; ++mi)
        ldsm_a(a[mi], x_s + (kk >> 2) * kWidePanel,
               16 * (kWideMt1 * wm + mi), 2 * (kk & 3), lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_b(b, w1c + (kk >> 2) * kW1cPanel, 32 * wn + 16 * np,
               2 * (kk & 3), lane);
#pragma unroll
        for (int mi = 0; mi < kWideMt1; ++mi) {
          mma_bf16(acc1[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc1[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with W1 chunk j
    if (j + 1 < n_chunks) load_w1(j + 1);
    cp_async_commit();

    store_hidden<kWideMt1, kDrop>(smem + hs_off, acc1, b1, f0, keep, scale,
                                  wm, 32 * wn, g, t);
    cp_async_wait<1>();  // W2 chunk j landed
    __syncthreads();     // ... for every thread, and hd is in place
    if (hd != nullptr)
      store_chunk<kWideRows, kDxThreads>(hd, filter, r0, f0, rows,
                                         smem + hs_off, tid);

    // P2: y [64 r][512 d] += hd W2[:, chunk]^T
#pragma unroll
    for (int kk = 0; kk < kDxChunk / 16; ++kk) {
      uint32_t a[kWideMt2][4];
#pragma unroll
      for (int mi = 0; mi < kWideMt2; ++mi)
        ldsm_a(a[mi], hs, 16 * (kWideMt2 * wm2 + mi), 2 * kk, lane);
#pragma unroll
      for (int np = 0; np < kWideNt2 / 2; ++np) {
        uint32_t b[4];
        ldsm_b(b, w2c, 8 * kWideNt2 * wn2 + 16 * np, 2 * kk, lane);
#pragma unroll
        for (int mi = 0; mi < kWideMt2; ++mi) {
          mma_bf16(acc2[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc2[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with W2 chunk j and hd
    if (j + 1 < n_chunks) load_w2(j + 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

  store_y<kWide>(y, yp, b2, acc2, r0, rows, wm2, wn2, g, t);
}

// The dx pass at D 512: per chunk, P1 dhd [64][64] = dy W2[:, chunk]
// (dy by ldsm_a, W2 [512 k][64 n] by ldsm_trans), dh over hd as in the
// D 256 pass, then P2 dx [64][512] += round(dh) W1[chunk, :] (W1 [64
// k][512 n] by ldsm_trans).  W2 and hd of chunk j + 1 arrive under P2 of
// chunk j, W1 of chunk j + 1 under P1 of chunk j + 1.
__global__ void __launch_bounds__(kDxThreads, 1)
ffn_dx_bf16_wide_kernel(const __nv_bfloat16* __restrict__ w1,
                        const __nv_bfloat16* __restrict__ w2,
                        const __nv_bfloat16* __restrict__ hd,
                        const __nv_bfloat16* __restrict__ dy,
                        __nv_bfloat16* __restrict__ dx,
                        __nv_bfloat16* __restrict__ dh,
                        float* __restrict__ db1p, float* __restrict__ db2p,
                        int rows, int filter, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const uint32_t dy_s = base;
  const uint32_t w2c = base + kWideRowBytes;  // W2[:, chunk]: [512][64]
  const uint32_t w1c = w2c + kWideWBytes;     // W1[chunk, :]: 8 panels
  constexpr int hs_off = kWideRowBytes + 2 * kWideWBytes;  // 2 tiles
  float* red = reinterpret_cast<float*>(smem + hs_off + 2 * kWideHBytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % kDxRowWarps1, wn = warp / kDxRowWarps1;
  const int wm2 = warp % kDxRowWarps2, wn2 = warp / kDxRowWarps2;
  const int tile = blockIdx.x, r0 = tile * kWideRows;
  const int chunks = filter / kDxChunk;

  auto load_w2_hd = [&](int j) {
    const int ot = opaque(tid);
    const int f0 = j * kDxChunk;
    load_panels_async<kDxThreads, kWide, kDxChunk>(w2c, w2, filter, 0, f0,
                                                   kWide, ot);
    load_panels_async<kDxThreads, kWideRows, kDxChunk>(
        base + hs_off + (j & 1) * kWideHBytes, hd, filter, r0, f0, rows, ot);
  };
  auto load_w1 = [&](int j) {
    load_panels_async<kDxThreads, kDxChunk, kWide>(
        w1c, w1, kWide, j * kDxChunk, 0, filter, opaque(tid));
  };
  load_panels_async<kDxThreads, kWideRows, kWide>(dy_s, dy, kWide, r0, 0,
                                                  rows, tid);
  load_w2_hd(0);
  cp_async_commit();
  load_w1(0);
  cp_async_commit();

  float acc2[kWideMt2][kWideNt2][4];
#pragma unroll
  for (int mi = 0; mi < kWideMt2; ++mi) zero(acc2[mi]);

  for (int j = 0; j < chunks; ++j) {
    const int f0 = j * kDxChunk;
    const int cur = hs_off + (j & 1) * kWideHBytes;
    const uint32_t hs = base + cur;
    cp_async_wait<1>();  // dy, W2 and hd of chunk j landed
    __syncthreads();     // ... for every thread

    // P1: dhd [64 r][64 f] = dy W2[:, chunk]
    float acc1[kWideMt1][4][4];
#pragma unroll
    for (int mi = 0; mi < kWideMt1; ++mi) zero(acc1[mi]);
#pragma unroll
    for (int kk = 0; kk < kWide / 16; ++kk) {
      uint32_t a[kWideMt1][4];
#pragma unroll
      for (int mi = 0; mi < kWideMt1; ++mi)
        ldsm_a(a[mi], dy_s + (kk >> 2) * kWidePanel,
               16 * (kWideMt1 * wm + mi), 2 * (kk & 3), lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_trans(b, w2c, 16 * kk, 4 * wn + 2 * np, lane);
#pragma unroll
        for (int mi = 0; mi < kWideMt1; ++mi) {
          mma_bf16(acc1[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc1[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }

    store_dh(smem + cur, acc1, scale, red, wm, 32 * wn, g, t);
    __syncthreads();  // round(dh) and the db1 sums are in place; every
                      // warp is done with W2 chunk j
    if (j + 1 < chunks) load_w2_hd(j + 1);
    cp_async_commit();
    if (tid < kDxChunk) {
      float b = 0.f;
#pragma unroll
      for (int w = 0; w < kDxRowWarps1; ++w) b += red[w * kDxChunk + tid];
      db1p[static_cast<long long>(tile) * filter + f0 + tid] = b;
    }
    store_chunk<kWideRows, kDxThreads>(dh, filter, r0, f0, rows, smem + cur,
                                       tid);
    cp_async_wait<1>();  // W1 chunk j landed
    __syncthreads();     // ... for every thread

    // P2: dx [64 r][512 d] += round(dh) W1[chunk, :]
#pragma unroll
    for (int kk = 0; kk < kDxChunk / 16; ++kk) {
      uint32_t a[kWideMt2][4];
#pragma unroll
      for (int mi = 0; mi < kWideMt2; ++mi)
        ldsm_a(a[mi], hs, 16 * (kWideMt2 * wm2 + mi), 2 * kk, lane);
#pragma unroll
      for (int np = 0; np < kWideNt2 / 2; ++np) {
        const int d = 8 * kWideNt2 * wn2 + 16 * np;
        uint32_t b[4];
        ldsm_trans(b, w1c + (d >> 6) * kW1cPanel, 16 * kk, (d & 63) >> 3,
                   lane);
#pragma unroll
        for (int mi = 0; mi < kWideMt2; ++mi) {
          mma_bf16(acc2[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc2[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with W1 chunk j and dh
    if (j + 1 < chunks) load_w1(j + 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

  store_dx<kWide>(dx, acc2, r0, rows, wm2, wn2, g, t);
  store_db2<kWide, kWideRows, kDxThreads>(db2p, smem, tile, tid);
}

// y = round(sum of the S float32 partials in split order + b2), four
// values a thread
template <int D>
__global__ void __launch_bounds__(kThreads)
ffn_fwd_sum_kernel(const float* __restrict__ yp, const float* __restrict__ b2,
                   __nv_bfloat16* __restrict__ y, int rows, int splits) {
  const long long n4 = static_cast<long long>(rows) * D / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < n4; e += stride) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < splits; ++sp) {
      const float4 v = reinterpret_cast<const float4*>(yp)[sp * n4 + e];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int d = static_cast<int>((4 * e) % D);
    reinterpret_cast<uint2*>(y)[e] =
        make_uint2(pack_bf16(s.x + b2[d], s.y + b2[d + 1]),
                   pack_bf16(s.z + b2[d + 2], s.w + b2[d + 3]));
  }
}

// ------------------------------------------- float32 dW pass: FMA loops
template <typename T, int D>
struct DwSmem {
  static constexpr int BR = kDwRowsF32;
  // model dims a block holds at once: all of D up to 256.  At D 512 a
  // block computes one half of dW1's and dW2's dims, and reads dy and W2
  // in two halves of the contraction for dh (its own half last, which
  // then stays for its products and db2).
  static constexpr int DB = D < 256 ? D : 256;
  static constexpr int kW2t = DB + kPad, kDy = DB + kPad, kT = BR + kPad;
  static constexpr size_t bytes =
      sizeof(T) * (kCols * kW2t + BR * kDy + 2 * DB * kT + 2 * kCols * kT) +
      sizeof(float) * kCols * kT;
};

// Block (c, s, h): filter columns 64 c .. 64 c + 63 over row split s and
// model dims h DB .. h DB + DB - 1, 16 warps.  Partials (float32): dw1p
// [S][F][D], dw2p [S][D][F], db1p [S][F] (from the blocks of half 0)
// and, from the blocks of column tile 0, db2p [S][D].
template <typename T, int D>
__global__ void __launch_bounds__(kDwThreads)
ffn_dw_kernel(const T* __restrict__ x, const T* __restrict__ w2,
              const T* __restrict__ hd, const T* __restrict__ dy,
              float* __restrict__ dw1p, float* __restrict__ dw2p,
              float* __restrict__ db1p, float* __restrict__ db2p, int rows,
              int filter, float scale) {
  using S = DwSmem<T, D>;
  constexpr int BR = S::BR, DB = S::DB, kHalves = D / DB;
  constexpr int NTA = BR / 32;  // n tiles (rows) per warp of dh^T
  constexpr int NTB = DB / 32;  // n tiles (model dims) per warp of dW
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w2t = reinterpret_cast<T*>(smem_raw);  // [64 f][DB]
  T* dys = w2t + kCols * S::kW2t;           // [BR][DB]
  T* dyt = dys + BR * S::kDy;               // [DB][BR]
  T* xt = dyt + DB * S::kT;                 // [DB][BR]
  T* hdt = xt + DB * S::kT;                 // [64 f][BR]
  T* dht = hdt + kCols * S::kT;             // [64 f][BR]: round(dh)^T
  float* dhf = reinterpret_cast<float*>(dht + kCols * S::kT);  // unrounded

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3;   // filter rows 16 wm .. of the block's 64
  const int wn = warp >> 2;  // quarter of the n range
  const int f0 = blockIdx.x * kCols;
  const int split = blockIdx.y, splits = gridDim.y;
  const int h = blockIdx.z, d0 = h * DB;
  const int tiles = (rows + BR - 1) / BR;
  const int per_split = (tiles + splits - 1) / splits;
  const int tile_end = min(tiles, (split + 1) * per_split);

  if constexpr (kHalves == 1)
    load_tile_t<kDwThreads>(w2t, S::kW2t, w2, filter, 0, f0, D, kCols, D,
                            tid);
  float acc_w1[NTB][4], acc_w2[NTB][4];
  zero(acc_w1);
  zero(acc_w2);
  float db1 = 0.f, db2 = 0.f;  // column sums: filter col tid (< 64), dim tid

  for (int tile = split * per_split; tile < tile_end; ++tile) {
    const int r0 = tile * BR;
    // dh^T [64 f][BR r] = W2^T[chunk] dy^T, masked by hd > 0, over the
    // halves of the model dims
    float acc_a[NTA][4];
    zero(acc_a);
    const int na = wn * (BR / 4);
    for (int q = 0; q < kHalves; ++q) {
      const int kh = (h + 1 + q) % kHalves;
      const bool own = kh == h;
      __syncthreads();
      if constexpr (kHalves > 1)
        load_tile_t<kDwThreads>(w2t, S::kW2t, w2, filter, kh * DB, f0, DB,
                                kCols, D, tid);
      constexpr int V = Vec<T>::n;
      for (int i = tid; i < BR * (DB / V); i += kDwThreads) {
        const int r = i % BR, d = (i / BR) * V;
        const uint4 v = load_vec(dy, D, r0, r, kh * DB + d, rows);
        *reinterpret_cast<uint4*>(dys + r * S::kDy + d) = v;
        if (own) {
          const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
          for (int j = 0; j < V; ++j) dyt[(d + j) * S::kT + r] = e[j];
        }
      }
      if (own) {
        load_tile_t<kDwThreads>(xt, S::kT, x, D, r0, d0, BR, DB, rows, tid);
        load_tile_t<kDwThreads>(hdt, S::kT, hd, filter, r0, f0, BR, kCols,
                                rows, tid);
      }
      __syncthreads();
      warp_gemm<NTA>(acc_a, w2t + 16 * wm * S::kW2t, S::kW2t,
                     dys + na * S::kDy, S::kDy, DB, lane);
    }
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

    // dW2^T [64 f][DB] += hd^T dy ; dW1 [64 f][DB] += round(dh)^T x
    const int nb = wn * (DB / 4);
    warp_gemm<NTB>(acc_w2, hdt + 16 * wm * S::kT, S::kT, dyt + nb * S::kT,
                   S::kT, BR, lane);
    warp_gemm<NTB>(acc_w1, dht + 16 * wm * S::kT, S::kT, xt + nb * S::kT,
                   S::kT, BR, lane);
    // the bias sums, row by row in a fixed order
    if (h == 0 && tid < kCols)
      for (int r = 0; r < BR; ++r) db1 += dhf[tid * S::kT + r];
    if (blockIdx.x == 0 && tid < DB)
      for (int r = 0; r < BR; ++r) db2 += to_float(dys[r * S::kDy + tid]);
  }

  const long long fd = static_cast<long long>(filter) * D;
#pragma unroll
  for (int j = 0; j < NTB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = f0 + 16 * wm + g + 8 * (i >> 1);
      const int d = d0 + wn * (DB / 4) + 8 * j + 2 * t + (i & 1);
      dw1p[split * fd + static_cast<long long>(f) * D + d] = acc_w1[j][i];
      dw2p[split * fd + static_cast<long long>(d) * filter + f] =
          acc_w2[j][i];
    }
  if (h == 0 && tid < kCols)
    db1p[static_cast<long long>(split) * filter + f0 + tid] = db1;
  if (blockIdx.x == 0 && tid < DB) db2p[split * D + d0 + tid] = db2;
}

// dW1, dW2 (operand dtype) and db1, db2 (float32): the sums of the S
// weight partials in split order, and of the P bias partials, one warp
// a bias column (lane l adds parts l, l + 32, ... in order, then a fixed
// butterfly of shuffles)
template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_dw_sum_kernel(const float* __restrict__ dw1p,
                  const float* __restrict__ dw2p,
                  const float* __restrict__ db1p,
                  const float* __restrict__ db2p, T* __restrict__ dw1,
                  T* __restrict__ dw2, float* __restrict__ db1,
                  float* __restrict__ db2, int filter, int dim, int splits,
                  int bias_parts) {
  const long long fd = static_cast<long long>(filter) * dim;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long e = first; e < fd; e += stride) {
    float s1 = 0.f, s2 = 0.f;
    for (int s = 0; s < splits; ++s) {
      s1 += dw1p[s * fd + e];
      s2 += dw2p[s * fd + e];
    }
    dw1[e] = from_float<T>(s1);
    dw2[e] = from_float<T>(s2);
  }
  const int lane = threadIdx.x & 31;
  for (long long c = first >> 5; c < filter + dim; c += stride >> 5) {
    const bool b1 = c < filter;
    const float* p = b1 ? db1p + c : db2p + (c - filter);
    const long long ld = b1 ? filter : dim;
    float s = 0.f;
#pragma unroll 4
    for (int i = lane; i < bias_parts; i += 32) s += p[i * ld];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
    if (lane == 0) {
      if (b1)
        db1[c] = s;
      else
        db2[c - filter] = s;
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

// The partials buffer: dW1 [S][F][D], dW2 [S][D][F], then db1 [P][F] and
// db2 [P][D] (P bias partials: the S splits of the float32 dW pass, or
// the row tiles of the bf16 dx pass)
struct Partials {
  float *dw1, *dw2, *db1, *db2;
};

Partials split_partials(void* partials, int filter, int dim, int splits,
                        int bias_parts) {
  const long long fd = static_cast<long long>(filter) * dim;
  float* p = static_cast<float*>(partials);
  Partials out;
  out.dw1 = p;
  out.dw2 = out.dw1 + splits * fd;
  out.db1 = out.dw2 + splits * fd;
  out.db2 = out.db1 + static_cast<long long>(bias_parts) * filter;
  return out;
}

constexpr int kSms = 132;

// rows of a bf16 dx tile: at D 256, 128 when those tiles fill the SMs at
// least once, else 64; at D 512, 64
int dx_rows(int rows, int dim) {
  return dim == kDim && (rows + 127) / 128 >= kSms ? 128 : 64;
}

int dx_tiles(int rows, int dim) {
  return (rows + dx_rows(rows, dim) - 1) / dx_rows(rows, dim);
}

template <int D>
cudaError_t launch_fwd_f32(const void* x, const void* w1, const float* b1,
                           const void* w2, const float* b2, void* y,
                           void* hd, int rows, int filter, unsigned threshold,
                           float scale, const neurst::DropoutSite& site,
                           cudaStream_t s) {
  auto kernel = ffn_fwd_kernel<float, D>;
  const size_t bytes = FwdSmem<float, D>::bytes;
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(rows + kRows - 1) / kRows, kThreads, bytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), b1,
      static_cast<const float*>(w2), b2, static_cast<float*>(y),
      static_cast<float*>(hd), rows, filter, threshold, scale, site);
  return cudaGetLastError();
}

cudaError_t launch_fwd_bf16(const void* x, const void* w1, const float* b1,
                            const void* w2, const float* b2, void* y,
                            float* yp, void* hd, int rows, int filter,
                            int dim, int splits, unsigned threshold,
                            float scale, const neurst::DropoutSite& site,
                            cudaStream_t s) {
  const bool wide = dim == kWide;
  auto kernel = wide ? (threshold != 0u ? ffn_fwd_bf16_wide_kernel<true>
                                        : ffn_fwd_bf16_wide_kernel<false>)
                     : (threshold != 0u ? ffn_fwd_bf16_kernel<true>
                                        : ffn_fwd_bf16_kernel<false>);
  const size_t bytes = wide ? kWideFwdSmem : kFwdSmem;
  const int tile = wide ? kWideRows : kFwdRows;
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  using bf16 = __nv_bfloat16;
  kernel<<<dim3((rows + tile - 1) / tile, splits), kDxThreads, bytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
      static_cast<const bf16*>(w2), b2, static_cast<bf16*>(y), yp,
      static_cast<bf16*>(hd), rows, filter, threshold, scale, site);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dx_f32(const void* w1, const void* w2, const void* hd,
                          const void* dy, void* dx, int rows, int filter,
                          float scale, cudaStream_t s) {
  auto kernel = ffn_dx_kernel<float, D>;
  const size_t bytes = DxSmem<float, D>::bytes;
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(rows + kRows - 1) / kRows, kThreads, bytes, s>>>(
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<const float*>(hd), static_cast<const float*>(dy),
      static_cast<float*>(dx), rows, filter, scale);
  return cudaGetLastError();
}

cudaError_t launch_dx_bf16(const void* w1, const void* w2, const void* hd,
                           const void* dy, void* dx, void* dh,
                           const Partials& p, int rows, int filter, int dim,
                           float scale, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  const int tile = dx_rows(rows, dim);
  auto kernel = dim == kWide ? ffn_dx_bf16_wide_kernel
                : tile == 128 ? ffn_dx_bf16_kernel<128>
                              : ffn_dx_bf16_kernel<64>;
  const size_t bytes = dim == kWide ? kWideDxSmem
                       : tile == 128 ? DxTile<128>::kSmem
                                     : DxTile<64>::kSmem;
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dx_tiles(rows, dim), kDxThreads, bytes, s>>>(
      static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(hd), static_cast<const bf16*>(dy),
      static_cast<bf16*>(dx), static_cast<bf16*>(dh), p.db1, p.db2, rows,
      filter, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dw_f32(const void* x, const void* w2, const void* hd,
                          const void* dy, const Partials& p, int rows,
                          int filter, int splits, float scale,
                          cudaStream_t s) {
  using S = DwSmem<float, D>;
  auto kernel = ffn_dw_kernel<float, D>;
  cudaError_t err = set_smem(kernel, S::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(filter / kCols, splits, D / S::DB), kDwThreads, S::bytes,
           s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w2),
      static_cast<const float*>(hd), static_cast<const float*>(dy), p.dw1,
      p.dw2, p.db1, p.db2, rows, filter, scale);
  return cudaGetLastError();
}

cudaError_t launch_dw_bf16(const void* x, const void* hd, const void* dy,
                           const void* dh, const Partials& p, int rows,
                           int filter, int dim, int splits, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  // dW1 [F][D] = round(dh)^T x ; dW2^T [F][D] = hd^T dy, stored [D][F];
  // at D 512 each output row takes two 256-column tiles
  const RowProduct p0{static_cast<const bf16*>(dh),
                      static_cast<const bf16*>(x), p.dw1, filter, dim,
                      false};
  const RowProduct p1{static_cast<const bf16*>(hd),
                      static_cast<const bf16*>(dy), p.dw2, filter, dim,
                      true};
  return launch_row_product<kDim>(p0, &p1, rows, splits, s);
}

template <typename T>
cudaError_t launch_dw_sum(const Partials& p, void* dw1, void* dw2,
                          float* db1, float* db2, int filter, int dim,
                          int splits, int bias_parts, cudaStream_t s) {
  const long long fd = static_cast<long long>(filter) * dim;
  const long long blocks = (fd + kThreads - 1) / kThreads;
  ffn_dw_sum_kernel<T><<<static_cast<int>(blocks < 132 * 8 ? blocks
                                                            : 132 * 8),
                         kThreads, 0, s>>>(
      p.dw1, p.dw2, p.db1, p.db2, static_cast<T*>(dw1), static_cast<T*>(dw2),
      db1, db2, filter, dim, splits, bias_parts);
  return cudaGetLastError();
}

// the bf16 backward also tiles the filter by 128 (the dW pass's tiles)
bool bad_args(int rows, int filter, int dim, int dtype) {
  return rows <= 0 || filter <= 0 || filter % 64 != 0 ||
         (dtype == 1 && filter % kRpTileM != 0) ||
         (dim != kDim && dim != kWide) || (dtype != 0 && dtype != 1);
}

}  // namespace

// Every entry point returns the cudaError_t of its launch (0 on success).
// dtype: 0 = float32, 1 = bfloat16.  `hd` may be null (inference).
// threshold 0 = no dropout; otherwise the FFN site (k0, k1, stream_id,
// micro, the hidden's first element group) and scale = 1 / (1 - realized
// rate).  `splits` filter splits
// (bf16 only; float32 takes 1): above 1 the kernel writes S float32
// partials [S, R, D] to `partials` and neurst_ffn_fwd_sum forms y.
extern "C" int neurst_ffn_fwd(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* y,
                              void* hd, void* partials, int rows,
                              int filter, int dim, int splits,
                              unsigned threshold, float scale, unsigned k0,
                              unsigned k1, unsigned stream_id,
                              unsigned micro, unsigned long long group,
                              int dtype, void* stream) {
  if (bad_args(rows, filter, dim, dtype) || splits <= 0 ||
      splits > filter / kDxChunk || (dtype == 0 && splits != 1) ||
      (splits > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const neurst::DropoutSite site{k0, k1, stream_id, micro, group};
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1
          ? launch_fwd_bf16(x, w1, b1f, w2, b2f, y,
                            static_cast<float*>(partials), hd, rows, filter,
                            dim, splits, threshold, scale, site, s)
      : dim == kWide
          ? launch_fwd_f32<kWide>(x, w1, b1f, w2, b2f, y, hd, rows, filter,
                                  threshold, scale, site, s)
          : launch_fwd_f32<kDim>(x, w1, b1f, w2, b2f, y, hd, rows, filter,
                                 threshold, scale, site, s);
  return static_cast<int>(err);
}

// bf16 y [R, D] from the forward's S partials and b2
extern "C" int neurst_ffn_fwd_sum(const void* partials, const void* b2,
                                  void* y, int rows, int dim, int splits,
                                  void* stream) {
  if (rows <= 0 || (dim != kDim && dim != kWide) || splits <= 0 ||
      partials == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      (static_cast<long long>(rows) * dim / 4 + kThreads - 1) / kThreads;
  auto kernel =
      dim == kWide ? ffn_fwd_sum_kernel<kWide> : ffn_fwd_sum_kernel<kDim>;
  kernel<<<static_cast<int>(blocks < kSms * 8 ? blocks : kSms * 8), kThreads,
           0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(y), rows, splits);
  return static_cast<int>(cudaGetLastError());
}

// The backward, three launches: dx, dW, dW sum.  scale = 1 / (1 - realized
// rate), 1 without dropout.  `partials` holds 2 S F D + P (F + D) floats
// (see Partials): P = S for float32, the dx tiles for bf16.  bf16 also
// takes dh [R, F] in the operand dtype, which its dx pass writes and its
// dW pass reads; float32 ignores dh (its dW pass recomputes dh).

// dx [R, D] from hd and dy; bf16 also writes round(dh) and the bias
// partials.
extern "C" int neurst_ffn_dx(const void* w1, const void* w2, const void* hd,
                             const void* dy, void* dx, void* dh,
                             void* partials, int rows, int filter, int dim,
                             int splits, float scale, int dtype,
                             void* stream) {
  if (bad_args(rows, filter, dim, dtype) || splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(
        dim == kWide
            ? launch_dx_f32<kWide>(w1, w2, hd, dy, dx, rows, filter, scale, s)
            : launch_dx_f32<kDim>(w1, w2, hd, dy, dx, rows, filter, scale,
                                  s));
  if (dh == nullptr || partials == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Partials p =
      split_partials(partials, filter, dim, splits, dx_tiles(rows, dim));
  return static_cast<int>(launch_dx_bf16(w1, w2, hd, dy, dx, dh, p, rows,
                                         filter, dim, scale, s));
}

// The float32 partials of `splits` row splits of dW1 and dW2 (and, for
// float32, of db1 and db2).
extern "C" int neurst_ffn_dw(const void* x, const void* w2, const void* hd,
                             const void* dy, const void* dh, void* partials,
                             int rows, int filter, int dim, int splits,
                             float scale, int dtype, void* stream) {
  if (bad_args(rows, filter, dim, dtype) || splits <= 0 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Partials p = split_partials(partials, filter, dim, splits, splits);
    return static_cast<int>(
        dim == kWide ? launch_dw_f32<kWide>(x, w2, hd, dy, p, rows, filter,
                                            splits, scale, s)
                     : launch_dw_f32<kDim>(x, w2, hd, dy, p, rows, filter,
                                           splits, scale, s));
  }
  if (dh == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Partials p =
      split_partials(partials, filter, dim, splits, dx_tiles(rows, dim));
  return static_cast<int>(
      launch_dw_bf16(x, hd, dy, dh, p, rows, filter, dim, splits, s));
}

extern "C" int neurst_ffn_dw_sum(const void* partials, void* dw1, void* dw2,
                                 void* db1, void* db2, int filter, int dim,
                                 int splits, int bias_parts, int dtype,
                                 void* stream) {
  if (bad_args(1, filter, dim, dtype) || splits <= 0 || bias_parts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Partials p = split_partials(const_cast<void*>(partials), filter, dim,
                                    splits, bias_parts);
  float* db1f = static_cast<float*>(db1);
  float* db2f = static_cast<float*>(db2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch_dw_sum<float>(p, dw1, dw2, db1f, db2f, filter, dim,
                                        splits, bias_parts, s)
                 : launch_dw_sum<__nv_bfloat16>(p, dw1, dw2, db1f, db2f,
                                                filter, dim, splits,
                                                bias_parts, s);
  return static_cast<int>(err);
}
