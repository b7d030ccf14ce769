// A product over rows on the tensor cores, C = A^T B summed over R rows,
// split over row ranges into float32 partials: the dW pass of the bf16
// fused-FFN backward (dW1 = round(dh)^T x, dW2^T = hd^T dy) and of the
// bf16 fused linear xent backward (dW = round(dz)^T x).
//
// One grid of 128 x kN output tiles (kN = N up to 256: 128 rows of M by
// all of N, or by one of N / 256 column tiles) x S row splits.  Each
// block streams 64-row slabs of its two operands ([64][128] of A,
// [64][kN] of B) through a 3-stage cp.async ring; warps of 64 x 64
// outputs (2 x kN / 64 of them) read A transposed by ldsm_at and B by
// ldsm_trans.  Taking all of N a tile reads each row's 128 + N operand
// values once per 128 columns of M.  A block writes its float32 partial
// (transposed to [N][M] where asked); the caller's sum kernel adds the S
// partials in split order, so two calls give the same bits.  Measured
// (fused FFN, M 2048, N 256) against 64 x 32 warp tiles (16 warps) and
// 32-row slabs (4 stages), this was the fastest, by 1-15%.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace neurst {

constexpr int kRpTileM = 128;
constexpr int kRpK = 64;
constexpr int kRpStages = 3;
constexpr int kRpWarpCols = 64;             // a warp's output columns
constexpr int kRpPanel = kRpK * 128;        // [64][64] bf16
constexpr int kRpA = 2 * kRpPanel;          // [64][128]

// threads and shared memory of a block with kN output columns
template <int kN>
struct RowProductTile {
  static constexpr int kThreads = 32 * 2 * (kN / kRpWarpCols);
  static constexpr int kB = (kN / 64) * kRpPanel;  // [64][kN]
  static constexpr int kStage = kRpA + kB;
  static constexpr size_t kSmem = kRpStages * kStage;
};

// C [S][M][N] (float32 partials; [S][N][M] when `transposed`) = sum over
// rows of a [R][M]^T b [R][N]; M a multiple of 128, N of kN
struct RowProduct {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  float* c;
  int m, n;
  bool transposed;
};

// Blocks x < tiles(p0) compute p0's tiles, the rest p1's (p1 may repeat
// p0 where there is one product); blockIdx.y is the row split.
template <int kN>
__global__ void __launch_bounds__(RowProductTile<kN>::kThreads, 1)
row_product_bf16_kernel(RowProduct p0, RowProduct p1, int rows) {
  using Tile = RowProductTile<kN>;
  constexpr int kThreads = Tile::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // rows 64 wm, cols kRpWarpCols wn
  const int wm = warp & 1, wn = warp >> 1;
  const int tiles0 = (p0.m / kRpTileM) * (p0.n / kN);
  const bool second = static_cast<int>(blockIdx.x) >= tiles0;
  const RowProduct p = second ? p1 : p0;
  const int tile = blockIdx.x - (second ? tiles0 : 0);
  const int m0 = (tile / (p.n / kN)) * kRpTileM;
  const int n0 = (tile % (p.n / kN)) * kN;
  const int slabs = (rows + kRpK - 1) / kRpK;
  const int per_split = (slabs + gridDim.y - 1) / gridDim.y;
  const int s0 = blockIdx.y * per_split;
  const int n_slabs = max(0, min(slabs, s0 + per_split) - s0);

  auto load_slab = [&](int j) {  // addresses recomputed each slab
    const int ot = opaque(tid);
    const uint32_t st = base + (j % kRpStages) * Tile::kStage;
    const int r0 = (s0 + j) * kRpK;
    load_panels_async<kThreads, kRpK, kRpTileM>(st, p.a, p.m, r0, m0, rows,
                                                ot);
    load_panels_async<kThreads, kRpK, kN>(st + kRpA, p.b, p.n, r0, n0, rows,
                                          ot);
  };
#pragma unroll
  for (int j = 0; j < kRpStages - 1; ++j) {
    if (j < n_slabs) load_slab(j);
    cp_async_commit();
  }

  float acc[4][kRpWarpCols / 8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) zero(acc[mi]);

  for (int j = 0; j < n_slabs; ++j) {
    cp_async_wait<kRpStages - 2>();  // slab j landed
    __syncthreads();  // ... for every thread; slab j - 1 is consumed
    if (j + kRpStages - 1 < n_slabs) load_slab(j + kRpStages - 1);
    cp_async_commit();
    const uint32_t st = base + (j % kRpStages) * Tile::kStage;
    const uint32_t a_s = st + wm * kRpPanel;
    const uint32_t b_s = st + kRpA + ((kRpWarpCols * wn) >> 6) * kRpPanel;
    const int b_c0 = ((kRpWarpCols * wn) & 63) >> 3;
#pragma unroll
    for (int ks = 0; ks < kRpK / 16; ++ks) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_at(a[mi], a_s, 16 * ks, 2 * mi, lane);
#pragma unroll
      for (int np = 0; np < kRpWarpCols / 16; ++np) {
        uint32_t b[4];
        ldsm_trans(b, b_s, 16 * ks, b_c0 + 2 * np, lane);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* c = p.c + static_cast<long long>(blockIdx.y) * p.m * p.n;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nt = 0; nt < kRpWarpCols / 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 64 * wm + 16 * mi + g + 8 * h;
        const int n = n0 + kRpWarpCols * wn + 8 * nt + 2 * t;
        if (p.transposed) {
          c[static_cast<long long>(n) * p.m + m] = acc[mi][nt][2 * h];
          c[static_cast<long long>(n + 1) * p.m + m] = acc[mi][nt][2 * h + 1];
        } else {
          *reinterpret_cast<float2*>(c + static_cast<long long>(m) * p.n +
                                     n) =
              make_float2(acc[mi][nt][2 * h], acc[mi][nt][2 * h + 1]);
        }
      }
}

// Output tiles of the products (p1 counted where it is not p0): the
// grid's x extent.
template <int kN>
int row_product_tiles(const RowProduct& p) {
  return (p.m / kRpTileM) * (p.n / kN);
}

template <int kN>
cudaError_t launch_row_product(const RowProduct& p0, const RowProduct* p1,
                               int rows, int splits, cudaStream_t s) {
  using Tile = RowProductTile<kN>;
  cudaError_t err = cudaFuncSetAttribute(
      row_product_bf16_kernel<kN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tile::kSmem));
  if (err != cudaSuccess) return err;
  const int tiles =
      row_product_tiles<kN>(p0) + (p1 ? row_product_tiles<kN>(*p1) : 0);
  row_product_bf16_kernel<kN><<<dim3(tiles, splits), Tile::kThreads,
                                Tile::kSmem, s>>>(p0, p1 ? *p1 : p0, rows);
  return cudaGetLastError();
}

}  // namespace neurst
