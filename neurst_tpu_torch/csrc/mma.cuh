// Tensor-core fragments and staging helpers shared by the fused-FFN,
// fused-xent and flash-attention kernels (sm_90a): dtype conversions,
// the exponential on the special-function unit, the warp-level
// mma.sync.m16n8k16 bf16 product and a float32 FMA product in its
// accumulator layout, 16-byte vector staging by plain loads (the float32
// fused-FFN kernels) and by cp.async into swizzled tiles read with
// ldmatrix (flash attention, the bf16 fused FFN and fused linear xent).
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16 x 16 row-major: a0 (row g, k 2t, 2t+1), a1 (row g+8, k 2t..),
//                        a2 (row g, k 2t+8..), a3 (row g+8, k 2t+8..)
//   B 16 x 8 (k x n):    b0 (k 2t, 2t+1; n g), b1 (k 2t+8, 2t+9; n g)
//   C 16 x 8 float32:    c0, c1 (row g, n 2t, 2t+1), c2, c3 (row g+8, ..)
// Each 32-bit register holds two bf16, the lower column in the low half.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace neurst {

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

// 2^x on the special-function unit (ex2.approx.ftz: relative error
// ~2^-22, results below 2^-126 flushed to 0, -inf gives 0), in place of
// exp2f's range-checked sequence
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16 and packed: lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += A B on the tensor cores, bf16 operands, float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  mma_bf16(c, a[0], a[1], a[2], a[3], b0, b1);
}

// One warp: acc[j] += A[16 x K] * B_j[8 x K]^T for j < NT in float32 by
// FMA, in the m16n8 accumulator layout of mma.sync (element i of acc[j]
// is row g + 8 (i >> 1), column 8 j + 2 t + (i & 1)): the float32
// fused-FFN kernels.  A is row-major [16][lda] (k contiguous), B is
// [NT * 8][ldb] (k contiguous).
template <int NT>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4],
                                          const float* A, int lda,
                                          const float* B, int ldb, int K,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float a_lo = A[g * lda + k], a_hi = A[(g + 8) * lda + k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = B[(8 * j + 2 * t) * ldb + k];
      const float b1 = B[(8 * j + 2 * t + 1) * ldb + k];
      acc[j][0] = fmaf(a_lo, b0, acc[j][0]);
      acc[j][1] = fmaf(a_lo, b1, acc[j][1]);
      acc[j][2] = fmaf(a_hi, b0, acc[j][2]);
      acc[j][3] = fmaf(a_hi, b1, acc[j][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// Staging moves 16-byte vectors (8 bf16 or 4 float): every leading
// dimension, column offset and tile width is a multiple of 8 elements,
// every shared-memory pitch a multiple of 16 bytes, and the wrapper
// passes 16-byte aligned tensors.
template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
};

// the 16-byte vector at src[(r0 + r) * ld + c], zero at or past `limit`
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* src, long long ld, int r0,
                                          int r, int c, int limit) {
  if (r0 + r >= limit) return make_uint4(0u, 0u, 0u, 0u);
  return *reinterpret_cast<const uint4*>(
      src + static_cast<long long>(r0 + r) * ld + c);
}

// dst[r][c] = src[(r0 + r) * ld + c0 + c] for r < rows, c < cols, by a
// block of NTHREADS; rows at or past `limit` read as zero
template <int NTHREADS, typename T>
__device__ __forceinline__ void load_tile(T* dst, int pitch, const T* src,
                                          long long ld, int r0, int c0,
                                          int rows, int cols, int limit,
                                          int tid) {
  constexpr int V = Vec<T>::n;
  const int vcols = cols / V;
  for (int i = tid; i < rows * vcols; i += NTHREADS) {
    const int r = i / vcols, c = (i % vcols) * V;
    *reinterpret_cast<uint4*>(dst + r * pitch + c) =
        load_vec(src, ld, r0, r, c0 + c, limit);
  }
}

// dst[c][r] = src[(r0 + r) * ld + c0 + c] (transposed), zero past `limit`.
// Neighbouring threads take neighbouring rows, so the scalar stores of
// one vector element land on distinct banks.
template <int NTHREADS, typename T>
__device__ __forceinline__ void load_tile_t(T* dst, int pitch, const T* src,
                                            long long ld, int r0, int c0,
                                            int rows, int cols, int limit,
                                            int tid) {
  constexpr int V = Vec<T>::n;
  for (int i = tid; i < rows * (cols / V); i += NTHREADS) {
    const int r = i % rows, c = (i / rows) * V;
    const uint4 v = load_vec(src, ld, r0, r, c0 + c, limit);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int j = 0; j < V; ++j) dst[(c + j) * pitch + r] = e[j];
  }
}

// ------------------------------------------- cp.async and ldmatrix staging

// x, as a value the compiler cannot see through: what is derived from it
// inside a loop is computed there, not hoisted and held in registers (the
// bf16 kernels recompute their copies' addresses each chunk this way, so
// the accumulators keep the registers)
__device__ __forceinline__ int opaque(int x) {
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
  return x;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory, asynchronously; zeros
// when !in (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 16 : 0));
}

// 4 bytes, for float32 row statistics whose rows are not 16-byte aligned
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Tiles of 64 rows x 64 bf16 (128-byte rows of eight 16-byte chunks),
// chunk c of row r stored at chunk c ^ (r & 7): the eight rows one
// ldmatrix matrix reads sit on eight distinct bank groups.
constexpr int kSwzRows = 64;
constexpr int kSwzBytes = kSwzRows * 128;

__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// rows [t0, t0 + 64) of a [T, 64] bf16 slice with row stride `stride`
// (elements) into the swizzled tile at `tile`, by a block of NTHREADS
// with 16-byte cp.async; rows at or past t_len are zero
template <int NTHREADS>
__device__ __forceinline__ void load_tile_async(uint32_t tile,
                                                const __nv_bfloat16* base,
                                                long long stride, int t0,
                                                int t_len, int tid) {
  static_assert(kSwzRows * 8 % NTHREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < kSwzRows * 8 / NTHREADS; ++j) {
    const int i = tid + j * NTHREADS;
    const int r = i >> 3, c = i & 7;
    const bool in = t0 + r < t_len;
    const __nv_bfloat16* src =
        in ? base + static_cast<long long>(t0 + r) * stride + 8 * c : base;
    cp_async16(tile + swz(r, c), src, in);
  }
}

// Four 8 x 8 bf16 matrices from a swizzled tile.  Lane l addresses row
// r0 + (l & 15), chunk c0 + (l >> 4): with .trans this gives the B
// fragments (k = rows 16 kk.., n = 16 columns at chunk c0) of a [k][n]
// tile, b0, b1 of n-tile c0 in r[0], r[1] and of c0 + 1 in r[2], r[3];
// without it, the A fragment of rows r0.., k at chunk c0 (a0..a3).
__device__ __forceinline__ void ldsm_a(uint32_t (&r)[4], uint32_t tile,
                                       int r0, int c0, int lane) {
  const uint32_t addr = tile + swz(r0 + (lane & 15), c0 + (lane >> 4));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_trans(uint32_t (&r)[4], uint32_t tile,
                                           int r0, int c0, int lane) {
  const uint32_t addr = tile + swz(r0 + (lane & 15), c0 + (lane >> 4));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The B fragments of a [n][k] tile (rows n, k contiguous, as K is for
// Q K^T): n-tiles r0.. and r0 + 8, k at chunks c0, c0 + 1; lane l
// addresses row r0 + (l & 7) + 8 (l >> 4), chunk c0 + ((l >> 3) & 1).
// b0, b1 of n-tile r0 land in r[0], r[1], of r0 + 8 in r[2], r[3].
__device__ __forceinline__ void ldsm_b(uint32_t (&r)[4], uint32_t tile,
                                       int r0, int c0, int lane) {
  const uint32_t addr = tile + swz(r0 + (lane & 7) + ((lane >> 4) << 3),
                                   c0 + ((lane >> 3) & 1));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The A fragment (rows m, k) of a TRANSPOSED [k][m] tile (m contiguous,
// as a product over rows reads its left operand): k rows r0 .. r0 + 15,
// m columns at chunks c0, c0 + 1.  ldsm_b's addressing with .trans:
// a0 (m 0-7, k 0-7), a1 (m 8-15, k 0-7), a2 (m 0-7, k 8-15), a3.
__device__ __forceinline__ void ldsm_at(uint32_t (&r)[4], uint32_t tile,
                                        int r0, int c0, int lane) {
  const uint32_t addr = tile + swz(r0 + (lane & 7) + ((lane >> 4) << 3),
                                   c0 + ((lane >> 3) & 1));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// A [ROWS][COLS] bf16 tile (COLS a multiple of 64) is stored as COLS / 64
// swizzled panels of [ROWS][64], panel p at tile + p * ROWS * 128, so
// ldsm_* address a panel as they address a 64-wide tile.  This copies
// rows [r0, r0 + ROWS) and columns [c0, c0 + COLS) of a row-major matrix
// with leading dimension ld by 16-byte cp.async (neighbouring threads
// take neighbouring chunks of a row); rows at or past `limit` are zero.
template <int NTHREADS, int ROWS, int COLS>
__device__ __forceinline__ void load_panels_async(uint32_t tile,
                                                  const __nv_bfloat16* src,
                                                  long long ld, int r0,
                                                  int c0, int limit,
                                                  int tid) {
  constexpr int kChunks = COLS / 8;
  static_assert(ROWS * kChunks % NTHREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / NTHREADS; ++j) {
    const int i = tid + j * NTHREADS;
    const int r = i / kChunks, cc = i % kChunks;
    const bool in = r0 + r < limit;
    const __nv_bfloat16* p =
        in ? src + static_cast<long long>(r0 + r) * ld + c0 + 8 * cc : src;
    cp_async16(tile + (cc >> 3) * (ROWS * 128) + swz(r, cc & 7), p, in);
  }
}

}  // namespace neurst
