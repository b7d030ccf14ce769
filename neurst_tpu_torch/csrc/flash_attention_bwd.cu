// Flash-attention backward for Hopper (sm_90a), plain C interface: two
// kernels, dq and dk/dv, no atomics.
//
// Replaces: neurst_tpu/ops/flash_attention.py:_dq_kernel (the Pallas
// call at :435) and :_dkv_kernel (the call at :474).  Both recompute
// p = exp(s - lse) from the forward's row
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
// With attention dropout (training) the kernels regenerate the forward's
// mask (csrc/philox.cuh, at the absolute index (bn Tq + q) Tk + k, which
// does not depend on the tiling) and, as the TPU kernels do
// (:218-230, :286-309), form pm = keep ? p / (1 - rate) : 0,
// ds = pm dp - p delta and dv = round(pm)^T dO.
//
// bfloat16 (the path's dtype): tensor cores, 4 warps a block, every
// product on mma.sync.m16n8k16 (bf16 in, float32 out), every operand
// staged by 16-byte cp.async into swizzled tiles read by ldmatrix.
//   dq: one block per 64-query tile; Q and dO come in once and stay in
//       registers as A fragments (16 rows a warp); K and V tiles of 64
//       keys stream through a cp.async ring.  For each 16 keys a warp
//       computes S = Q K^T and dP = dO V^T, forms dS in its accumulator
//       fragments and, rounded to bf16, feeds them as the A operand of
//       dq += dS K, with K read transposed by ldmatrix.trans.
//   dk/dv: one block per 64-key tile; K and V stay in registers (16 keys
//       a warp); Q, dO and the rows' lse and delta stream through the
//       ring.  The warp computes the TRANSPOSED scores S^T = K Q^T and
//       dP^T = V dO^T, so P^T and dS^T come out in accumulator layout and
//       serve directly as A fragments of dv += round(pm)^T dO and
//       dk += round(dS)^T Q (dO and Q read by ldmatrix.trans); lse and
//       delta are read by column.
// With dropout each block's 128 threads draw the tile's keep bits into a
// 512-byte bitmask, one Philox call per four elements, double-buffered
// (csrc/flash_tile.cuh); lanes read their bits from it.
//
// What bounds it on an H100: at the training slice's shape
// ([40, 750, 4, 64] bf16, 38.8 M valid pairs) dq moves 60 MB and does
// 14.9 GFLOP, dk/dv 76 MB and 19.9 GFLOP: memory bounds both (18 and
// 23 us), the tensor cores nearly so (15 and 20 us).  What stops the
// kernels short of it: the issue of ldmatrix and mma.sync (12 ldmatrix a
// 24 mma in dq, 16 a 32 in dk/dv; each warp re-reads the tile it shares
// with three others), one exponential per score, 12 warps an SM at 168
// registers, and, with dropout, the Philox integer work (one call per
// four scores, regenerated by the forward and both backward kernels).
//
// float32 (only the card-vs-CPU checks run it) keeps the first design:
// float32 FMA loops out of shared memory, each of 256 threads owning a
// 4 x 4 tile of the 64 x 64 score block and of its output, tiles stored
// transposed with a pitch of 65; TF32 mma would not hold those checks'
// tolerance.
//
// Layout: q, dO [B, Tq, N, H] and k, v [B, Tk, N, H] with arbitrary
// element strides over B, T and N (the head dim contiguous; bf16 views
// 16-byte aligned), so the fused qkv projection's slices need no copy;
// lse and delta [B, N, Tq] float32; dq [B, Tq, N, H], dk and dv
// [B, Tk, N, H] written contiguous.
//
// Grids: dq (ceil(Tq / 64), B * N), looping over k tiles up to the valid
// length (and the causal edge); dk/dv (ceil(Tk / 64), B * N), looping
// over q tiles from the causal lower bound; a k tile wholly past the
// length writes zeros and returns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile.cuh"
#include "mma.cuh"
#include "philox.cuh"

namespace {

using namespace neurst;
using namespace neurst::flash;

// ------------------------------------------------ bfloat16: tensor cores

constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kStages = 2;         // ring depth
constexpr int kBitsBytes = 2 * 128 * 4;  // two 64 x 2-word keep bitmasks
constexpr int kStatsBytes = 2 * kTile * 4;  // lse and delta of a q tile
// Q and dO tiles, the K and V rings, the bitmasks
constexpr size_t kDqSmemBf16 = (2 + 2 * kStages) * kSwzBytes + kBitsBytes;
// K and V tiles, the Q and dO rings, the stats ring, the bitmasks
constexpr size_t kDkvSmemBf16 =
    (2 + 2 * kStages) * kSwzBytes + kStages * kStatsBytes + kBitsBytes;

template <bool kCausal, bool kDropout>
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ lengths,
                     __nv_bfloat16* __restrict__ dq, int n_heads, int t_q,
                     int t_k, Strides qs_, Strides ks_, Strides vs_,
                     Strides ds_, float scale, unsigned threshold,
                     float inv_keep, DropoutSite site) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_s = smem_addr(smem);
  const uint32_t do_s = q_s + kSwzBytes;
  const uint32_t k_s = do_s + kSwzBytes;          // kStages tiles
  const uint32_t v_s = k_s + kStages * kSwzBytes;  // kStages tiles
  uint32_t* bits =
      reinterpret_cast<uint32_t*>(smem + (2 + 2 * kStages) * kSwzBytes);

  const int bn = blockIdx.y;
  const int b = bn / n_heads;
  const int n = bn % n_heads;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int valid = min(max(lengths[b], 0), t_k);
  // keys past `valid` (and, causally, past the tile's last row) are
  // masked for every row of the block: those tiles add nothing
  const int kv_end = kCausal ? min(valid, q0 + kTile) : valid;
  const int n_tiles = (kv_end + kTile - 1) / kTile;

  const __nv_bfloat16* k_base = k + b * ks_.b + n * ks_.n;
  const __nv_bfloat16* v_base = v + b * vs_.b + n * vs_.n;
  auto load_kv = [&](int j) {
    const int stage = j % kStages;
    load_tile_async<kMmaThreads>(k_s + stage * kSwzBytes, k_base, ks_.t,
                                 j * kTile, t_k, tid);
    load_tile_async<kMmaThreads>(v_s + stage * kSwzBytes, v_base, vs_.t,
                                 j * kTile, t_k, tid);
  };
  if (n_tiles > 0) {
    load_tile_async<kMmaThreads>(q_s, q + b * qs_.b + n * qs_.n, qs_.t, q0,
                                 t_q, tid);
    load_tile_async<kMmaThreads>(do_s, dout + b * ds_.b + n * ds_.n, ds_.t,
                                 q0, t_q, tid);
  }
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load_kv(j);
    cp_async_commit();
  }

  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const float scale_log2 = scale * kLog2e;
  float lse_log2[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < t_q;
    const long long at = static_cast<long long>(bn) * t_q + row[r];
    lse_log2[r] = in ? lse[at] * kLog2e : 0.f;
    row_delta[r] = in ? delta[at] : 0.f;
  }
  float acc[8][4];
  zero(acc);
  uint32_t qf[4][4], dof[4][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    uint32_t* tile_bits = bits + (j & 1) * 128;
    if (kDropout)
      keep_bits<kCausal>(tile_bits, bn, t_q, t_k, q0, k0, valid, threshold,
                         site, tid);
    cp_async_wait<kStages - 2>();  // tile j (and Q, dO) landed
    __syncthreads();  // ... for every thread; tile j - 1 is consumed
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldsm_a(qf[kk], q_s, 16 * warp, 2 * kk, lane);
        ldsm_a(dof[kk], do_s, 16 * warp, 2 * kk, lane);
      }
    }
    if (j + kStages - 1 < n_tiles) load_kv(j + kStages - 1);
    cp_async_commit();
    const uint32_t k_t = k_s + (j % kStages) * kSwzBytes;
    const uint32_t v_t = v_s + (j % kStages) * kSwzBytes;

#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {  // keys k0 + 16 kc ..
      float s[2][4], dp[2][4];
      zero(s);
      zero(dp);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t kb[4], vb[4];
        ldsm_b(kb, k_t, 16 * kc, 2 * kk, lane);
        mma_bf16(s[0], qf[kk], kb[0], kb[1]);
        mma_bf16(s[1], qf[kk], kb[2], kb[3]);
        ldsm_b(vb, v_t, 16 * kc, 2 * kk, lane);
        mma_bf16(dp[0], dof[kk], vb[0], vb[1]);
        mma_bf16(dp[1], dof[kk], vb[2], vb[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const int c = 16 * kc + 8 * nt + 2 * t + (i & 1);
          const bool ok =
              k0 + c < valid && (!kCausal || k0 + c <= row[r]);
          const float p =
              ok ? fast_exp2(fmaf(s[nt][i], scale_log2, -lse_log2[r])) : 0.f;
          float ds = p * (dp[nt][i] - row_delta[r]);
          if (kDropout) {
            // keep word of row r, keys 32 (kc >> 1) ..: read where used,
            // which keeps the kernel within its registers
            const uint32_t kw = tile_bits[2 * (row[r] - q0) + (kc >> 1)];
            const bool keep = (kw >> (c & 31)) & 1u;
            ds = (keep ? p * inv_keep : 0.f) * dp[nt][i] - p * row_delta[r];
          }
          s[nt][i] = ds;
        }
      // acc += round(dS) K: dS's fragments are the A operand (k = keys)
      const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]),
                             pack_bf16(s[0][2], s[0][3]),
                             pack_bf16(s[1][0], s[1][1]),
                             pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldsm_trans(kb, k_t, 16 * kc, 2 * np, lane);
        mma_bf16(acc[2 * np], a, kb[0], kb[1]);
        mma_bf16(acc[2 * np + 1], a, kb[2], kb[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= t_q) continue;
    __nv_bfloat16* out =
        dq + ((static_cast<long long>(b) * t_q + row[r]) * n_heads + n) *
                 kHeadDim;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<uint32_t*>(out + 8 * nt + 2 * t) = pack_bf16(
          acc[nt][2 * r] * scale, acc[nt][2 * r + 1] * scale);
  }
}

// Three blocks an SM (at most 168 registers a thread): with the query
// loop kept rolled this fits without spilling and runs 1.2-1.3x faster
// than two blocks at 185 registers.
template <bool kCausal, bool kDropout>
__global__ void __launch_bounds__(kMmaThreads, 3)
flash_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ lengths,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int n_heads, int t_q,
                      int t_k, Strides qs_, Strides ks_, Strides vs_,
                      Strides ds_, float scale, unsigned threshold,
                      float inv_keep, DropoutSite site) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t k_s = smem_addr(smem);
  const uint32_t v_s = k_s + kSwzBytes;
  const uint32_t q_s = v_s + kSwzBytes;             // kStages tiles
  const uint32_t do_s = q_s + kStages * kSwzBytes;  // kStages tiles
  unsigned char* stats_p = smem + (2 + 2 * kStages) * kSwzBytes;
  const uint32_t stats_s = smem_addr(stats_p);  // kStages x [lse, delta]
  uint32_t* bits =
      reinterpret_cast<uint32_t*>(stats_p + kStages * kStatsBytes);

  const int bn = blockIdx.y;
  const int b = bn / n_heads;
  const int n = bn % n_heads;
  const int k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int valid = min(max(lengths[b], 0), t_k);
  const long long key_stride = static_cast<long long>(n_heads) * kHeadDim;
  __nv_bfloat16* dk_base =
      dk + (static_cast<long long>(b) * t_k * n_heads + n) * kHeadDim;
  __nv_bfloat16* dv_base =
      dv + (static_cast<long long>(b) * t_k * n_heads + n) * kHeadDim;

  if (k0 >= valid) {  // every key of the tile is masked for every row
    for (int i = tid; i < kTile * 8; i += kMmaThreads) {
      const int c = k0 + (i >> 3), h = 8 * (i & 7);
      if (c < t_k) {
        *reinterpret_cast<uint4*>(dk_base + c * key_stride + h) =
            make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dv_base + c * key_stride + h) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }

  // causally, rows before k0 attend no key of this tile
  const int q_start = kCausal ? k0 : 0;
  const int n_tiles = t_q > q_start ? (t_q - q_start + kTile - 1) / kTile
                                    : 0;
  const __nv_bfloat16* q_base = q + b * qs_.b + n * qs_.n;
  const __nv_bfloat16* do_base = dout + b * ds_.b + n * ds_.n;
  const long long stats_row = static_cast<long long>(bn) * t_q;
  auto load_q = [&](int i) {
    const int stage = i % kStages, qi0 = q_start + i * kTile;
    load_tile_async<kMmaThreads>(q_s + stage * kSwzBytes, q_base, qs_.t, qi0,
                                 t_q, tid);
    load_tile_async<kMmaThreads>(do_s + stage * kSwzBytes, do_base, ds_.t,
                                 qi0, t_q, tid);
    // thread tid < 64: lse of row qi0 + tid; else delta of row qi0 + tid - 64
    const int r = tid & (kTile - 1);
    const bool in = qi0 + r < t_q;
    const float* src = tid < kTile ? lse : delta;
    cp_async4(stats_s + stage * kStatsBytes + tid * 4,
              in ? src + stats_row + qi0 + r : src, in);
  };
  load_tile_async<kMmaThreads>(k_s, k + b * ks_.b + n * ks_.n, ks_.t, k0, t_k,
                               tid);
  load_tile_async<kMmaThreads>(v_s, v + b * vs_.b + n * vs_.n, vs_.t, k0, t_k,
                               tid);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_q(i);
    cp_async_commit();
  }

  // keys key[0] = k0 + 16 warp + g and key[1] = key[0] + 8, bits key_bit
  // and key_bit + 8 of the tile's keep words of the 32-key half `half`
  const int key[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  const int half = warp >> 1, key_bit = (16 * warp + g) & 31;
  const float scale_log2 = scale * kLog2e;
  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  uint32_t kf[4][4], vf[4][4];

  for (int i = 0; i < n_tiles; ++i) {
    const int qi0 = q_start + i * kTile;
    uint32_t* tile_bits = bits + (i & 1) * 128;
    if (kDropout)
      keep_bits<kCausal>(tile_bits, bn, t_q, t_k, qi0, k0, valid, threshold,
                         site, tid);
    cp_async_wait<kStages - 2>();  // tile i (and K, V) landed
    __syncthreads();  // ... for every thread; tile i - 1 is consumed
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldsm_a(kf[kk], k_s, 16 * warp, 2 * kk, lane);
        ldsm_a(vf[kk], v_s, 16 * warp, 2 * kk, lane);
      }
    }
    if (i + kStages - 1 < n_tiles) load_q(i + kStages - 1);
    cp_async_commit();
    const int stage = i % kStages;
    const uint32_t q_t = q_s + stage * kSwzBytes;
    const uint32_t do_t = do_s + stage * kSwzBytes;
    const float* lse_t =
        reinterpret_cast<const float*>(stats_p + stage * kStatsBytes);
    const float* delta_t = lse_t + kTile;

#pragma unroll 1
    for (int nq = 0; nq < 4; ++nq) {  // queries qi0 + 16 nq ..
      // st[nt], dpt[nt]: keys (rows) x queries qi0 + 16 nq + 8 nt ..
      float st[2][4], dpt[2][4];
      zero(st);
      zero(dpt);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t qb[4], db[4];
        ldsm_b(qb, q_t, 16 * nq, 2 * kk, lane);
        mma_bf16(st[0], kf[kk], qb[0], qb[1]);
        mma_bf16(st[1], kf[kk], qb[2], qb[3]);
        ldsm_b(db, do_t, 16 * nq, 2 * kk, lane);
        mma_bf16(dpt[0], vf[kk], db[0], db[1]);
        mma_bf16(dpt[1], vf[kk], db[2], db[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int ql = 16 * nq + 8 * nt + 2 * t;  // tile row of e = 0
        const float2 ls = *reinterpret_cast<const float2*>(lse_t + ql);
        const float2 dl = *reinterpret_cast<const float2*>(delta_t + ql);
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // query qi0 + ql + e
          const int query = qi0 + ql + e;
          const float lse_log2 = (e ? ls.y : ls.x) * kLog2e;
          const float row_delta = e ? dl.y : dl.x;
          // the query's keep bits of key[0] and key[1] at bits 0 and 8
          const uint32_t kw =
              kDropout ? tile_bits[2 * (ql + e) + half] >> key_bit : 0u;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e4 = 2 * r + e;
            const bool ok = query < t_q && key[r] < valid &&
                            (!kCausal || key[r] <= query);
            const float p =
                ok ? fast_exp2(fmaf(st[nt][e4], scale_log2, -lse_log2))
                   : 0.f;
            float pm = p;
            float ds = p * (dpt[nt][e4] - row_delta);
            if (kDropout) {
              pm = (kw >> (8 * r)) & 1u ? p * inv_keep : 0.f;
              ds = pm * dpt[nt][e4] - p * row_delta;
            }
            st[nt][e4] = pm;
            dpt[nt][e4] = ds;
          }
        }
      }
      // dv += round(pm)^T dO and dk += round(dS)^T Q: the transposed
      // fragments are the A operand (k = queries)
      const uint32_t a_p[4] = {pack_bf16(st[0][0], st[0][1]),
                               pack_bf16(st[0][2], st[0][3]),
                               pack_bf16(st[1][0], st[1][1]),
                               pack_bf16(st[1][2], st[1][3])};
      const uint32_t a_s[4] = {pack_bf16(dpt[0][0], dpt[0][1]),
                               pack_bf16(dpt[0][2], dpt[0][3]),
                               pack_bf16(dpt[1][0], dpt[1][1]),
                               pack_bf16(dpt[1][2], dpt[1][3])};
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t db[4], qb[4];
        ldsm_trans(db, do_t, 16 * nq, 2 * np, lane);
        mma_bf16(dv_acc[2 * np], a_p, db[0], db[1]);
        mma_bf16(dv_acc[2 * np + 1], a_p, db[2], db[3]);
        ldsm_trans(qb, q_t, 16 * nq, 2 * np, lane);
        mma_bf16(dk_acc[2 * np], a_s, qb[0], qb[1]);
        mma_bf16(dk_acc[2 * np + 1], a_s, qb[2], qb[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= t_k) continue;
    const long long at = key[r] * key_stride;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<uint32_t*>(dk_base + at + 8 * nt + 2 * t) =
          pack_bf16(dk_acc[nt][2 * r] * scale,
                    dk_acc[nt][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv_base + at + 8 * nt + 2 * t) =
          pack_bf16(dv_acc[nt][2 * r], dv_acc[nt][2 * r + 1]);
    }
  }
}

// ------------------------------------------ float32: FMA loops (checks)

constexpr int kThreads = 256;
constexpr int kPitch = kTile + 1;

typedef float Row[kPitch];

// rows [t0, t0 + kTile) of one (b, n) slice into dst[h][row] (transposed);
// rows at or past t_len read as zero
__device__ __forceinline__ void load_transposed(Row* dst, const float* base,
                                                long long stride_t, int t0,
                                                int t_len, int tid) {
  for (int i = tid; i < kTile * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim, h = i % kHeadDim;
    const int t = t0 + r;
    dst[h][r] = t < t_len ? base[t * stride_t + h] : 0.f;
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

template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ lengths, float* __restrict__ dq,
                    int n_heads, int t_q, int t_k, Strides qs_, Strides ks_,
                    Strides vs_, Strides ds_, float scale,
                    unsigned threshold, float inv_keep, DropoutSite site) {
  extern __shared__ float smem_f[];
  Row* qt = reinterpret_cast<Row*>(smem_f);  // [H][rows]
  Row* dot = qt + kHeadDim;                  // [H][rows]
  Row* kt = dot + kHeadDim;                  // [H][keys]
  Row* vt = kt + kHeadDim;                   // [H][keys]
  Row* ds_tile = vt + kHeadDim;              // [rows][keys]

  const int bn = blockIdx.y;
  const int b = bn / n_heads;
  const int n = bn % n_heads;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int valid = min(max(lengths[b], 0), t_k);

  const float* k_base = k + b * ks_.b + n * ks_.n;
  const float* v_base = v + b * vs_.b + n * vs_.n;
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
        float ds = p * (dp[i][j] - row_delta[i]);
        if (threshold != 0u) {
          const bool keep =
              ok && dropout_keep(
                        (static_cast<unsigned long long>(bn) * t_q + row) *
                                t_k + col,
                        site, threshold);
          ds = (keep ? p * inv_keep : 0.f) * dp[i][j] - p * row_delta[i];
        }
        ds_tile[ty + 16 * i][tx + 16 * j] = ds;
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
    float* out = dq + ((static_cast<long long>(b) * t_q + row) * n_heads + n)
                          * kHeadDim;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[tx + 16 * j] = acc[i][j] * scale;
  }
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ lengths, float* __restrict__ dk,
                     float* __restrict__ dv, int n_heads, int t_q, int t_k,
                     Strides qs_, Strides ks_, Strides vs_, Strides ds_,
                     float scale, unsigned threshold, float inv_keep,
                     DropoutSite site) {
  extern __shared__ float smem_f[];
  Row* kt = reinterpret_cast<Row*>(smem_f);  // [H][keys]
  Row* vt = kt + kHeadDim;                   // [H][keys]
  Row* qt = vt + kHeadDim;                   // [H][rows]
  Row* dot = qt + kHeadDim;                  // [H][rows]
  Row* p_tile = dot + kHeadDim;              // [rows][keys]
  Row* ds_tile = p_tile + kTile;             // [rows][keys]
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
  float* dk_base = dk + (static_cast<long long>(b) * t_k * n_heads + n)
                            * kHeadDim;
  float* dv_base = dv + (static_cast<long long>(b) * t_k * n_heads + n)
                            * kHeadDim;

  if (k0 >= valid) {  // every key of the tile is masked for every row
    for (int i = tid; i < kTile * kHeadDim; i += kThreads) {
      const int c = k0 + i / kHeadDim, h = i % kHeadDim;
      if (c < t_k) {
        dk_base[c * key_stride + h] = 0.f;
        dv_base[c * key_stride + h] = 0.f;
      }
    }
    return;
  }

  load_transposed(kt, k + b * ks_.b + n * ks_.n, ks_.t, k0, t_k, tid);
  load_transposed(vt, v + b * vs_.b + n * vs_.n, vs_.t, k0, t_k, tid);
  const float* q_base = q + b * qs_.b + n * qs_.n;
  const float* do_base = dout + b * ds_.b + n * ds_.n;

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
        float pm = p;
        float ds = p * (dp[i][j] - delta_tile[r]);
        if (threshold != 0u) {
          const bool keep =
              ok && dropout_keep(
                        (static_cast<unsigned long long>(bn) * t_q + row) *
                                t_k + col,
                        site, threshold);
          pm = keep ? p * inv_keep : 0.f;
          ds = pm * dp[i][j] - p * delta_tile[r];
        }
        p_tile[r][tx + 16 * j] = pm;
        ds_tile[r][tx + 16 * j] = ds;
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
      dk_base[c * key_stride + tx + 16 * j] = dk_acc[i][j] * scale;
      dv_base[c * key_stride + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

constexpr size_t kDqSmemF32 = 5 * kHeadDim * kPitch * sizeof(float);
constexpr size_t kDkvSmemF32 =
    (4 * kHeadDim + 2 * kTile) * kPitch * sizeof(float)
    + 2 * kTile * sizeof(float);

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* lengths;
  int batch, n_heads, t_q, t_k;
  Strides qs, ks, vs, ds;
  bool causal;
  unsigned threshold;
  float inv_keep;
  DropoutSite site;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
}

template <typename T>
const T* in_ptr(const void* p) {
  return static_cast<const T*>(p);
}

template <bool kCausal>
cudaError_t launch_dq_f32(const Args& a, void* dq) {
  auto kernel = flash_dq_f32_kernel<kCausal>;
  cudaError_t err = prepare(kernel, kDqSmemF32);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_q + kTile - 1) / kTile, a.batch * a.n_heads);
  kernel<<<grid, kThreads, kDqSmemF32, a.stream>>>(
      in_ptr<float>(a.q), in_ptr<float>(a.k), in_ptr<float>(a.v),
      in_ptr<float>(a.dout), a.lse, a.delta, a.lengths,
      static_cast<float*>(dq), a.n_heads, a.t_q, a.t_k, a.qs, a.ks, a.vs,
      a.ds, kScale, a.threshold,
      a.inv_keep, a.site);
  return cudaGetLastError();
}

template <bool kCausal>
cudaError_t launch_dkv_f32(const Args& a, void* dk, void* dv) {
  auto kernel = flash_dkv_f32_kernel<kCausal>;
  cudaError_t err = prepare(kernel, kDkvSmemF32);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_k + kTile - 1) / kTile, a.batch * a.n_heads);
  kernel<<<grid, kThreads, kDkvSmemF32, a.stream>>>(
      in_ptr<float>(a.q), in_ptr<float>(a.k), in_ptr<float>(a.v),
      in_ptr<float>(a.dout), a.lse, a.delta, a.lengths,
      static_cast<float*>(dk), static_cast<float*>(dv), a.n_heads, a.t_q,
      a.t_k, a.qs, a.ks, a.vs, a.ds,
      kScale, a.threshold, a.inv_keep,
      a.site);
  return cudaGetLastError();
}

template <bool kCausal, bool kDropout>
cudaError_t launch_dq_bf16(const Args& a, void* dq) {
  auto kernel = flash_dq_bf16_kernel<kCausal, kDropout>;
  cudaError_t err = prepare(kernel, kDqSmemBf16);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_q + kTile - 1) / kTile, a.batch * a.n_heads);
  using B = __nv_bfloat16;
  kernel<<<grid, kMmaThreads, kDqSmemBf16, a.stream>>>(
      in_ptr<B>(a.q), in_ptr<B>(a.k), in_ptr<B>(a.v), in_ptr<B>(a.dout),
      a.lse, a.delta, a.lengths, static_cast<B*>(dq), a.n_heads, a.t_q,
      a.t_k, a.qs, a.ks, a.vs, a.ds,
      kScale, a.threshold, a.inv_keep,
      a.site);
  return cudaGetLastError();
}

template <bool kCausal, bool kDropout>
cudaError_t launch_dkv_bf16(const Args& a, void* dk, void* dv) {
  auto kernel = flash_dkv_bf16_kernel<kCausal, kDropout>;
  cudaError_t err = prepare(kernel, kDkvSmemBf16);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_k + kTile - 1) / kTile, a.batch * a.n_heads);
  using B = __nv_bfloat16;
  kernel<<<grid, kMmaThreads, kDkvSmemBf16, a.stream>>>(
      in_ptr<B>(a.q), in_ptr<B>(a.k), in_ptr<B>(a.v), in_ptr<B>(a.dout),
      a.lse, a.delta, a.lengths, static_cast<B*>(dk), static_cast<B*>(dv),
      a.n_heads, a.t_q, a.t_k, a.qs, a.ks, a.vs, a.ds,
      kScale, a.threshold, a.inv_keep,
      a.site);
  return cudaGetLastError();
}

bool bad_args(const Args& a, int head_dim, int dtype) {
  return head_dim != kHeadDim || a.batch <= 0 || a.n_heads <= 0 ||
         a.t_q <= 0 || a.t_k <= 0 || a.batch * a.n_heads > 65535 ||
         (dtype != 0 && dtype != 1) ||
         (dtype == 1 &&
          !(aligned16(a.q, a.qs) && aligned16(a.k, a.ks) &&
            aligned16(a.v, a.vs) && aligned16(a.dout, a.ds)));
}

Args make_args(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               const void* lengths, int batch, int n_heads, int t_q,
               int t_k, const long long* strides, int causal,
               const unsigned* dropout, unsigned long long group,
               float inv_keep, void* stream) {
  return Args{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              static_cast<const int*>(lengths), batch, n_heads, t_q, t_k,
              Strides{strides[0], strides[1], strides[2]},
              Strides{strides[3], strides[4], strides[5]},
              Strides{strides[6], strides[7], strides[8]},
              Strides{strides[9], strides[10], strides[11]}, causal != 0,
              dropout[0], inv_keep,
              DropoutSite{dropout[1], dropout[2], dropout[3], dropout[4],
                          group},
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Both entry points return the cudaError_t of the launch (0 on success).
// `strides` holds 12 element strides: (b, t, n) of q, k, v and dO, in
// that order.  `dropout` holds 5 words: the threshold (0 = no dropout)
// and the site (k0, k1, stream, micro); `group` is the site's first
// element group; inv_keep = 1 / (1 - rate).
// dtype: 0 = float32, 1 = bfloat16 (16-byte aligned views; q, k, v, dO
// and the outputs share it).
extern "C" int neurst_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* lengths, void* dq,
    int batch, int n_heads, int t_q, int t_k, int head_dim,
    const long long* strides, int causal, int dtype,
    const unsigned* dropout, unsigned long long group, float inv_keep,
    void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, lengths, batch,
                           n_heads, t_q, t_k, strides, causal, dropout,
                           group, inv_keep, stream);
  if (bad_args(a, head_dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0)
    err = a.causal ? launch_dq_f32<true>(a, dq) : launch_dq_f32<false>(a, dq);
  else if (a.threshold)
    err = a.causal ? launch_dq_bf16<true, true>(a, dq)
                   : launch_dq_bf16<false, true>(a, dq);
  else
    err = a.causal ? launch_dq_bf16<true, false>(a, dq)
                   : launch_dq_bf16<false, false>(a, dq);
  return static_cast<int>(err);
}

extern "C" int neurst_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* lengths, void* dk,
    void* dv, int batch, int n_heads, int t_q, int t_k, int head_dim,
    const long long* strides, int causal, int dtype,
    const unsigned* dropout, unsigned long long group, float inv_keep,
    void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, lengths, batch,
                           n_heads, t_q, t_k, strides, causal, dropout,
                           group, inv_keep, stream);
  if (bad_args(a, head_dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0)
    err = a.causal ? launch_dkv_f32<true>(a, dk, dv)
                   : launch_dkv_f32<false>(a, dk, dv);
  else if (a.threshold)
    err = a.causal ? launch_dkv_bf16<true, true>(a, dk, dv)
                   : launch_dkv_bf16<false, true>(a, dk, dv);
  else
    err = a.causal ? launch_dkv_bf16<true, false>(a, dk, dv)
                   : launch_dkv_bf16<false, false>(a, dk, dv);
  return static_cast<int>(err);
}
