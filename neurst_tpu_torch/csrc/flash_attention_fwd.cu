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
// bfloat16 (the path's dtype): tensor cores.  One block of 4 warps per
// (64-query tile, b n slice), each warp owning 16 query rows.  Q's tile
// comes in once by 16-byte cp.async (a row of 64 bf16 is 128 contiguous
// bytes even in the fused qkv view) and goes to registers by ldmatrix; K
// and V tiles of 64 keys stream through a cp.async ring in shared memory,
// swizzled so that ldmatrix reads them without bank conflicts.  S = Q K^T
// and O += P V run on mma.sync.m16n8k16 (bf16 in, float32 out).  The
// online softmax (m, l) lives in registers per accumulator row, and P's
// accumulator fragments, rounded to bf16 where the TPU rounds them,
// become the A fragments of P V with no trip through shared memory.
// With dropout the block's 128 threads first draw the tile's keep bits
// into a 512-byte bitmask (csrc/flash_tile.cuh, one Philox call per four
// elements), double-buffered so one barrier a tile serves both.
//
// What bounds it on an H100: memory.  At the training shape ([40, 750,
// 4, 64] with the kernel check's lengths, 38.8 M valid pairs) one call
// moves 44 MB and does 9.9 GFLOP (13 us at 3.35 TB/s, 10 us at the bf16
// peak); tiles past a row's length are neither read nor multiplied.  The
// kernel runs at about 4.5x that: it is held by the exponentials (one
// SFU op per score), by the issue of ldmatrix and mma.sync from 12 warps
// an SM, and by one barrier a tile.  With dropout the Philox integer
// work (ten rounds of two wide multiplies and XORs a call, one call per
// four scores), which no byte or operation bound counts, takes about
// half of its time.
//
// float32 (only the card-vs-CPU checks run it) keeps the first design:
// the products as float32 FMA loops out of shared memory, 4 threads per
// query row, since TF32 mma would not hold those checks' tolerance.
//
// Layout: q [B, Tq, N, H], k/v [B, Tk, N, H] with arbitrary element
// strides over B, T and N (the head dim must be contiguous; bf16 views
// 16-byte aligned), so the fused qkv projection's slices need no copy.
// o is written contiguous [B, Tq, N, H]; lse is [B, N, Tq] float32.

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
constexpr int kStages = 2;  // K/V ring depth
// Q tile, the K and V rings, two 64 x 2-word keep bitmasks
constexpr size_t kSmem = (1 + 2 * kStages) * kSwzBytes + 2 * 128 * 4;

template <bool kCausal, bool kDropout>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ lengths,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int n_heads, int t_q, int t_k, Strides qs_,
                      Strides ks_, Strides vs_, float scale,
                      unsigned threshold, float inv_keep, DropoutSite site) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_s = smem_addr(smem);
  const uint32_t k_s = q_s + kSwzBytes;               // kStages tiles
  const uint32_t v_s = k_s + kStages * kSwzBytes;     // kStages tiles
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + kSmem - 2 * 128 * 4);

  const int bn = blockIdx.y;
  const int b = bn / n_heads;
  const int n = bn % n_heads;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int valid = min(max(lengths[b], 0), t_k);
  // keys past `valid` (and, causally, past the tile's last row) are
  // masked for every row of the block: those tiles would change nothing
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
  }
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load_kv(j);
    cp_async_commit();
  }

  // rows row[0] = q0 + 16 warp + g and row[1] = row[0] + 8
  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const float scale_log2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[8][4];
  zero(acc);
  uint32_t qf[4][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    uint32_t* tile_bits = bits + (j & 1) * 128;
    if (kDropout)
      keep_bits<kCausal>(tile_bits, bn, t_q, t_k, q0, k0, valid, threshold,
                         site, tid);
    cp_async_wait<kStages - 2>();  // tile j (and Q) landed
    __syncthreads();  // ... for every thread; tile j - 1 is consumed
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldsm_a(qf[kk], q_s, 16 * warp, 2 * kk,
                                            lane);
    }
    if (j + kStages - 1 < n_tiles) load_kv(j + kStages - 1);
    cp_async_commit();
    const uint32_t k_t = k_s + (j % kStages) * kSwzBytes;
    const uint32_t v_t = v_s + (j % kStages) * kSwzBytes;

    // s[nt] = the 16 x 8 scores of keys k0 + 8 nt ..
    float s[8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldsm_b(kb, k_t, 16 * np, 2 * kk, lane);
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }

    // online softmax per accumulator row (the quad of lanes g shares it)
    uint32_t kw[2][2];  // keep words of this thread's two rows
    if (kDropout) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint2 w = *reinterpret_cast<const uint2*>(
            tile_bits + 2 * (row[r] - q0));
        kw[r][0] = w.x;
        kw[r][1] = w.y;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // masked scores become -inf, which the exponential takes to 0
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * nt + 2 * t + e;
          const bool ok = col < valid && (!kCausal || col <= row[r]);
          s[nt][2 * r + e] = ok ? s[nt][2 * r + e] : -INFINITY;
          mx = fmaxf(mx, s[nt][2 * r + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // m, in log2 units of the scaled scores, starts finite: a row with
      // no valid key yet keeps alpha = 1 and p = 0
      const float m_new = fmaxf(m[r], mx * scale_log2);
      const float alpha = fast_exp2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][2 * r] *= alpha;
        acc[nt][2 * r + 1] *= alpha;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * nt + 2 * t + e;
          const float p =
              fast_exp2(fmaf(s[nt][2 * r + e], scale_log2, -m_new));
          // the normaliser takes the unrounded, un-dropped p; P.V the
          // dropped p in bf16
          l[r] += p;
          float pd = p;
          if (kDropout)
            pd = (kw[r][nt >> 2] >> (c & 31)) & 1u ? p * inv_keep : 0.f;
          s[nt][2 * r + e] = pd;
        }
      }
    }

    // acc += P V: P's fragments of keys 16 kk .. are the A operand
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t vb[4];
        ldsm_trans(vb, v_t, 16 * kk, 2 * np, lane);
        mma_bf16(acc[2 * np], a, vb[0], vb[1]);
        mma_bf16(acc[2 * np + 1], a, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l_row = l[r];
    l_row += __shfl_xor_sync(0xffffffffu, l_row, 1);
    l_row += __shfl_xor_sync(0xffffffffu, l_row, 2);
    if (row[r] >= t_q) continue;
    const float inv = 1.f / fmaxf(l_row, 1e-20f);
    __nv_bfloat16* o_row =
        o + ((static_cast<long long>(b) * t_q + row[r]) * n_heads + n) *
                kHeadDim;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<uint32_t*>(o_row + 8 * nt + 2 * t) = pack_bf16(
          acc[nt][2 * r] * inv, acc[nt][2 * r + 1] * inv);
    if (t == 0)
      lse[static_cast<long long>(bn) * t_q + row[r]] =
          l_row > 0.f ? m[r] / kLog2e + logf(fmaxf(l_row, 1e-37f))
                      : kNegInf;
  }
}

// ------------------------------------------ float32: FMA loops (checks)

constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 32;   // keys per tile
constexpr int kThreads = 256;
constexpr int kColsPerThread = kBlockN / 4;
constexpr int kDimsPerThread = kHeadDim / 4;

// Thread (row, sub) of 256 owns key columns sub + 4 j of each 32-key
// tile and output dims sub + 4 i, which keeps its shared-memory reads on
// distinct banks.
template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ lengths, float* __restrict__ o,
                     float* __restrict__ lse, int n_heads, int t_q, int t_k,
                     Strides qs_, Strides ks_, Strides vs_, float scale,
                     unsigned threshold, float inv_keep, DropoutSite site) {
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

  const float* q_base = q + b * qs_.b + n * qs_.n;
  const float* k_base = k + b * ks_.b + n * ks_.n;
  const float* v_base = v + b * vs_.b + n * vs_.n;

  for (int i = tid; i < kBlockM * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim, h = i % kHeadDim;
    const int t = q0 + r;
    q_tile[r][h] = t < t_q ? q_base[t * qs_.t + h] : 0.f;
  }

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
      k_tile[r][h] = in ? k_base[t * ks_.t + h] : 0.f;
      v_tile[r][h] = in ? v_base[t * vs_.t + h] : 0.f;
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
      float pd = p;
      if (threshold != 0u && ok)
        pd = dropout_keep(
                 (static_cast<unsigned long long>(bn) * t_q + q_row) * t_k +
                     col,
                 site, threshold)
                 ? p * inv_keep
                 : 0.f;
      p_tile[row][sub + 4 * j] = pd;
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
    float* o_row = o + ((static_cast<long long>(b) * t_q + q_row) * n_heads
                        + n) * kHeadDim;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i)
      o_row[sub + 4 * i] = acc[i] / denom;
    if (sub == 0)
      lse[static_cast<long long>(bn) * t_q + q_row] =
          l > 0.f ? m + logf(fmaxf(l, 1e-37f)) : kNegInf;
  }
}

struct Args {
  const void *q, *k, *v;
  const int* lengths;
  void* o;
  float* lse;
  int batch, n_heads, t_q, t_k;
  Strides qs, ks, vs;
  unsigned threshold;
  float inv_keep;
  DropoutSite site;
  cudaStream_t stream;
};

template <bool kCausal, bool kDropout>
cudaError_t launch_bf16(const Args& a) {
  auto kernel = flash_fwd_bf16_kernel<kCausal, kDropout>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  using B = __nv_bfloat16;
  const dim3 grid((a.t_q + kTile - 1) / kTile, a.batch * a.n_heads);
  kernel<<<grid, kMmaThreads, kSmem, a.stream>>>(
      static_cast<const B*>(a.q), static_cast<const B*>(a.k),
      static_cast<const B*>(a.v), a.lengths, static_cast<B*>(a.o), a.lse,
      a.n_heads, a.t_q, a.t_k, a.qs, a.ks, a.vs, kScale, a.threshold,
      a.inv_keep, a.site);
  return cudaGetLastError();
}

template <bool kCausal>
cudaError_t launch_f32(const Args& a) {
  const dim3 grid((a.t_q + kBlockM - 1) / kBlockM, a.batch * a.n_heads);
  flash_fwd_f32_kernel<kCausal><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.lengths, static_cast<float*>(a.o),
      a.lse, a.n_heads, a.t_q, a.t_k, a.qs, a.ks, a.vs, kScale, a.threshold,
      a.inv_keep, a.site);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  Strides are in
// elements.  dtype: 0 = float32, 1 = bfloat16 (16-byte aligned views).
// threshold 0 = no dropout; else the dropout site (k0, k1, stream_id,
// micro) and the scale inv_keep = 1 / (1 - rate).
extern "C" int neurst_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths,
    void* o, void* lse, int batch, int n_heads, int t_q, int t_k,
    int head_dim, long long q_sb, long long q_st, long long q_sn,
    long long k_sb, long long k_st, long long k_sn, long long v_sb,
    long long v_st, long long v_sn, int causal, int dtype,
    unsigned threshold, float inv_keep, unsigned k0, unsigned k1,
    unsigned stream_id, unsigned micro, void* stream) {
  const Args a{q, k, v, static_cast<const int*>(lengths), o,
               static_cast<float*>(lse), batch, n_heads, t_q, t_k,
               Strides{q_sb, q_st, q_sn}, Strides{k_sb, k_st, k_sn},
               Strides{v_sb, v_st, v_sn}, threshold, inv_keep,
               DropoutSite{k0, k1, stream_id, micro},
               static_cast<cudaStream_t>(stream)};
  if (head_dim != kHeadDim || batch <= 0 || n_heads <= 0 || t_q <= 0 ||
      t_k <= 0 || batch * n_heads > 65535 || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && !(aligned16(q, a.qs) && aligned16(k, a.ks) &&
                       aligned16(v, a.vs))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0)
    err = causal ? launch_f32<true>(a) : launch_f32<false>(a);
  else if (threshold)
    err = causal ? launch_bf16<true, true>(a) : launch_bf16<false, true>(a);
  else
    err = causal ? launch_bf16<true, false>(a) : launch_bf16<false, false>(a);
  return static_cast<int>(err);
}
