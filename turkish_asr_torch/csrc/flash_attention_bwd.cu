// Flash-attention backward for Hopper (sm_90a), MQA and MHA, on the tensor
// cores, with the forward's attention-weight dropout regenerated in the
// kernel.
//
// Replaces: turkish_asr_tpu/ops/_flash_attention_impl.py
//   _flash_attention_bwd_impl, the Kh == 1 branch (pallas_call at :422)
//   and the Kh == H branch (:491), tile body _bwd_tile (:317), and the
//   backward half of the in-kernel dropout (_keep_mask re-seeded at :397,
//   :465).
//
// Computes, with s the forward's scores, p = exp(s - m) / l the forward's
// normalized probabilities (m, l saved by the forward: bit for bit its p),
// keep the dropout mask scaled by 1/(1 - rate) (1 without dropout),
// g = dL/d out and delta = rowsum(g * out) (taken outside the kernel, as
// the TPU package takes it):
//   y  = p * keep                      (the probabilities the forward used)
//   dp = (g @ v^T) * keep
//   ds = p * (dp - delta) * scale      (scale = 1/sqrt(D), as _bwd_tile :360)
//   dq = ds @ k,   dk = ds^T @ q,   dv = y^T @ g       (all fp32)
// Rows past the row count and keys past T weigh 0. A row with no valid key
// is uniform in the forward and gets the matching finite gradient.
//
// What bounds it on the H100: 10*T'*T'*D flops per query head for the five
// products against T'*D*(H + 2) bf16 inputs, H*T'*D fp32 g and dq, and the
// fp32 dk, dv. At the main path's shapes (D = 64, T' <= 801) the bytes
// bound it, as for the forward; the kernels spend more than that on the
// scores computed in both kernels below, on the split products and on the
// exp, division and hash of every score.
//
// Design: the TPU kernel sums dk/dv over q tiles by read-modify-write of
// one output block, legal only because the TPU grid runs in order. Hopper
// blocks run in parallel, so this is the FlashAttention-2 split, with no
// atomics (deterministic):
//   - flash_bwd_dq: one block per (b, 64-row q tile), as the forward's
//     blocks: 4 warps of 16 rows loop over the 64-key K/V tiles
//     (double-buffered with cp.async), S = Q K^T and dP = G V^T on the
//     tensor cores, p and ds per element in the accumulator layout, and
//     dQ += dS K with dS repacked in registers as the A operand.
//   - flash_bwd_dkdv: one block per (b, kv head, 64-key tile, row chunk),
//     4 warps of 16 keys. It keeps its K and V tiles in shared memory and
//     loops over its chunk of the kv head's query rows (H*T folded rows for
//     MQA, whose heads share one kv head; T rows for MHA) in 64-row tiles,
//     double-buffered: S^T = K Q^T and dP^T = V G^T with keys as the rows,
//     so Y^T and dS^T are A operands in registers for dV += Y^T G and
//     dK += dS^T Q, 16 query rows at a time.
//   - The rows are split into chunks so that MQA, which has one kv head,
//     fills the card: at B = 4, T' = 801, 52 key tiles alone would occupy
//     52 of 132 SMs. Each chunk's dk/dv go to an fp32 scratch (allocated
//     by the wrapper), and flash_bwd_sum_chunks adds the chunks in a fixed
//     order. With one chunk the dk/dv kernel writes dk, dv itself.
// Both kernels recompute the scores and p from m and l with the forward's
// formula; the dropout mask comes from the position hash
// (dropout_hash.cuh) at each accumulator element's (row, key), which the
// fragment layout gives (flash_mma.cuh).
//
// Numerics: _bwd_tile takes every product on fp32 operands (g, ds and y
// are fp32), and the card check holds the kernels to 1e-4 of the largest
// gradient. q, k, v in bf16 are exact as bf16 operands; dS and Y enter
// the tensor cores as bf16 hi + lo pairs (flash_mma.cuh): two mma terms
// against a bf16 operand, three (hi*hi + hi*lo + lo*hi) against another
// pair, about 2^-16 relative a product. Rounding g, dS and Y once to bf16
// instead errs by up to 2^-9 relative per element, and the sums of such
// errors break 1e-4 of the largest gradient. g takes three parts in
// dP = G V^T (the pair in dV): where a row's weight sits on one key, p = 1
// there and ds = p (dp - delta) is pure cancellation, which 4*T' rows add
// up in that key's dk; with g as a pair that broke 1e-4 on the card (fp32,
// B=4, T'=201, one row of length 1: 1.86e-4). fp32 q, k, v (dtype 0) are
// pairs, and v three parts in dP. tests/test_torch_attention_split.py
// models this arithmetic on the CPU: at that case three parts land within
// 1.7e-5 (fp32) and 7.0e-6 (bf16) of the largest gradient, pairs at up to
// 3.1e-4 and 1.6e-4; one rounding at B=2, T'=37 at 2.9e-3.
//
// Layout: q, g, dq (B, H, T, D); k, v, dk, dv (B, Kh, T, D); mask (B, T)
// uint8; row_max, row_sum, delta (B, H, T) fp32; all contiguous, q/k/v/g
// 16-byte aligned. q, k, v are bf16 or fp32; g and the outputs are fp32
// (the wrapper casts dq, dk, dv to the input dtype). partial: (2, chunks,
// B, Kh, T, D) fp32 when chunks > 1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dropout_hash.cuh"
#include "flash_mma.cuh"

namespace {

using flash::bf16;
using flash::kThreads;

constexpr int kBlock = 64;  // rows (query rows or keys) of a shared-memory tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;
  const float* g;
  const float* row_max;
  const float* row_sum;
  const float* delta;
  float* dq;
  float* dk;
  float* dv;
  float* partial;
  int H, Kh, T_len, D;
  int chunks, chunk_rows;
  float scale;
  uint32_t seed, threshold;
  float inv_keep;
};

// The dropout row hash of a row of the kv group: folded MQA rows are
// (r / T, r % T); MHA rows are (the block's head, r).
__device__ __forceinline__ uint32_t row_hash_of(const Params& P, int b, int head, int row) {
  const int h = (P.Kh == 1) ? row / P.T_len : head;
  return dropout_row_hash(P.seed, b, P.H, h, (P.Kh == 1) ? row - h * P.T_len : row);
}

// p, and ds with y = p * keep, of one score element.
template <bool kDropout>
__device__ __forceinline__ void grads_of(const Params& P, bool valid, float acc_s, float shift,
                                         float m, float l, float dp, float delta,
                                         uint32_t rhash, int key, float& y, float& ds) {
  float p = 0.f;
  if (valid) p = __fdiv_rn(expf(__fadd_rn(__fmul_rn(acc_s, P.scale), shift) - m), l);
  float keep = 1.f;
  if (kDropout) keep = dropout_keep(rhash, key, P.threshold) ? P.inv_keep : 0.f;
  y = p * keep;
  ds = p * (dp * keep - delta) * P.scale;
}

// How the operands are held: q and k in kIn parts (one bf16 part, or an
// fp32 pair); g always in three parts and v in three when it is fp32, so
// that dP = G V^T is exact to ~2^-24 (dp - delta cancels for a row whose
// weight sits on one key); dS and Y in pairs. fp32 tiles are staged
// through registers, so they gain nothing from a second buffer: fp32
// instances keep one, which keeps D = 128 inside shared memory.
template <typename Tin> struct Split {
  static constexpr bool kFp32 = std::is_same<Tin, float>::value;
  static constexpr int kIn = kFp32 ? 2 : 1;
  static constexpr int kV = kFp32 ? 3 : 1;
  static constexpr int kG = 3;
  static constexpr int kBufs = kFp32 ? 1 : 2;
};

template <typename Tin, int DP>
constexpr size_t dq_smem_bytes() {
  // Q, G, then the buffers of K and V tiles, and the mask shifts.
  using S = Split<Tin>;
  return (S::kIn + S::kG + S::kBufs * (S::kIn + S::kV)) * kBlock * (DP + 8) * sizeof(bf16) +
         S::kBufs * kBlock * sizeof(float);
}

template <typename Tin, int DP>
constexpr size_t dkdv_smem_bytes() {
  // K and V, the buffers of Q and G tiles, and per buffer the rows' m, l,
  // delta and dropout hash.
  using S = Split<Tin>;
  return (S::kIn + S::kV + S::kBufs * (S::kIn + S::kG)) * kBlock * (DP + 8) * sizeof(bf16) +
         S::kBufs * 4 * kBlock * sizeof(float);
}

// dq of one 64-row tile: grid (row tiles, Kh == 1 ? 1 : H, B).
template <typename Tin, int DP, bool kDropout>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(Params P) {
  using S = Split<Tin>;
  constexpr int LD = DP + 8;
  constexpr int kTile = kBlock * LD;
  constexpr int kIn = S::kIn, kV = S::kV, kG = S::kG, kBufs = S::kBufs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [part][tile]
  bf16* sG = sQ + kIn * kTile;                    // [part][tile]
  bf16* sK = sG + kG * kTile;                     // [buffer][part][tile]
  bf16* sV = sK + kBufs * kIn * kTile;            // [buffer][part][tile]
  float* sShift = reinterpret_cast<float*>(sV + kBufs * kV * kTile);  // [buffer][key]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int head = blockIdx.y, b = blockIdx.z;
  const int T = P.T_len, D = P.D;
  const int rows = (P.Kh == 1) ? P.H * T : T;
  const int r0 = blockIdx.x * kBlock;
  const size_t q_off = (static_cast<size_t>(b) * P.H + head) * T * D;
  const size_t kv_off = (static_cast<size_t>(b) * P.Kh + head) * T * D;
  const size_t stat_off = (static_cast<size_t>(b) * P.H + head) * T;
  const Tin* kb = static_cast<const Tin*>(P.k) + kv_off;
  const Tin* vb = static_cast<const Tin*>(P.v) + kv_off;
  const uint8_t* mb = P.mask + static_cast<size_t>(b) * T;

  if (D < DP) {
    flash::zero_words(smem_raw, (kIn + kG + kBufs * (kIn + kV)) * kTile / 2, tid);
    __syncthreads();
  }
  flash::stage<kBlock, DP, kIn>(sQ, kTile, static_cast<const Tin*>(P.q) + q_off, r0, rows, D,
                                tid);
  flash::stage<kBlock, DP, kG>(sG, kTile, P.g + q_off, r0, rows, D, tid);

  // issue() starts a step's copies and returns whether key k0 + tid (for
  // tid < kBlock) is valid; put_shift() stores that mask shift into the
  // step's buffer once no one reads it (after the step before, with two).
  auto issue = [&](int step) {
    const int buf = kBufs == 2 ? step & 1 : 0;
    const int k0 = step * kBlock;
    flash::stage<kBlock, DP, kIn>(sK + buf * kIn * kTile, kTile, kb, k0, T, D, tid);
    flash::stage<kBlock, DP, kV>(sV + buf * kV * kTile, kTile, vb, k0, T, D, tid);
    return tid < kBlock && k0 + tid < T && mb[k0 + tid] != 0;
  };
  auto put_shift = [&](int step, bool valid) {
    if (tid < kBlock)
      sShift[(kBufs == 2 ? step & 1 : 0) * kBlock + tid] = valid ? 0.f : flash::kMaskShift;
  };
  put_shift(0, issue(0));
  flash::cp_async_commit();

  // This thread's rows 16 * warp + g + 8 i and their statistics.
  bool row_ok[2];
  float m[2], l[2], dl[2];
  uint32_t rh[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 16 * warp + g + 8 * i;
    row_ok[i] = row < rows;
    m[i] = row_ok[i] ? P.row_max[stat_off + row] : 0.f;
    l[i] = row_ok[i] ? P.row_sum[stat_off + row] : 1.f;
    dl[i] = row_ok[i] ? P.delta[stat_off + row] : 0.f;
    rh[i] = kDropout ? row_hash_of(P, b, head, row) : 0u;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int nk = (T + kBlock - 1) / kBlock;
  for (int step = 0; step < nk; ++step) {
    const int buf = kBufs == 2 ? step & 1 : 0;
    const bool next_valid = kBufs == 2 && step + 1 < nk && issue(step + 1);
    if (kBufs == 1 && step > 0) put_shift(step, issue(step));  // after the last step's barrier
    flash::cp_async_commit();
    flash::cp_async_wait<kBufs - 1>();
    __syncthreads();
    const int k0 = step * kBlock;
    const bf16* k_tile = sK + buf * kIn * kTile;
    const bf16* v_tile = sV + buf * kV * kTile;
    const float* shift = sShift + buf * kBlock;

    // s = Q K^T and dp = G V^T; [j][e]: row 16 warp + g + 8 (e / 2), key
    // k0 + 8 j + 2 t4 + e % 2.
    float s[kBlock / 8][4], dp[kBlock / 8][4];
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      const int fa = flash::a_frag(lane, 16 * warp, 16 * kc, LD);
      uint32_t aq[kIn][4], ag[kG][4];
      flash::ldsm_parts(aq, sQ, kTile, fa);
      flash::ldsm_parts(ag, sG, kTile, fa);
#pragma unroll
      for (int j2 = 0; j2 < kBlock / 16; ++j2) {
        const int fb = flash::b_frag(lane, 16 * j2, 16 * kc, LD);
        uint32_t bk[kIn][4], bv[kV][4];
        flash::ldsm_parts(bk, k_tile, kTile, fb);
        flash::ldsm_parts(bv, v_tile, kTile, fb);
        flash::mma_parts(s[2 * j2], aq, bk, 0);
        flash::mma_parts(s[2 * j2 + 1], aq, bk, 1);
        flash::mma_parts(dp[2 * j2], ag, bv, 0);
        flash::mma_parts(dp[2 * j2 + 1], ag, bv, 1);
      }
    }
    // ds per element, into s.
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = 8 * j + 2 * t4 + (e & 1);
        float y;
        grads_of<kDropout>(P, row_ok[i] && k0 + c < T, s[j][e], shift[c], m[i], l[i], dp[j][e],
                           dl[i], rh[i], k0 + c, y, s[j][e]);
      }
    // dQ += dS K: dS (a pair) from registers, K as B stored [key][d].
#pragma unroll
    for (int kc = 0; kc < kBlock / 16; ++kc) {
      uint32_t a[2][4];
      flash::fragment_of(s[2 * kc], s[2 * kc + 1], a);
#pragma unroll
      for (int dn = 0; dn < DP / 16; ++dn) {
        uint32_t bk[kIn][4];
        flash::ldsm_parts_trans(bk, k_tile, kTile, flash::bt_frag(lane, 16 * kc, 16 * dn, LD));
        flash::mma_parts(acc[2 * dn], a, bk, 0);
        flash::mma_parts(acc[2 * dn + 1], a, bk, 1);
      }
    }
    if (kBufs == 2 && step + 1 < nk) put_shift(step + 1, next_valid);
    __syncthreads();  // the next step's copy overwrites this buffer
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    float* out = P.dq + q_off + static_cast<size_t>(r0 + 16 * warp + g + 8 * i) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * t4;
      if (d < D) *reinterpret_cast<float2*>(out + d) = make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

// dk and dv of one 64-key tile over one chunk of query rows: grid (key
// tiles, chunks, B * Kh).
template <typename Tin, int DP, bool kDropout>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(Params P) {
  using S = Split<Tin>;
  constexpr int LD = DP + 8;
  constexpr int kTile = kBlock * LD;
  constexpr int kIn = S::kIn, kV = S::kV, kG = S::kG, kBufs = S::kBufs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [part][tile]
  bf16* sV = sK + kIn * kTile;                    // [part][tile]
  bf16* sQ = sV + kV * kTile;                     // [buffer][part][tile]
  bf16* sG = sQ + kBufs * kIn * kTile;            // [buffer][part][tile]
  float* sStat = reinterpret_cast<float*>(sG + kBufs * kG * kTile);  // [buffer][m, l, delta, hash][row]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * kBlock;
  const int chunk = blockIdx.y;
  const int bk = blockIdx.z;  // b * Kh + kv head
  const int b = bk / P.Kh, head = bk - b * P.Kh;  // head: the kv head (0 for MQA)
  const int T = P.T_len, D = P.D;
  const int rows = (P.Kh == 1) ? P.H * T : T;
  const int rbeg = chunk * P.chunk_rows;
  const int rend = min(rbeg + P.chunk_rows, rows);
  const size_t q_off = (static_cast<size_t>(b) * P.H + head) * T * D;
  const size_t kv_off = static_cast<size_t>(bk) * T * D;
  const size_t stat_off = (static_cast<size_t>(b) * P.H + head) * T;
  const Tin* qb = static_cast<const Tin*>(P.q) + q_off;
  const float* gb = P.g + q_off;

  if (D < DP) {
    flash::zero_words(smem_raw, (kIn + kV + kBufs * (kIn + kG)) * kTile / 2, tid);
    __syncthreads();
  }
  flash::stage<kBlock, DP, kIn>(sK, kTile, static_cast<const Tin*>(P.k) + kv_off, k0, T, D, tid);
  flash::stage<kBlock, DP, kV>(sV, kTile, static_cast<const Tin*>(P.v) + kv_off, k0, T, D, tid);

  // fetch() starts a step's copies: Q by cp.async (bf16), and the rows' m,
  // l, delta and hash and, at D <= 64 with two buffers, the fp32 G tile
  // into registers, whose loads stay in flight over the step before;
  // put() stores those into the step's buffer once no one reads it.
  constexpr bool kHoldG = kBufs == 2 && DP == 64;
  flash::Fp32Rows<kBlock, DP> g_next;
  float m_next = 0.f, l_next = 1.f, delta_next = 0.f;
  uint32_t hash_next = 0u;
  auto fetch = [&](int step) {
    const int buf = kBufs == 2 ? step & 1 : 0;
    const int r0 = rbeg + step * kBlock;
    flash::stage<kBlock, DP, kIn>(sQ + buf * kIn * kTile, kTile, qb, r0, rows, D, tid);
    if (kHoldG)
      g_next.load(gb, r0, rows, D, tid);
    else
      flash::stage<kBlock, DP, kG>(sG + buf * kG * kTile, kTile, gb, r0, rows, D, tid);
    const int row = r0 + tid;
    m_next = 0.f, l_next = 1.f, delta_next = 0.f, hash_next = 0u;
    if (tid < kBlock && row < rend) {
      m_next = P.row_max[stat_off + row];
      l_next = P.row_sum[stat_off + row];
      delta_next = P.delta[stat_off + row];
      hash_next = kDropout ? row_hash_of(P, b, head, row) : 0u;
    }
  };
  auto put = [&](int step) {
    const int buf = kBufs == 2 ? step & 1 : 0;
    if (kHoldG) g_next.template store<kG>(sG + buf * kG * kTile, kTile, tid);
    if (tid < kBlock) {
      float* st = sStat + buf * 4 * kBlock;
      st[tid] = m_next;
      st[kBlock + tid] = l_next;
      st[2 * kBlock + tid] = delta_next;
      reinterpret_cast<uint32_t*>(st)[3 * kBlock + tid] = hash_next;
    }
  };
  fetch(0);
  put(0);
  flash::cp_async_commit();

  // This thread's keys k0 + 16 * warp + g + 8 i.
  bool key_ok[2];
  float shift[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 16 * warp + g + 8 * i;
    key_ok[i] = key < T;
    shift[i] = (key_ok[i] && P.mask[static_cast<size_t>(b) * T + key] != 0) ? 0.f
                                                                            : flash::kMaskShift;
  }
  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const int steps = (rend - rbeg + kBlock - 1) / kBlock;
  for (int step = 0; step < steps; ++step) {
    const int buf = kBufs == 2 ? step & 1 : 0;
    if (kBufs == 2 && step + 1 < steps) fetch(step + 1);
    if (kBufs == 1 && step > 0) {  // after the last step's closing barrier
      fetch(step);
      put(step);
    }
    flash::cp_async_commit();
    flash::cp_async_wait<kBufs - 1>();
    __syncthreads();
    const int r0 = rbeg + step * kBlock;
    const bf16* q_tile = sQ + buf * kIn * kTile;
    const bf16* g_tile = sG + buf * kG * kTile;
    const float* st = sStat + buf * 4 * kBlock;

#pragma unroll
    for (int c = 0; c < kBlock / 16; ++c) {
      // sc[jj][e], dpt[jj][e]: key 16 warp + g + 8 (e / 2), query row
      // r0 + 16 c + 8 jj + 2 t4 + e % 2.
      float sc[2][4] = {}, dpt[2][4] = {};
#pragma unroll
      for (int kc = 0; kc < DP / 16; ++kc) {
        const int fa = flash::a_frag(lane, 16 * warp, 16 * kc, LD);
        const int fb = flash::b_frag(lane, 16 * c, 16 * kc, LD);
        uint32_t ak[kIn][4], av[kV][4], bq[kIn][4], bg[kG][4];
        flash::ldsm_parts(ak, sK, kTile, fa);
        flash::ldsm_parts(av, sV, kTile, fa);
        flash::ldsm_parts(bq, q_tile, kTile, fb);
        flash::ldsm_parts(bg, g_tile, kTile, fb);
        flash::mma_parts(sc[0], ak, bq, 0);
        flash::mma_parts(sc[1], ak, bq, 1);
        flash::mma_parts(dpt[0], av, bg, 0);
        flash::mma_parts(dpt[1], av, bg, 1);
      }
      // y^T into sc, ds^T into dpt.
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, r = 16 * c + 8 * jj + 2 * t4 + (e & 1);
          float y, ds;
          grads_of<kDropout>(P, key_ok[i] && r0 + r < rend, sc[jj][e], shift[i], st[r],
                             st[kBlock + r], dpt[jj][e], st[2 * kBlock + r],
                             reinterpret_cast<const uint32_t*>(st)[3 * kBlock + r],
                             k0 + 16 * warp + g + 8 * i, y, ds);
          sc[jj][e] = y;
          dpt[jj][e] = ds;
        }
      uint32_t ay[2][4], as[2][4];
      flash::fragment_of(sc[0], sc[1], ay);
      flash::fragment_of(dpt[0], dpt[1], as);
      // dV += Y^T G (G's first two parts) and dK += dS^T Q: G and Q as B
      // stored [row][d].
#pragma unroll
      for (int dn = 0; dn < DP / 16; ++dn) {
        const int fb = flash::bt_frag(lane, 16 * c, 16 * dn, LD);
        uint32_t bg[2][4], bq[kIn][4];
        flash::ldsm_parts_trans(bg, g_tile, kTile, fb);
        flash::ldsm_parts_trans(bq, q_tile, kTile, fb);
        flash::mma_parts(dv[2 * dn], ay, bg, 0);
        flash::mma_parts(dv[2 * dn + 1], ay, bg, 1);
        flash::mma_parts(dk[2 * dn], as, bq, 0);
        flash::mma_parts(dk[2 * dn + 1], as, bq, 1);
      }
    }
    if (kBufs == 2 && step + 1 < steps) put(step + 1);
    __syncthreads();  // the next step's copy overwrites this buffer
  }

  // One chunk: dk, dv directly; more: this chunk's slice of the scratch.
  const size_t n = static_cast<size_t>(gridDim.z) * T * D;
  float* dkb = P.chunks == 1 ? P.dk : P.partial + static_cast<size_t>(chunk) * n;
  float* dvb = P.chunks == 1 ? P.dv : P.partial + static_cast<size_t>(P.chunks + chunk) * n;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!key_ok[i]) continue;
    const size_t at = kv_off + static_cast<size_t>(k0 + 16 * warp + g + 8 * i) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * t4;
      if (d < D) {
        *reinterpret_cast<float2*>(dkb + at + d) = make_float2(dk[j][2 * i], dk[j][2 * i + 1]);
        *reinterpret_cast<float2*>(dvb + at + d) = make_float2(dv[j][2 * i], dv[j][2 * i + 1]);
      }
    }
  }
}

// dk, dv = the chunks' partials summed in chunk order (n4 float4s each).
__global__ void flash_bwd_sum_chunks(const float4* __restrict__ partial, float4* __restrict__ dk,
                                     float4* __restrict__ dv, int chunks, size_t n4) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float4 a = partial[i], c = partial[chunks * n4 + i];
    for (int k = 1; k < chunks; ++k) {
      const float4 x = partial[k * n4 + i], y = partial[(chunks + k) * n4 + i];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
    }
    dk[i] = a;
    dv[i] = c;
  }
}

template <typename Tin, int DP, bool kDropout>
cudaError_t set_dkdv_smem() {
  return cudaFuncSetAttribute(flash_bwd_dkdv<Tin, DP, kDropout>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(dkdv_smem_bytes<Tin, DP>()));
}

// How many blocks of this dk/dv instance an SM holds (its registers and
// shared memory decide).
template <typename Tin, int DP, bool kDropout>
cudaError_t dkdv_occupancy(int* blocks) {
  const cudaError_t err = set_dkdv_smem<Tin, DP, kDropout>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, flash_bwd_dkdv<Tin, DP, kDropout>, kThreads, dkdv_smem_bytes<Tin, DP>());
}

template <typename Tin, int DP, bool kDropout>
cudaError_t launch(const Params& P, int B, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem_bytes<Tin, DP>();
  constexpr size_t smem_dkdv = dkdv_smem_bytes<Tin, DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq<Tin, DP, kDropout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_dq));
  if (err != cudaSuccess) return err;
  err = set_dkdv_smem<Tin, DP, kDropout>();
  if (err != cudaSuccess) return err;
  const int rows = (P.Kh == 1) ? P.H * P.T_len : P.T_len;
  const dim3 grid_dq((rows + kBlock - 1) / kBlock, P.Kh == 1 ? 1 : P.H, B);
  flash_bwd_dq<Tin, DP, kDropout><<<grid_dq, kThreads, smem_dq, stream>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_dkdv((P.T_len + kBlock - 1) / kBlock, P.chunks, B * P.Kh);
  flash_bwd_dkdv<Tin, DP, kDropout><<<grid_dkdv, kThreads, smem_dkdv, stream>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess || P.chunks == 1) return err;
  const size_t n4 = static_cast<size_t>(B) * P.Kh * P.T_len * P.D / 4;
  const size_t want = (n4 + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  flash_bwd_sum_chunks<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(P.partial),
                                                   reinterpret_cast<float4*>(P.dk),
                                                   reinterpret_cast<float4*>(P.dv), P.chunks, n4);
  return cudaGetLastError();
}

template <typename Tin, int DP>
cudaError_t launch_rate(const Params& P, int B, int dropout, cudaStream_t stream) {
  return dropout ? launch<Tin, DP, true>(P, B, stream) : launch<Tin, DP, false>(P, B, stream);
}

template <typename Tin, int DP>
cudaError_t occupancy_rate(int dropout, int* blocks) {
  return dropout ? dkdv_occupancy<Tin, DP, true>(blocks) : dkdv_occupancy<Tin, DP, false>(blocks);
}

}  // namespace

// Returns a cudaError_t; *blocks: how many blocks of the dk/dv instance
// that flash_attention_bwd launches for (D, dtype, dropout) an SM of the
// current device holds. The wrapper sizes the row chunks by it.
extern "C" int flash_attention_bwd_dkdv_occupancy(int D, int dtype, int dropout, int* blocks) {
  if (D <= 0 || D % 8 != 0 || D > 128 || (dtype != 0 && dtype != 1) || !blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return static_cast<int>(D <= 64 ? occupancy_rate<bf16, 64>(dropout, blocks)
                                    : occupancy_rate<bf16, 128>(dropout, blocks));
  return static_cast<int>(D <= 64 ? occupancy_rate<float, 64>(dropout, blocks)
                                  : occupancy_rate<float, 128>(dropout, blocks));
}

// Returns a cudaError_t: 0 when every launch was accepted.
// dtype: 0 = fp32 q/k/v, 1 = bf16 q/k/v. dropout as in flash_attention_fwd.
// chunks, chunk_rows: the dk/dv kernel splits the kv head's query rows
// into `chunks` runs of `chunk_rows` (a multiple of 64, the last run
// shorter), each a block of its own; with chunks > 1, `partial` is their
// (2, chunks, B, Kh, T, D) fp32 scratch.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* mask, const void* g, const void* row_max,
                                   const void* row_sum, const void* delta, void* dq,
                                   void* dk, void* dv, void* partial, int B, int H, int Kh,
                                   int T_len, int D, int dtype, int dropout, int chunks,
                                   int chunk_rows, unsigned int seed, unsigned int threshold,
                                   float inv_keep, void* stream) {
  const int rows = (Kh == 1) ? H * T_len : T_len;
  if (B <= 0 || H <= 0 || T_len <= 0 || D <= 0 || D % 8 != 0 || D > 128 ||
      (Kh != 1 && Kh != H) || (dtype != 0 && dtype != 1) || chunks < 1 || chunk_rows < kBlock ||
      chunk_rows % kBlock != 0 || static_cast<long long>(chunks) * chunk_rows < rows ||
      static_cast<long long>(chunks - 1) * chunk_rows >= rows || (chunks > 1 && !partial))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P;
  P.q = q;
  P.k = k;
  P.v = v;
  P.mask = static_cast<const uint8_t*>(mask);
  P.g = static_cast<const float*>(g);
  P.row_max = static_cast<const float*>(row_max);
  P.row_sum = static_cast<const float*>(row_sum);
  P.delta = static_cast<const float*>(delta);
  P.dq = static_cast<float*>(dq);
  P.dk = static_cast<float*>(dk);
  P.dv = static_cast<float*>(dv);
  P.partial = static_cast<float*>(partial);
  P.H = H;
  P.Kh = Kh;
  P.T_len = T_len;
  P.D = D;
  P.chunks = chunks;
  P.chunk_rows = chunk_rows;
  P.scale = 1.0f / sqrtf(static_cast<float>(D));
  P.seed = seed;
  P.threshold = threshold;
  P.inv_keep = inv_keep;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(D <= 64 ? launch_rate<bf16, 64>(P, B, dropout, s)
                                    : launch_rate<bf16, 128>(P, B, dropout, s));
  return static_cast<int>(D <= 64 ? launch_rate<float, 64>(P, B, dropout, s)
                                  : launch_rate<float, 128>(P, B, dropout, s));
}
