// Flash-attention backward for Hopper (sm_90a), MQA and MHA: wgmma fed by
// TMA through an mbarrier ring, each score and its gradient taken once,
// with the forward's attention-weight dropout regenerated in the kernel.
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
// fp32 dk, dv: the bytes at the training shape, the flops at T'=1601.
//
// Design: the TPU kernel sums dk/dv over q tiles by read-modify-write of
// one output block, legal only because the TPU grid runs in order. Hopper
// blocks run in parallel, so (attention_plan in ops/flash_attention.py
// gives every grid):
//   - flash_bwd_dkdv: one block per (b, kv head, key tile, chunk of query
//     rows): kGroups consumer warpgroups of 64 keys each and a producer
//     warpgroup (setmaxnreg hands its registers to the consumers). The
//     block keeps its K and V tiles in shared memory; the producer streams
//     the chunk's 64-row Q and G tiles through a ring of kStages stages
//     (full and empty mbarriers; TMA, the fp32 G through a staging buffer
//     that the producer splits into three bf16 parts) with the rows' m, l
//     and delta and, under dropout, the tile's keep mask (the producer
//     hashes each (row, key) of the tile once: with the hashes in the
//     consumers' loop their registers spilled). Per tile a consumer takes
//     S^T = K Q^T and dP^T = V G^T on wgmma (all operands from shared
//     memory, K-major),
//     y and ds per element in the accumulator layout, and dV += Y^T G and
//     dK += dS^T Q with Y^T and dS^T as register A operands and G and Q
//     MN-major from the same tiles. So each (query tile, key tile) pair's
//     scores and dP are taken once (the mma.sync design before took both
//     again in its dq kernel).
//   - dq needs ds summed over the key tiles. The dk/dv kernel writes ds
//     once, as the bf16 hi + lo pair its dQ product takes, through shared
//     memory and a TMA store to a scratch (B * Kh, 2, T, pitch) bf16 that
//     the wrapper allocates (pitch: the rows rounded up to 8);
//     flash_bwd_dq then runs dq = dS K as a plain
//     wgmma product over the key tiles, dS and K by TMA. That is
//     deterministic (each dq element is one block's fixed-order sum) and
//     has no semaphore or atomics. Its price is the scratch's bytes, 8 a
//     score written and read (20.5 MB at the training shape, mostly in
//     L2; 328 MB at T'=1601 B=4), against the recompute it replaces: the
//     scores, dP with g in three parts, and an exp, a division and a hash
//     a score, about two fifths of the mma.sync design's tensor-core work.
//   - The rows are split into chunks so that MQA, which has one kv head,
//     fills the card. Each chunk's dk/dv go to an fp32 scratch (allocated
//     by the wrapper), and flash_bwd_sum_chunks adds the chunks in a fixed
//     order. With one chunk the dk/dv kernel writes dk, dv itself.
// The scores and p come from m and l with the forward's formula; the
// dropout mask from the position hash (dropout_hash.cuh) at each
// accumulator element's (row, key), which the layout gives (hopper.cuh).
//
// Numerics: _bwd_tile takes every product on fp32 operands (g, ds and y
// are fp32), and the card check holds the kernels to 1e-4 of the largest
// gradient. q, k, v in bf16 are exact as bf16 operands; dS and Y enter
// the tensor cores as bf16 hi + lo pairs (flash_wgmma.cuh): two terms
// against a bf16 operand, three (hi*hi + hi*lo + lo*hi) against another
// pair, about 2^-16 relative a product. Rounding g, dS and Y once to bf16
// instead errs by up to 2^-9 relative per element, and the sums of such
// errors break 1e-4 of the largest gradient. g takes three parts in
// dP^T = V G^T (the pair in dV): where a row's weight sits on one key, p =
// 1 there and ds = p (dp - delta) is pure cancellation, which 4*T' rows
// add up in that key's dk; with g as a pair that broke 1e-4 on the card
// (fp32, B=4, T'=201, one row of length 1: 1.86e-4). fp32 q, k, v (dtype
// 0) are pairs, and v three parts in dP. tests/test_torch_attention_split.py
// models this arithmetic on the CPU: at that case three parts land within
// 1.7e-5 (fp32) and 7.0e-6 (bf16) of the largest gradient, pairs at up to
// 3.1e-4 and 1.6e-4; one rounding at B=2, T'=37 at 2.9e-3. fp32 instances
// hold one consumer warpgroup a block and one stage, so their parts fit in
// shared memory.
//
// Layout: q, g, dq (B, H, T, D); k, v, dk, dv (B, Kh, T, D); mask (B, T)
// uint8; row_max, row_sum, delta (B, H, T) fp32; all contiguous, q/k/v/g
// 16-byte aligned. q, k, v are bf16 or fp32; g and the outputs are fp32
// (the wrapper casts dq, dk, dv to the input dtype). partial: (2, chunks,
// B, Kh, T, D) fp32 when chunks > 1. The entry point encodes the tensor
// maps on the host at each call (`ab_attention.py --host` times the
// wrapper's host cost with them; PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dropout_hash.cuh"
#include "flash_wgmma.cuh"

namespace {

using flash::bf16;
using flash::kTile;
using namespace hopper;


struct Params {
  const uint8_t* mask;
  const float* row_max;
  const float* row_sum;
  const float* delta;
  float* dq;
  float* dk;
  float* dv;
  float* partial;
  int H, Kh, T_len, D, rows;
  int chunks, chunk_rows;
  float scale;
  uint32_t seed, threshold;
  float inv_keep;
};

// How each instance holds its operands: q and k in kIn parts (one bf16
// part, or an fp32 pair); g always in three parts and v in three when it
// is fp32, so that dP = G V^T is exact to ~2^-24 (dp - delta cancels for a
// row whose weight sits on one key); dS and Y in pairs.
template <typename Tin, int DP> struct Split {
  static constexpr bool kFp32 = std::is_same<Tin, float>::value;
  static constexpr int kIn = kFp32 ? 2 : 1;
  static constexpr int kV = kFp32 ? 3 : 1;
  static constexpr int kG = 3;
  static constexpr int kGroups = kFp32 ? 1 : 2;  // consumer warpgroups a block
  static constexpr int kThreads = 128 * (kGroups + 1);
  static constexpr int kMinBlocks = kGroups == 2 ? 1 : 2;
  // setmaxnreg: all of the SM's 65536 registers (2 x 32768 for one group)
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = kGroups == 2 ? 232 : 216;
  static constexpr int kStaging = kTile * DP * 4;  // bytes of the fp32 staging buffer
};

// The dk/dv kernel's shared memory (bytes from a 1024-aligned base).
template <typename Tin, int DP> struct DkdvLayout : Split<Tin, DP> {
  using S = Split<Tin, DP>;
  static constexpr int kStages = (!S::kFp32 && DP == 64) ? 2 : 1;
  static constexpr int kKeys = kTile * S::kGroups;   // keys a block
  static constexpr int kKVTile = kKeys * DP * 2;     // one part of K or V
  static constexpr int kRowTile = kTile * DP * 2;    // one part of a Q or G tile
  static constexpr int kKAt = 0;
  static constexpr int kVAt = kKAt + S::kIn * kKVTile;
  static constexpr int kQAt = kVAt + S::kV * kKVTile;  // [stage][part]
  static constexpr int kGAt = kQAt + kStages * S::kIn * kRowTile;  // [stage][part]
  static constexpr int kStagingAt = kGAt + kStages * S::kG * kRowTile;
  static constexpr int kWords = kKeys / 32;  // keep-mask words of a row
  static constexpr int kStatFloats = 3 * kTile + kTile * kWords;  // a stage's m, l, delta, mask
  static constexpr int kStat = kStagingAt + S::kStaging;  // [stage][m, l, delta][row], [row][word]
  static constexpr int kDsTile = kTile * kTile * 2;  // one part of a warpgroup's ds^T tile
  static constexpr int kDsAt = (kStat + kStages * kStatFloats * 4 + 1023) / 1024 * 1024;
  static constexpr int kBars = kDsAt + S::kGroups * 2 * kDsTile;  // full, empty, kv, staging
  static constexpr int kBytes = kBars + (2 * kStages + 2) * 8 + 1024;
};

// The dq kernel's: dS (both parts) and K tiles through the ring.
template <typename Tin, int DP> struct DqLayout : Split<Tin, DP> {
  using S = Split<Tin, DP>;
  static constexpr int kStages = 2;
  static constexpr int kRows = kTile * S::kGroups;  // query rows a block
  static constexpr int kDsTile = kTile * kRows * 2;  // one part of a dS tile: 64 keys x kRows
  static constexpr int kKTile = kTile * DP * 2;
  static constexpr int kDsAt = 0;                         // [stage][part]
  static constexpr int kKAt = kDsAt + kStages * 2 * kDsTile;  // [stage][part]
  static constexpr int kStagingAt = kKAt + kStages * S::kIn * kKTile;
  static constexpr int kBars = kStagingAt + (S::kFp32 ? S::kStaging : 0);
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// The dropout row hash of a row of the kv group: folded MQA rows are
// (r / T, r % T); MHA rows are (the block's head, r).
__device__ __forceinline__ uint32_t row_hash_of(const Params& P, int b, int head, int row) {
  const int h = (P.Kh == 1) ? row / P.T_len : head;
  return dropout_row_hash(P.seed, b, P.H, h, (P.Kh == 1) ? row - h * P.T_len : row);
}

// p, and ds with y = p * keep, of one score element (kept: its dropout
// bit). A key past T has shift -inf and a row outside the chunk m = +inf,
// so either gives p = 0 without a test.
template <bool kDropout>
__device__ __forceinline__ void grads_of(const Params& P, float acc_s, float shift, float m,
                                         float l, float dp, float delta, bool kept, float& y,
                                         float& ds) {
  const float p = flash::div_rn(expf(__fadd_rn(__fmul_rn(acc_s, P.scale), shift) - m), l);
  float keep = 1.f;
  if (kDropout) keep = kept ? P.inv_keep : 0.f;
  y = p * keep;
  ds = p * (dp * keep - delta) * P.scale;
}

// dk and dv of one key tile (64 keys a consumer warpgroup) over one chunk
// of query rows, and ds of every (key, row) pair to the scratch: grid (key
// tiles, chunks, B * Kh).
template <typename Tin, int DP, bool kDropout>
__global__ void __launch_bounds__(Split<Tin, DP>::kThreads, Split<Tin, DP>::kMinBlocks)
    flash_bwd_dkdv(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tg,
                   const __grid_constant__ CUtensorMap tds, Params P) {
  using L = DkdvLayout<Tin, DP>;
  constexpr int kIn = L::kIn, kV = L::kV, kG = L::kG, kGroups = L::kGroups;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sK = smem + L::kKAt;
  unsigned char* sV = smem + L::kVAt;
  unsigned char* sQ = smem + L::kQAt;
  unsigned char* sG = smem + L::kGAt;
  float* staging = reinterpret_cast<float*>(smem + L::kStagingAt);
  float* sStat = reinterpret_cast<float*>(smem + L::kStat);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* kv_bar = empty + kStages;
  uint64_t* stage_bar = kv_bar + 1;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * L::kKeys;
  const int chunk = blockIdx.y;
  const int bk = blockIdx.z;  // b * Kh + kv head
  const int b = bk / P.Kh, head = bk - b * P.Kh;  // head: the kv head (0 for MQA)
  const int T = P.T_len, D = P.D;
  const int rbeg = chunk * P.chunk_rows;
  const int rend = min(rbeg + P.chunk_rows, P.rows);
  const int steps = (rend - rbeg + kTile - 1) / kTile;
  const size_t stat_off = static_cast<size_t>(bk) * P.rows;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 128 * kGroups);
    }
    mbar_init(kv_bar, 128);
    mbar_init(stage_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * kGroups) {
    // Producer: K and V once, then the chunk's Q and G tiles and row
    // statistics through the ring.
    regs_dec<L::kProducerRegs>();
    const int t = tid - 128 * kGroups;
    uint32_t stage_phase = 0;
    for (int w = 0; w < kGroups; ++w) {
      flash::stage_tile<Tin, DP, kIn>(&tk, sK, L::kKVTile, L::kKeys, kTile * w, k0 + kTile * w,
                                      bk, kv_bar, staging, stage_bar, stage_phase, t);
      flash::stage_tile<Tin, DP, kV>(&tv, sV, L::kKVTile, L::kKeys, kTile * w, k0 + kTile * w,
                                     bk, kv_bar, staging, stage_bar, stage_phase, t);
    }
    fence_proxy_async();
    mbar_arrive(kv_bar);
    Ring ring;
    for (int step = 0; step < steps; ++step) {
      const int r0 = rbeg + step * kTile;
      mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
      flash::stage_tile<Tin, DP, kIn>(&tq, sQ + ring.stage * kIn * L::kRowTile, L::kRowTile,
                                      kTile, 0, r0, bk, &full[ring.stage], staging, stage_bar,
                                      stage_phase, t);
      flash::stage_tile<float, DP, kG>(&tg, sG + ring.stage * kG * L::kRowTile, L::kRowTile,
                                       kTile, 0, r0, bk, &full[ring.stage], staging, stage_bar,
                                       stage_phase, t);
      float* st = sStat + ring.stage * L::kStatFloats;
      if (t < kTile) {
        const int row = r0 + t;
        const bool ok = row < rend;
        st[t] = ok ? P.row_max[stat_off + row] : INFINITY;
        st[kTile + t] = ok ? P.row_sum[stat_off + row] : 1.f;
        st[2 * kTile + t] = ok ? P.delta[stat_off + row] : 0.f;
      }
      if (kDropout) {
        // The tile's keep mask, a bit a (row, key): two threads a row, each
        // hashing half of the block's keys, 32 to a word.
        const int r = t % kTile, half = t / kTile;
        const uint32_t rh = row_hash_of(P, b, head, r0 + r);
        uint32_t* words = reinterpret_cast<uint32_t*>(st + 3 * kTile) + r * L::kWords;
#pragma unroll
        for (int w = half * L::kWords / 2; w < (half + 1) * L::kWords / 2; ++w) {
          uint32_t bits = 0u;
#pragma unroll
          for (int j = 0; j < 32; ++j)
            bits |= static_cast<uint32_t>(dropout_keep(rh, k0 + 32 * w + j, P.threshold)) << j;
          words[w] = bits;
        }
      }
      fence_proxy_async();
      mbar_arrive(&full[ring.stage]);
      ring.next<kStages>();
    }
    return;
  }

  // Consumer warpgroup wg: keys k0 + 64 wg + 16 warp + g (+ 8).
  regs_inc<L::kConsumerRegs>();
  const int wg = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int key_row0 = kTile * wg;  // the warpgroup's keys in the K/V tiles
  bool key_ok[2];
  float shift[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + key_row0 + 16 * warp + g + 8 * i;
    key_ok[i] = key < T;
    shift[i] = !key_ok[i]                                          ? -INFINITY
               : P.mask[static_cast<size_t>(b) * T + key] != 0 ? 0.f
                                                               : flash::kMaskShift;
  }
  float dk[DP / 64][32], dv[DP / 64][32];
#pragma unroll
  for (int h = 0; h < DP / 64; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[h][i] = dv[h][i] = 0.f;
  float sc[32], dpt[32], t[32];
  // This warpgroup's ds^T tile ([key][row], both parts), which a TMA store
  // copies to the scratch.
  unsigned char* ds_tile = smem + L::kDsAt + wg * 2 * L::kDsTile;
  const int wt = tid & 127;

  mbar_wait(kv_bar, 0);
  Ring ring;
  for (int step = 0; step < steps; ++step) {
    const int r0 = rbeg + step * kTile;
    mbar_wait(&full[ring.stage], ring.phase);
    const unsigned char* q_tile = sQ + ring.stage * kIn * L::kRowTile;
    const unsigned char* g_tile = sG + ring.stage * kG * L::kRowTile;
    const float* st = sStat + ring.stage * L::kStatFloats;
    // This thread's keys' word of each row's keep mask, and their bits.
    const uint32_t* keep_words =
        reinterpret_cast<const uint32_t*>(st + 3 * kTile) + (key_row0 + 16 * warp) / 32;
    const int bit = (16 * warp) % 32 + g;

    // S^T = K Q^T and dP^T = V G^T: keys as rows, the tile's query rows as
    // columns. [i]: key 16 warp + g + 8 ((i / 2) % 2), row r0 + 8 (i / 4)
    // + 2 t4 + i % 2.
    reg_fence(sc);
    reg_fence(dpt);
    wg_fence();
    flash::products_ss<kIn, kIn, DP / 16, 0, 0>(
        sc, t, [&](int i, int kk) { return desc_k(sK + i * L::kKVTile, L::kKeys, key_row0, kk); },
        [&](int j, int kk) { return desc_k(q_tile + j * L::kRowTile, kTile, 0, kk); }, 0);
    if (kIn > 1) {
      flash::finish_products<kIn, kIn>(sc, t);
      wg_fence();
    }
    flash::products_ss<kV, kG, DP / 16, 0, 0>(
        dpt, t, [&](int i, int kk) { return desc_k(sV + i * L::kKVTile, L::kKeys, key_row0, kk); },
        [&](int j, int kk) { return desc_k(g_tile + j * L::kRowTile, kTile, 0, kk); }, 0);
    flash::finish_products<kV, kG>(dpt, t);
    reg_fence(sc);

    // y^T into sc, ds^T into dpt.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int ki = (i >> 1) & 1, c = 8 * (i >> 2) + 2 * t4 + (i & 1);
      float y, ds;
      grads_of<kDropout>(P, sc[i], shift[ki], st[c], st[kTile + c], dpt[i], st[2 * kTile + c],
                         kDropout && ((keep_words[c * L::kWords] >> (bit + 8 * ki)) & 1u), y, ds);
      sc[i] = y;
      dpt[i] = ds;
    }
    uint32_t ay[4][2][4], as[4][2][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      flash::a_parts<2>(sc, kc, ay[kc]);
      flash::a_parts<2>(dpt, kc, as[kc]);
    }
    // ds to the scratch: register e of k-step kc holds the pair of rows
    // 16 kc + 8 (e / 2) + 2 t4 (+ 1) of key 16 warp + g + 8 (e % 2), written
    // into the tile once the last tile's store has read it, then one TMA
    // store a part (keys past T and rows past the row count are not written).
    if (wt == 0) bulk_wait_read<0>();
    named_sync(2 + wg, 128);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t at =
            element_at(kTile, 16 * warp + g + 8 * (e & 1), 16 * kc + 8 * (e >> 1) + 2 * t4);
        *reinterpret_cast<uint32_t*>(ds_tile + at) = as[kc][0][e];
        *reinterpret_cast<uint32_t*>(ds_tile + L::kDsTile + at) = as[kc][1][e];
      }
    fence_proxy_async();
    named_sync(2 + wg, 128);
    if (wt == 0) {
      tma_store_3d(&tds, ds_tile, r0, k0 + key_row0, 2 * bk);
      tma_store_3d(&tds, ds_tile + L::kDsTile, r0, k0 + key_row0, 2 * bk + 1);
      bulk_commit();
    }
    // dV += Y^T G (G's first two parts) and dK += dS^T Q: G and Q MN-major.
#pragma unroll
    for (int h = 0; h < DP / 64; ++h) {
      reg_fence(dv[h]);
      wg_fence();
      flash::products_rs<2, 2, 4, 1>(
          dv[h], t, ay,
          [&](int j, int kc) { return desc_mn(g_tile + j * L::kRowTile, kTile, h, kc); }, 1);
      flash::finish_products<2, 2>(dv[h], t);
    }
#pragma unroll
    for (int h = 0; h < DP / 64; ++h) {
      reg_fence(dk[h]);
      wg_fence();
      flash::products_rs<2, kIn, 4, 1>(
          dk[h], t, as,
          [&](int j, int kc) { return desc_mn(q_tile + j * L::kRowTile, kTile, h, kc); }, 1);
      flash::finish_products<2, kIn>(dk[h], t);
    }
    mbar_arrive(&empty[ring.stage]);
    ring.next<kStages>();
  }
  if (wt == 0) bulk_wait<0>();  // the ds tile stays until its last store is done

  // One chunk: dk, dv directly; more: this chunk's slice of the scratch.
  const size_t n = static_cast<size_t>(gridDim.z) * T * D;
  float* dkb = P.chunks == 1 ? P.dk : P.partial + static_cast<size_t>(chunk) * n;
  float* dvb = P.chunks == 1 ? P.dv : P.partial + static_cast<size_t>(P.chunks + chunk) * n;
  const size_t kv_off = static_cast<size_t>(bk) * T * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!key_ok[i]) continue;
    const size_t at = kv_off + static_cast<size_t>(k0 + key_row0 + 16 * warp + g + 8 * i) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * t4;
      if (d < D) {
        const int e = 4 * (j & 7) + 2 * i;
        *reinterpret_cast<float2*>(dkb + at + d) = make_float2(dk[j >> 3][e], dk[j >> 3][e + 1]);
        *reinterpret_cast<float2*>(dvb + at + d) = make_float2(dv[j >> 3][e], dv[j >> 3][e + 1]);
      }
    }
  }
}

// dq of one block of query rows (64 a consumer warpgroup): dq = dS K over
// the key tiles, dS (its pair) and K by TMA: grid (row blocks, 1, B * Kh).
template <typename Tin, int DP>
__global__ void __launch_bounds__(Split<Tin, DP>::kThreads, Split<Tin, DP>::kMinBlocks)
    flash_bwd_dq(const __grid_constant__ CUtensorMap tds,
                 const __grid_constant__ CUtensorMap tk, Params P) {
  using L = DqLayout<Tin, DP>;
  constexpr int kIn = L::kIn, kGroups = L::kGroups, kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sDs = smem + L::kDsAt;
  unsigned char* sK = smem + L::kKAt;
  float* staging = reinterpret_cast<float*>(smem + L::kStagingAt);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* stage_bar = empty + kStages;

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * L::kRows;
  const int bk = blockIdx.z;
  const int nk = (P.T_len + kTile - 1) / kTile;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 128 * kGroups);
    }
    mbar_init(stage_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * kGroups) {
    regs_dec<L::kProducerRegs>();
    const int t = tid - 128 * kGroups;
    uint32_t stage_phase = 0;
    Ring ring;
    for (int n = 0; n < nk; ++n) {
      mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
      unsigned char* ds_tile = sDs + ring.stage * 2 * L::kDsTile;
      if (t == 0) {
        mbar_expect_tx(&full[ring.stage], 2 * L::kDsTile);
        for (int part = 0; part < 2; ++part)
          for (int w = 0; w < kGroups; ++w)
            tma_load_3d(ds_tile + part * L::kDsTile + w * kTile * 128, &tds, &full[ring.stage],
                        r0 + kTile * w, kTile * n, 2 * bk + part);
      }
      flash::stage_tile<Tin, DP, kIn>(&tk, sK + ring.stage * kIn * L::kKTile, L::kKTile, kTile,
                                      0, kTile * n, bk, &full[ring.stage], staging, stage_bar,
                                      stage_phase, t);
      fence_proxy_async();
      mbar_arrive(&full[ring.stage]);
      ring.next<kStages>();
    }
    return;
  }

  regs_inc<L::kConsumerRegs>();
  const int wg = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  float acc[DP / 64][32], t[32];
#pragma unroll
  for (int h = 0; h < DP / 64; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  Ring ring;
  for (int n = 0; n < nk; ++n) {
    mbar_wait(&full[ring.stage], ring.phase);
    const unsigned char* ds_tile = sDs + ring.stage * 2 * L::kDsTile;
    const unsigned char* k_tile = sK + ring.stage * kIn * L::kKTile;
#pragma unroll
    for (int h = 0; h < DP / 64; ++h) {
      reg_fence(acc[h]);
      wg_fence();
      flash::products_ss<2, kIn, 4, 1, 1>(
          acc[h], t,
          [&](int i, int kk) { return desc_mn(ds_tile + i * L::kDsTile, kTile, wg, kk); },
          [&](int j, int kk) { return desc_mn(k_tile + j * L::kKTile, kTile, h, kk); }, 1);
      flash::finish_products<2, kIn>(acc[h], t);
    }
    mbar_arrive(&empty[ring.stage]);
    ring.next<kStages>();
  }

  const int D = P.D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + kTile * wg + 16 * warp + g + 8 * i;
    if (row >= P.rows) continue;
    float* out = P.dq + (static_cast<size_t>(bk) * P.rows + row) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * t4;
      const int e = 4 * (j & 7) + 2 * i;
      if (d < D)
        *reinterpret_cast<float2*>(out + d) = make_float2(acc[j >> 3][e], acc[j >> 3][e + 1]);
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
                              DkdvLayout<Tin, DP>::kBytes);
}

// How many blocks of this dk/dv instance an SM holds (its registers and
// shared memory decide).
template <typename Tin, int DP, bool kDropout>
cudaError_t dkdv_occupancy(int* blocks) {
  const cudaError_t err = set_dkdv_smem<Tin, DP, kDropout>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, flash_bwd_dkdv<Tin, DP, kDropout>,
                                                       Split<Tin, DP>::kThreads,
                                                       DkdvLayout<Tin, DP>::kBytes);
}

template <typename Tin, int DP, bool kDropout>
cudaError_t launch(const CUtensorMap* maps, const Params& P, int BK, int dq_blocks,
                   cudaStream_t stream) {
  using L = DkdvLayout<Tin, DP>;
  using Q = DqLayout<Tin, DP>;
  cudaError_t err = set_dkdv_smem<Tin, DP, kDropout>();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq<Tin, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Q::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_dkdv((P.T_len + L::kKeys - 1) / L::kKeys, P.chunks, BK);
  flash_bwd_dkdv<Tin, DP, kDropout><<<grid_dkdv, L::kThreads, L::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq<Tin, DP><<<dim3(dq_blocks, 1, BK), Q::kThreads, Q::kBytes, stream>>>(maps[4],
                                                                                    maps[1], P);
  err = cudaGetLastError();
  if (err != cudaSuccess || P.chunks == 1) return err;
  const size_t n4 = static_cast<size_t>(BK) * P.T_len * P.D / 4;
  const size_t want = (n4 + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  flash_bwd_sum_chunks<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(P.partial),
                                                   reinterpret_cast<float4*>(P.dk),
                                                   reinterpret_cast<float4*>(P.dv), P.chunks, n4);
  return cudaGetLastError();
}

template <typename Tin, int DP>
cudaError_t launch_rate(const CUtensorMap* maps, const Params& P, int BK, int dq_blocks,
                        int dropout, cudaStream_t stream) {
  return dropout ? launch<Tin, DP, true>(maps, P, BK, dq_blocks, stream)
                 : launch<Tin, DP, false>(maps, P, BK, dq_blocks, stream);
}

template <typename Tin, int DP>
cudaError_t occupancy_rate(int dropout, int* blocks) {
  return dropout ? dkdv_occupancy<Tin, DP, true>(blocks) : dkdv_occupancy<Tin, DP, false>(blocks);
}

}  // namespace

// Returns a cudaError_t; *blocks: how many blocks of the dk/dv instance
// that flash_attention_bwd launches for (D, dtype, dropout) an SM of the
// current device holds. attention_plan sizes the row chunks by it.
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
// The launch (ops/flash_attention.py::attention_plan): the dk/dv kernel
// takes block_keys keys a block, its grid (key tiles, chunks, B * Kh)
// splitting the kv head's query rows into `chunks` runs of `chunk_rows`
// (a multiple of 64, the last run shorter), with `stages` ring stages;
// with chunks > 1, `partial` is their (2, chunks, B, Kh, T, D) fp32
// scratch. ds: the (B * Kh, 2, T, pitch) bf16 scratch, pitch >= the rows
// and a multiple of 8. The dq kernel's grid is (dq_blocks, 1, B * Kh) of
// block_keys query rows each. Refused unless the plan is this instance's
// and every grid covers its rows.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* mask, const void* g, const void* row_max,
                                   const void* row_sum, const void* delta, void* dq,
                                   void* dk, void* dv, void* partial, void* ds, int B, int H,
                                   int Kh, int T_len, int D, int dtype, int dropout, int chunks,
                                   int chunk_rows, int block_keys, int stages, int dq_blocks,
                                   int pitch, unsigned int seed, unsigned int threshold,
                                   float inv_keep, void* stream) {
  const int rows = (Kh == 1) ? H * T_len : T_len;
  if (B <= 0 || H <= 0 || T_len <= 0 || D <= 0 || D % 8 != 0 || D > 128 ||
      (Kh != 1 && Kh != H) || (dtype != 0 && dtype != 1) || !ds ||
      (chunks > 1 && !partial) || B * Kh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int DP = D <= 64 ? 64 : 128;
  const int want_keys = dtype == 1 ? DkdvLayout<bf16, 64>::kKeys : DkdvLayout<float, 64>::kKeys;
  const int want_stages =
      dtype == 1 ? (DP == 64 ? DkdvLayout<bf16, 64>::kStages : DkdvLayout<bf16, 128>::kStages)
                 : (DP == 64 ? DkdvLayout<float, 64>::kStages : DkdvLayout<float, 128>::kStages);
  if (block_keys != want_keys || stages != want_stages || chunks < 1 || chunk_rows < kTile ||
      chunk_rows % kTile != 0 || static_cast<long long>(chunks) * chunk_rows < rows ||
      static_cast<long long>(chunks - 1) * chunk_rows >= rows || chunks > 65535 ||
      static_cast<long long>(dq_blocks) * block_keys < rows ||
      static_cast<long long>(dq_blocks - 1) * block_keys >= rows || pitch < rows ||
      pitch % 8 != 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  Params P;
  P.mask = static_cast<const uint8_t*>(mask);
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
  P.rows = rows;
  P.chunks = chunks;
  P.chunk_rows = chunk_rows;
  P.scale = 1.0f / sqrtf(static_cast<float>(D));
  P.seed = seed;
  P.threshold = threshold;
  P.inv_keep = inv_keep;
  // q, g as (B * Kh, rows, D): rows folded for MQA; k, v as (B * Kh, T,
  // D); ds as (2 B Kh, T, rows) with rows `pitch` apart.
  const int esize = dtype == 1 ? 2 : 4;
  const int box_cols = dtype == 1 ? 64 : DP;
  const long long BK = static_cast<long long>(B) * Kh;
  CUtensorMap maps[5];
  if (!hopper_host::encode_3d(&maps[0], q, esize, D, D, rows, BK, box_cols, kTile) ||
      !hopper_host::encode_3d(&maps[1], k, esize, D, D, T_len, BK, box_cols, kTile) ||
      !hopper_host::encode_3d(&maps[2], v, esize, D, D, T_len, BK, box_cols, kTile) ||
      !hopper_host::encode_3d(&maps[3], g, 4, D, D, rows, BK, DP, kTile) ||
      !hopper_host::encode_3d(&maps[4], ds, 2, rows, pitch, T_len, 2 * BK, 64, kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bk = static_cast<int>(BK);
  if (dtype == 1)
    return static_cast<int>(DP == 64 ? launch_rate<bf16, 64>(maps, P, bk, dq_blocks, dropout, s)
                                     : launch_rate<bf16, 128>(maps, P, bk, dq_blocks, dropout, s));
  return static_cast<int>(DP == 64 ? launch_rate<float, 64>(maps, P, bk, dq_blocks, dropout, s)
                                   : launch_rate<float, 128>(maps, P, bk, dq_blocks, dropout, s));
}
