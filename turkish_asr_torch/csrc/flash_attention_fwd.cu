// Flash-attention forward for Hopper (sm_90a), MQA and MHA: wgmma fed by
// TMA through an mbarrier ring.
//
// Replaces: turkish_asr_tpu/ops/_flash_attention_impl.py
//   _flash_attention_fwd_impl, the Kh == 1 branch (pallas_call at :244,
//   tile body _attend at :71) and the Kh == H branch (pallas_call at :290).
//
// Computes, for every query row r of (b, h):
//   s[r, j]  = (q[r] . k[j]) / sqrt(D) + (mask[b, j] - 1) * 1e9     (fp32)
//   out[r]   = softmax_j(s[r]) @ v                                   (fp32)
//   lse[r]   = m + log(sum_j exp(s[r, j] - m)),  m = max_j s[r, j]
// A masked key gets a finite -1e9 added, never -inf, so a row with no
// valid key comes out as uniform weights over its -1e9-shifted scores,
// as the TPU kernel gives it. Keys past T and query rows past the row
// count read as zero (TMA fills a box past the tensor with zeros) and are
// masked or not written; nothing is rounded up to a tile multiple.
//
// What bounds it on the H100: 4*T'*T'*D flops per query head against
// T'*D*(H + 2) input elements and T'*D*H fp32 outputs: the bytes at the
// training shape (T'=200), the flops from the served T'=601 up. The
// kernel does 6*T'*T'*D (the scores twice, below) plus an exp and a
// division a score.
//
// Design (attention_plan in ops/flash_attention.py gives the grid):
//   - A block is kGroups consumer warpgroups of 64 query rows each and one
//     producer warpgroup; setmaxnreg hands the producer's registers to the
//     consumers. The producer loads the block's Q tile once, then streams
//     64-key K (and V) tiles through a ring of kStages stages, each with a
//     full and an empty mbarrier: one thread issues the TMA copies
//     (cp.async.bulk.tensor, 128-byte swizzle, the tensor maps passed as
//     __grid_constant__ parameters), the others write the tile's 64 mask
//     shifts. A consumer warpgroup waits on the full barrier, runs its
//     products and arrives on the empty one.
//   - S = Q K^T is wgmma m64n64k16 with Q and K from shared memory (both
//     K-major); O += P V takes P from registers (the accumulator repacked
//     to bf16, hopper.cuh) and V from shared memory (MN-major), so P never
//     touches shared memory. D = 128 runs P V as two 64-column halves.
//   - Two passes, to round p where the TPU kernel rounds it: pass 1 takes
//     S per key tile for each row's max m and sum l (online: l is rescaled
//     by exp(m_old - m_new) when the max moves; the tile's sum and l are
//     fp64, so the rescaling adds no rounding of its own); pass 2 forms the
//     exactly normalized p = exp(s - m) / l, applies dropout, rounds p to
//     the input dtype as the TPU kernel does before p @ v (_attend :89)
//     and runs P V. Only pass 2 stages V. A one-pass online softmax could
//     only round the unnormalized p; on the served path that moved 2% of a
//     random-weight model's frame argmaxes away from the plain version's.
//     The scores keep the plain version's two roundings (__fmul_rn,
//     __fadd_rn), exp is expf with no fast-math, and the backward rebuilds
//     p from the same m and l with the same formula.
//   - The MQA property the TPU kernel exists for is kept: with Kh == 1 the
//     H query heads fold into rows (B, H*T, D), so one K/V tile serves the
//     block's every row; with Kh == H a block takes its own head's K/V.
//
// fp32 inputs (dtype 0: the tests and the fp32 gradient check, not the
// bf16 main path) run the same code with each operand a bf16 pair x = hi +
// lo (flash_wgmma.cuh: pack_parts): TMA copies the fp32 tile into a staging
// buffer and the producer warpgroup splits it into the two bf16 tiles as
// it stages them. S and P V take three terms, hi*hi + hi*lo + lo*hi, the
// two small ones summed in an accumulator of their own and added once a
// tile (flash_wgmma.cuh says why). fp32 instances hold one
// consumer warpgroup a block (two blocks an SM), so their tiles fit.
//
// Attention-weight dropout (training; counterpart of _keep_mask and the
// per-program seeding of the TPU kernel, :62 and :228/:277): with rate > 0
// the normalized p is multiplied by 1/(1 - rate) where the position hash
// of dropout_hash.cuh keeps it and set to 0 where it drops it, before p is
// rounded to the input dtype (_attend :85-91); lse is taken before
// dropout. The hash is keyed by position: accumulator element i of thread
// t in warp w of a warpgroup is query row 16 w + t % 32 / 4 + 8 ((i / 2) %
// 2) of the warpgroup's 64 and key 8 (i / 4) + 2 (t % 4) + i % 2 of the
// tile (hopper.cuh), so the backward regenerates the same mask with its
// own tiling. rate == 0 instantiates the kernel without any of that code.
//
// Layout: q (B, H, T, D), k and v (B, Kh, T, D), mask (B, T) uint8, all
// contiguous, q/k/v 16-byte aligned; out (B, H, T, D) fp32, lse, row_max
// and row_sum (B, H, T) fp32. row_max and row_sum are the softmax's m and
// l, which the backward uses to rebuild p = exp(s - m) / l bit for bit:
// exp(s - lse) cannot do that for a row with no valid key, whose lse
// rounds to exactly -1e9. The entry point encodes the three tensor maps on
// the host at each call (cuTensorMapEncodeTiled, looked up through the
// CUDA runtime); `ab_attention.py --host` times the wrapper's host cost
// with them (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dropout_hash.cuh"
#include "flash_wgmma.cuh"

namespace {

using flash::bf16;
using flash::kTile;  // query rows of a consumer warpgroup; keys of a K/V tile
using namespace hopper;

constexpr int kStages = 2;  // K/V tiles in flight

struct Params {
  const uint8_t* mask;
  float* out;
  float* lse;
  float* row_max;
  float* row_sum;
  int H, Kh, T_len, D, rows;
  float scale;
  uint32_t seed, threshold;
  float inv_keep;
};

// The instance's shape: Tin's parts, warpgroups and shared memory (bytes
// from a 1024-aligned base).
template <typename Tin, int DP> struct Layout {
  static constexpr bool kFp32 = std::is_same<Tin, float>::value;
  static constexpr int kParts = kFp32 ? 2 : 1;
  static constexpr int kGroups = kFp32 ? 1 : 2;      // consumer warpgroups
  static constexpr int kThreads = 128 * (kGroups + 1);
  static constexpr int kMinBlocks = kGroups == 1 ? 2 : 1;
  // setmaxnreg: all of the SM's 65536 registers (2 x 32768 for one group)
  static constexpr int kProducerRegs = kGroups == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = kGroups == 3 ? 160 : kGroups == 2 ? 232 : 216;
  static constexpr int kRows = kTile * kGroups;       // query rows a block
  static constexpr int kQTile = kRows * DP * 2;       // bytes of one part of Q
  static constexpr int kKVTile = kTile * DP * 2;      // of one part of a K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kParts * kQTile;     // [stage][part]
  static constexpr int kV = kK + kStages * kParts * kKVTile;
  static constexpr int kStaging = kV + kStages * kParts * kKVTile;  // fp32 [64][DP]
  static constexpr int kShift = kStaging + (kFp32 ? kTile * DP * 4 : 0);  // [stage][key]
  static constexpr int kBars = kShift + kStages * kTile * 4;  // full, empty, q, staging
  static constexpr int kBytes = kBars + (2 * kStages + 2) * 8 + 1024;  // + the alignment
};

// p cast to v's dtype and widened back.
template <typename T> __device__ __forceinline__ float round_p(float p) { return p; }
template <> __device__ __forceinline__ float round_p<bf16>(float p) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

template <typename Tin, int DP, bool kDropout>
__global__ void __launch_bounds__(Layout<Tin, DP>::kThreads, Layout<Tin, DP>::kMinBlocks)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, Params P) {
  using L = Layout<Tin, DP>;
  constexpr int kParts = L::kParts, kGroups = L::kGroups;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sQ = smem + L::kQ;
  unsigned char* sK = smem + L::kK;
  unsigned char* sV = smem + L::kV;
  float* staging = reinterpret_cast<float*>(smem + L::kStaging);
  float* sShift = reinterpret_cast<float*>(smem + L::kShift);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;
  uint64_t* stage_bar = q_bar + 1;

  const int tid = threadIdx.x;
  const int bk = blockIdx.z;  // b * Kh + kv head
  const int b = bk / P.Kh, head = bk - b * P.Kh;
  const int T = P.T_len;
  const int q0 = blockIdx.x * L::kRows;
  const int nk = (T + kTile - 1) / kTile;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 128 * kGroups);
    }
    mbar_init(q_bar, 128);
    mbar_init(stage_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * kGroups) {
    // Producer warpgroup: Q once, then K tiles 0..nk-1 (pass 1) and K/V
    // tiles 0..nk-1 (pass 2) through the ring.
    regs_dec<L::kProducerRegs>();
    const int t = tid - 128 * kGroups;
    if (t == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
    }
    uint32_t stage_phase = 0;
    for (int w = 0; w < kGroups; ++w)
      flash::stage_tile<Tin, DP, kParts>(&tq, sQ, L::kQTile, L::kRows, kTile * w,
                                         q0 + kTile * w, bk, q_bar, staging, stage_bar,
                                         stage_phase, t);
    fence_proxy_async();
    mbar_arrive(q_bar);
    const uint8_t* mb = P.mask + static_cast<size_t>(b) * T;
    Ring ring;
    for (int step = 0; step < 2 * nk; ++step) {
      mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
      const int k0 = (step < nk ? step : step - nk) * kTile;
      unsigned char* k_tile = sK + ring.stage * kParts * L::kKVTile;
      flash::stage_tile<Tin, DP, kParts>(&tk, k_tile, L::kKVTile, kTile, 0, k0, bk,
                                         &full[ring.stage], staging, stage_bar, stage_phase, t);
      if (step >= nk)
        flash::stage_tile<Tin, DP, kParts>(&tv, sV + ring.stage * kParts * L::kKVTile,
                                           L::kKVTile, kTile, 0, k0, bk, &full[ring.stage],
                                           staging, stage_bar, stage_phase, t);
      if (t < kTile)  // -inf past the sequence: weight 0
        sShift[ring.stage * kTile + t] =
            k0 + t >= T ? -INFINITY : (mb[k0 + t] != 0 ? 0.f : flash::kMaskShift);
      fence_proxy_async();
      mbar_arrive(&full[ring.stage]);
      ring.next<kStages>();
    }
    return;
  }

  // Consumer warpgroup wg: query rows q0 + 64 wg + 16 warp + g (+ 8).
  regs_inc<L::kConsumerRegs>();
  const int wg = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = kTile * wg;  // the warpgroup's rows in the Q tile
  float m_run[2] = {-INFINITY, -INFINITY};
  double l_run[2] = {0.0, 0.0};
  uint32_t row_hash[2] = {0u, 0u};
  if (kDropout) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + row0 + 16 * warp + g + 8 * i;  // a folded MQA row is (row / T, row % T)
      const int h = (P.Kh == 1) ? row / T : head;
      row_hash[i] = dropout_row_hash(P.seed, b, P.H, h, (P.Kh == 1) ? row - h * T : row);
    }
  }
  float o[DP / 64][32];
#pragma unroll
  for (int h = 0; h < DP / 64; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[h][i] = 0.f;
  float s[32], t[32];

  mbar_wait(q_bar, 0);
  Ring ring;
  for (int step = 0; step < 2 * nk; ++step) {
    const bool pass1 = step < nk;
    const int k0 = (pass1 ? step : step - nk) * kTile;
    mbar_wait(&full[ring.stage], ring.phase);
    const unsigned char* k_tile = sK + ring.stage * kParts * L::kKVTile;

    // S = Q K^T (fp32 pairs: hi*hi, then hi*lo + lo*hi on their own).
    reg_fence(s);
    wg_fence();
    flash::products_ss<kParts, kParts, DP / 16, 0, 0>(
        s, t, [&](int i, int kk) { return desc_k(sQ + i * L::kQTile, L::kRows, row0, kk); },
        [&](int j, int kk) { return desc_k(k_tile + j * L::kKVTile, kTile, 0, kk); }, 0);
    flash::finish_products<kParts, kParts>(s, t);
    // The scaled score plus the mask shift (two roundings, as in the plain
    // version, so fully masked rows agree; -inf past the sequence).
    const float* shift = sShift + ring.stage * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 sh = *reinterpret_cast<const float2*>(shift + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = __fadd_rn(__fmul_rn(s[4 * j + e], P.scale), (e & 1) ? sh.y : sh.x);
    }

    if (pass1) {
      mbar_arrive(&empty[ring.stage]);
      // Row max and sum, online over the key tiles. Key k0 lies inside the
      // sequence, so m_new is finite. Each lane sums its 16 terms of a
      // tile in fp32; the tile's sum and the running l are fp64.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[i], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sum += expf(s[4 * j + 2 * i] - m_new) + expf(s[4 * j + 2 * i + 1] - m_new);
        double tile = sum;
        tile += __shfl_xor_sync(0xffffffffu, tile, 1);
        tile += __shfl_xor_sync(0xffffffffu, tile, 2);
        l_run[i] = l_run[i] * exp(static_cast<double>(m_run[i]) - m_new) + tile;
        m_run[i] = m_new;
      }
    } else {
      // Normalized p (dropped and rescaled under dropout), rounded to the
      // input dtype, then O += P V with P from registers.
      const float l_f[2] = {static_cast<float>(l_run[0]), static_cast<float>(l_run[1])};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float p = flash::div_rn(expf(s[i] - m_run[r]), l_f[r]);
        if (kDropout)
          p = dropout_keep(row_hash[r], k0 + 8 * (i >> 2) + 2 * t4 + (i & 1), P.threshold)
                  ? __fmul_rn(p, P.inv_keep)
                  : 0.f;
        s[i] = round_p<Tin>(p);
      }
      uint32_t a[4][kParts][4];  // P's parts (a bf16 p is one part, exactly)
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) flash::a_parts<kParts>(s, kc, a[kc]);
      const unsigned char* v_tile = sV + ring.stage * kParts * L::kKVTile;
#pragma unroll
      for (int h = 0; h < DP / 64; ++h) {
        reg_fence(o[h]);
        wg_fence();
        flash::products_rs<kParts, kParts, 4, 1>(
            o[h], t, a,
            [&](int j, int kc) { return desc_mn(v_tile + j * L::kKVTile, kTile, h, kc); }, 1);
        flash::finish_products<kParts, kParts>(o[h], t);
      }
      mbar_arrive(&empty[ring.stage]);
    }
    ring.next<kStages>();
  }

  const int D = P.D;
  const size_t base = static_cast<size_t>(bk) * P.rows;  // (b, h) rows: folded for MQA
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row0 + 16 * warp + g + 8 * i;
    if (row >= P.rows) continue;
    float* orow = P.out + (base + row) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * t4;
      if (d < D)
        *reinterpret_cast<float2*>(orow + d) =
            make_float2(o[j >> 3][4 * (j & 7) + 2 * i], o[j >> 3][4 * (j & 7) + 2 * i + 1]);
    }
    if (t4 == 0) {
      const float l = static_cast<float>(l_run[i]);
      P.lse[base + row] = m_run[i] + logf(l);
      P.row_max[base + row] = m_run[i];
      P.row_sum[base + row] = l;
    }
  }
}

template <typename Tin, int DP, bool kDropout>
cudaError_t launch(const CUtensorMap* maps, const Params& P, dim3 grid, cudaStream_t stream) {
  using L = Layout<Tin, DP>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<Tin, DP, kDropout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<Tin, DP, kDropout>
      <<<grid, L::kThreads, L::kBytes, stream>>>(maps[0], maps[1], maps[2], P);
  return cudaGetLastError();
}

template <typename Tin, int DP>
cudaError_t launch_rate(const CUtensorMap* maps, const Params& P, dim3 grid, int dropout,
                        cudaStream_t stream) {
  return dropout ? launch<Tin, DP, true>(maps, P, grid, stream)
                 : launch<Tin, DP, false>(maps, P, grid, stream);
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
// dtype: 0 = fp32 inputs, 1 = bf16 inputs. dropout: 0 runs the kernel
// without dropout (seed, threshold and inv_keep unused); 1 keeps p where
// the position hash is >= threshold and scales it by inv_keep.
// block_rows, stages, grid_x: the launch ops/flash_attention.py::
// attention_plan gives; refused unless they are this instance's and the
// grid covers every row (the grid is (grid_x, 1, B * Kh)).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, void* lse,
                                   void* row_max, void* row_sum,
                                   int B, int H, int Kh, int T_len, int D,
                                   int dtype, int dropout, unsigned int seed,
                                   unsigned int threshold, float inv_keep, int block_rows,
                                   int stages, int grid_x, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0 || D <= 0 || D % 8 != 0 || D > 128 ||
      (Kh != 1 && Kh != H) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (Kh == 1) ? H * T_len : T_len;
  const int want_rows = dtype == 1 ? Layout<bf16, 64>::kRows : Layout<float, 64>::kRows;
  if (block_rows != want_rows || stages != kStages ||
      static_cast<long long>(grid_x) * block_rows < rows ||
      static_cast<long long>(grid_x - 1) * block_rows >= rows || B * Kh > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  Params P;
  P.mask = static_cast<const uint8_t*>(mask);
  P.out = static_cast<float*>(out);
  P.lse = static_cast<float*>(lse);
  P.row_max = static_cast<float*>(row_max);
  P.row_sum = static_cast<float*>(row_sum);
  P.H = H;
  P.Kh = Kh;
  P.T_len = T_len;
  P.D = D;
  P.rows = rows;
  P.scale = 1.0f / sqrtf(static_cast<float>(D));
  P.seed = seed;
  P.threshold = threshold;
  P.inv_keep = inv_keep;
  // q as (B * Kh, rows, D): its rows folded for MQA; k, v as (B * Kh, T, D).
  const int esize = dtype == 1 ? 2 : 4;
  const int DP = D <= 64 ? 64 : 128;
  const int box_cols = dtype == 1 ? 64 : DP;
  CUtensorMap maps[3];
  if (!hopper_host::encode_3d(&maps[0], q, esize, D, D, rows, static_cast<long long>(B) * Kh,
                              box_cols, kTile) ||
      !hopper_host::encode_3d(&maps[1], k, esize, D, D, T_len, static_cast<long long>(B) * Kh,
                              box_cols, kTile) ||
      !hopper_host::encode_3d(&maps[2], v, esize, D, D, T_len, static_cast<long long>(B) * Kh,
                              box_cols, kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_x, 1, B * Kh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(DP == 64 ? launch_rate<bf16, 64>(maps, P, grid, dropout, s)
                                     : launch_rate<bf16, 128>(maps, P, grid, dropout, s));
  return static_cast<int>(DP == 64 ? launch_rate<float, 64>(maps, P, grid, dropout, s)
                                   : launch_rate<float, 128>(maps, P, grid, dropout, s));
}
