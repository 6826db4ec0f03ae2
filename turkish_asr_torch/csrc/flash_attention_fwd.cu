// Flash-attention forward for Hopper (sm_90a), MQA and MHA, on the tensor
// cores.
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
// as the TPU kernel gives it. Keys past T (the ragged last key tile) and
// query rows past the row count (the ragged last query tile) are masked
// in the kernel; nothing is rounded up to a tile multiple.
//
// What bounds it on the H100: 4*T'*T'*D flops per query head against
// T'*D*(H + 2) input elements and T'*D*H fp32 outputs. At the main path's
// shapes (D = 64, T' <= 801) the bf16 tensor cores would finish the flops
// in less time than device memory takes to read and write the bytes, so
// the bound is the bytes; the kernel spends more than that on its two
// passes over K (below) and on the exp and division of every score.
//
// Design (FlashAttention-2 layout on mma.sync): a block of 4 warps owns 64
// query rows, 16 per warp; K and V stream through shared memory in 64-key
// tiles, double-buffered with cp.async so that tile j + 1 is in flight
// while tile j is multiplied. Tiles stay bf16 in shared memory (rows
// padded by 16 bytes so ldmatrix is free of bank conflicts); S = Q K^T and
// O += P V run as mma.sync.m16n8k16 bf16 with fp32 accumulators, fragments
// from ldmatrix (.trans for V). A warp's S accumulator (16 rows x 64 keys)
// holds each row in one quad of lanes, so the row max and sum are reduced
// by two shuffles, and P is repacked in registers as the A operand of P V:
// it never passes through shared memory.
// Two passes, to round p where the TPU kernel rounds it: pass 1 takes
// S per tile for each row's max m and sum l (online: l is rescaled by
// exp(m_old - m_new) when the max moves); pass 2 forms the exactly
// normalized p = exp(s - m) / l, applies dropout, rounds p to the input
// dtype as the TPU kernel does before p @ v (_attend :89) and runs P V.
// A one-pass online softmax could only round the unnormalized p; on the
// served path that moved 2% of a random-weight model's frame argmaxes away
// from the plain version's. The scores keep the plain version's two
// roundings (__fmul_rn, __fadd_rn), and exp is expf, not __expf, with no
// fast-math: the backward rebuilds p from the same m and l with the same
// formula.
// The MQA property the TPU kernel exists for is kept: with Kh == 1 the H
// query heads fold into rows (B, H*T, D), so one K/V tile in shared memory
// serves every head; with Kh == H each block takes its own head's K/V.
//
// fp32 inputs (dtype 0: the tests and the fp32 gradient check, not the
// bf16 main path) run through the same tensor-core code with each operand
// split into a bf16 pair, x = hi + lo (flash_mma.cuh): S and P V take
// three mma terms each, hi*hi + hi*lo + lo*hi, about 2^-16 relative a
// product, well inside the fp32 tolerance (out and lse 1e-4). That keeps
// one kernel for both dtypes; keeping the old fp32 FMA code as the fp32
// instance would keep a second kernel. The fp32 tiles are split as they
// are staged, through registers, so their copies do not overlap the math.
//
// Attention-weight dropout (training; counterpart of _keep_mask and the
// per-program seeding of the TPU kernel, :62 and :228/:277): with rate > 0
// the normalized p is multiplied by 1/(1 - rate) where the position hash
// of dropout_hash.cuh keeps it and set to 0 where it drops it, before p is
// rounded to the input dtype (_attend :85-91); lse is taken before
// dropout. The hash is keyed by position, not by tile: an accumulator
// element's query row is 16 * warp + lane / 4 (+ 8 for c2, c3) and its key
// 8 * n_tile + 2 * (lane % 4) (+ 1 for c1, c3), so the backward
// (flash_attention_bwd.cu) regenerates the same mask with its own tiling.
// rate == 0 instantiates the kernel without any of that code.
//
// Layout: q (B, H, T, D), k and v (B, Kh, T, D), mask (B, T) uint8, all
// contiguous, q/k/v 16-byte aligned; out (B, H, T, D) fp32, lse, row_max
// and row_sum (B, H, T) fp32. row_max and row_sum are the softmax's m and
// l, which the backward uses to rebuild p = exp(s - m) / l bit for bit:
// exp(s - lse) cannot do that for a row with no valid key, whose lse
// rounds to exactly -1e9.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dropout_hash.cuh"
#include "flash_mma.cuh"

namespace {

using flash::bf16;
using flash::kThreads;

constexpr int kBlockQ = 64;  // query rows a block owns, 16 per warp
constexpr int kBlockK = 64;  // keys a shared-memory tile holds

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;
  float* out;
  float* lse;
  float* row_max;
  float* row_sum;
  int H, Kh, T_len, D;
  float scale;
  uint32_t seed, threshold;
  float inv_keep;
};

// p cast to v's dtype and widened back.
template <typename T> __device__ __forceinline__ float round_p(float p) { return p; }
template <> __device__ __forceinline__ float round_p<bf16>(float p) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

template <typename Tin, int DP>
constexpr size_t smem_bytes() {
  // Q, two K and two V tiles (each hi, and lo for fp32), the keys' mask shifts.
  return 5 * (std::is_same<Tin, float>::value ? 2 : 1) * kBlockK * (DP + 8) * sizeof(bf16) +
         2 * kBlockK * sizeof(float);
}

// DP = head dim padded to 64 or 128. kDropout instantiates the dropout code.
template <typename Tin, int DP, bool kDropout>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params P) {
  constexpr bool kSplit = std::is_same<Tin, float>::value;
  constexpr int LD = DP + 8;
  constexpr int kTile = kBlockK * LD;       // elements of one 64-row tile
  constexpr int kParts = kSplit ? 2 : 1;    // hi (and lo)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kParts * kTile;           // [buffer][part][tile]
  bf16* sV = sK + 2 * kParts * kTile;
  float* sShift = reinterpret_cast<float*>(sV + 2 * kParts * kTile);  // [buffer][key]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int head = blockIdx.y;  // 0 when Kh == 1: the heads are folded into rows
  const int b = blockIdx.z;
  const int T = P.T_len, D = P.D;
  const int rows = (P.Kh == 1) ? P.H * T : T;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t q_off = (static_cast<size_t>(b) * P.H + head) * T * D;
  const size_t kv_off = (static_cast<size_t>(b) * P.Kh + head) * T * D;
  const size_t stat_off = (static_cast<size_t>(b) * P.H + head) * T;
  const Tin* kb = static_cast<const Tin*>(P.k) + kv_off;
  const Tin* vb = static_cast<const Tin*>(P.v) + kv_off;
  const uint8_t* mb = P.mask + static_cast<size_t>(b) * T;

  if (D < DP) {
    flash::zero_words(smem_raw, 5 * kParts * kTile / 2, tid);
    __syncthreads();
  }
  flash::stage<kBlockQ, DP, kParts>(sQ, kTile, static_cast<const Tin*>(P.q) + q_off, q0, rows,
                                    D, tid);

  // Step s < nk stages K tile s (pass 1); step nk + j stages K and V tile j.
  // issue() starts a step's copies and returns whether key k0 + tid (for
  // tid < kBlockK) is valid: that byte's load is in flight over the step
  // before, and its mask shift is stored into the step's buffer after it.
  const int nk = (T + kBlockK - 1) / kBlockK;
  auto issue = [&](int step) {
    const int buf = step & 1;
    const int k0 = (step < nk ? step : step - nk) * kBlockK;
    flash::stage<kBlockK, DP, kParts>(sK + buf * kParts * kTile, kTile, kb, k0, T, D, tid);
    if (step >= nk)
      flash::stage<kBlockK, DP, kParts>(sV + buf * kParts * kTile, kTile, vb, k0, T, D, tid);
    return tid < kBlockK && k0 + tid < T && mb[k0 + tid] != 0;
  };
  auto put_shift = [&](int step, bool valid) {
    if (tid < kBlockK) sShift[(step & 1) * kBlockK + tid] = valid ? 0.f : flash::kMaskShift;
  };
  put_shift(0, issue(0));
  flash::cp_async_commit();

  // This thread's rows: 16 * warp + g (i = 0) and + 8 (i = 1).
  float m_run[2] = {-INFINITY, -INFINITY};
  double l_run[2] = {0.0, 0.0};  // fp64: the rescaling adds no rounding of its own
  uint32_t row_hash[2] = {0u, 0u};
  if (kDropout) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + 16 * warp + g + 8 * i;  // a folded MQA row is (row / T, row % T)
      const int h = (P.Kh == 1) ? row / T : head;
      row_hash[i] = dropout_row_hash(P.seed, b, P.H, h, (P.Kh == 1) ? row - h * T : row);
    }
  }
  float o[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int step = 0; step < 2 * nk; ++step) {
    const int buf = step & 1;
    const bool next_valid = step + 1 < 2 * nk && issue(step + 1);
    flash::cp_async_commit();
    flash::cp_async_wait<1>();
    __syncthreads();
    const int k0 = (step < nk ? step : step - nk) * kBlockK;
    const bf16* k_tile = sK + buf * kParts * kTile;
    const float* shift = sShift + buf * kBlockK;

    // s[j][e]: row 16 * warp + g + 8 * (e / 2), key k0 + 8 j + 2 t4 + e % 2.
    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      uint32_t a[kParts][4];
      flash::ldsm_parts(a, sQ, kTile, flash::a_frag(lane, 16 * warp, 16 * kc, LD));
#pragma unroll
      for (int j2 = 0; j2 < kBlockK / 16; ++j2) {
        uint32_t bk[kParts][4];
        flash::ldsm_parts(bk, k_tile, kTile, flash::b_frag(lane, 16 * j2, 16 * kc, LD));
        flash::mma_parts(s[2 * j2], a, bk, 0);
        flash::mma_parts(s[2 * j2 + 1], a, bk, 1);
      }
    }
    // The scaled score plus the mask shift (two roundings, as in the plain
    // version, so fully masked rows agree); -inf past the sequence (weight 0).
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t4 + (e & 1);
        s[j][e] = (k0 + c < T) ? __fadd_rn(__fmul_rn(s[j][e], P.scale), shift[c]) : -INFINITY;
      }

    if (step < nk) {
      // Pass 1: row max and row sum, online over the key tiles. Key k0 lies
      // inside the sequence, so m_new is finite. Each lane sums its 16
      // terms of a tile in fp32; the tile's sum and the running l are fp64,
      // so the rescaling by exp(m_old - m_new) adds no rounding of its own
      // (an fp32 running sum drifts by an ulp or more, and every p of the
      // row moves with l).
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[i], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j)
          sum += expf(s[j][2 * i] - m_new) + expf(s[j][2 * i + 1] - m_new);
        double tile = sum;
        tile += __shfl_xor_sync(0xffffffffu, tile, 1);
        tile += __shfl_xor_sync(0xffffffffu, tile, 2);
        l_run[i] = l_run[i] * exp(static_cast<double>(m_run[i]) - m_new) + tile;
        m_run[i] = m_new;
      }
    } else {
      // Pass 2: normalized p (dropped and rescaled under dropout), rounded
      // to the input dtype, then O += P V with P from registers.
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = __fdiv_rn(expf(s[j][e] - m_run[e >> 1]), static_cast<float>(l_run[e >> 1]));
          if (kDropout)
            p = dropout_keep(row_hash[e >> 1], k0 + 8 * j + 2 * t4 + (e & 1), P.threshold)
                    ? __fmul_rn(p, P.inv_keep)
                    : 0.f;
          s[j][e] = round_p<Tin>(p);
        }
      const bf16* v_tile = sV + buf * kParts * kTile;
#pragma unroll
      for (int kc = 0; kc < kBlockK / 16; ++kc) {
        uint32_t a[kParts][4];  // P's parts (a bf16 p is one part, exactly)
        flash::fragment_of(s[2 * kc], s[2 * kc + 1], a);
#pragma unroll
        for (int dn = 0; dn < DP / 16; ++dn) {
          uint32_t bv[kParts][4];
          flash::ldsm_parts_trans(bv, v_tile, kTile, flash::bt_frag(lane, 16 * kc, 16 * dn, LD));
          flash::mma_parts(o[2 * dn], a, bv, 0);
          flash::mma_parts(o[2 * dn + 1], a, bv, 1);
        }
      }
    }
    if (step + 1 < 2 * nk) put_shift(step + 1, next_valid);  // the other buffer: no reader now
    __syncthreads();  // the next step's copy overwrites this buffer
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * warp + g + 8 * i;
    if (row >= rows) continue;
    float* orow = P.out + q_off + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * t4;
      if (d < D) *reinterpret_cast<float2*>(orow + d) = make_float2(o[j][2 * i], o[j][2 * i + 1]);
    }
    if (t4 == 0) {
      const float l = static_cast<float>(l_run[i]);
      P.lse[stat_off + row] = m_run[i] + logf(l);
      P.row_max[stat_off + row] = m_run[i];
      P.row_sum[stat_off + row] = l;
    }
  }
}

template <typename Tin, int DP, bool kDropout>
cudaError_t launch(const Params& P, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<Tin, DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<Tin, DP, kDropout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int rows = (P.Kh == 1) ? P.H * P.T_len : P.T_len;
  const dim3 grid((rows + kBlockQ - 1) / kBlockQ, P.Kh == 1 ? 1 : P.H, B);
  flash_fwd_kernel<Tin, DP, kDropout><<<grid, kThreads, smem, stream>>>(P);
  return cudaGetLastError();
}

template <typename Tin, int DP>
cudaError_t launch_rate(const Params& P, int B, int dropout, cudaStream_t stream) {
  return dropout ? launch<Tin, DP, true>(P, B, stream) : launch<Tin, DP, false>(P, B, stream);
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
// dtype: 0 = fp32 inputs, 1 = bf16 inputs. dropout: 0 runs the kernel
// without dropout (seed, threshold and inv_keep unused); 1 keeps p where
// the position hash is >= threshold and scales it by inv_keep.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, void* lse,
                                   void* row_max, void* row_sum,
                                   int B, int H, int Kh, int T_len, int D,
                                   int dtype, int dropout, unsigned int seed,
                                   unsigned int threshold, float inv_keep, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0 || D <= 0 || D % 8 != 0 || D > 128 ||
      (Kh != 1 && Kh != H) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P;
  P.q = q;
  P.k = k;
  P.v = v;
  P.mask = static_cast<const uint8_t*>(mask);
  P.out = static_cast<float*>(out);
  P.lse = static_cast<float*>(lse);
  P.row_max = static_cast<float*>(row_max);
  P.row_sum = static_cast<float*>(row_sum);
  P.H = H;
  P.Kh = Kh;
  P.T_len = T_len;
  P.D = D;
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
