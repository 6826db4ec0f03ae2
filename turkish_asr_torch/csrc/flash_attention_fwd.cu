// Flash-attention forward for Hopper (sm_90a), MQA and MHA.
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
// What bounds it on the H100: at the serving shapes (D = 64, T' <= 801)
// the work is 4*T'*T'*D flops per query head (6*T'*T'*D with the second
// score pass below), against T'*D*(H + 2) elements of input, so the kernel
// is compute-bound. This first version runs its products as fp32 FMAs
// from shared memory (no tensor cores), so its ceiling is the card's fp32
// FMA rate, not the bf16 tensor-core rate.
//
// Design: the TPU kernel keeps one sequence's whole K/V in VMEM (tens of
// MB) and takes an exact softmax over the full row. A Hopper block has at
// most 227 KB of shared memory, so K/V stream through it in 64-key tiles,
// twice. Pass 1 streams the K tiles with an online softmax to get each
// row's max m and sum l (l is rescaled by exp(m_old - m_new) when the max
// moves). Pass 2 streams the K and V tiles again, forms the exactly
// normalized p = exp(s - m) / l, rounds it to the input dtype as the TPU
// kernel does before p @ v (_attend :89), and accumulates p @ v in fp32.
// A one-pass online softmax would skip the second score pass but could
// only round the unnormalized p; on the served path that moved 2% of a
// random-weight model's frame argmaxes away from the plain version's.
// The MQA property the TPU kernel exists for is kept: with Kh == 1 the H
// query heads fold into rows (B, H*T, D), so one K/V tile in shared memory
// serves every head; with Kh == H each block takes its own head's K/V.
// Inputs are bf16 or fp32 and are widened to fp32 as they are staged.
//
// Attention-weight dropout (training; counterpart of _keep_mask and the
// per-program seeding of the TPU kernel, :62 and :228/:277): with rate > 0
// the normalized p is multiplied by 1/(1 - rate) where the position hash
// of dropout_hash.cuh keeps it and set to 0 where it drops it, before p is
// rounded to the input dtype (_attend :85-91); lse is taken before
// dropout. The hash is keyed by position, not by tile, so the backward
// (flash_attention_bwd.cu) regenerates the same mask with its own tiling.
// rate == 0 instantiates the kernel without any of that code.
//
// Layout: q (B, H, T, D), k and v (B, Kh, T, D), mask (B, T) uint8, all
// contiguous; out (B, H, T, D) fp32, lse, row_max and row_sum (B, H, T)
// fp32. row_max and row_sum are the softmax's m and l, which the backward
// uses to rebuild p = exp(s - m) / l bit for bit: exp(s - lse) cannot do
// that for a row with no valid key, whose lse rounds to exactly -1e9.
// Block: 256 threads as a 16 x 16 grid; thread (ty, tx) owns query rows
// ty + 16 i (i < 4) and, in the score tile, key columns tx + 16 j (j < 4),
// in the output tile, head-dim columns tx + 16 c (c < DC).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kBlockQ / 16;
constexpr int kColsPerThread = kBlockK / 16;
constexpr float kMaskShift = -1e9f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T and widened back: the cast of p to v's dtype.
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__host__ __device__ constexpr size_t smem_floats(int D) {
  // Q tile, K tile, V tile (row stride D + 1), P tile (row stride
  // kBlockK + 1), and the per-key additive mask.
  return static_cast<size_t>(kBlockQ) * (D + 1) +
         2 * static_cast<size_t>(kBlockK) * (D + 1) +
         static_cast<size_t>(kBlockQ) * (kBlockK + 1) + kBlockK;
}

// DC = head-dim columns per thread in the output tile: 4 covers D <= 64,
// 8 covers D <= 128. kDropout instantiates the dropout code.
template <typename T, int DC, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ lse,
                 float* __restrict__ row_max, float* __restrict__ row_sum,
                 int H, int Kh, int T_len, int D, float scale,
                 uint32_t seed, uint32_t threshold, float inv_keep) {
  extern __shared__ float smem[];
  const int ld = D + 1;  // odd stride: column reads hit distinct banks
  const int ldp = kBlockK + 1;
  float* sQ = smem;
  float* sK = sQ + kBlockQ * ld;
  float* sV = sK + kBlockK * ld;
  float* sP = sV + kBlockK * ld;
  float* sMask = sP + kBlockQ * ldp;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int head = blockIdx.y;  // 0 when Kh == 1: the heads are folded into rows
  const int b = blockIdx.z;
  const int rows = (Kh == 1) ? H * T_len : T_len;
  const int q0 = blockIdx.x * kBlockQ;

  const size_t q_off = (static_cast<size_t>(b) * H + head) * T_len * D;
  const size_t kv_off = (static_cast<size_t>(b) * Kh + head) * T_len * D;
  const T* qb = q + q_off;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;
  const uint8_t* mb = mask + static_cast<size_t>(b) * T_len;
  float* ob = out + q_off;
  const size_t stat_off = (static_cast<size_t>(b) * H + head) * T_len;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = q0 + r;
    sQ[r * ld + d] = row < rows ? widen(qb[static_cast<size_t>(row) * D + d]) : 0.f;
  }

  float m_run[kRowsPerThread];
  float l_run[kRowsPerThread];
  float acc[kRowsPerThread][DC];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // Stage the K tile (and the V tile when with_v) of keys [k0, k0 + 64)
  // and the tile's additive mask; keys past T read as zero.
  auto stage = [&](int k0, bool with_v) {
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int r = idx / D;
      const int d = idx - r * D;
      const int key = k0 + r;
      const bool ok = key < T_len;
      const size_t g = static_cast<size_t>(key) * D + d;
      sK[r * ld + d] = ok ? widen(kb[g]) : 0.f;
      if (with_v) sV[r * ld + d] = ok ? widen(vb[g]) : 0.f;
    }
    if (tid < kBlockK) {
      const int key = k0 + tid;
      sMask[tid] = (key < T_len && mb[key] != 0) ? 0.f : kMaskShift;
    }
  };

  // s[i][j] = score of row ty + 16 i against key k0 + tx + 16 j: the scaled
  // product plus the mask shift (two roundings, as in the plain version,
  // so fully masked rows agree), -inf past the sequence (weight 0).
  float s[kRowsPerThread][kColsPerThread];
  auto scores = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kRowsPerThread];
      float kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qv[i] = sQ[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) kv[j] = sK[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int c = tx + 16 * j;
        const float sc = __fadd_rn(__fmul_rn(s[i][j], scale), sMask[c]);
        s[i][j] = (k0 + c < T_len) ? sc : -INFINITY;
      }
  };

  // Pass 1: row max and row sum, online over the key tiles.
  for (int k0 = 0; k0 < T_len; k0 += kBlockK) {
    stage(k0, false);
    __syncthreads();
    scores(k0);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) tile_max = fmaxf(tile_max, s[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      // Key k0 lies inside the sequence, so m_new is finite.
      const float m_new = fmaxf(m_run[i], tile_max);
      float tile_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) tile_sum += expf(s[i][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, off);
      l_run[i] = l_run[i] * expf(m_run[i] - m_new) + tile_sum;
      m_run[i] = m_new;
    }
    __syncthreads();  // the next tile overwrites sK and sMask
  }

  // The dropout row hash of each of this thread's rows: a folded MQA row
  // r is (head r / T, time r % T); an MHA row is (blockIdx.y, r).
  uint32_t row_hash[kRowsPerThread];
  if (kDropout) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = q0 + ty + 16 * i;
      const int h = (Kh == 1) ? row / T_len : head;
      const int t = (Kh == 1) ? row - h * T_len : row;
      row_hash[i] = dropout_row_hash(seed, b, H, h, t);
    }
  }

  // Pass 2: normalized p (dropped and rescaled under dropout), rounded to
  // the input dtype, then p @ v in fp32.
  for (int k0 = 0; k0 < T_len; k0 += kBlockK) {
    stage(k0, true);
    __syncthreads();
    scores(k0);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        float p = __fdiv_rn(expf(s[i][j] - m_run[i]), l_run[i]);
        if (kDropout)
          p = dropout_keep(row_hash[i], k0 + tx + 16 * j, threshold) ? __fmul_rn(p, inv_keep)
                                                                     : 0.f;
        sP[(ty + 16 * i) * ldp + tx + 16 * j] = round_to<T>(p);
      }
    __syncthreads();

    for (int kk = 0; kk < kBlockK; ++kk) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + 16 * c;
        vv[c] = d < D ? sV[kk * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float p = sP[(ty + 16 * i) * ldp + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
    __syncthreads();  // the next tile overwrites sK, sV, sP and sMask
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) ob[static_cast<size_t>(row) * D + d] = acc[i][c];
    }
    if (tx == 0) {
      lse[stat_off + row] = m_run[i] + logf(l_run[i]);
      row_max[stat_off + row] = m_run[i];
      row_sum[stat_off + row] = l_run[i];
    }
  }
}

template <typename T, int DC, bool kDropout>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   void* out, void* lse, void* row_max, void* row_sum, int B, int H,
                   int Kh, int T_len, int D, uint32_t seed, uint32_t threshold,
                   float inv_keep, cudaStream_t stream) {
  const size_t smem = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DC, kDropout>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int rows = (Kh == 1) ? H * T_len : T_len;
  const dim3 grid((rows + kBlockQ - 1) / kBlockQ, Kh == 1 ? 1 : H, B);
  flash_fwd_kernel<T, DC, kDropout><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out),
      static_cast<float*>(lse), static_cast<float*>(row_max), static_cast<float*>(row_sum),
      H, Kh, T_len, D, 1.0f / sqrtf(static_cast<float>(D)), seed, threshold, inv_keep);
  return cudaGetLastError();
}

template <typename T, int DC>
cudaError_t launch_rate(const void* q, const void* k, const void* v, const void* mask,
                        void* out, void* lse, void* row_max, void* row_sum, int B, int H,
                        int Kh, int T_len, int D, int dropout, uint32_t seed,
                        uint32_t threshold, float inv_keep, cudaStream_t stream) {
  return dropout ? launch<T, DC, true>(q, k, v, mask, out, lse, row_max, row_sum, B, H, Kh,
                                       T_len, D, seed, threshold, inv_keep, stream)
                 : launch<T, DC, false>(q, k, v, mask, out, lse, row_max, row_sum, B, H, Kh,
                                        T_len, D, seed, threshold, inv_keep, stream);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(
        D <= 64 ? launch_rate<__nv_bfloat16, 4>(q, k, v, mask, out, lse, row_max, row_sum, B,
                                                H, Kh, T_len, D, dropout, seed, threshold,
                                                inv_keep, s)
                : launch_rate<__nv_bfloat16, 8>(q, k, v, mask, out, lse, row_max, row_sum, B,
                                                H, Kh, T_len, D, dropout, seed, threshold,
                                                inv_keep, s));
  return static_cast<int>(
      D <= 64 ? launch_rate<float, 4>(q, k, v, mask, out, lse, row_max, row_sum, B, H, Kh,
                                      T_len, D, dropout, seed, threshold, inv_keep, s)
              : launch_rate<float, 8>(q, k, v, mask, out, lse, row_max, row_sum, B, H, Kh,
                                      T_len, D, dropout, seed, threshold, inv_keep, s));
}
