// Flash-attention backward for Hopper (sm_90a), MQA and MHA, with the
// forward's attention-weight dropout regenerated in the kernel.
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
// What bounds it on the H100: like the forward, 8*T'*T'*D flops per query
// head across the two kernels below (four T' x T' x D products, the two
// score-shaped ones computed twice) against O(T'*D) bytes, so it is
// compute-bound; this first version runs fp32 FMAs from shared memory
// (no tensor cores), so its ceiling is the card's fp32 FMA rate.
//
// Design: the TPU kernel sums dk/dv over q tiles by read-modify-write of
// one output block, legal only because the TPU grid runs in order. Hopper
// blocks run in parallel, so this is the FlashAttention-2 split into two
// kernels with no atomics (deterministic):
//   - flash_bwd_dkdv: one block per (b, kv head, 64-key tile). It keeps its
//     K and V tiles in shared memory and loops over ALL query rows of the
//     kv head (H*T folded rows for MQA, whose heads share one kv head; T
//     rows for MHA), accumulating dk and dv for its keys in registers.
//   - flash_bwd_dq: one block per (b, q tile), as the forward's blocks,
//     looping over the key tiles and accumulating dq in registers.
// Both recompute the scores and p from m and l; the dropout mask comes
// from the position hash (dropout_hash.cuh) with each kernel's own tiling.
// Layout: q, g, dq (B, H, T, D); k, v, dk, dv (B, Kh, T, D); mask (B, T)
// uint8; row_max, row_sum, delta (B, H, T) fp32; all contiguous. q, k, v
// are bf16 or fp32 and are widened to fp32 as they are staged; g and the
// outputs are fp32 (the wrapper casts dq, dk, dv to the input dtype).
// Block: 256 threads as a 16 x 16 grid, as in the forward.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kRows = kBlockQ / 16;  // score rows per thread
constexpr int kCols = kBlockK / 16;  // score columns per thread
constexpr float kMaskShift = -1e9f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

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
  int H, Kh, T_len, D;
  float scale;
  uint32_t seed, threshold;
  float inv_keep;
};

// Stage rows [r0, r0 + 64) of a (rows, D) matrix into a (64, D + 1) tile;
// rows past `rows` read as zero.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int r0, int rows, int D,
                                           int tid) {
  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = r0 + r;
    dst[r * (D + 1) + d] = row < rows ? widen(src[static_cast<size_t>(row) * D + d]) : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over (64, D + 1) tiles,
// in the forward's order of FMAs.
__device__ __forceinline__ void tile_dot(float (&acc)[kRows][kCols], const float* A,
                                         const float* Bm, int D, int tx, int ty) {
  const int ld = D + 1;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[kRows];
    float bv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) a[i] = A[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < kCols; ++j) bv[j] = Bm[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// The (head, time) of a row of the kv group: folded MQA rows are
// (r / T, r % T); MHA rows are (the block's head, r).
__device__ __forceinline__ uint32_t row_hash_of(const Params& P, int b, int head, int row) {
  const int h = (P.Kh == 1) ? row / P.T_len : head;
  const int t = (P.Kh == 1) ? row - h * P.T_len : row;
  return dropout_row_hash(P.seed, b, P.H, h, t);
}

// p, y (dropped p) and ds of one 64 x 64 tile from its scores sc (rows
// ty + 16 i, keys k0 + tx + 16 j) and dp = g @ v^T of the same elements.
template <bool kDropout>
__device__ __forceinline__ void tile_grads(const Params& P, float (&sc)[kRows][kCols],
                                           float (&dp)[kRows][kCols], const float* sMask,
                                           const float* sM, const float* sL, const float* sDelta,
                                           const uint32_t (&rh)[kRows], int r0, int rows,
                                           int k0, int tx, int ty, float* y_out, float* ds_out,
                                           int ldp) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i;
    const bool row_ok = r0 + r < rows;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      const int key = k0 + c;
      float p = 0.f;
      if (row_ok && key < P.T_len) {
        const float s = __fadd_rn(__fmul_rn(sc[i][j], P.scale), sMask[c]);
        p = __fdiv_rn(expf(s - sM[r]), sL[r]);
      }
      float keep = 1.f;
      if (kDropout) keep = dropout_keep(rh[i], key, P.threshold) ? P.inv_keep : 0.f;
      const float y = p * keep;
      const float ds = p * (dp[i][j] * keep - sDelta[r]) * P.scale;
      if (y_out) y_out[r * ldp + c] = y;
      ds_out[r * ldp + c] = ds;
    }
  }
}

__host__ __device__ constexpr size_t dq_smem_floats(int D) {
  // Q, G, K, V tiles (stride D + 1), the ds tile (stride 65), the key mask
  // and the per-row m, l, delta.
  return 4 * static_cast<size_t>(kBlockQ) * (D + 1) +
         static_cast<size_t>(kBlockQ) * (kBlockK + 1) + kBlockK + 3 * kBlockQ;
}

__host__ __device__ constexpr size_t dkdv_smem_floats(int D) {
  // K, V, Q, G tiles, the y and ds tiles, the key mask, per-row m, l, delta.
  return 4 * static_cast<size_t>(kBlockQ) * (D + 1) +
         2 * static_cast<size_t>(kBlockQ) * (kBlockK + 1) + kBlockK + 3 * kBlockQ;
}

template <typename T>
__device__ __forceinline__ void stage_keys(float* sK, float* sV, float* sMask, const T* kb,
                                           const T* vb, const uint8_t* mb, int k0, int T_len,
                                           int D, int tid) {
  stage_rows(sK, kb, k0, T_len, D, tid);
  stage_rows(sV, vb, k0, T_len, D, tid);
  if (tid < kBlockK) {
    const int key = k0 + tid;
    sMask[tid] = (key < T_len && mb[key] != 0) ? 0.f : kMaskShift;
  }
}

__device__ __forceinline__ void stage_row_stats(float* sM, float* sL, float* sDelta,
                                                const float* m, const float* l,
                                                const float* delta, int r0, int rows, int tid) {
  if (tid < kBlockQ) {
    const int row = r0 + tid;
    const bool ok = row < rows;
    sM[tid] = ok ? m[row] : 0.f;
    sL[tid] = ok ? l[row] : 1.f;
    sDelta[tid] = ok ? delta[row] : 0.f;
  }
}

// dq of one 64-row tile: grid (row tiles, Kh == 1 ? 1 : H, B).
template <typename T, int DC, bool kDropout>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(Params P) {
  extern __shared__ float smem[];
  const int D = P.D, ld = D + 1, ldp = kBlockK + 1;
  float* sQ = smem;
  float* sG = sQ + kBlockQ * ld;
  float* sK = sG + kBlockQ * ld;
  float* sV = sK + kBlockK * ld;
  float* sDS = sV + kBlockK * ld;
  float* sMask = sDS + kBlockQ * ldp;
  float* sM = sMask + kBlockK;
  float* sL = sM + kBlockQ;
  float* sDelta = sL + kBlockQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int head = blockIdx.y, b = blockIdx.z;
  const int rows = (P.Kh == 1) ? P.H * P.T_len : P.T_len;
  const int r0 = blockIdx.x * kBlockQ;
  const size_t q_off = (static_cast<size_t>(b) * P.H + head) * P.T_len * D;
  const size_t kv_off = (static_cast<size_t>(b) * P.Kh + head) * P.T_len * D;
  const size_t stat_off = (static_cast<size_t>(b) * P.H + head) * P.T_len;
  const T* kb = static_cast<const T*>(P.k) + kv_off;
  const T* vb = static_cast<const T*>(P.v) + kv_off;
  const uint8_t* mb = P.mask + static_cast<size_t>(b) * P.T_len;

  stage_rows(sQ, static_cast<const T*>(P.q) + q_off, r0, rows, D, tid);
  stage_rows(sG, P.g + q_off, r0, rows, D, tid);
  stage_row_stats(sM, sL, sDelta, P.row_max + stat_off, P.row_sum + stat_off,
                  P.delta + stat_off, r0, rows, tid);
  uint32_t rh[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) rh[i] = kDropout ? row_hash_of(P, b, head, r0 + ty + 16 * i) : 0u;

  float acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < P.T_len; k0 += kBlockK) {
    stage_keys(sK, sV, sMask, kb, vb, mb, k0, P.T_len, D, tid);
    __syncthreads();
    float sc[kRows][kCols], dp[kRows][kCols];
    tile_dot(sc, sQ, sK, D, tx, ty);
    tile_dot(dp, sG, sV, D, tx, ty);
    tile_grads<kDropout>(P, sc, dp, sMask, sM, sL, sDelta, rh, r0, rows, k0, tx, ty, nullptr,
                         sDS, ldp);
    __syncthreads();
    for (int kk = 0; kk < kBlockK; ++kk) {
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + 16 * c;
        kv[c] = d < D ? sK[kk * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float ds = sDS[(ty + 16 * i) * ldp + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
    __syncthreads();  // the next tile overwrites sK, sV, sDS and sMask
  }

  float* dqb = P.dq + q_off;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) dqb[static_cast<size_t>(row) * D + d] = acc[i][c];
    }
  }
}

// dk and dv of one 64-key tile: grid (key tiles, Kh, B).
template <typename T, int DC, bool kDropout>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(Params P) {
  extern __shared__ float smem[];
  const int D = P.D, ld = D + 1, ldp = kBlockK + 1;
  float* sK = smem;
  float* sV = sK + kBlockK * ld;
  float* sQ = sV + kBlockK * ld;
  float* sG = sQ + kBlockQ * ld;
  float* sY = sG + kBlockQ * ld;
  float* sDS = sY + kBlockQ * ldp;
  float* sMask = sDS + kBlockQ * ldp;
  float* sM = sMask + kBlockK;
  float* sL = sM + kBlockQ;
  float* sDelta = sL + kBlockQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int head = blockIdx.y, b = blockIdx.z;  // head: the kv head (0 for MQA)
  const int k0 = blockIdx.x * kBlockK;
  const int rows = (P.Kh == 1) ? P.H * P.T_len : P.T_len;
  const size_t q_off = (static_cast<size_t>(b) * P.H + head) * P.T_len * D;
  const size_t kv_off = (static_cast<size_t>(b) * P.Kh + head) * P.T_len * D;
  const size_t stat_off = (static_cast<size_t>(b) * P.H + head) * P.T_len;
  const T* qb = static_cast<const T*>(P.q) + q_off;
  const float* gb = P.g + q_off;

  stage_keys(sK, sV, sMask, static_cast<const T*>(P.k) + kv_off,
             static_cast<const T*>(P.v) + kv_off, P.mask + static_cast<size_t>(b) * P.T_len,
             k0, P.T_len, D, tid);

  float acc_dk[kRows][DC], acc_dv[kRows][DC];  // keys ty + 16 i, dims tx + 16 c
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  for (int r0 = 0; r0 < rows; r0 += kBlockQ) {
    stage_rows(sQ, qb, r0, rows, D, tid);
    stage_rows(sG, gb, r0, rows, D, tid);
    stage_row_stats(sM, sL, sDelta, P.row_max + stat_off, P.row_sum + stat_off,
                    P.delta + stat_off, r0, rows, tid);
    __syncthreads();
    uint32_t rh[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      rh[i] = kDropout ? row_hash_of(P, b, head, r0 + ty + 16 * i) : 0u;
    float sc[kRows][kCols], dp[kRows][kCols];
    tile_dot(sc, sQ, sK, D, tx, ty);
    tile_dot(dp, sG, sV, D, tx, ty);
    tile_grads<kDropout>(P, sc, dp, sMask, sM, sL, sDelta, rh, r0, rows, k0, tx, ty, sY, sDS,
                         ldp);
    __syncthreads();
    for (int r = 0; r < kBlockQ; ++r) {
      float gv[DC], qv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + 16 * c;
        gv[c] = d < D ? sG[r * ld + d] : 0.f;
        qv[c] = d < D ? sQ[r * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float y = sY[r * ldp + ty + 16 * i];
        const float ds = sDS[r * ldp + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc_dv[i][c] = fmaf(y, gv[c], acc_dv[i][c]);
          acc_dk[i][c] = fmaf(ds, qv[c], acc_dk[i][c]);
        }
      }
    }
    __syncthreads();  // the next row tile overwrites sQ, sG, sY, sDS and the row stats
  }

  float* dkb = P.dk + kv_off;
  float* dvb = P.dv + kv_off;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= P.T_len) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dkb[static_cast<size_t>(key) * D + d] = acc_dk[i][c];
        dvb[static_cast<size_t>(key) * D + d] = acc_dv[i][c];
      }
    }
  }
}

template <typename T, int DC, bool kDropout>
cudaError_t launch(const Params& P, int B, cudaStream_t stream) {
  const size_t smem_dq = dq_smem_floats(P.D) * sizeof(float);
  const size_t smem_dkdv = dkdv_smem_floats(P.D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq<T, DC, kDropout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_dq));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, DC, kDropout>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dkdv));
  if (err != cudaSuccess) return err;
  const int rows = (P.Kh == 1) ? P.H * P.T_len : P.T_len;
  const dim3 grid_dq((rows + kBlockQ - 1) / kBlockQ, P.Kh == 1 ? 1 : P.H, B);
  flash_bwd_dq<T, DC, kDropout><<<grid_dq, kThreads, smem_dq, stream>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_dkdv((P.T_len + kBlockK - 1) / kBlockK, P.Kh, B);
  flash_bwd_dkdv<T, DC, kDropout><<<grid_dkdv, kThreads, smem_dkdv, stream>>>(P);
  return cudaGetLastError();
}

template <typename T, int DC>
cudaError_t launch_rate(const Params& P, int B, int dropout, cudaStream_t stream) {
  return dropout ? launch<T, DC, true>(P, B, stream) : launch<T, DC, false>(P, B, stream);
}

}  // namespace

// Returns a cudaError_t: 0 when both launches were accepted.
// dtype: 0 = fp32 q/k/v, 1 = bf16 q/k/v. dropout as in flash_attention_fwd.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* mask, const void* g, const void* row_max,
                                   const void* row_sum, const void* delta, void* dq,
                                   void* dk, void* dv, int B, int H, int Kh, int T_len,
                                   int D, int dtype, int dropout, unsigned int seed,
                                   unsigned int threshold, float inv_keep, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0 || D <= 0 || D % 8 != 0 || D > 128 ||
      (Kh != 1 && Kh != H) || (dtype != 0 && dtype != 1))
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
    return static_cast<int>(D <= 64 ? launch_rate<__nv_bfloat16, 4>(P, B, dropout, s)
                                    : launch_rate<__nv_bfloat16, 8>(P, B, dropout, s));
  return static_cast<int>(D <= 64 ? launch_rate<float, 4>(P, B, dropout, s)
                                  : launch_rate<float, 8>(P, B, dropout, s));
}
