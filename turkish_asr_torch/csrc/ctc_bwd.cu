// CTC backward (beta) recursion and gradient for Hopper (sm_90a).
//
// Replaces: turkish_asr_tpu/ops/_ctc_pallas_impl.py _run_backward /
//   _bwd_kernel (pallas_call at :223, kernel at :114), with the cotangent
//   scaling and the scatter of lane gradients to (B, T, V) that _ctc_bwd
//   does outside its kernel (:301-336).
//
// Computes, time-reversed, with y = emit[t + 1] + beta[t + 1] and
// skip2[s] = allow_skip[s + 2] (:313):
//   cand[s]  = (y[s] (+) y[s+1]) (+) (y[s+2] if skip2[s])
//   beta_t   = final (0 at s = 2 tl and, for tl > 0, s = 2 tl - 1; -1e30
//              elsewhere)                       at t == input_length - 1
//            = cand                             for t < input_length - 1
//            = beta_{t+1}                       for t >= input_length
//   d nll / d emit[t, s] = -exp(alpha[t, s] + beta_t[s] - ll) * cot[b]
//                          for t < input_length, else 0
//   grad[b, t, v] = sum of d nll / d emit[t, s] over the lanes s with
//                   ext[s] == v
// (a (+) b, the sentinel -1e30 and the association as in ctc_fwd.cu.)
//
// What bounds it on the H100: as the forward, a sequential recursion whose
// steps are latency (loads of alpha and emissions, two block barriers),
// plus the (B, T, V) gradient, which the caller zero-fills and the kernel
// writes only at the labels' columns.
//
// Design: one block per sample, looping t downwards, beta in registers
// (each thread owns lanes s = tid + k * blockDim.x, as in the forward) and
// y published through a shared row. Several lanes add into one (b, t, v):
// blank sits at every even s and a label repeats wherever the target
// repeats it. The sum is deterministic, with no atomics: the lanes whose
// label is blank go through a fixed-shape block reduction (each thread's
// lanes in order, then a warp butterfly, then thread 0 over the warps in
// order); every other label is summed by its first lane, which walks the
// chain of lanes with the same label in increasing s (next_same, built on
// the host side from the extended labels) and writes the column once. No
// V-wide row is staged: V reaches ~32k with an HF tokenizer.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float logaddexp(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

template <int K>
__global__ void ctc_bwd_kernel(const float* __restrict__ log_probs,
                               const int* __restrict__ ext, const uint8_t* __restrict__ skip,
                               const int* __restrict__ next_same,
                               const uint8_t* __restrict__ leader,
                               const int* __restrict__ input_lengths,
                               const int* __restrict__ target_lengths,
                               const float* __restrict__ alpha, const float* __restrict__ nll,
                               const float* __restrict__ cot, float* __restrict__ grad,
                               int T_len, int V, int S, int blank) {
  extern __shared__ float smem[];
  float* sY = smem;                                       // S + 2: y, then two -1e30
  float* sG = sY + S + 2;                                 // S: this step's lane gradients
  float* sWarp = sG + S;                                  // 32: blank partial sums
  int* sNext = reinterpret_cast<int*>(sWarp + 32);        // S: next lane with the same label

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane_id = tid & 31, warp = tid >> 5, n_warps = (nt + 31) >> 5;
  const float* lp = log_probs + static_cast<size_t>(b) * T_len * V;
  const float* ab = alpha + static_cast<size_t>(b) * T_len * S;
  float* gb = grad + static_cast<size_t>(b) * T_len * V;
  const int il = input_lengths[b];
  const int tl = target_lengths[b];
  const float ll = -nll[b];
  const float c = cot[b];
  const int hi = 2 * tl;
  const int lo = max(2 * tl - 1, 0);

  int e[K], label[K];
  bool sk2[K], lead[K];
  float beta[K], emn[K], fin[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = tid + k * nt;
    const bool ok = s < S;
    const size_t o = static_cast<size_t>(b) * S + s;
    label[k] = ok ? ext[o] : blank;
    e[k] = min(max(label[k], 0), V - 1);
    sk2[k] = ok && s + 2 < S && skip[o + 2] != 0;
    lead[k] = ok && leader[o] != 0 && label[k] != blank;
    fin[k] = (s == hi || (s == lo && tl > 0)) ? 0.f : kNegInf;
    beta[k] = kNegInf;
    emn[k] = 0.f;
    if (ok) sNext[s] = next_same[o];
  }
  if (tid == 0) sY[S] = sY[S + 1] = kNegInf;

  for (int t = min(T_len, il) - 1; t >= 0; --t) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = tid + k * nt;
      if (s < S) sY[s] = emn[k] + beta[k];
    }
    __syncthreads();
    float blank_sum = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = tid + k * nt;
      if (s >= S) continue;
      const float y2 = sk2[k] ? sY[s + 2] : kNegInf;
      const float cand = logaddexp(logaddexp(sY[s], sY[s + 1]), y2);
      beta[k] = (t == il - 1) ? fin[k] : cand;  // t < il - 1 otherwise
      const float g = -expf(ab[static_cast<size_t>(t) * S + s] + beta[k] - ll) * c;
      sG[s] = g;
      if (label[k] == blank) blank_sum += g;
      emn[k] = lp[static_cast<size_t>(t) * V + e[k]];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      blank_sum += __shfl_xor_sync(0xffffffffu, blank_sum, off);
    if (lane_id == 0) sWarp[warp] = blank_sum;
    __syncthreads();
    float* row = gb + static_cast<size_t>(t) * V;
    if (tid == 0) {
      float sum = 0.f;
      for (int w = 0; w < n_warps; ++w) sum += sWarp[w];
      row[min(max(blank, 0), V - 1)] = sum;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!lead[k]) continue;
      const int s = tid + k * nt;
      float sum = sG[s];
      for (int j = sNext[s]; j >= 0; j = sNext[j]) sum += sG[j];
      row[e[k]] = sum;
    }
  }
}

template <int K>
cudaError_t launch(const void* lp, const void* ext, const void* skip, const void* next_same,
                   const void* leader, const void* il, const void* tl, const void* alpha,
                   const void* nll, const void* cot, void* grad, int B, int T_len, int V,
                   int S, int blank, int threads, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(S) + 2 + 32) * sizeof(float) +
                      static_cast<size_t>(S) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      ctc_bwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ctc_bwd_kernel<K><<<B, threads, smem, stream>>>(
      static_cast<const float*>(lp), static_cast<const int*>(ext),
      static_cast<const uint8_t*>(skip), static_cast<const int*>(next_same),
      static_cast<const uint8_t*>(leader), static_cast<const int*>(il),
      static_cast<const int*>(tl), static_cast<const float*>(alpha),
      static_cast<const float*>(nll), static_cast<const float*>(cot),
      static_cast<float*>(grad), T_len, V, S, blank);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
// log_probs (B, T, V) fp32; ext (B, S) int32; skip (B, S) uint8 (allow_skip);
// next_same (B, S) int32 (next lane with the same label, -1 at the end);
// leader (B, S) uint8 (first lane of its label); input_lengths,
// target_lengths (B,) int32; alpha (B, T, S) and nll (B,) from ctc_fwd;
// cot (B,) fp32 cotangent of nll; grad (B, T, V) fp32, zero-filled by the
// caller. S <= 8192.
extern "C" int ctc_bwd(const void* log_probs, const void* ext, const void* skip,
                       const void* next_same, const void* leader, const void* input_lengths,
                       const void* target_lengths, const void* alpha, const void* nll,
                       const void* cot, void* grad, int B, int T_len, int V, int S, int blank,
                       void* stream) {
  if (B <= 0 || T_len <= 0 || V <= 0 || S <= 0 || S > 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = S >= 1024 ? 1024 : ((S + 31) / 32) * 32;
  const int lanes = (S + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CTC_BWD_LAUNCH(K)                                                                    \
  launch<K>(log_probs, ext, skip, next_same, leader, input_lengths, target_lengths, alpha,   \
            nll, cot, grad, B, T_len, V, S, blank, threads, s)
  if (lanes <= 1) return static_cast<int>(CTC_BWD_LAUNCH(1));
  if (lanes <= 2) return static_cast<int>(CTC_BWD_LAUNCH(2));
  if (lanes <= 4) return static_cast<int>(CTC_BWD_LAUNCH(4));
  return static_cast<int>(CTC_BWD_LAUNCH(8));
#undef CTC_BWD_LAUNCH
}
