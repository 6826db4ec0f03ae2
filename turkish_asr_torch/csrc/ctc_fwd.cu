// CTC forward (alpha) recursion for Hopper (sm_90a).
//
// Replaces: turkish_asr_tpu/ops/_ctc_pallas_impl.py _run_forward /
//   _fwd_kernel (pallas_call at :196, kernel at :85), with the emission
//   gather of _prep (:149-190) and the final log-likelihood of _ctc_fwd
//   (:274-298).
//
// Computes, for each sample b with extended labels ext (blank-interleaved,
// S = 2L + 1 lanes) and skip flags allow_skip (ops/ctc.py ctc_topology):
//   alpha_0[s] = lp[b, 0, ext[s]] for s == 0, and s == 1 when the target is
//                non-empty; -1e30 elsewhere
//   alpha_t[s] = ((alpha[s] (+) alpha[s-1]) (+) alpha[s-2] if skip[s])
//                + lp[b, t, ext[s]]                  for 0 < t < input_length
//   alpha_t    = alpha_{t-1}                          for t >= input_length
//   ll = alpha_last[2 tl] (+) alpha_last[2 tl - 1] for tl > 0, else alpha_last[0]
// with a (+) b = max(a, b) + log1p(exp(-|a - b|)) (the TPU kernel's
// _logaddexp, :58, in the same association) and the finite sentinel
// -1e30 for log 0. It writes nll[b] = -ll and alpha[b, t, :] for every
// t < input_length (the backward reads them; later rows are not written).
//
// What bounds it on the H100: the recursion is sequential in t, and each
// step is a few transcendentals per lane plus one gathered 4-byte load per
// lane, so a step costs latency (a load, a block barrier), not bandwidth
// or flops. At B = 32 there are only 32 independent recursions.
//
// Design: the TPU ran the time loop as a sequential grid with alpha in
// VMEM scratch; Hopper blocks carry nothing between them, so one block
// owns one sample and loops over t inside. Each thread owns K lanes
// s = tid + k * blockDim.x (blockDim = min(1024, S rounded up to 32), so
// S may exceed the block: K up to 8 covers S <= 8192; the largest target
// bucket, 512, gives S = 1025). A lane keeps its alpha in a register and
// publishes it through a double-buffered shared row, one __syncthreads a
// step; the next step's emissions are loaded before the barrier, so their
// latency overlaps it. The emission is read straight from
// log_probs[b, t, ext[s]]: the one-hot matmul of _prep was a TPU
// workaround for slow gathers, and a direct load is exact. No lane padding
// to 128: that was the TPU's layout rule. The loop stops at the sample's
// input length, past which alpha is frozen.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float logaddexp(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

template <int K>
__global__ void ctc_fwd_kernel(const float* __restrict__ log_probs,
                               const int* __restrict__ ext, const uint8_t* __restrict__ skip,
                               const int* __restrict__ input_lengths,
                               const int* __restrict__ target_lengths,
                               float* __restrict__ alpha, float* __restrict__ nll, int T_len,
                               int V, int S) {
  extern __shared__ float buf[];  // two rows of S: alpha of the last step, the new one
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* lp = log_probs + static_cast<size_t>(b) * T_len * V;
  float* ab = alpha + static_cast<size_t>(b) * T_len * S;
  const int len = min(input_lengths[b], T_len);
  const int tl = target_lengths[b];

  int e[K];
  bool sk[K];
  float a[K], em[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = tid + k * nt;
    const bool ok = s < S;
    const int label = ok ? ext[static_cast<size_t>(b) * S + s] : 0;
    e[k] = min(max(label, 0), V - 1);  // memory safety only: labels are < V
    sk[k] = ok && skip[static_cast<size_t>(b) * S + s] != 0;
    const bool start = s == 0 || (s == 1 && tl > 0);
    a[k] = (ok && start) ? lp[e[k]] : kNegInf;
    if (ok) {
      buf[s] = a[k];
      if (len > 0) ab[s] = a[k];
    }
    em[k] = (ok && 1 < len) ? lp[static_cast<size_t>(V) + e[k]] : 0.f;
  }
  __syncthreads();

  int cur = 0;
  for (int t = 1; t < len; ++t) {
    const float* prev = buf + cur * S;
    float* next = buf + (cur ^ 1) * S;
    float* row = ab + static_cast<size_t>(t) * S;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = tid + k * nt;
      if (s >= S) continue;
      const float a1 = s >= 1 ? prev[s - 1] : kNegInf;
      float acc = logaddexp(a[k], a1);
      if (sk[k]) acc = logaddexp(acc, s >= 2 ? prev[s - 2] : kNegInf);
      a[k] = acc + em[k];
      next[s] = a[k];
      row[s] = a[k];
    }
    // The next step's emissions, loaded before the barrier.
#pragma unroll
    for (int k = 0; k < K; ++k)
      em[k] = (tid + k * nt < S && t + 1 < len) ? lp[static_cast<size_t>(t + 1) * V + e[k]]
                                                : 0.f;
    __syncthreads();
    cur ^= 1;
  }

  if (tid == 0) {
    const float* fin = buf + cur * S;
    float ll;
    if (tl > 0) {
      const int hi = min(2 * tl, S - 1);
      const int lo = min(2 * tl - 1, S - 1);
      ll = logaddexp(fin[hi], fin[lo]);
    } else {
      ll = fin[0];
    }
    nll[b] = -ll;
  }
}

template <int K>
cudaError_t launch(const void* lp, const void* ext, const void* skip, const void* il,
                   const void* tl, void* alpha, void* nll, int B, int T_len, int V, int S,
                   int threads, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(S) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ctc_fwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ctc_fwd_kernel<K><<<B, threads, smem, stream>>>(
      static_cast<const float*>(lp), static_cast<const int*>(ext),
      static_cast<const uint8_t*>(skip), static_cast<const int*>(il),
      static_cast<const int*>(tl), static_cast<float*>(alpha), static_cast<float*>(nll), T_len,
      V, S);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
// log_probs (B, T, V) fp32; ext (B, S) int32; skip (B, S) uint8;
// input_lengths, target_lengths (B,) int32; alpha (B, T, S) fp32 out;
// nll (B,) fp32 out. S <= 8192.
extern "C" int ctc_fwd(const void* log_probs, const void* ext, const void* skip,
                       const void* input_lengths, const void* target_lengths, void* alpha,
                       void* nll, int B, int T_len, int V, int S, void* stream) {
  if (B <= 0 || T_len <= 0 || V <= 0 || S <= 0 || S > 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = S >= 1024 ? 1024 : ((S + 31) / 32) * 32;
  const int lanes = (S + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes <= 1)
    return static_cast<int>(launch<1>(log_probs, ext, skip, input_lengths, target_lengths,
                                      alpha, nll, B, T_len, V, S, threads, s));
  if (lanes <= 2)
    return static_cast<int>(launch<2>(log_probs, ext, skip, input_lengths, target_lengths,
                                      alpha, nll, B, T_len, V, S, threads, s));
  if (lanes <= 4)
    return static_cast<int>(launch<4>(log_probs, ext, skip, input_lengths, target_lengths,
                                      alpha, nll, B, T_len, V, S, threads, s));
  return static_cast<int>(launch<8>(log_probs, ext, skip, input_lengths, target_lengths, alpha,
                                    nll, B, T_len, V, S, threads, s));
}
