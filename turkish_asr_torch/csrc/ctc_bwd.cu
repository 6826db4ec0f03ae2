// CTC backward (beta) recursion and gradient for Hopper (sm_90a).
//
// Replaces: turkish_asr_tpu/ops/_ctc_pallas_impl.py _run_backward /
//   _bwd_kernel (pallas_call at :223, kernel at :114), with the cotangent
//   scaling and the scatter of lane gradients to (B, T, V) that _ctc_bwd
//   does outside its kernel (:301-336), and the extended labels and skip
//   flags of ctc_topology (turkish_asr_tpu/ops/ctc.py:33).
//
// Computes, time-reversed, with y = emit[t + 1] + beta[t + 1] and
// skip2[s] = allow_skip[s + 2] (:313):
//   cand[s]  = (y[s] (+) y[s+1]) (+) (y[s+2] if skip2[s])
//   beta_t   = final (0 at s = 2 tl and, for tl > 0, s = 2 tl - 1; -1e30
//              elsewhere)                       at t == input_length - 1
//            = cand                             for t < input_length - 1
//   d nll / d emit[t, s] = -exp(alpha[t, s] + beta_t[s] - ll) * cot[b]
//                          for t < input_length, else 0
//   grad[b, t, v] = sum of d nll / d emit[t, s] over the lanes s with
//                   ext[s] == v (0 where no lane has label v)
// (a (+) b, the sentinel -1e30 and the association as in ctc_fwd.cu.)
//
// What bounds it on the H100: as the forward, a dependent chain of T'
// steps, each two logaddexps per lane issued by one warp; the (B, T, V)
// gradient it writes (every element, zeros included) is the only sizeable
// traffic.
//
// Design: one warp runs the beta recursion (the wide path: W warps, as in
// the forward), each thread holding K contiguous lanes of beta in
// registers; y[s+1] and y[s+2] come from its own registers or from thread
// g + 1 by __shfl_down_sync. The loop reads shared memory only: the block's
// other warps (producers) gather the emissions lp[b, t + 1, ext[s]] of the
// next chunk of Tc frames with cp.async into a double-buffered slab, and
// the warp writes each step's beta row into a second double-buffered slab.
// The gradient is off the critical path: while the warp runs chunk c, the
// producers turn chunk c - 1's beta rows into lane gradients
// -exp(alpha + beta - ll) * cot (alpha read from device memory, eight
// loads in flight a thread), zero the chunk's (b, t, :) rows and, after a
// named barrier among themselves, write each row's labels: blank by a
// fixed-order warp reduction (each lane its lanes in increasing s, then a
// butterfly), every other label by its first lane, which walks the chain
// of lanes with the same label in increasing s. The sum has no atomics, so
// two calls give the same bits, and every element of the gradient is
// written, so the caller need not zero it. The chains (next lane with the
// same label, first-lane flag) are built per sample in shared memory by
// the producers while the warp runs the first chunk: O(L^2) comparisons of
// the targets. One __syncthreads per chunk. No V-wide row is staged: V
// reaches ~32k with an HF tokenizer. The logaddexps are the forward's
// (ctc_common.cuh), without a branch and stage by stage across the lanes.

#include "ctc_common.cuh"

namespace {

using ctc::kNegInf;

constexpr int kProducerWarps = 8;
constexpr int kLoadsInFlight = 8;

template <int K, int MAXW>
__global__ void __launch_bounds__(32 * (MAXW + kProducerWarps))
    ctc_bwd_kernel(const float* __restrict__ log_probs, const void* __restrict__ targets,
                   const void* __restrict__ input_lengths,
                   const void* __restrict__ target_lengths, const float* __restrict__ alpha,
                   const float* __restrict__ nll, const float* __restrict__ cot,
                   float* __restrict__ grad, int T_len, int V, int L, int blank, int flags,
                   int W, int Tc) {
  constexpr bool kPrefetch = K <= ctc::kPrefetchLanes;
  extern __shared__ float smem[];
  const int S = 2 * L + 1;
  const int NG = 32 * W;
  const int Sp = NG * K;
  float* em = smem;                                  // [2][Tc][Sp] emissions of frame t + 1
  float* bt = em + 2 * Tc * Sp;                      // [2][Tc][Sp] beta, then lane gradients
  float* bnd = bt + 2 * Tc * Sp;                     // [2][W][2] each warp's first two y
  int* ext = reinterpret_cast<int*>(bnd + 4 * W);    // [S]
  int* next = ext + S;                               // [S] next lane with the same label
  uint8_t* leader = reinterpret_cast<uint8_t*>(next + S);  // [S] first lane of its label

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bool recursion = warp < W;
  const int ptid = tid - NG, nprod = blockDim.x - NG;
  const int pwarp = warp - W, npwarps = nprod >> 5;
  const float* lp = log_probs + static_cast<size_t>(b) * T_len * V;
  const float* ab = alpha + static_cast<size_t>(b) * T_len * S;
  float* gb = grad + static_cast<size_t>(b) * T_len * V;
  const long long il = ctc::load_index(input_lengths, flags, 1, b);
  const int len = static_cast<int>(il < 0 ? 0 : (il > T_len ? T_len : il));
  const int tl = static_cast<int>(ctc::load_index(target_lengths, flags, 2, b));
  const float ll = -nll[b];
  const float cb = cot[b];
  const int blank_col = ctc::clamp_label(blank, V);
  const int nc = (len + Tc - 1) / Tc;
  // Chunk c holds frames [lo(c), hi(c)), taken from the end.
  auto chunk_hi = [&](int c) { return len - c * Tc; };
  auto chunk_lo = [&](int c) { return max(len - (c + 1) * Tc, 0); };

  ctc::build_ext(ext, targets, flags, b, L, blank);
  for (int s = tid; s < S; s += blockDim.x) {
    next[s] = -1;
    leader[s] = 0;
  }
  __syncthreads();

  // Producers: the emissions of frame t + 1 for the frames of chunk c
  // (0 past the last frame) into buf.
  auto gather = [&](float* buf, int c) {
    const int lo = chunk_lo(c), n = chunk_hi(c) - lo;
    for (int e = ptid; e < n * S; e += nprod) {
      const int tt = e / S, s = e - tt * S;
      const int f = lo + tt + 1;
      if (f < T_len)
        ctc::cp_async4(buf + tt * Sp + s,
                       lp + static_cast<size_t>(f) * V + ctc::clamp_label(ext[s], V));
      else
        buf[tt * Sp + s] = 0.f;
    }
  };
  // Producers: chunk c's beta rows in buf into the (b, t, :) gradient rows.
  auto reduce = [&](float* buf, int c) {
    const int lo = chunk_lo(c), n = chunk_hi(c) - lo;
    const float* arow = ab + static_cast<size_t>(lo) * S;
    for (int base = ptid; base < n * S; base += kLoadsInFlight * nprod) {
      float av[kLoadsInFlight];
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int e = base + u * nprod;
        av[u] = e < n * S ? arow[e] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int e = base + u * nprod;
        if (e < n * S) {
          const int tt = e / S;
          float* p = buf + tt * Sp + (e - tt * S);
          *p = -expf(av[u] + *p - ll) * cb;
        }
      }
    }
    ctc::zero_floats(gb + static_cast<size_t>(lo) * V, static_cast<size_t>(n) * V, ptid, nprod);
    ctc::named_barrier(2, nprod);  // lane gradients done, rows zeroed (1: the wide path's)
    for (int tt = pwarp; tt < n; tt += npwarps) {
      const float* row = buf + tt * Sp;
      float* out = gb + static_cast<size_t>(lo + tt) * V;
      float sum = 0.f;
      for (int s = lane; s < S; s += 32)
        if (ctc::clamp_label(ext[s], V) == blank_col) sum += row[s];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) out[blank_col] = sum;
      for (int s = 2 * lane + 1; s < S; s += 64) {
        if (!leader[s]) continue;
        float x = row[s];
        for (int j = next[s]; j >= 0; j = next[j]) x += row[j];
        out[ctc::clamp_label(ext[s], V)] = x;
      }
    }
  };
  // Producers: the label chains over the odd lanes (even lanes are blank).
  auto build_chains = [&]() {
    for (int i = ptid; i < L; i += nprod) {
      const int s = 2 * i + 1;
      const int v = ctc::clamp_label(ext[s], V);
      if (v == blank_col) continue;  // summed with the blanks
      int nx = -1;
      for (int j = i + 1; j < L; ++j)
        if (ctc::clamp_label(ext[2 * j + 1], V) == v) {
          nx = 2 * j + 1;
          break;
        }
      bool first = true;
      for (int j = 0; j < i; ++j)
        if (ctc::clamp_label(ext[2 * j + 1], V) == v) {
          first = false;
          break;
        }
      next[s] = nx;
      leader[s] = first;
    }
  };

  const int g = tid;
  float beta[K];
  unsigned long long valid = 0, skip2 = 0, final_lane = 0;
  if (recursion) {
    const int hi = 2 * tl, lo = max(2 * tl - 1, 0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = K * g + k;
      beta[k] = kNegInf;
      if (s < S) valid |= 1ull << k;
      if (s + 2 < S && ctc::allow_skip(ext, s + 2, blank)) skip2 |= 1ull << k;
      if (s == hi || (s == lo && tl > 0)) final_lane |= 1ull << k;
    }
  } else if (nc > 0) {
    gather(em, 0);
    ctc::cp_async_wait_all();
  }
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    const int lo = chunk_lo(c), hi = chunk_hi(c);
    float* ebuf = em + (c & 1) * Tc * Sp;
    float* bbuf = bt + (c & 1) * Tc * Sp;
    if (recursion) {
      float e_next[kPrefetch ? K : 1];  // the next row's emissions, loaded a step ahead
#pragma unroll
      for (int k = 0; k < (kPrefetch ? K : 0); ++k)
        e_next[k] = ebuf[(hi - 1 - lo) * Sp + K * g + k];
      for (int t = hi - 1; t >= lo; --t) {
        const int tt = t - lo;
        float e_now[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (kPrefetch) {
            e_now[k] = e_next[k];
            if (t > lo) e_next[k] = ebuf[(tt - 1) * Sp + K * g + k];
          } else {
            e_now[k] = ebuf[tt * Sp + K * g + k];
          }
        }
        if (t == il - 1) {
#pragma unroll
          for (int k = 0; k < K; ++k) beta[k] = ((final_lane >> k) & 1) ? 0.f : kNegInf;
        } else {
          float y[K];
#pragma unroll
          for (int k = 0; k < K; ++k) y[k] = ((valid >> k) & 1) ? e_now[k] + beta[k] : kNegInf;
          if (MAXW > 1 && W > 1) {
            if (lane == 0) {
              float* nb = bnd + (t & 1) * 2 * W + 2 * warp;
              nb[0] = y[0];
              nb[1] = y[1];
            }
            ctc::named_barrier(1, NG);
          }
          float n1 = __shfl_down_sync(0xffffffffu, y[0], 1);
          float n2 = __shfl_down_sync(0xffffffffu, y[1], 1);
          float b1 = kNegInf, b2 = kNegInf;
          if (MAXW > 1 && warp + 1 < W) {  // the wide path: the warp above published them
            const float* nb = bnd + (t & 1) * 2 * W + 2 * (warp + 1);
            b1 = nb[0];
            b2 = nb[1];
          }
          n1 = lane == 31 ? b1 : n1;
          n2 = lane == 31 ? b2 : n2;
          float y1[K], y2[K], c1[K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            y1[k] = k + 1 < K ? y[k + 1] : n1;
            y2[k] = ((skip2 >> k) & 1) ? (k + 2 < K ? y[k + 2] : (k + 1 < K ? n1 : n2)) : kNegInf;
          }
          ctc::logaddexp_lanes<K>(y, y1, c1);
          ctc::logaddexp_lanes<K>(c1, y2, beta);
        }
#pragma unroll
        for (int k = 0; k < K; ++k)
          if ((valid >> k) & 1) bbuf[tt * Sp + K * g + k] = beta[k];
      }
    } else {
      if (c + 1 < nc) gather(em + ((c + 1) & 1) * Tc * Sp, c + 1);
      if (c == 0) {
        ctc::zero_floats(gb + static_cast<size_t>(len) * V, static_cast<size_t>(T_len - len) * V,
                         ptid, nprod);
        build_chains();
      } else {
        reduce(bt + ((c - 1) & 1) * Tc * Sp, c - 1);
      }
      ctc::cp_async_wait_all();
    }
    __syncthreads();
  }

  if (!recursion) {
    if (nc > 0)
      reduce(bt + ((nc - 1) & 1) * Tc * Sp, nc - 1);
    else
      ctc::zero_floats(gb, static_cast<size_t>(T_len) * V, ptid, nprod);
  }
}

template <int K, int MAXW>
cudaError_t launch(const void* lp, const void* targets, const void* il, const void* tl,
                   const void* alpha, const void* nll, const void* cot, void* grad, int B,
                   int T_len, int V, int L, int blank, int flags, int W, int Tc, int smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ctc_bwd_kernel<K, MAXW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ctc_bwd_kernel<K, MAXW><<<B, 32 * (W + kProducerWarps), smem, stream>>>(
      static_cast<const float*>(lp), targets, il, tl, static_cast<const float*>(alpha),
      static_cast<const float*>(nll), static_cast<const float*>(cot), static_cast<float*>(grad),
      T_len, V, L, blank, flags, W, Tc);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
// log_probs (B, T, V) fp32; targets (B, L), input_lengths and
// target_lengths (B,), int32 or int64 as `flags` says (ctc_common.cuh);
// alpha (B, T, S) and nll (B,) from ctc_fwd; cot (B,) fp32 cotangent of
// nll; grad (B, T, V) fp32, every element written (no zero fill needed).
// The plan (W, K, Tc, smem) comes from ops/ctc.py ctc_plan.
extern "C" int ctc_bwd(const void* log_probs, const void* targets, const void* input_lengths,
                       const void* target_lengths, const void* alpha, const void* nll,
                       const void* cot, void* grad, int B, int T_len, int V, int L, int blank,
                       int flags, int W, int K, int Tc, int smem, void* stream) {
  const int S = 2 * L + 1;
  if (B <= 0 || T_len <= 0 || V <= 0 || L < 0 ||
      !ctc::plan_ok(S, W, K, Tc, kProducerWarps, smem, ctc::bwd_smem_bytes(S, W, K, Tc)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W > 1)
    return static_cast<int>(launch<ctc::kWideLanes, ctc::kWideWarps>(
        log_probs, targets, input_lengths, target_lengths, alpha, nll, cot, grad, B, T_len, V,
        L, blank, flags, W, Tc, smem, st));
  switch (K) {
#define CTC_BWD_CASE(KK)                                                                      \
  case KK:                                                                                    \
    return static_cast<int>(launch<KK, 1>(log_probs, targets, input_lengths, target_lengths,  \
                                          alpha, nll, cot, grad, B, T_len, V, L, blank,       \
                                          flags, W, Tc, smem, st));
    CTC_LANE_COUNTS(CTC_BWD_CASE)
#undef CTC_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
