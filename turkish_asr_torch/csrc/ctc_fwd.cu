// CTC forward (alpha) recursion for Hopper (sm_90a).
//
// Replaces: turkish_asr_tpu/ops/_ctc_pallas_impl.py _run_forward /
//   _fwd_kernel (pallas_call at :196, kernel at :85), with the emission
//   gather of _prep (:149-190), the extended labels and skip flags of
//   ctc_topology (turkish_asr_tpu/ops/ctc.py:33) and the final
//   log-likelihood of _ctc_fwd (:274-298).
//
// Computes, for each sample b with extended labels ext (blank-interleaved,
// S = 2L + 1 lanes, built here from targets) and skip flags (ctc_common.cuh
// allow_skip):
//   alpha_0[s] = lp[b, 0, ext[s]] for s == 0, and s == 1 when the target is
//                non-empty; -1e30 elsewhere
//   alpha_t[s] = ((alpha[s] (+) alpha[s-1]) (+) alpha[s-2] if skip[s])
//                + lp[b, t, ext[s]]                  for 0 < t < input_length
//   ll = alpha_last[2 tl] (+) alpha_last[2 tl - 1] for tl > 0, else alpha_last[0]
// with a (+) b = max(a, b) + log1p(exp(-|a - b|)) (the TPU kernel's
// _logaddexp, :58, in the same association) and the finite sentinel -1e30
// for log 0. It writes nll[b] = -ll and alpha[b, t, :] for every
// t < input_length (the backward reads them; later rows are not written).
//
// What bounds it on the H100: a dependent chain of T' steps per sample,
// each two logaddexps (expf, log1pf: ~30 dependent instructions each) per
// lane, all issued by one warp. The bytes (the log-probs read once, alpha
// written once) are a few microseconds' worth; at B = 32 only 32 SMs have
// work. PERF.md has the step's time as measured.
//
// Design: the step's latency is the kernel's time, so the recursion runs
// in one warp with no block barrier in its loop (S <= 32 * 33 = 1056: up
// to the longest target bucket, L = 512). Thread g of the warp owns K
// contiguous lanes in registers (K = 5 at L = 64); alpha[s-1] and
// alpha[s-2] come from its own registers or from thread g - 1 by
// __shfl_up_sync, so a step is two shuffles and K independent
// logaddexps. The block's other warps (producers) gather the emissions
// lp[b, t, ext[s]] of the next chunk of Tc frames into a double-buffered
// (Tc, Sp) slab in shared memory with cp.async while the warp runs the
// current chunk, so the loop reads no device memory; the warp writes each
// step's alpha row back over the emissions it used, and the producers copy
// the finished chunk out, coalesced, to alpha. One __syncthreads per chunk.
// The emission of a lane is loaded straight from log_probs: the one-hot
// matmul of _prep was a TPU workaround for slow gathers. Wider S (up to
// 8192) takes the wide path: W = ceil(S / 544) recursion warps of 17 lanes
// a thread, whose boundary lanes meet through shared memory and one named
// barrier a step. ext is built from targets in shared memory by the block.
// The logaddexps run without a branch (ctc_common.cuh: log1pf's main path,
// bit for bit, and the skip term kept by a select), stage by stage across
// the thread's lanes: a branch per logaddexp made each lane wait for the
// one before it.

#include "ctc_common.cuh"

namespace {

using ctc::kNegInf;
using ctc::logaddexp;

constexpr int kProducerWarps = 4;

template <int K, int MAXW>
__global__ void __launch_bounds__(32 * (MAXW + kProducerWarps))
    ctc_fwd_kernel(const float* __restrict__ log_probs, const void* __restrict__ targets,
                   const void* __restrict__ input_lengths,
                   const void* __restrict__ target_lengths, float* __restrict__ alpha,
                   float* __restrict__ nll, int T_len, int V, int L, int blank, int flags, int W,
                   int Tc) {
  constexpr bool kPrefetch = K <= ctc::kPrefetchLanes;
  extern __shared__ float smem[];
  const int S = 2 * L + 1;
  const int NG = 32 * W;  // recursion threads
  const int Sp = NG * K;  // lanes, padded to the recursion threads' share
  float* em = smem;                              // [2][Tc][Sp] emissions, then alpha rows
  float* bnd = em + 2 * Tc * Sp;                 // [2][W][2] each warp's last two lanes
  float* fin = bnd + 4 * W;                      // [2] alpha_last[2 tl], alpha_last[2 tl - 1]
  int* ext = reinterpret_cast<int*>(fin + 2);    // [S]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bool recursion = warp < W;
  const int ptid = tid - NG, nprod = blockDim.x - NG;  // producer index and count
  const float* lp = log_probs + static_cast<size_t>(b) * T_len * V;
  float* ab = alpha + static_cast<size_t>(b) * T_len * S;
  const long long il = ctc::load_index(input_lengths, flags, 1, b);
  const int len = static_cast<int>(il < 0 ? 0 : (il > T_len ? T_len : il));
  const int tl = static_cast<int>(ctc::load_index(target_lengths, flags, 2, b));
  const int frames = max(len, 1);  // frame 0 gives alpha_0, which ll reads even at len 0
  const int nc = (frames + Tc - 1) / Tc;

  ctc::build_ext(ext, targets, flags, b, L, blank);
  // Padded lanes read zeros and are never written back.
  for (int i = tid; i < 2 * Tc * (Sp - S); i += blockDim.x) {
    const int row = i / (Sp - S);
    em[row * Sp + S + (i - row * (Sp - S))] = 0.f;
  }
  __syncthreads();

  // Producers: cp.async the emissions of frames [t0, t0 + n) into buf.
  auto gather = [&](float* buf, int t0, int n) {
    for (int e = ptid; e < n * S; e += nprod) {
      const int tt = e / S, s = e - tt * S;
      ctc::cp_async4(buf + tt * Sp + s,
                     lp + static_cast<size_t>(t0 + tt) * V + ctc::clamp_label(ext[s], V));
    }
  };
  // Producers: copy the alpha rows t < len of the chunk at t0 out of buf.
  auto write_out = [&](const float* buf, int t0) {
    const int n = min(t0 + Tc, len) - t0;
    float* dst = ab + static_cast<size_t>(t0) * S;
    for (int e = ptid; e < n * S; e += nprod) {
      const int tt = e / S;
      dst[e] = buf[tt * Sp + (e - tt * S)];
    }
  };

  const int g = tid;  // recursion thread index (tid < NG)
  float a[K];
  unsigned long long skip = 0;  // bit k: lane K * g + k takes the s - 2 transition
  if (recursion) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = K * g + k;
      if (s < S && ctc::allow_skip(ext, s, blank)) skip |= 1ull << k;
      a[k] = kNegInf;
    }
  } else {
    gather(em, 0, min(Tc, frames));
    ctc::cp_async_wait_all();
  }
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * Tc;
    float* buf = em + (c & 1) * Tc * Sp;
    if (recursion) {
      const int n = min(Tc, frames - t0);
      float e_next[kPrefetch ? K : 1];  // the next row's emissions, loaded a step ahead
#pragma unroll
      for (int k = 0; k < (kPrefetch ? K : 0); ++k) e_next[k] = buf[K * g + k];
      for (int tt = 0; tt < n; ++tt) {
        const int t = t0 + tt;
        float* row = buf + tt * Sp + K * g;
        float e_now[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (kPrefetch) {
            e_now[k] = e_next[k];
            if (tt + 1 < n) e_next[k] = row[Sp + k];
          } else {
            e_now[k] = row[k];
          }
        }
        if (t == 0) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int s = K * g + k;
            a[k] = (s < S && (s == 0 || (s == 1 && tl > 0))) ? e_now[k] : kNegInf;
          }
        } else {
          float p1 = __shfl_up_sync(0xffffffffu, a[K - 1], 1);
          float p2 = __shfl_up_sync(0xffffffffu, a[K - 2], 1);
          float b1 = kNegInf, b2 = kNegInf;
          if (MAXW > 1 && warp > 0) {  // the wide path: the warp below published them
            const float* nb = bnd + ((t - 1) & 1) * 2 * W + 2 * (warp - 1);
            b1 = nb[0];
            b2 = nb[1];
          }
          p1 = lane == 0 ? b1 : p1;
          p2 = lane == 0 ? b2 : p2;
          // Both logaddexps run on every lane and a select keeps the second
          // where the skip is allowed: a branch would serialize the lanes.
          float a1[K], a2[K], acc[K], acc2[K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            a1[k] = k >= 1 ? a[k - 1] : p1;
            a2[k] = k >= 2 ? a[k - 2] : (k == 1 ? p1 : p2);
          }
          ctc::logaddexp_lanes<K>(a, a1, acc);
          ctc::logaddexp_lanes<K>(acc, a2, acc2);
#pragma unroll
          for (int k = 0; k < K; ++k) a[k] = ctc::select((skip >> k) & 1, acc2[k], acc[k]) + e_now[k];
        }
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (K * g + k < S) row[k] = a[k];
        if (MAXW > 1 && W > 1) {
          if (lane == 31) {
            float* nb = bnd + (t & 1) * 2 * W + 2 * warp;
            nb[0] = a[K - 1];
            nb[1] = a[K - 2];
          }
          ctc::named_barrier(1, NG);
        }
      }
    } else {
      if (c > 0) write_out(em + ((c - 1) & 1) * Tc * Sp, t0 - Tc);
      if (c + 1 < nc) {
        gather(em + ((c + 1) & 1) * Tc * Sp, t0 + Tc, min(Tc, frames - t0 - Tc));
        ctc::cp_async_wait_all();
      }
    }
    __syncthreads();
  }

  if (recursion) {
    const int hi = tl > 0 ? min(2 * tl, S - 1) : 0;
    const int lo = min(max(2 * tl - 1, 0), S - 1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = K * g + k;
      if (s == hi) fin[0] = a[k];
      if (tl > 0 && s == lo) fin[1] = a[k];
    }
  } else {
    write_out(em + ((nc - 1) & 1) * Tc * Sp, (nc - 1) * Tc);
  }
  __syncthreads();
  if (tid == 0) nll[b] = -(tl > 0 ? logaddexp(fin[0], fin[1]) : fin[0]);
}

template <int K, int MAXW>
cudaError_t launch(const void* lp, const void* targets, const void* il, const void* tl,
                   void* alpha, void* nll, int B, int T_len, int V, int L, int blank, int flags,
                   int W, int Tc, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ctc_fwd_kernel<K, MAXW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ctc_fwd_kernel<K, MAXW><<<B, 32 * (W + kProducerWarps), smem, stream>>>(
      static_cast<const float*>(lp), targets, il, tl, static_cast<float*>(alpha),
      static_cast<float*>(nll), T_len, V, L, blank, flags, W, Tc);
  return cudaGetLastError();
}

// Counts the x in [first, first + count) (as bit patterns) where
// log1p_unit(x) and log1pf(x) differ (two NaNs agree).
__global__ void log1p_unit_check(unsigned first, unsigned count,
                                 unsigned long long* mismatches) {
  unsigned long long n = 0;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(first + i);
    const float want = log1pf(x), got = ctc::log1p_unit(x);
    n += __float_as_uint(want) != __float_as_uint(got) && !(want != want && got != got);
  }
  if (n) atomicAdd(mismatches, n);
}

}  // namespace

// Launches the check of ctc_common.cuh log1p_unit against log1pf over every
// float in [0, 1] and the NaNs, adding the mismatches to *mismatches (a
// device counter the caller zeroes). Returns a cudaError_t.
extern "C" int log1p_unit_mismatches(void* mismatches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<unsigned long long*>(mismatches);
  log1p_unit_check<<<1024, 256, 0, st>>>(0u, 0x3f800001u, out);  // +0 .. 1.0
  log1p_unit_check<<<1024, 256, 0, st>>>(0x7f800001u, 0x7fffffu, out);  // NaNs
  return static_cast<int>(cudaGetLastError());
}

// Returns a cudaError_t: 0 when the launch was accepted.
// log_probs (B, T, V) fp32; targets (B, L), input_lengths and
// target_lengths (B,), each int32 or int64 as `flags` says (ctc_common.cuh);
// alpha (B, T, S = 2L + 1) fp32 out; nll (B,) fp32 out. The launch plan
// (W recursion warps of K lanes a thread, Tc frames a chunk, smem bytes)
// comes from ops/ctc.py ctc_plan; a plan the kernel does not take is
// refused with cudaErrorInvalidValue.
extern "C" int ctc_fwd(const void* log_probs, const void* targets, const void* input_lengths,
                       const void* target_lengths, void* alpha, void* nll, int B, int T_len,
                       int V, int L, int blank, int flags, int W, int K, int Tc, int smem,
                       void* stream) {
  const int S = 2 * L + 1;
  if (B <= 0 || T_len <= 0 || V <= 0 || L < 0 ||
      !ctc::plan_ok(S, W, K, Tc, kProducerWarps, smem, ctc::fwd_smem_bytes(S, W, K, Tc)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W > 1)
    return static_cast<int>(launch<ctc::kWideLanes, ctc::kWideWarps>(
        log_probs, targets, input_lengths, target_lengths, alpha, nll, B, T_len, V, L, blank,
        flags, W, Tc, smem, st));
  switch (K) {
#define CTC_FWD_CASE(KK)                                                                      \
  case KK:                                                                                    \
    return static_cast<int>(launch<KK, 1>(log_probs, targets, input_lengths, target_lengths,  \
                                          alpha, nll, B, T_len, V, L, blank, flags, W, Tc,    \
                                          smem, st));
    CTC_LANE_COUNTS(CTC_FWD_CASE)
#undef CTC_FWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
