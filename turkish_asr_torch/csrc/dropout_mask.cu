// Dump of the attention-dropout keep mask, for tests and checks.
//
// Replaces: turkish_asr_tpu/ops/_flash_attention_impl.py dump_keep_mask
//   (pallas_call at :170 for MQA, :189 for MHA), which materializes the
//   keep mask the TPU kernels draw so that tests can rebuild the dropped
//   attention explicitly.
//
// Writes keep[b, h, t, j] = 1 where the position hash of dropout_hash.cuh
// keeps the attention weight of query row t against key j, else 0, into a
// torch.bool buffer (one byte an element): the same mask
// flash_attention_fwd.cu and flash_attention_bwd.cu apply, for MQA and MHA
// alike (the hash is keyed by the query head, not the tiling).
//
// What bounds it on the H100: one byte written per element (the bound by
// bytes, 0.0031 ms at B=4, H=4, T'=801) against the integer work that
// makes it: the index split, the key's xor, fmix32's shifts and xors, the
// compare and the byte's place in its word run on the integer ALU pipe
// (64 lanes a clock an SM; the multiplies go to the FMA pipe), which sets
// a floor above the bytes bound. scripts/dump_floor.py counts it
// from the compiled code (PERF.md).
//
// Design: each thread makes 16 consecutive bytes of the flat (B, H, T, T)
// buffer and writes them with one 16-byte store, in grid-stride loops
// over 16-byte groups on a grid sized to the card. It splits a group's
// start index into (b, h, t, j) once (32-bit arithmetic where
// B·H·T·T + 15 < 2^32, a 64-bit instance past it). A first pass makes the
// groups that lie in one row, each element from one row hash: the key's
// multiply, one fmix32, one compare. A second pass makes the groups a row
// starts inside (about one a row at T' >= 16), testing each element for
// the row's end and hashing the next row there. Two passes keep a warp's
// threads on one path: a crossing group inside the first pass would hold
// its warp for a second run of 16 elements (slower at T'=801). The
// last group, where the element count is no multiple of 16, stores byte
// by byte.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

// Elements [i0, min(i0 + 16, n)) of the flat (B, H, T, T) mask, from the
// start's (b, h, t, j): 16 bytes in one word each of four.
template <typename Index>
__device__ __forceinline__ void put_group(uint8_t* keep, Index n, Index i0, const uint32_t (&w)[4]) {
  if (i0 + 16 <= n) {
    *reinterpret_cast<uint4*>(keep + i0) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int k = 0; i0 + k < n; ++k) keep[i0 + k] = static_cast<uint8_t>(w[k >> 2] >> (8 * (k & 3)));
  }
}

// Index = uint32_t while n + 15 fits in it, else uint64_t. Two passes over
// the groups, so that the warps of each stay on one path: the first makes
// every group that lies in one row (all but about one group a row at
// T' >= 16), with one row hash; the second every group a row starts
// inside, testing each element for the row's end.
template <typename Index>
__global__ void __launch_bounds__(kThreads)
    dump_keep_mask_kernel(uint8_t* __restrict__ keep, Index n, int H, int T_len, uint32_t seed,
                          uint32_t threshold) {
  const Index T = static_cast<Index>(T_len);
  const Index groups = (n + 15) / 16;
  const Index first = blockIdx.x * static_cast<Index>(kThreads) + threadIdx.x;
  const Index stride = static_cast<Index>(gridDim.x) * kThreads;
  // A group crosses into the next row when that row starts inside it.
  auto split = [&](Index i0, int& b, int& h, int& t, int& j) {
    const Index row = i0 / T;  // over (b, h, t)
    const Index bh = row / T;
    j = static_cast<int>(i0 - row * T);
    t = static_cast<int>(row - bh * T);
    b = static_cast<int>(bh / H);
    h = static_cast<int>(bh) - b * H;
    return j + 16 > T_len && i0 + (T - j) < n;
  };
  for (Index gi = first; gi < groups; gi += stride) {
    int b, h, t, j;
    if (split(gi * 16, b, h, t, j)) continue;
    const uint32_t row_hash = dropout_row_hash(seed, b, H, h, t);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 16; ++k)
      w[k >> 2] |= static_cast<uint32_t>(dropout_keep(row_hash, j + k, threshold)) << (8 * (k & 3));
    put_group(keep, n, gi * 16, w);
  }
  // The groups a row starts inside: at T' >= 16 the one holding each row's
  // first element, unless it starts the group; below, any group.
  const Index rows = n / T;
  const Index candidates = T_len >= 16 ? rows : groups;
  for (Index ci = first; ci < candidates; ci += stride) {
    const Index i0 = T_len >= 16 ? ci * T / 16 * 16 : ci * 16;
    int b, h, t, j;
    if (!split(i0, b, h, t, j)) continue;
    uint32_t row_hash = dropout_row_hash(seed, b, H, h, t);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      w[k >> 2] |= static_cast<uint32_t>(dropout_keep(row_hash, j, threshold)) << (8 * (k & 3));
      if (++j == T_len) {  // the next row (past the last group's end: never stored)
        j = 0;
        if (++t == T_len) {
          t = 0;
          if (++h == H) {
            h = 0;
            ++b;
          }
        }
        row_hash = dropout_row_hash(seed, b, H, h, t);
      }
    }
    put_group(keep, n, i0, w);
  }
}

template <typename Index>
cudaError_t launch(uint8_t* keep, uint64_t n, int H, int T_len, uint32_t seed, uint32_t threshold,
                   cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const uint64_t groups = (n + 15) / 16;
  const uint64_t wanted = (groups + kThreads - 1) / kThreads;
  const uint64_t most = static_cast<uint64_t>(sms) * kBlocksPerSM;
  const unsigned blocks = static_cast<unsigned>(wanted < most ? wanted : most);
  dump_keep_mask_kernel<Index><<<blocks, kThreads, 0, stream>>>(
      keep, static_cast<Index>(n), H, T_len, seed, threshold);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted. keep is a
// contiguous (B, H, T, T) one-byte buffer (torch.bool), 16-byte aligned.
extern "C" int dump_keep_mask(void* keep, int B, int H, int T_len, unsigned int seed,
                              unsigned int threshold, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0 || (reinterpret_cast<uintptr_t>(keep) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t n = static_cast<uint64_t>(B) * H * T_len * T_len;
  uint8_t* out = static_cast<uint8_t*>(keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 32-bit indices while n + 15, the end of the last group, fits in them.
  return static_cast<int>(n + 15 < (uint64_t{1} << 32)
                              ? launch<uint32_t>(out, n, H, T_len, seed, threshold, s)
                              : launch<uint64_t>(out, n, H, T_len, seed, threshold, s));
}
