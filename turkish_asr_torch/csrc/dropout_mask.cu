// Dump of the attention-dropout keep mask, for tests and checks.
//
// Replaces: turkish_asr_tpu/ops/_flash_attention_impl.py dump_keep_mask
//   (pallas_call at :170 for MQA, :189 for MHA), which materializes the
//   keep mask the TPU kernels draw so that tests can rebuild the dropped
//   attention explicitly.
//
// Writes keep[b, h, t, j] = 1 where the position hash of dropout_hash.cuh
// keeps the attention weight of query row t against key j, else 0: the
// same mask flash_attention_fwd.cu and flash_attention_bwd.cu apply, for
// MQA and MHA alike (the hash is keyed by the query head, not the tiling).
//
// What bounds it on the H100: one byte written per element and ~20
// integer operations to make it, so it is bound by the integer issue rate
// for small T and by the (B, H, T, T) store for large T; it runs off the
// training path, so this version is a plain grid-stride loop.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

__global__ void dump_keep_mask_kernel(uint8_t* __restrict__ keep, int B, int H, int T_len,
                                      uint32_t seed, uint32_t threshold) {
  const size_t n = static_cast<size_t>(B) * H * T_len * T_len;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < n;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(idx % T_len);
    size_t rest = idx / T_len;
    const int t = static_cast<int>(rest % T_len);
    rest /= T_len;
    const int h = static_cast<int>(rest % H);
    const int b = static_cast<int>(rest / H);
    keep[idx] = dropout_keep(dropout_row_hash(seed, b, H, h, t), j, threshold) ? 1 : 0;
  }
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted. keep is a
// contiguous (B, H, T, T) uint8 buffer.
extern "C" int dump_keep_mask(void* keep, int B, int H, int T_len, unsigned int seed,
                              unsigned int threshold, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(B) * H * T_len * T_len;
  const int threads = 256;
  const int blocks = static_cast<int>(n / threads + 1 < 65536 ? n / threads + 1 : 65536);
  dump_keep_mask_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(keep), B, H, T_len, seed, threshold);
  return static_cast<int>(cudaGetLastError());
}
