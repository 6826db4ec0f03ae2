// Counter-based attention-dropout hash shared by the flash-attention
// forward, its backward and the keep-mask dump kernel.
//
// Replaces the TPU kernels' per-program hardware PRNG
// (turkish_asr_tpu/ops/_flash_attention_impl.py: _keep_mask :62, seeded
// with seed + pid * _SEED_MIX at :228, :277, :397, :465). Those bits depend
// on the grid's tiling; the forward and backward kernels here tile
// differently, so the bits are a pure function of the element's position
// instead: (seed, batch b, query head h, query row t, key column j).
//
//   stream = fmix32(seed ^ (b * H + h + 1) * 0x9E3779B1)
//   row    = fmix32(stream ^ (t + 1) * 0x85EBCA77)
//   bits   = fmix32(row ^ (j + 1) * 0xC2B2AE3D)
//   keep   = bits >= threshold,   threshold = min(floor(rate * 2^32), 2^32 - 1)
//
// fmix32 is MurmurHash3's 32-bit finalizer. All arithmetic is 32-bit
// unsigned with wraparound, so the plain PyTorch version
// (turkish_asr_torch/ops/_dropout.py) reproduces every bit in int64.
// The row hash is computed once per query row; each score element costs
// one multiply and one fmix32 (two multiplies, three shifts).

#pragma once

#include <stdint.h>

__host__ __device__ __forceinline__ uint32_t dropout_fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__host__ __device__ __forceinline__ uint32_t dropout_row_hash(uint32_t seed, int b, int H,
                                                              int h, int t) {
  const uint32_t stream =
      dropout_fmix32(seed ^ (static_cast<uint32_t>(b * H + h + 1) * 0x9E3779B1u));
  return dropout_fmix32(stream ^ (static_cast<uint32_t>(t + 1) * 0x85EBCA77u));
}

__host__ __device__ __forceinline__ bool dropout_keep(uint32_t row_hash, int key,
                                                      uint32_t threshold) {
  return dropout_fmix32(row_hash ^ (static_cast<uint32_t>(key + 1) * 0xC2B2AE3Du)) >=
         threshold;
}
