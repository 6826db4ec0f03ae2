// Hopper (sm_90a) building blocks of the flash-attention kernels: mbarrier
// rings, TMA tile loads, wgmma on 128-byte-swizzled bf16 tiles, register
// hand-over between warpgroups, and the host-side tensor-map encoding.
//
// Tiles. A bf16 tile of R rows and C columns (C a multiple of 64) is C/64
// "atoms" of R rows x 128 bytes, atom a at byte a * R * 128, each row's
// eight 16-byte chunks stored at chunk ^ (row % 8): the layout TMA writes
// with CU_TENSOR_MAP_SWIZZLE_128B for a box of 64 columns, and the one
// wgmma reads with the 128-byte swizzle (layout type 1). Every tile starts
// on a 1024-byte boundary, where the swizzle pattern repeats. element_at()
// gives an element's byte offset, for tiles the threads write themselves.
//
// wgmma operands from such a tile (PTX ISA, "Matrix Descriptor Format"):
//   K-major, the tile's rows are M (or N) and its columns K (q and k rows
//     with d contiguous, as S = Q K^T reads both): k-step kk of 16 columns
//     starts at atom kk / 4, byte 32 * (kk % 4) of its first row; the
//     stride between 8-row groups (SBO) is 1024 bytes.
//   MN-major (transposed), the tile's rows are K and its columns N (v rows
//     with d contiguous, as O += P V reads V): k-step kk of 16 rows starts
//     at byte 2048 * kk; 8-row groups 1024 bytes apart (SBO), 64-column
//     atoms R * 128 bytes apart (LBO).
// The m64n64k16 accumulator (32 fp32 a thread) holds, in thread t of the
// warpgroup (warp w = t / 32, g = t % 32 / 4, q = t % 4), element i at row
// 16 w + g + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 q + i % 2: the
// mma.sync m16n8 layout of each warp's 16 rows. An A operand from
// registers takes four bf16x2 a thread in the m16n8k16 A layout of the
// same rows, so two 8-column groups of an accumulator, repacked, are the A
// operand of a 16-deep k-step (flash_wgmma.cuh: a_parts).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, nothing is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` of TMA data on the barrier's phase.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Expect `bytes` more of TMA data on the barrier's phase, without arriving.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity (the
// first phase after init has parity 0).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A ring position: stage and the parity of its current round.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  template <int kStages> __device__ __forceinline__ void next() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// Barrier among `threads` threads (a multiple of 32) under id (1-15; 0 is
// __syncthreads).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma, TMA) of this CTA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --------------------------------------------------------------------- TMA

// The box at coordinates (c0, c1, c2) of a 3-D tensor map into shared
// memory; the barrier counts its bytes. Coordinates past the tensor read
// as zero.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The box at (c0, c1, c2) of a 3-D tensor map from shared memory (a bulk
// async-group: commit, then wait before the buffer is written again).
// Elements past the tensor are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until at most N committed stores are still reading shared memory.
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Wait until at most N committed stores are still in flight.
template <int N> __device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ------------------------------------------------------------ warpgroups

template <int N> __device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------------------ tiles

// Byte offset of element (r, c) of a bf16 tile of R rows (layout above).
__device__ __forceinline__ uint32_t element_at(int R, int r, int c) {
  return static_cast<uint32_t>((c >> 6) * R * 128 + r * 128 +
                               ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1));
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// Descriptor of k-step kk of a K-major tile of R rows at `tile`, from its
// row `row0` (a multiple of 8).
__device__ __forceinline__ uint64_t desc_k(const void* tile, int R, int row0, int kk) {
  return make_desc(smem_u32(tile) + (kk >> 2) * R * 128 + row0 * 128 + (kk & 3) * 32, 16, 1024);
}

// Descriptor of k-step kk of an MN-major tile of R rows at `tile`, from
// its 64-column atom `atom`.
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int R, int atom, int kk) {
  return make_desc(smem_u32(tile) + atom * R * 128 + kk * 2048, R * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the wgmma fence, commit and wait around it.
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_ACC32(d)                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define HOPPER_D32                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "     \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B, m64n64k16, bf16 in, fp32 accumulate: A and B from shared
// memory; tA / tB = 1 reads that operand MN-major. accumulate = 0
// overwrites d.
template <int tA, int tB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : HOPPER_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate), "n"(tA), "n"(tB));
}

// The same with A from registers (the m16n8k16 A layout of each warp's rows).
template <int tB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : HOPPER_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(tB));
}

}  // namespace hopper

// ------------------------------------------------------------------- host

namespace hopper_host {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime: the
// libraries link no libcuda of their own.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map of an (outer, rows, cols) tensor whose rows are `pitch`
// elements apart (pitch >= cols, pitch * elem_bytes a multiple of 16) and
// whose outer index steps rows * pitch elements; element size 2 (bf16:
// boxes of 64 columns, 128-byte swizzle) or 4 (fp32: boxes of box_cols
// columns, unswizzled), box_rows rows and one outer index a box. Returns
// false if the encoding is refused.
inline bool encode_3d(CUtensorMap* map, const void* base, int elem_bytes, long long cols,
                      long long pitch, long long rows, long long outer, int box_cols,
                      int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(pitch * elem_bytes),
                                 static_cast<cuuint64_t>(rows * pitch * elem_bytes)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map,
            elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            3, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            elem_bytes == 2 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace hopper_host
