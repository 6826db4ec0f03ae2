// Warp-level tensor-core building blocks (sm_90a): cp.async tile copies,
// ldmatrix fragment loads, the bf16 m16n8k16 mma with fp32 accumulators
// (the SwiGLU kernel's products), and the bf16 hi/lo split that carries
// fp32 operands through the bf16 tensor cores (pack_parts, which the
// flash-attention kernels' wgmma products take too: flash_wgmma.cuh).
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// with g = lane / 4 and t = lane % 4 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"):
//   A (16 x 16, row-major), 4 registers of 2 bf16: a0 (row g, cols 2t, 2t+1),
//     a1 (row g+8, cols 2t..), a2 (row g, cols 2t+8..), a3 (row g+8, cols 2t+8..);
//   B (16 x 8, k x n), 2 registers: b0 (k 2t, 2t+1, col g), b1 (k 2t+8.., col g);
//   C (16 x 8) fp32, 4 registers: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// So an accumulator's two n8 tiles over 16 columns are, repacked to bf16,
// an A fragment over those 16 columns as its k: a0 = (c0, c1) and a1 =
// (c2, c3) of the first tile, a2, a3 the same of the second.
//
// Shared-memory tiles are bf16 with rows padded by 8 elements: the 16-byte
// pad shifts each row by four banks, so the eight row addresses of an 8 x 8
// ldmatrix hit all 32 banks.
//
// fp32 operands as bf16 parts: x = hi + lo with hi = bf16(x) and lo =
// bf16(x - hi) (x - hi is exact in fp32), so |x - hi - lo| <= 2^-17 |x|;
// a third part, bf16(x - hi - lo), leaves at most 2^-25 |x|. A product of
// two pairs is taken as hi*hi + hi*lo + lo*hi (lo*lo, below 2^-16 of the
// product, is dropped); a pair against a bf16 operand as hi*b + lo*b
// (flash_wgmma.cuh). Every partial product of two bf16 values is exact in
// fp32, and the sums are fp32.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (src is
// then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b on the tensor cores.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x0, x1 split into P bf16 parts, each part one register (x0 in the low
// half: the lower column of a fragment pair): part 0 rounds x, each
// further part rounds what the parts before it left.
template <int P>
__device__ __forceinline__ void pack_parts(float x0, float x1, uint32_t (&r)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    r[i] = *reinterpret_cast<uint32_t*>(&h);
    x0 -= __low2float(h);
    x1 -= __high2float(h);
  }
}

// The A fragment (P parts) over 16 columns from the accumulators of their
// two n8 tiles c0, c1 (the layouts above).
template <int P>
__device__ __forceinline__ void fragment_of(const float (&c0)[4], const float (&c1)[4],
                                            uint32_t (&a)[P][4]) {
  uint32_t r[4][P];
  pack_parts<P>(c0[0], c0[1], r[0]);
  pack_parts<P>(c0[2], c0[3], r[1]);
  pack_parts<P>(c1[0], c1[1], r[2]);
  pack_parts<P>(c1[2], c1[3], r[3]);
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = r[e][i];
}

// Fragment addresses inside a tile of row stride ld (elements), for one
// lane's row of the x4 ldmatrix:
//   a_frag: A over rows [r, r + 16), k cols [c, c + 16)      (ldsm_x4)
//   bt_frag: B of two n8 tiles, stored [k][n]: k rows [c, c + 16), n cols
//           [n, n + 16); the same register order (ldsm_x4_trans)
__device__ __forceinline__ int a_frag(int lane, int r, int c, int ld) {
  return (r + (lane & 15)) * ld + c + ((lane >> 4) << 3);
}
__device__ __forceinline__ int bt_frag(int lane, int c, int n, int ld) {
  return (c + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n + ((lane >> 4) << 3);
}

}  // namespace flash
