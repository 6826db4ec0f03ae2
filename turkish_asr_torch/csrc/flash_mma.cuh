// Tensor-core building blocks shared by the flash-attention forward and
// backward (sm_90a): cp.async tile copies, ldmatrix fragment loads, the
// bf16 m16n8k16 mma with fp32 accumulators, and the bf16 hi/lo split that
// carries fp32 operands through the bf16 tensor cores.
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
// Shared-memory tiles are bf16, rows of kLd = DP + 8 elements (DP the head
// dim padded to a multiple of 16): the 16-byte pad shifts each row by four
// banks, so the eight row addresses of an 8 x 8 ldmatrix hit all 32 banks.
//
// fp32 operands as bf16 parts: x = hi + lo with hi = bf16(x) and lo =
// bf16(x - hi) (x - hi is exact in fp32), so |x - hi - lo| <= 2^-17 |x|;
// a third part, bf16(x - hi - lo), leaves at most 2^-25 |x|. A product of
// two pairs is taken as hi*hi + hi*lo + lo*hi (lo*lo, below 2^-16 of the
// product, is dropped); a pair against a bf16 operand as hi*b + lo*b
// (mma_parts). Every partial product of two bf16 values is exact in fp32,
// and the sums are fp32.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kMaskShift = -1e9f;

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
//   b_frag: B of two n8 tiles, stored [n][k]: n rows [n, n + 16), k cols
//           [c, c + 16); r[0], r[1] = b0, b1 of n tile 0, r[2], r[3] of tile 1 (ldsm_x4)
//   bt_frag: B of two n8 tiles, stored [k][n]: k rows [c, c + 16), n cols
//           [n, n + 16); the same register order (ldsm_x4_trans)
__device__ __forceinline__ int a_frag(int lane, int r, int c, int ld) {
  return (r + (lane & 15)) * ld + c + ((lane >> 4) << 3);
}
__device__ __forceinline__ int b_frag(int lane, int n, int c, int ld) {
  return (n + (lane & 7) + ((lane >> 4) << 3)) * ld + c + (((lane >> 3) & 1) << 3);
}
__device__ __forceinline__ int bt_frag(int lane, int c, int n, int ld) {
  return (c + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n + ((lane >> 4) << 3);
}

// Rows [row0, row0 + ROWS) of a (rows, D) row-major fp32 matrix, in this
// thread's registers: load() issues all of the thread's 16-byte loads at
// once (rows past `rows` and columns past D read as zero), so they are in
// flight together, and over whatever the block computes before store();
// store() splits them into P bf16 parts, tiles `stride` elements apart of
// row stride DP + 8.
template <int ROWS, int DP>
struct Fp32Rows {
  static constexpr int kPerRow = DP / 4;
  static constexpr int kN = ROWS * kPerRow / kThreads;
  float4 x[kN];

  __device__ __forceinline__ void load(const float* src, int row0, int rows, int D, int tid) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kPerRow, c = (idx % kPerRow) * 4;
      x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < rows && c < D)
        x[i] = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(row0 + r) * D + c));
    }
  }

  template <int P>
  __device__ __forceinline__ void store(bf16* dst, int stride, int tid) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kPerRow, c = (idx % kPerRow) * 4;
      uint32_t a[P], b[P];
      pack_parts<P>(x[i].x, x[i].y, a);
      pack_parts<P>(x[i].z, x[i].w, b);
#pragma unroll
      for (int j = 0; j < P; ++j)
        *reinterpret_cast<uint2*>(dst + j * stride + r * (DP + 8) + c) = make_uint2(a[j], b[j]);
    }
  }
};

// Copy rows [row0, row0 + ROWS) of a (rows, D) row-major matrix into a
// (ROWS, DP + 8) bf16 tile: bf16 sources (P = 1) by cp.async (the caller
// commits and waits); fp32 sources through registers (Fp32Rows), split
// into P tiles `stride` elements apart, 64 rows at a time. Rows past
// `rows` are zero; bf16 copies leave columns [D, DP) as they are (the
// caller zeroes them once).
template <int ROWS, int DP, int P>
__device__ __forceinline__ void stage(bf16* dst, int /*stride*/, const bf16* src, int row0,
                                      int rows, int D, int tid) {
  static_assert(P == 1, "bf16 data is one part");
  const int per_row = D / 8;
  for (int idx = tid; idx < ROWS * per_row; idx += kThreads) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * 8;
    const bool ok = row0 + r < rows;
    cp_async_16(dst + r * (DP + 8) + c, ok ? src + static_cast<size_t>(row0 + r) * D + c : src,
                ok);
  }
}

template <int ROWS, int DP, int P>
__device__ __forceinline__ void stage(bf16* dst, int stride, const float* src, int row0,
                                      int rows, int D, int tid) {
  constexpr int kRows = ROWS < 64 ? ROWS : 64;
#pragma unroll 1
  for (int r = 0; r < ROWS; r += kRows) {
    Fp32Rows<kRows, DP> x;
    x.load(src, row0 + r, rows, D, tid);
    x.template store<P>(dst + r * (DP + 8), stride, tid);
  }
}

// The fragments of P parts `stride` elements apart, at element offset `at`
// of the first.
template <int P>
__device__ __forceinline__ void ldsm_parts(uint32_t (&r)[P][4], const bf16* tile, int stride,
                                           int at) {
#pragma unroll
  for (int i = 0; i < P; ++i) ldsm_x4(r[i], tile + i * stride + at);
}

template <int P>
__device__ __forceinline__ void ldsm_parts_trans(uint32_t (&r)[P][4], const bf16* tile,
                                                 int stride, int at) {
#pragma unroll
  for (int i = 0; i < P; ++i) ldsm_x4_trans(r[i], tile + i * stride + at);
}

// c += A B for one n8 tile (`half` of a two-tile B fragment), over the
// products of A's part i and B's part j with i + j < max(PA, PB): the
// terms down to the finer operand's last part. Two pairs give hi*hi,
// hi*lo, lo*hi; a triple against bf16 data gives its three parts; two
// triples give the six terms above 2^-24. The small terms are summed in
// an accumulator of their own and added to c once: the tensor cores add
// each product block to its accumulator at the accumulator's precision,
// so small terms poured one mma at a time into a large c lose their low
// bits: on the card the worst fp32 gradient (B=4, T'=601) fell from 9.1e-5
// to 2.3e-5 of the largest with the separate sum, against 1e-4 allowed.
template <int PA, int PB>
__device__ __forceinline__ void mma_parts(float (&c)[4], const uint32_t (&a)[PA][4],
                                          const uint32_t (&b)[PB][4], int half) {
  constexpr int kTop = (PA > PB ? PA : PB) - 1;
  mma(c, a[0], b[0][2 * half], b[0][2 * half + 1]);
  if (kTop == 0) return;
  float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < PA; ++i)
#pragma unroll
    for (int j = 0; j < PB; ++j)
      if (i + j > 0 && i + j <= kTop) mma(t, a[i], b[j][2 * half], b[j][2 * half + 1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// Zero `words` 32-bit words of shared memory: the tiles' columns [D, DP),
// which no copy writes, must read as zero in every product.
__device__ __forceinline__ void zero_words(void* base, int words, int tid) {
  uint32_t* p = static_cast<uint32_t*>(base);
  for (int i = tid; i < words; i += kThreads) p[i] = 0u;
}

}  // namespace flash
