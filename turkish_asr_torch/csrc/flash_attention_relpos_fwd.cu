// Relative-position attention forward for Hopper (sm_90a): Transformer-XL's
// score (Dai et al. 2019, sec. 3.3) as Conformer uses it, wgmma fed by TMA,
// with no score tensor in global memory.
//
// Computes, for head h of row b, query i and key j (ops/_relpos_attention.py
// is the plain version):
//   s[i, j] = ((q_i + u_h) . k_j + (q_i + v_h) . p[T-1-i+j]) / sqrt(D)
//             + (j < length[b] ? 0 : -1e9)                         (fp32)
//   out_i   = softmax_j(s[i]) @ v                                   (bf16 out)
// p holds the 2T-1 projected relative positions from T-1 down to -(T-1)
// (ESPnet's order), so p[T-1-i+j] is the embedding of i - j.
//
// Layout: q, k, v, out (B, T, H, D) bf16 (the projections' own layout: no
// transpose before or after), p (2T-1, H, D) bf16, u and v biases (H, D)
// fp32, lengths (B,) int32. D = 64 or 128, one template instance each. Keys
// past T and query rows past T read as zero (TMA fills a box past the
// tensor with zeros); keys past T get weight 0 and rows past T are not
// written.
//
// Design (the flash forward's, csrc/flash_attention_fwd.cu, one pass):
//   - A block is two consumer warpgroups of 64 query rows and one producer
//     warpgroup, whose thread 0 loads the block's Q tile once and streams
//     64-key K and V tiles and the rows of p they need through a two-stage
//     ring of full/empty mbarriers (4-D tensor maps over (D, H, T, B), so a
//     box is one head's rows and 64 columns: a D = 128 tile is two boxes).
//     setmaxnreg hands the producer's registers to the consumers.
//   - The biases are added to q once: each consumer warpgroup reads its
//     rows of Q from shared memory as q + u (bf16) into the register
//     A-operand layout, so S = (Q + u) K^T is a register wgmma (m64n64k16).
//   - Position: the 64 rows of a warpgroup against 64 keys span 127
//     relative distances, so (Q + v) over 128 rows of p gives every term
//     they need: band[a][n] = (q_a + v) . p[k0 + n] with k0 = T-64-i0+j0 and
//     n = 63-a+c for query a and key c of the tiles. The block's two
//     warpgroups share 192 rows of p (rows 64-191 for the first, 0-127 for
//     the second). The skew is a pass through shared memory: each warp
//     writes its 16 band rows and reads back, for each score it holds,
//     column 63-a+c of its row (a warp's rows are its own, so a __syncwarp
//     orders it).
//   - Online softmax in fp32 (base 2, the running max and sum rescaled when
//     the max moves), P rounded to bf16 in registers as the A operand of
//     O += P V (V MN-major from shared memory).
//   - Keys at or past a row's length weigh nothing once any key is valid,
//     so key tiles past the length are skipped; a row of length 0 attends
//     over all T keys, as the plain version does.
// The two head sizes differ where D = 128 would not fit (Plan below):
//   - D = 64: q + v too is a register A operand; each stage holds its key
//     tile's whole 192-row box of p, and the band is one m64n128k16 wgmma
//     skewed through a 64 x 128 float buffer a warpgroup.
//   - D = 128 (the same box would make ~260 KB of shared memory and q + u,
//     q + v and a 64 x 128 O would pass the registers): q + v is written
//     over the Q tile and read by shared-memory wgmmas; p comes as a ring of
//     four 64-row chunks, one new chunk a key tile (consecutive tiles share
//     128 rows), and the band is two m64n64k16 wgmmas, one a chunk, skewed
//     in two passes through a 64 x 64 float buffer.
// No tensor of B x H x T x T or T x (2T-1) scores exists anywhere: the
// band lives in registers and the skew buffer.
//
// What bounds it on the H100 (ops/relpos_attention.py, asr_bench's count):
// 6*B*H*T*T*D flops counted (q.k, q.p and p.v for each pair) against
// 4*B*T*H*D bf16 elements moved: the flops at every served length. The
// kernel computes 8*T*T*D a head (the band's 128 columns for 64 keys).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;       // query rows of a consumer warpgroup; keys of a tile
constexpr int kGroups = 2;      // consumer warpgroups
constexpr int kRows = kTile * kGroups;
constexpr int kBand = kRows + kTile;  // rows of p a block's key tile needs
constexpr int kStages = 2;
constexpr int kThreads = 128 * (kGroups + 1);
constexpr float kMaskShift = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the instance for head size D (a 1024-byte multiple
// between tiles, where the 128-byte swizzle repeats).
template <int D>
struct Plan {
  static constexpr bool kRing = D > 64;   // p as a ring of chunks; q + v from shared memory
  static constexpr int kSteps = D / 16;   // k-steps of a product over D
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kKVBytes = kTile * D * 2;
  static constexpr int kPBytes = kRing ? 0 : kBand * D * 2;  // the stage's box of p
  static constexpr int kStageBytes = 2 * kKVBytes + kPBytes;
  static constexpr int kChunks = kRing ? 4 : 0;              // 64-row chunks of p
  static constexpr int kChunkBytes = kTile * D * 2;
  static constexpr int kPitch = kRing ? 72 : 132;  // floats between the skew buffer's rows
  static constexpr int kOffQ = 0;
  static constexpr int kOffStages = kOffQ + kQBytes;                        // [stage]{K, V, P}
  static constexpr int kOffChunks = kOffStages + kStages * kStageBytes;     // [chunk]
  static constexpr int kOffSkew = kOffChunks + kChunks * kChunkBytes;       // [group][64][kPitch]
  static constexpr int kOffBars = kOffSkew + kGroups * kTile * kPitch * 4;  // full, empty, q
  static constexpr int kSmemBytes = kOffBars + (2 * kStages + 1) * 8 + 1024;  // + the alignment
};
static_assert(Plan<64>::kSmemBytes <= 232448 && Plan<128>::kSmemBytes <= 232448,
              "the plan exceeds the H100's 227 KB of shared memory a block");

struct Params {
  const float* u;
  const float* v;
  const int* lengths;
  bf16* out;
  int T, H;
  float scale_log2;  // log2(e) / sqrt(D)
};

// The box at (c0, c1, c2, c3) of a 4-D tensor map into shared memory; the
// barrier counts its bytes. Coordinates past the tensor read as zero.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// A tile of `rows` rows of D columns: D / 64 boxes, one 128-byte atom each.
template <int D>
__device__ __forceinline__ void tma_load_tile(unsigned char* dst, int rows, const CUtensorMap* map,
                                              uint64_t* bar, int h, int row, int outer) {
#pragma unroll
  for (int a = 0; a < D / 64; ++a)
    tma_load_4d(dst + a * rows * 128, map, bar, 64 * a, h, row, outer);
}

// d (+)= A B, m64n128k16, A from registers (the m16n8k16 A layout of each
// warp's rows), B from shared memory (tB = 1: MN-major); accumulator layout
// as hopper.cuh's m64n128 one.
template <int tB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : HOPPER_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(tB));
}

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The score's mask shift for key j (base 2).
__device__ __forceinline__ float key_shift(int j, int length, int T) {
  return j < length ? 0.f : (j < T ? kMaskShift * kLog2e : -INFINITY);
}

// One 64-column half of a warpgroup's band, columns n0 ... n0+63, through
// the skew buffer: each score (a, c) of this warp whose column 63 - a + c
// lies in the half gains that band entry.
template <int kPitch>
__device__ __forceinline__ void skew_half(float (&s)[32], const float (&band)[32], float* skew,
                                          int warp, int g, int t4, int n0) {
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + 2 * t4;
    *reinterpret_cast<float2*>(skew + r * kPitch + c) = make_float2(band[i], band[i + 1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int a = 16 * warp + g + 8 * ((i >> 1) & 1);
    const int col = 63 - a + 8 * (i >> 2) + 2 * t4 + (i & 1) - n0;
    if (col >= 0 && col < 64) s[i] += skew[a * kPitch + col];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_relpos_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tp, Params P) {
  typedef Plan<D> L;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sQ = smem + L::kOffQ;
  unsigned char* chunks = smem + L::kOffChunks;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kOffBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;

  const int tid = threadIdx.x;
  const int bh = blockIdx.z;
  const int b = bh / P.H, h = bh - b * P.H;
  const int T = P.T;
  const int q0 = blockIdx.x * kRows;
  const int nk = (T + kTile - 1) / kTile;
  const int length = min(max(P.lengths[b], 0), T);
  // Key tiles past the length add exactly nothing (exp of -1e9 below the max).
  const int tiles = length > 0 ? (length + kTile - 1) / kTile : nk;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kGroups);
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * kGroups) {
    regs_dec<40>();
    if (tid != 128 * kGroups) return;
    tma_prefetch(&tq);
    tma_prefetch(&tk);
    tma_prefetch(&tv);
    tma_prefetch(&tp);
    mbar_arrive_tx(q_bar, L::kQBytes);
    tma_load_tile<D>(sQ, kRows, &tq, q_bar, h, q0, b);
    Ring ring;
    for (int step = 0; step < tiles; ++step) {
      mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
      const int j0 = step * kTile;
      unsigned char* st = smem + L::kOffStages + ring.stage * L::kStageBytes;
      if constexpr (L::kRing) {
        // chunk c holds p rows T-128-q0+64c ... +63; key tile `step` reads
        // chunks step ... step+2, so the first loads three, the others one
        const int first = step == 0 ? 0 : step + 2;
        mbar_arrive_tx(&full[ring.stage],
                       L::kStageBytes + (step + 3 - first) * L::kChunkBytes);
        tma_load_tile<D>(st, kTile, &tk, &full[ring.stage], h, j0, b);
        tma_load_tile<D>(st + L::kKVBytes, kTile, &tv, &full[ring.stage], h, j0, b);
        for (int c = first; c <= step + 2; ++c)
          tma_load_tile<D>(chunks + (c & 3) * L::kChunkBytes, kTile, &tp, &full[ring.stage], h,
                           T - kRows - q0 + kTile * c, 0);
      } else {
        mbar_arrive_tx(&full[ring.stage], L::kStageBytes);
        tma_load_tile<D>(st, kTile, &tk, &full[ring.stage], h, j0, b);
        tma_load_tile<D>(st + L::kKVBytes, kTile, &tv, &full[ring.stage], h, j0, b);
        // p rows T-128-q0+j0 ... +191: the second warpgroup's band, then the first's
        tma_load_tile<D>(st + 2 * L::kKVBytes, kBand, &tp, &full[ring.stage], h,
                         T - kRows - q0 + j0, 0);
      }
      ring.next<kStages>();
    }
    return;
  }

  regs_inc<232>();
  const int wg = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  float* skew = reinterpret_cast<float*>(smem + L::kOffSkew) + wg * kTile * L::kPitch;

  // q + u of the warpgroup's rows as register A operands, and q + v: in
  // registers too (D = 64), or written over the rows of Q (D = 128).
  mbar_wait(q_bar, 0);
  uint32_t qu[L::kSteps][4], qv[L::kRing ? 1 : L::kSteps][4];
  {
    const float* u = P.u + h * D;
    const float* v = P.v + h * D;
#pragma unroll
    for (int kc = 0; kc < L::kSteps; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = kTile * wg + 16 * warp + g + 8 * (e & 1);
        const int c = 16 * kc + 8 * (e >> 1) + 2 * t4;
        unsigned char* at = sQ + element_at(kRows, r, c);
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(at);
        const float x0 = __low2float(x), x1 = __high2float(x);
        qu[kc][e] = pack_bf16(x0 + u[c], x1 + u[c + 1]);
        if constexpr (L::kRing)
          *reinterpret_cast<uint32_t*>(at) = pack_bf16(x0 + v[c], x1 + v[c + 1]);
        else
          qv[kc][e] = pack_bf16(x0 + v[c], x1 + v[c + 1]);
      }
    if constexpr (L::kRing) {  // q + v visible to the warpgroup's wgmmas
      fence_proxy_async();
      named_sync(1 + wg, 128);
    }
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float s[32];

  Ring ring;
  for (int step = 0; step < tiles; ++step) {
    const int j0 = step * kTile;
    mbar_wait(&full[ring.stage], ring.phase);
    const unsigned char* st = smem + L::kOffStages + ring.stage * L::kStageBytes;

    if constexpr (L::kRing) {
      // the band's columns 0-63 from chunk step+1-wg, 64-127 from the next
      const unsigned char* lo = chunks + ((step + 1 - wg) & 3) * L::kChunkBytes;
      const unsigned char* hi = chunks + ((step + 2 - wg) & 3) * L::kChunkBytes;
      float blo[32], bhi[32];
      reg_fence(s);
      reg_fence(blo);
      reg_fence(bhi);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < L::kSteps; ++kk)
        wgmma_rs<0>(s, qu[kk], desc_k(st, kTile, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < L::kSteps; ++kk)
        wgmma_ss<0, 0>(blo, desc_k(sQ, kRows, kTile * wg, kk), desc_k(lo, kTile, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < L::kSteps; ++kk)
        wgmma_ss<0, 0>(bhi, desc_k(sQ, kRows, kTile * wg, kk), desc_k(hi, kTile, 0, kk), kk > 0);
      wg_commit();
      wg_wait<0>();
      reg_fence(s);
      reg_fence(blo);
      reg_fence(bhi);

      // The skew in two passes of 64 columns (the other half adds nothing).
      skew_half<L::kPitch>(s, blo, skew, warp, g, t4, 0);
      skew_half<L::kPitch>(s, bhi, skew, warp, g, t4, 64);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = j0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        s[i] = __fmaf_rn(s[i], P.scale_log2, key_shift(j, length, T));
      }
    } else {
      float band[64];
      reg_fence(s);
      reg_fence(band);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < L::kSteps; ++kk)
        wgmma_rs<0>(s, qu[kk], desc_k(st, kTile, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < L::kSteps; ++kk)
        wgmma_rs_n128<0>(band, qv[kk],
                         desc_k(st + 2 * L::kKVBytes, kBand, kTile * (1 - wg), kk), kk > 0);
      wg_commit();
      wg_wait<0>();
      reg_fence(s);
      reg_fence(band);

      // The skew: band row a (this warp's), column 63 - a + c for key c.
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
        const int c = 8 * (i >> 2) + 2 * t4;
        *reinterpret_cast<float2*>(skew + r * L::kPitch + c) = make_float2(band[i], band[i + 1]);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int a = 16 * warp + g + 8 * ((i >> 1) & 1);
        const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
        s[i] = __fmaf_rn(s[i] + skew[a * L::kPitch + 63 - a + c], P.scale_log2,
                         key_shift(j0 + c, length, T));
      }
    }

    // Online softmax over the tile, base 2.
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);  // finite: key j0 < T
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float e = exp2f(s[i] - m_run[r]);
      l_run[r] += e;
      s[i] = e;
      o[i] *= alpha[r];
      if constexpr (D == 128) o[i + 32] *= alpha[r];  // columns 64-127: the same rows
    }
    uint32_t a[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[kc][e] = pack_bf16(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1]);
    reg_fence(o);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      if constexpr (D == 64)
        wgmma_rs<1>(o, a[kc], desc_mn(st + L::kKVBytes, kTile, 0, kc), 1);
      else
        wgmma_rs_n128<1>(o, a[kc], desc_mn(st + L::kKVBytes, kTile, 0, kc), 1);
    }
    wg_commit();
    wg_wait<0>();
    reg_fence(o);
    mbar_arrive(&empty[ring.stage]);
    ring.next<kStages>();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int i = q0 + kTile * wg + 16 * warp + g + 8 * r;
    if (i >= T) continue;
    const float inv = 1.0f / l;
    bf16* orow = P.out + ((static_cast<size_t>(b) * T + i) * P.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

// A 4-D map of a bf16 (outer, rows, heads, D) tensor, read as boxes of
// box_rows rows of 64 columns of one head and one outer index (128-byte
// swizzle).
bool encode_rows(CUtensorMap* map, const void* base, long long D, long long heads,
                 long long rows, long long outer, int box_rows) {
  hopper_host::EncodeTiled fn = hopper_host::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D * 2),
                                 static_cast<cuuint64_t>(heads * D * 2),
                                 static_cast<cuuint64_t>(rows * heads * D * 2)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* p, const void* pos_bias_u,
           const void* pos_bias_v, const void* lengths, void* out, int B, int T, int H,
           cudaStream_t stream) {
  typedef Plan<D> L;
  CUtensorMap maps[4];
  if (!encode_rows(&maps[0], q, D, H, T, B, kRows) ||
      !encode_rows(&maps[1], k, D, H, T, B, kTile) ||
      !encode_rows(&maps[2], v, D, H, T, B, kTile) ||
      !encode_rows(&maps[3], p, D, H, 2LL * T - 1, 1, L::kRing ? kTile : kBand))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P;
  P.u = static_cast<const float*>(pos_bias_u);
  P.v = static_cast<const float*>(pos_bias_v);
  P.lengths = static_cast<const int*>(lengths);
  P.out = static_cast<bf16*>(out);
  P.T = T;
  P.H = H;
  P.scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  cudaError_t err = cudaFuncSetAttribute(flash_relpos_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kRows - 1) / kRows, 1, B * H);
  flash_relpos_fwd_kernel<D><<<grid, kThreads, L::kSmemBytes, stream>>>(maps[0], maps[1], maps[2],
                                                                         maps[3], P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted. q, k, v, out (B,
// T, H, D) and p (2T-1, H, D) bf16, contiguous and 16-byte aligned; u, v
// (H, D) fp32; lengths (B,) int32; D = 64 or 128. The grid is
// (ceil(T / 128), 1, B * H).
extern "C" int flash_attention_relpos_fwd(const void* q, const void* k, const void* v,
                                          const void* p, const void* pos_bias_u,
                                          const void* pos_bias_v, const void* lengths,
                                          void* out, int B, int T, int H, int D,
                                          void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, p, pos_bias_u, pos_bias_v, lengths, out, B, T, H, s);
  if (D == 128) return launch<128>(q, k, v, p, pos_bias_u, pos_bias_v, lengths, out, B, T, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
