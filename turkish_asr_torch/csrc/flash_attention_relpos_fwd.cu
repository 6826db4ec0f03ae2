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
// fp32, lengths (B,) int32. D = 64. Keys past T and query rows past T read
// as zero (TMA fills a box past the tensor with zeros); keys past T get
// weight 0 and rows past T are not written.
//
// Design (the flash forward's, csrc/flash_attention_fwd.cu, one pass):
//   - A block is two consumer warpgroups of 64 query rows and one producer
//     warpgroup, whose thread 0 loads the block's Q tile once and streams
//     64-key K and V tiles and the band of p they need through a two-stage
//     ring of full/empty mbarriers (4-D tensor maps over (D, H, T, B), so a
//     box is one head's rows). setmaxnreg hands the producer's registers to
//     the consumers.
//   - The biases are added to q once: each consumer warpgroup reads its
//     rows of Q from shared memory into the register A-operand layout as
//     q + u and q + v (bf16), so both score products are register wgmmas.
//   - Content: S = (Q + u) K^T, wgmma m64n64k16.
//   - Position: the 64 rows of a warpgroup against 64 keys span 127
//     relative distances, so one m64n128k16 wgmma of (Q + v) over 128 rows
//     of p gives every term they need: band[a][n] = (q_a + v) . p[k0 + n]
//     with k0 = T-64-i0+j0 and n = 63-a+c for query a and key c of the
//     tiles. The block's two warpgroups share one 192-row box of p (rows
//     64-191 for the first, 0-127 for the second). The skew is a pass
//     through shared memory: each warp writes its 16 band rows and reads
//     back, for each score it holds, column 63-a+c of its row (a warp's
//     rows are its own, so a __syncwarp orders it).
//   - Online softmax in fp32 (base 2, the running max and sum rescaled when
//     the max moves), P rounded to bf16 in registers as the A operand of
//     O += P V (V MN-major from shared memory).
//   - Keys at or past a row's length weigh nothing once any key is valid,
//     so key tiles past the length are skipped; a row of length 0 attends
//     over all T keys, as the plain version does.
// No tensor of B x H x T x T or T x (2T-1) scores exists anywhere: the
// band lives in registers and a 64 x 132 float buffer a warpgroup.
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

constexpr int kD = 64;          // head size: one 128-byte atom a row
constexpr int kTile = 64;       // query rows of a consumer warpgroup; keys of a tile
constexpr int kGroups = 2;      // consumer warpgroups
constexpr int kRows = kTile * kGroups;
constexpr int kBand = kRows + kTile;  // rows of p a block's key tile needs
constexpr int kStages = 2;
constexpr int kThreads = 128 * (kGroups + 1);
constexpr int kPitch = 132;     // floats between the skew buffer's rows
constexpr float kMaskShift = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kQBytes = kRows * kD * 2;
constexpr int kKVBytes = kTile * kD * 2;
constexpr int kPBytes = kBand * kD * 2;
constexpr int kStageBytes = 2 * kKVBytes + kPBytes;
constexpr int kOffQ = 0;
constexpr int kOffStages = kOffQ + kQBytes;                        // [stage]{K, V, P}
constexpr int kOffSkew = kOffStages + kStages * kStageBytes;       // [group][64][kPitch]
constexpr int kOffBars = kOffSkew + kGroups * kTile * kPitch * 4;  // full, empty, q
constexpr int kSmemBytes = kOffBars + (2 * kStages + 1) * 8 + 1024;  // + the alignment

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

// d (+)= A B, m64n128k16, A from registers (the m16n8k16 A layout of each
// warp's rows), B K-major from shared memory; accumulator layout as
// hopper.cuh's m64n128 one.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : HOPPER_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<uint32_t*>(&h);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_relpos_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tp, Params P) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sQ = smem + kOffQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBars);
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
    mbar_arrive_tx(q_bar, kQBytes);
    tma_load_4d(sQ, &tq, q_bar, 0, h, q0, b);
    Ring ring;
    for (int step = 0; step < tiles; ++step) {
      mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
      const int j0 = step * kTile;
      unsigned char* st = smem + kOffStages + ring.stage * kStageBytes;
      mbar_arrive_tx(&full[ring.stage], kStageBytes);
      tma_load_4d(st, &tk, &full[ring.stage], 0, h, j0, b);
      tma_load_4d(st + kKVBytes, &tv, &full[ring.stage], 0, h, j0, b);
      // p rows T-128-q0+j0 ... +191: the second warpgroup's band, then the first's
      tma_load_4d(st + 2 * kKVBytes, &tp, &full[ring.stage], 0, h, T - kRows - q0 + j0, 0);
      ring.next<kStages>();
    }
    return;
  }

  regs_inc<232>();
  const int wg = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  float* skew = reinterpret_cast<float*>(smem + kOffSkew) + wg * kTile * kPitch;

  // q + u and q + v of the warpgroup's rows as register A operands.
  mbar_wait(q_bar, 0);
  uint32_t qu[4][4], qv[4][4];
  {
    const float* u = P.u + h * kD;
    const float* v = P.v + h * kD;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = kTile * wg + 16 * warp + g + 8 * (e & 1);
        const int c = 16 * kc + 8 * (e >> 1) + 2 * t4;
        const __nv_bfloat162 x =
            *reinterpret_cast<const __nv_bfloat162*>(sQ + element_at(kRows, r, c));
        const float x0 = __low2float(x), x1 = __high2float(x);
        qu[kc][e] = pack_bf16(x0 + u[c], x1 + u[c + 1]);
        qv[kc][e] = pack_bf16(x0 + v[c], x1 + v[c + 1]);
      }
  }

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float s[32], band[64];

  Ring ring;
  for (int step = 0; step < tiles; ++step) {
    const int j0 = step * kTile;
    mbar_wait(&full[ring.stage], ring.phase);
    const unsigned char* st = smem + kOffStages + ring.stage * kStageBytes;

    reg_fence(s);
    reg_fence(band);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<0>(s, qu[kk], desc_k(st, kTile, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n128(band, qv[kk], desc_k(st + 2 * kKVBytes, kBand, kTile * (1 - wg), kk),
                    kk > 0);
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
      *reinterpret_cast<float2*>(skew + r * kPitch + c) = make_float2(band[i], band[i + 1]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int a = 16 * warp + g + 8 * ((i >> 1) & 1);
      const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
      const int j = j0 + c;
      const float shift = j < length ? 0.f : (j < T ? kMaskShift * kLog2e : -INFINITY);
      s[i] = __fmaf_rn(s[i] + skew[a * kPitch + 63 - a + c], P.scale_log2, shift);
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
    }
    uint32_t a[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[kc][e] = pack_bf16(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1]);
    reg_fence(o);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs<1>(o, a[kc], desc_mn(st + kKVBytes, kTile, 0, kc), 1);
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
    bf16* orow = P.out + ((static_cast<size_t>(b) * T + i) * P.H + h) * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

// A 4-D map of a bf16 (outer, rows, heads, 64) tensor, read as boxes of
// box_rows rows of one head and one outer index (128-byte swizzle).
bool encode_rows(CUtensorMap* map, const void* base, long long heads, long long rows,
                 long long outer, int box_rows) {
  hopper_host::EncodeTiled fn = hopper_host::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(kD * 2),
                                 static_cast<cuuint64_t>(heads * kD * 2),
                                 static_cast<cuuint64_t>(rows * heads * kD * 2)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kD), 1, static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted. q, k, v, out (B,
// T, H, 64) and p (2T-1, H, 64) bf16, contiguous and 16-byte aligned; u, v
// (H, 64) fp32; lengths (B,) int32. The grid is (ceil(T / 128), 1, B * H).
extern "C" int flash_attention_relpos_fwd(const void* q, const void* k, const void* v,
                                          const void* p, const void* pos_bias_u,
                                          const void* pos_bias_v, const void* lengths,
                                          void* out, int B, int T, int H, int D,
                                          void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || D != kD || static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  if (!encode_rows(&maps[0], q, H, T, B, kRows) || !encode_rows(&maps[1], k, H, T, B, kTile) ||
      !encode_rows(&maps[2], v, H, T, B, kTile) ||
      !encode_rows(&maps[3], p, H, 2LL * T - 1, 1, kBand))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P;
  P.u = static_cast<const float*>(pos_bias_u);
  P.v = static_cast<const float*>(pos_bias_v);
  P.lengths = static_cast<const int*>(lengths);
  P.out = static_cast<bf16*>(out);
  P.T = T;
  P.H = H;
  P.scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  cudaError_t err = cudaFuncSetAttribute(flash_relpos_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kRows - 1) / kRows, 1, B * H);
  flash_relpos_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], P);
  return static_cast<int>(cudaGetLastError());
}
