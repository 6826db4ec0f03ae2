// The bias epilogue of the port's model: a product as cuBLAS or cuDNN left
// it, its fp32 bias added, the sum rounded to the compute dtype, and the
// elementwise tail that follows at the call site, in one pass over device
// memory.
//
// Replaces: no TPU kernel. The JAX package leaves the bias add and the
// activations after it to XLA, which fuses them into the product's epilogue.
// PyTorch runs each of them as its own kernel: an upcast, a broadcast fp32
// add and a downcast for the bias alone (``models/attention.py`` before this
// kernel), then one to eight kernels more for the tail, each re-reading the
// bf16 result. Those moved 20 bytes or more for each element of a bf16
// product; this kernel reads 2 and writes 2.
//
// Function (``ops/bias_act.py`` states it as plain PyTorch, the chain this
// replaces, and the card tests hold the two bit for bit). For an element x
// of channel c, with every fp32 step rounded as PyTorch's separate kernels
// round it (``__fadd_rn``/``__fmul_rn``/``__fdiv_rn`` are never contracted
// into an FMA) and cd() the rounding to the compute dtype (bf16: PyTorch's
// rounding to nearest even; fp32: none):
//
//   v = cd(float(x) + bias[c])
//   none      y = v
//   relu      y = max(v, 0), NaN kept (``clamp_min``)
//   silu      y = cd(v / (1 + expf(-v)))                   (PyTorch's silu)
//   glu_mask  (M, 2C) -> (M, C): a = v of column c, g = v of column C + c,
//             y = cd(a * cd(1 / (1 + expf(-g)))), 0 where mask[row] is false
//   bn_silu   (B, C, T) through its strides -> (B, T, C) through its strides:
//             u = cd(((v - mean[c]) * rstd[c]) * weight[c] + shift[c]),
//             y = cd(u / (1 + expf(-u)))   (BatchNorm on running statistics,
//             rstd from the torch call the plain chain makes, then SiLU)
//
// Element types (``dtypes``): bf16 in and out (the served bf16 model), fp32
// in and out (fp32 compute), fp32 in and bf16 out (a row-parallel layer's
// fp32 sum in bf16 compute).
//
// What bounds it on the H100: bytes. Each element is read once and written
// once (4 bytes in bf16; the masked GLU rows are not read), against a few
// fp32 operations; at 3.35 TB/s the (32, 512, 1601, 40) subsample output of
// Conformer (L) takes 1.25 ms, and a block's ~236 M biased elements 0.28 ms.
//
// Design:
// - pointwise tails (none, relu, silu): one thread a vector of kVec = 8, 4, 2
//   or 1 elements (at most 16 bytes of either type, the widest the width and
//   the pointers' alignment allow), in place where the wrapper lets it, over
//   a dense tensor in its memory order (outer, C, inner). Rows (inner 1,
//   channel last in memory): the vector holds kVec channels, whose biases
//   come in as float4 loads (L1 serves them: a block's rows share the bias).
//   Planes (inner > 1, as the subsample's convolutions leave them): the
//   vector lies in one plane and takes one bias.
// - glu_mask: one thread a vector of kVec output channels, reading the two
//   halves' vectors of its row; a masked row is written as zeros unread.
// - bn_silu: the depthwise convolution's output is read through its strides
//   (cuDNN may leave it channel-major or channel-last, and the even kernel's
//   first frame is skipped by the view) in 64 x 64 (frame, channel) tiles,
//   with the channel or the frame along the warp, whichever has stride 1, and
//   written through a padded shared tile in the layout the plain chain gives
//   its (B, T, C) result: the input's order of dimensions, so that the next
//   product sees the same strides and runs the same cuBLAS path. Channel-last
//   writes go two channels a thread. The tile's 64 channels' five parameters
//   are staged in shared memory once.
// Every kernel's name starts with bias_act and names no product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
enum Tail { kNone = 0, kRelu = 1, kSilu = 2 };
// ``dtypes`` of the C entry points: (input, output) element types.
enum Dtypes { kBf16 = 0, kFp32 = 1, kFp32ToBf16 = 2 };
using bf16_t = uint16_t;  // a bf16 as its bit pattern

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ uint32_t float_to_bf16_bits(float f) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f)));
}

// f rounded to the compute dtype T (bf16: to nearest even; fp32: f).
template <typename T>
__device__ __forceinline__ float round_to(float f) {
  if constexpr (std::is_same_v<T, bf16_t>) return __bfloat162float(__float2bfloat16_rn(f));
  return f;
}

template <typename T>
__device__ __forceinline__ float to_float(T e) {
  if constexpr (std::is_same_v<T, bf16_t>) return bf16_bits_to_float(e);
  return e;
}

template <typename T>
__device__ __forceinline__ T from_float(float f) {
  if constexpr (std::is_same_v<T, bf16_t>) return static_cast<bf16_t>(float_to_bf16_bits(f));
  return f;
}

// PyTorch's silu and sigmoid, in their fp32 opmath.
__device__ __forceinline__ float silu(float x) { return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x))); }
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

template <int kTail>
__device__ __forceinline__ float apply_tail(float v) {
  if (kTail == kRelu) return isnan(v) ? v : fmaxf(v, 0.0f);
  if (kTail == kSilu) return silu(v);
  return v;
}

// kVec elements of T at p (aligned to kVec * sizeof(T) <= 16 bytes) as
// floats, and back.
template <typename T, int kVec>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[kVec]) {
  if constexpr (std::is_same_v<T, float>) {
    if constexpr (kVec == 4) {
      const float4 w = *reinterpret_cast<const float4*>(p);
      f[0] = w.x, f[1] = w.y, f[2] = w.z, f[3] = w.w;
    } else if constexpr (kVec == 2) {
      const float2 w = *reinterpret_cast<const float2*>(p);
      f[0] = w.x, f[1] = w.y;
    } else {
      f[0] = *p;
    }
  } else if constexpr (kVec == 8) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = bf16_bits_to_float(words[i] & 0xffffu);
      f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  } else if constexpr (kVec == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    f[0] = bf16_bits_to_float(w.x & 0xffffu);
    f[1] = __uint_as_float(w.x & 0xffff0000u);
    f[2] = bf16_bits_to_float(w.y & 0xffffu);
    f[3] = __uint_as_float(w.y & 0xffff0000u);
  } else if constexpr (kVec == 2) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    f[0] = bf16_bits_to_float(w & 0xffffu);
    f[1] = __uint_as_float(w & 0xffff0000u);
  } else {
    f[0] = bf16_bits_to_float(*p);
  }
}

template <typename T, int kVec>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[kVec]) {
  if constexpr (std::is_same_v<T, float>) {
    if constexpr (kVec == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    } else if constexpr (kVec == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
    } else {
      *p = f[0];
    }
  } else if constexpr (kVec == 1) {
    *p = static_cast<bf16_t>(float_to_bf16_bits(f[0]));
  } else {
    uint32_t words[kVec / 2];
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i)
      words[i] = float_to_bf16_bits(f[2 * i]) | (float_to_bf16_bits(f[2 * i + 1]) << 16);
    if constexpr (kVec == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2], words[3]);
    } else if constexpr (kVec == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(words[0], words[1]);
    } else {
      *reinterpret_cast<uint32_t*>(p) = words[0];
    }
  }
}

// bias[c0 .. c0 + kVec) (c0 a multiple of kVec, bias 16-byte aligned).
template <int kVec>
__device__ __forceinline__ void load_bias(const float* __restrict__ bias, uint32_t c0,
                                          float (&b)[kVec]) {
  if constexpr (kVec >= 4) {
#pragma unroll
    for (int i = 0; i < kVec; i += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(bias + c0 + i));
      b[i] = q.x;
      b[i + 1] = q.y;
      b[i + 2] = q.z;
      b[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) b[i] = __ldg(bias + c0 + i);
  }
}

// Rows (kPlanes false): n_vec vectors of a (M, C) tensor, C = c_vec * kVec.
// Planes (kPlanes true): n_vec vectors of an (N, C, S) tensor, S = c_vec * kVec
// (c_vec: vectors a plane), channel = plane % C.
template <typename Tin, typename Tout, int kTail, int kVec, bool kPlanes>
__global__ void __launch_bounds__(kThreads)
    bias_act_kernel(const Tin* x, Tout* y, const float* __restrict__ bias, uint32_t n_vec,
                    uint32_t c_vec, uint32_t C) {  // y may be x: no restrict
  const uint32_t v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n_vec) return;
  const size_t at = static_cast<size_t>(v) * kVec;
  float f[kVec];
  load_vec<Tin, kVec>(x + at, f);
  float b[kVec];
  if constexpr (kPlanes) {
    const float bc = __ldg(bias + (v / c_vec) % C);
#pragma unroll
    for (int i = 0; i < kVec; ++i) b[i] = bc;
  } else {
    load_bias<kVec>(bias, (v % c_vec) * kVec, b);
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) f[i] = apply_tail<kTail>(round_to<Tout>(__fadd_rn(f[i], b[i])));
  store_vec<Tout, kVec>(y + at, f);
}

// (M, 2C) -> (M, C); c_vec = C / kVec vectors an output row; mask (M,) or null.
template <typename Tin, typename Tout, int kVec>
__global__ void __launch_bounds__(kThreads)
    bias_act_glu_kernel(const Tin* __restrict__ x, Tout* __restrict__ y,
                        const float* __restrict__ bias, const uint8_t* __restrict__ mask,
                        uint32_t n_vec, uint32_t c_vec, uint32_t C) {
  const uint32_t v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n_vec) return;
  const uint32_t row = v / c_vec;
  const uint32_t c0 = (v - row * c_vec) * kVec;
  float out[kVec];
  if (mask != nullptr && !mask[row]) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) out[i] = 0.0f;
  } else {
    const Tin* in = x + static_cast<size_t>(row) * (2 * C) + c0;
    float a[kVec], g[kVec], ba[kVec], bg[kVec];
    load_vec<Tin, kVec>(in, a);
    load_vec<Tin, kVec>(in + C, g);
    load_bias<kVec>(bias, c0, ba);
    load_bias<kVec>(bias, C + c0, bg);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float av = round_to<Tout>(__fadd_rn(a[i], ba[i]));
      const float gv = round_to<Tout>(__fadd_rn(g[i], bg[i]));
      out[i] = __fmul_rn(av, round_to<Tout>(sigmoid(gv)));
    }
  }
  store_vec<Tout, kVec>(y + static_cast<size_t>(row) * C + c0, out);
}

constexpr int kTile = 64;  // frames and channels of a bn_silu tile

// Two adjacent channels' outputs at p, aligned to 2 * sizeof(T).
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b) {
  if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *reinterpret_cast<uint32_t*>(p) = float_to_bf16_bits(a) | (float_to_bf16_bits(b) << 16);
  }
}

// x (B, C, T) through strides (sB, sC, sT) -> y (B, T, C) through strides
// (oB, oT, oC), the layout the plain chain's TensorIterator gives it (the
// input's order of dimensions). kReadC / kWriteC: the warp runs along the
// channels when reading / writing (the stride that is 1), else along the
// frames; kPairs: channel-last writes of two channels a thread.
template <typename Tin, typename Tout, bool kReadC, bool kWriteC, bool kPairs>
__global__ void __launch_bounds__(kThreads)
    bias_act_bn_silu_kernel(const Tin* __restrict__ x, Tout* __restrict__ y,
                            const float* __restrict__ bias, const float* __restrict__ mean,
                            const float* __restrict__ rstd, const float* __restrict__ weight,
                            const float* __restrict__ shift, int C, int T, long long sB,
                            long long sC, long long sT, long long oB, long long oT, long long oC) {
  __shared__ float tile[kTile][kTile + 1];  // [frame][channel]
  __shared__ float param[5][kTile];
  const int t0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile, b = blockIdx.z;
  const int tid = threadIdx.x;
  if (tid < kTile && c0 + tid < C) {
    const int c = c0 + tid;
    param[0][tid] = bias[c];
    param[1][tid] = mean[c];
    param[2][tid] = rstd[c];
    param[3][tid] = weight[c];
    param[4][tid] = shift[c];
  }
  __syncthreads();
  const Tin* xb = x + static_cast<long long>(b) * sB;
#pragma unroll 4
  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int fast = i % kTile, slow = i / kTile;
    const int tt = kReadC ? slow : fast, cc = kReadC ? fast : slow;
    const int t = t0 + tt, c = c0 + cc;
    if (t < T && c < C) {
      const float xv = to_float<Tin>(xb[c * sC + t * sT]);
      const float v = round_to<Tout>(__fadd_rn(xv, param[0][cc]));
      const float hn = __fmul_rn(__fsub_rn(v, param[1][cc]), param[2][cc]);
      const float u = round_to<Tout>(__fadd_rn(__fmul_rn(hn, param[3][cc]), param[4][cc]));
      tile[tt][cc] = silu(u);
    }
  }
  __syncthreads();
  Tout* yb = y + static_cast<long long>(b) * oB;
  if constexpr (kPairs) {  // oC == 1, C, oT and oB even: two-element stores
    for (int i = tid; i < kTile * kTile / 2; i += kThreads) {
      const int tt = i / (kTile / 2), cc = 2 * (i % (kTile / 2));
      const int t = t0 + tt, c = c0 + cc;
      if (t < T && c < C) store_pair<Tout>(yb + t * oT + c, tile[tt][cc], tile[tt][cc + 1]);
    }
  } else {
    for (int i = tid; i < kTile * kTile; i += kThreads) {
      const int fast = i % kTile, slow = i / kTile;
      const int tt = kWriteC ? slow : fast, cc = kWriteC ? fast : slow;
      const int t = t0 + tt, c = c0 + cc;
      if (t < T && c < C) yb[t * oT + c * oC] = from_float<Tout>(tile[tt][cc]);
    }
  }
}

// The widest vector (8, 4, 2, 1 elements, at most 16 bytes of either type)
// that divides `width` and to whose size in each type x and y are aligned.
template <typename Tin, typename Tout>
int vector_width(long long width, const void* x, const void* y) {
  const auto a = reinterpret_cast<uintptr_t>(x), b = reinterpret_cast<uintptr_t>(y);
  constexpr int kMax = 16 / (sizeof(Tin) > sizeof(Tout) ? sizeof(Tin) : sizeof(Tout));
  for (int vec = kMax; vec > 1; vec /= 2)
    if (width % vec == 0 && a % (vec * sizeof(Tin)) == 0 && b % (vec * sizeof(Tout)) == 0)
      return vec;
  return 1;
}

unsigned grid_of(uint32_t n_vec) {
  return static_cast<unsigned>((static_cast<uint64_t>(n_vec) + kThreads - 1) / kThreads);
}

template <typename Tin, typename Tout, int kTail, bool kPlanes>
cudaError_t launch_pointwise(int vec, const Tin* x, Tout* y, const float* bias, uint32_t n_vec,
                             uint32_t c_vec, uint32_t C, cudaStream_t stream) {
  const unsigned grid = grid_of(n_vec);
#define POINTWISE(V)                                                                      \
  bias_act_kernel<Tin, Tout, kTail, V, kPlanes><<<grid, kThreads, 0, stream>>>(x, y, bias, \
                                                                               n_vec, c_vec, C)
  switch (vec) {
    case 8:
      if constexpr (sizeof(Tin) == 2 && sizeof(Tout) == 2) POINTWISE(8);
      break;
    case 4: POINTWISE(4); break;
    case 2: POINTWISE(2); break;
    default: POINTWISE(1);
  }
#undef POINTWISE
  return cudaGetLastError();
}

template <typename Tin, typename Tout, bool kPlanes>
cudaError_t launch_tail(int tail, int vec, const Tin* x, Tout* y, const float* bias,
                        uint32_t n_vec, uint32_t c_vec, uint32_t C, cudaStream_t stream) {
#define TAIL(K) launch_pointwise<Tin, Tout, K, kPlanes>(vec, x, y, bias, n_vec, c_vec, C, stream)
  switch (tail) {
    case kNone: return TAIL(kNone);
    case kRelu: return TAIL(kRelu);
    case kSilu: return TAIL(kSilu);
    default: return cudaErrorInvalidValue;
  }
#undef TAIL
}

template <typename Tin, typename Tout>
cudaError_t pointwise(const void* x, void* y, const float* bias, int tail, long long outer,
                      int C, long long inner, cudaStream_t stream) {
  const long long n = outer * C * inner;
  const bool planes = inner > 1;
  const int vec = vector_width<Tin, Tout>(planes ? inner : C, x, y);
  if (n / vec > 0xffffffffLL) return cudaErrorInvalidValue;
  const uint32_t n_vec = static_cast<uint32_t>(n / vec);
  const uint32_t c_vec = static_cast<uint32_t>((planes ? inner : C) / vec);
  const auto* xs = static_cast<const Tin*>(x);
  auto* ys = static_cast<Tout*>(y);
  return planes ? launch_tail<Tin, Tout, true>(tail, vec, xs, ys, bias, n_vec, c_vec, C, stream)
                : launch_tail<Tin, Tout, false>(tail, vec, xs, ys, bias, n_vec, c_vec, C, stream);
}

template <typename Tin, typename Tout>
cudaError_t glu(const void* x, void* y, const float* bias, const void* mask, long long M, int C,
                cudaStream_t stream) {
  const int vec = vector_width<Tin, Tout>(C, x, y);
  if (M * C / vec > 0xffffffffLL) return cudaErrorInvalidValue;
  const uint32_t n_vec = static_cast<uint32_t>(M * C / vec), c_vec = C / vec;
  const unsigned grid = grid_of(n_vec);
  const auto* xs = static_cast<const Tin*>(x);
  auto* ys = static_cast<Tout*>(y);
  const auto* m = static_cast<const uint8_t*>(mask);
#define GLU(V) \
  bias_act_glu_kernel<Tin, Tout, V><<<grid, kThreads, 0, stream>>>(xs, ys, bias, m, n_vec, c_vec, C)
  switch (vec) {
    case 8:
      if constexpr (sizeof(Tin) == 2 && sizeof(Tout) == 2) GLU(8);
      break;
    case 4: GLU(4); break;
    case 2: GLU(2); break;
    default: GLU(1);
  }
#undef GLU
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t bn_silu(const void* x, void* y, const float* bias, const float* mean,
                    const float* rstd, const float* weight, const float* shift, int B, int C,
                    int T, long long sB, long long sC, long long sT, long long oB, long long oT,
                    long long oC, cudaStream_t stream) {
  const dim3 grid((T + kTile - 1) / kTile, (C + kTile - 1) / kTile, B);
  const auto* xs = static_cast<const Tin*>(x);
  auto* ys = static_cast<Tout*>(y);
  const bool read_c = sC == 1, write_c = oC == 1;
  const bool pairs = write_c && C % 2 == 0 && oT % 2 == 0 && oB % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(y) % (2 * sizeof(Tout)) == 0;
#define BN_SILU(R, W, P)                                                                    \
  bias_act_bn_silu_kernel<Tin, Tout, R, W, P><<<grid, kThreads, 0, stream>>>(               \
      xs, ys, bias, mean, rstd, weight, shift, C, T, sB, sC, sT, oB, oT, oC)
  if (pairs)
    read_c ? BN_SILU(true, true, true) : BN_SILU(false, true, true);
  else if (write_c)
    read_c ? BN_SILU(true, true, false) : BN_SILU(false, true, false);
  else
    read_c ? BN_SILU(true, false, false) : BN_SILU(false, false, false);
#undef BN_SILU
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (outer, C, inner) dense in that order (y may be x when the types
// agree); bias: C fp32, 16-byte aligned. inner == 1: rows, channel last;
// else planes of inner elements. tail: 0 none, 1 relu, 2 silu; dtypes: 0 bf16
// in and out, 1 fp32 in and out, 2 fp32 in and bf16 out. Returns the launch's
// CUDA error (0: none).
int bias_act_pointwise(const void* x, void* y, const float* bias, int tail, int dtypes,
                       long long outer, int C, long long inner, void* stream) {
  if (outer * C * inner == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case kBf16: return pointwise<bf16_t, bf16_t>(x, y, bias, tail, outer, C, inner, s);
    case kFp32: return pointwise<float, float>(x, y, bias, tail, outer, C, inner, s);
    case kFp32ToBf16: return pointwise<float, bf16_t>(x, y, bias, tail, outer, C, inner, s);
    default: return cudaErrorInvalidValue;
  }
}

// x: (M, 2C) contiguous; y: (M, C); bias: 2C fp32, 16-byte aligned; mask: M
// bytes (0: the row is zeroed) or null; dtypes as bias_act_pointwise's.
int bias_act_glu(const void* x, void* y, const float* bias, const void* mask, int dtypes,
                 long long M, int C, void* stream) {
  if (M == 0 || C == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case kBf16: return glu<bf16_t, bf16_t>(x, y, bias, mask, M, C, s);
    case kFp32: return glu<float, float>(x, y, bias, mask, M, C, s);
    case kFp32ToBf16: return glu<float, bf16_t>(x, y, bias, mask, M, C, s);
    default: return cudaErrorInvalidValue;
  }
}

// x: (B, C, T) at element strides (sB, sC, sT); y: (B, T, C) at (oB, oT,
// oC); bias, mean, rstd, weight, shift: C fp32 each; dtypes as
// bias_act_pointwise's.
int bias_act_bn_silu(const void* x, void* y, const float* bias, const float* mean,
                     const float* rstd, const float* weight, const float* shift, int dtypes,
                     int B, int C, int T, long long sB, long long sC, long long sT, long long oB,
                     long long oT, long long oC, void* stream) {
  if (B == 0 || C == 0 || T == 0) return 0;
  if (B > 65535) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
#define ARGS x, y, bias, mean, rstd, weight, shift, B, C, T, sB, sC, sT, oB, oT, oC, s
  switch (dtypes) {
    case kBf16: return bn_silu<bf16_t, bf16_t>(ARGS);
    case kFp32: return bn_silu<float, float>(ARGS);
    case kFp32ToBf16: return bn_silu<float, bf16_t>(ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef ARGS
}

}  // extern "C"
