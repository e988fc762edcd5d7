// Tiled tensor-core GEMM for Hopper (sm_90a): int8 x int8 -> int32 and
// bf16 x bf16 -> f32, and the int8 convolution of the quantized ResNet as an
// implicit GEMM on the same main loop, with the quantization epilogue fused.
//
// Replaces the TPU kernel `pallas_mm` of scripts/int8_conv_probe.py
// (sec_mm_pallas, body mm_kernel): a (M, K) @ (K, N) product on a grid of
// (M/bm, N/bn, K/bk) steps whose accumulator lives in VMEM scratch, zeroed at
// the first K step and stored at the last. Here a block owns one output tile
// and walks K itself, so the accumulator stays in registers (wmma
// accumulator fragments) and is written once.
//
// Two launch functions share the main loop:
//   mm_tiled_launch   row-major A (M, K) times row-major B (K, N). int8 gives
//                     int32 and bf16 gives f32 (out_mode 0, the probe's
//                     function). int8 also takes the conv epilogue below: a
//                     1x1 stride-1 conv over NHWC input is exactly this
//                     product with A = x viewed as (B*H*W, Cin). For such a
//                     conv A may also be the wide (bf16 or f32) activation
//                     itself, quantized as it is loaded with the conv's
//                     input scale: clip(rint(x / s), -127, 127), the same
//                     arithmetic as a separate quantizing pass, without
//                     that pass's trip through device memory.
//   conv_int8_launch  the A tile is gathered by im2col addressing from NHWC
//                     int8 input x (B, H, W, Cin): kernel k x k, stride,
//                     dilation rate, symmetric zero pad. Zero fill is exact
//                     because the quantization is symmetric (zero point 0).
//                     B is the HWIO weight as a (K = k*k*Cin, N = Cout)
//                     int8 matrix.
// Epilogue (models/quant.py of the JAX package, conv_fn):
//   y = float(acc) * oscale[n] + bias[n], optional ReLU, then
//   out_mode 1: f32, 2: bf16 (round to nearest even),
//   3: int8 clip(rint(y / s_next), -127, 127) (round half to even).
// The multiply-add is one fused, once-rounded operation (__fmaf_rn): XLA's
// CPU backend contracts the JAX package's `acc * oscale + bias` the same
// way (it equals the fused result on every one of 10^6 random inputs, and
// the twice-rounded result on 75% of them), and the plain PyTorch version
// computes it exactly in float64 and rounds once.
//
// Bound. At the probe's 4096^3 the work is 137 G operations: 0.069 ms at
// 1979 TOPS int8 and 0.139 ms at 989 TFLOP/s bf16 (dense peaks), far above
// the bytes (48-96 MB). The ResNet convs at batch 128 are operation-bound
// too, except the stem (Cin = 3).
//
// Design (simple and right first; wgmma, TMA and a deeper pipeline are later
// work). 128 x 128 output tile per block of 8 warps (2 x 4), each warp
// 64 x 32 = 4 x 2 wmma 16x16x16 fragments. K advances 64 bytes per tile (64
// int8 or 32 bf16), double-buffered in shared memory: the next tile's global
// loads (16 bytes per thread and operand, twice) are issued before this
// tile's mma and stored after it. Shared tiles are kept as 16-wide K slices
// (A) and 16-wide N slices (B) so that every fragment starts 32-byte aligned
// with a leading dimension of 16; slices are padded to spread the stores over
// the banks. Loads fall back to scalar, masked reads where a row is not 16
// bytes long or aligned (the stem's Cin = 3, K = 147; odd test shapes).
// Blocks are numbered N-tile fastest, so blocks that share an A tile run
// together and read it from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kThreads = 256;
constexpr int kTileKBytes = 64;
constexpr int kChunkBytes = 16;

enum OutMode { kRaw = 0, kF32 = 1, kBF16 = 2, kI8 = 3 };
enum Flags { kVecA = 1, kVecB = 2, kVecOut = 4 };

template <typename T>
struct Types;
template <>
struct Types<int8_t> {
  using Acc = int;
  using Bits = uint8_t;
};
template <>
struct Types<__nv_bfloat16> {
  using Acc = float;
  using Bits = uint16_t;
};

// Tile geometry for element type T (sizes in elements unless named bytes).
template <typename T>
struct Geo {
  static constexpr int E = sizeof(T);
  static constexpr int BK = kTileKBytes / E;     // K per tile
  static constexpr int CH = kChunkBytes / E;     // elements per 16-byte load
  static constexpr int ASlices = BK / 16;
  static constexpr int ASlice = kBM * 16 + 32;   // 16-wide K slice of A
  static constexpr int BSlice = BK * 16 + 32 / E;  // 16-wide N slice of B
  static constexpr int AElems = ASlices * ASlice;
  static constexpr int StageElems = AElems + (kBN / 16) * BSlice;
  static constexpr int BChunksPerRow = kBN / CH;
};

constexpr int kStageBytes = 16768;  // Geo<T>::StageElems * E for both types
static_assert(Geo<int8_t>::StageElems * 1 == kStageBytes, "stage size");
static_assert(Geo<__nv_bfloat16>::StageElems * 2 == kStageBytes, "stage size");

// Pack up to CH elements, read one by one, into a 16-byte word.
template <typename T>
struct Packer {
  using Bits = typename Types<T>::Bits;
  static constexpr int PerWord = 4 / sizeof(T);
  uint32_t w[4] = {0, 0, 0, 0};
  __device__ __forceinline__ void put(int e, Bits v) {
    w[e / PerWord] |= uint32_t(v) << (8 * sizeof(T) * (e % PerWord));
  }
  __device__ __forceinline__ uint4 get() const {
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// An int8 quantization scale s with its float reciprocal inv = fl(1 / s).
struct Scale {
  float s, inv;
};

// clip(rint(y / s), -127, 127) as an int8 bit pattern, bit-exact with the
// IEEE quotient. t = y * inv is within 1.2e-7 |y / s| of the exact quotient
// (two roundings), and fl(y / s) within 6e-8 of it; so where t lies more
// than 2.5e-7 |t| from the nearest half-integer, rint(t) is rint(fl(y / s))
// and the multiply suffices. Only the rare t near a half-integer pays for
// the correctly rounded division.
__device__ __forceinline__ uint32_t quant8(float y, Scale q) {
  const float t = y * q.inv;
  float r = rintf(t);
  if (0.5f - fabsf(t - r) <= 2.5e-7f * fabsf(t)) r = rintf(__fdiv_rn(y, q.s));
  r = fminf(fmaxf(r, -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)__float2int_rn(r);
}

// A operand: a dense row-major (M, K) matrix.
template <typename T>
struct DenseA {
  using Elem = T;
  const T* a;
  int M, K;
  struct Row {
    const T* p;
    bool ok;
  };
  __device__ Row row(long long m) const {
    return {a + (m < M ? m : 0) * (long long)K, m < M};
  }
  __device__ uint4 load(const Row& r, int k, bool vec) const {
    constexpr int CH = Geo<T>::CH;
    if (vec) {
      if (r.ok && k < K) return *reinterpret_cast<const uint4*>(r.p + k);
      return make_uint4(0, 0, 0, 0);
    }
    Packer<T> pk;
    const auto* bits = reinterpret_cast<const typename Types<T>::Bits*>(r.p);
#pragma unroll
    for (int e = 0; e < CH; ++e)
      if (r.ok && k + e < K) pk.put(e, bits[k + e]);
    return pk.get();
  }
};

__device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Unpack 16 consecutive wide values from a 16-byte aligned address.
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[h];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[8 * h + 2 * i] = __uint_as_float(w[i] << 16);
      v[8 * h + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}
__device__ __forceinline__ void load16(const float* p, float* v) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

// A operand: a dense row-major (M, K) bf16 or f32 matrix, quantized to
// int8 with scale s as it is loaded (zero fill stays zero).
template <typename F>
struct QuantA {
  using Elem = int8_t;
  const F* a;
  int M, K;
  Scale q;
  struct Row {
    const F* p;
    bool ok;
  };
  __device__ Row row(long long m) const {
    return {a + (m < M ? m : 0) * (long long)K, m < M};
  }
  __device__ uint4 load(const Row& r, int k, bool vec) const {
    float v[16];
    if (vec) {  // K % 16 == 0: the 16 values are all in or all out
      if (!(r.ok && k < K)) return make_uint4(0, 0, 0, 0);
      load16(r.p + k, v);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        v[e] = (r.ok && k + e < K) ? to_float(r.p[k + e]) : 0.f;
    }
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int e = 0; e < 16; ++e) w[e / 4] |= quant8(v[e], q) << (8 * (e % 4));
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// A operand: the im2col view of NHWC int8 input; column k of row m is
// x[b, oh*stride - pad + dy*rate, ow*stride - pad + dx*rate, c] with
// k = (dy*ks + dx)*Cin + c (the HWIO weight flattened to (K, N)).
struct ConvA {
  using Elem = int8_t;
  const int8_t* x;
  int M, K, H, W, Cin, OH, OW, ks, stride, rate, pad;
  struct Row {
    const int8_t* img;
    int ih0, iw0;
    bool ok;
  };
  __device__ Row row(long long m) const {
    if (m >= M) return {x, 0, 0, false};
    const int ohw = OH * OW;
    const int b = (int)(m / ohw);
    const int rem = (int)(m - (long long)b * ohw);
    const int oh = rem / OW;
    const int ow = rem - oh * OW;
    return {x + (long long)b * H * W * Cin, oh * stride - pad, ow * stride - pad,
            true};
  }
  __device__ uint4 load(const Row& r, int k, bool vec) const {
    int tap = k / Cin;
    int c = k - tap * Cin;
    int dy = tap / ks;
    int dx = tap - dy * ks;
    if (vec) {  // Cin % 16 == 0: the 16 bytes lie in one tap, contiguous
      const int ih = r.ih0 + dy * rate, iw = r.iw0 + dx * rate;
      if (r.ok && k < K && ih >= 0 && ih < H && iw >= 0 && iw < W)
        return *reinterpret_cast<const uint4*>(
            r.img + ((long long)ih * W + iw) * Cin + c);
      return make_uint4(0, 0, 0, 0);
    }
    Packer<int8_t> pk;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int ih = r.ih0 + dy * rate, iw = r.iw0 + dx * rate;
      if (r.ok && k + e < K && ih >= 0 && ih < H && iw >= 0 && iw < W)
        pk.put(e, (uint8_t)r.img[((long long)ih * W + iw) * Cin + c]);
      if (++c == Cin) {
        c = 0;
        if (++dx == ks) {
          dx = 0;
          ++dy;
        }
      }
    }
    return pk.get();
  }
};

template <typename T>
__device__ __forceinline__ uint4 load_b(const T* b, int K, int N, int k, int n,
                                        bool vec) {
  constexpr int CH = Geo<T>::CH;
  if (vec) {
    if (k < K && n < N)
      return *reinterpret_cast<const uint4*>(b + (long long)k * N + n);
    return make_uint4(0, 0, 0, 0);
  }
  Packer<T> pk;
  const auto* bits = reinterpret_cast<const typename Types<T>::Bits*>(b);
#pragma unroll
  for (int e = 0; e < CH; ++e)
    if (k < K && n + e < N) pk.put(e, bits[(long long)k * N + n + e]);
  return pk.get();
}

struct Epilogue {
  const float* oscale;
  const float* bias;
  Scale next;
  int relu;
};

__device__ __forceinline__ uint32_t bits(int v) { return (uint32_t)v; }
__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// y = acc * oscale + bias (one rounding), then ReLU, for 8 columns.
template <typename Acc>
__device__ __forceinline__ void affine8(int n, int count, const Acc (&v)[8],
                                        const Epilogue& ep, float (&y)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    y[e] = 0.f;
    if (e < count) {
      y[e] = __fmaf_rn(to_float(v[e]), ep.oscale[n + e], ep.bias[n + e]);
      if (ep.relu) y[e] = fmaxf(y[e], 0.f);
    }
  }
}

// Store 8 consecutive outputs of row m from column n (fewer at the ragged
// edge N); `vec` allows one or two 16-byte (8-byte for int8) stores.
template <int OUT, typename Acc>
__device__ __forceinline__ void store8(void* out, long long m, int n, int N,
                                       const Acc (&v)[8], const Epilogue& ep,
                                       bool vec) {
  const long long base = m * N + n;
  const int count = min(8, N - n);
  const bool full = vec && count == 8;
  float y[8];
  if constexpr (OUT == kRaw) {
    Acc* o = static_cast<Acc*>(out) + base;
    if (full) {
      reinterpret_cast<uint4*>(o)[0] =
          make_uint4(bits(v[0]), bits(v[1]), bits(v[2]), bits(v[3]));
      reinterpret_cast<uint4*>(o)[1] =
          make_uint4(bits(v[4]), bits(v[5]), bits(v[6]), bits(v[7]));
    } else {
      for (int e = 0; e < count; ++e) o[e] = v[e];
    }
  } else if constexpr (OUT == kF32) {
    affine8(n, count, v, ep, y);
    float* o = static_cast<float*>(out) + base;
    if (full) {
      reinterpret_cast<float4*>(o)[0] = make_float4(y[0], y[1], y[2], y[3]);
      reinterpret_cast<float4*>(o)[1] = make_float4(y[4], y[5], y[6], y[7]);
    } else {
      for (int e = 0; e < count; ++e) o[e] = y[e];
    }
  } else if constexpr (OUT == kBF16) {
    affine8(n, count, v, ep, y);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + base;
    if (full) {
      *reinterpret_cast<uint4*>(o) =
          make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]),
                     pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
    } else {
      for (int e = 0; e < count; ++e) o[e] = __float2bfloat16_rn(y[e]);
    }
  } else {  // kI8
    affine8(n, count, v, ep, y);
    int8_t* o = static_cast<int8_t*>(out) + base;
    if (full) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lo |= quant8(y[e], ep.next) << (8 * e);
        hi |= quant8(y[e + 4], ep.next) << (8 * e);
      }
      *reinterpret_cast<uint2*>(o) = make_uint2(lo, hi);
    } else {
      for (int e = 0; e < count; ++e)
        o[e] = (int8_t)(uint8_t)quant8(y[e], ep.next);
    }
  }
}

template <typename L, int OUT>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_kernel(L aload, const typename L::Elem* __restrict__ bmat, void* out,
                int M, int N, int K, Epilogue ep, int flags) {
  using T = typename L::Elem;
  using G = Geo<T>;
  using Acc = typename Types<T>::Acc;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16,
                               typename std::conditional<
                                   sizeof(T) == 1, signed char, T>::type,
                               wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16,
                               typename std::conditional<
                                   sizeof(T) == 1, signed char, T>::type,
                               wmma::row_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, Acc>;
  using WT = typename std::conditional<sizeof(T) == 1, signed char, T>::type;

  __shared__ __align__(128) unsigned char smem[2 * kStageBytes];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int n_tiles = (N + kBN - 1) / kBN;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const bool vec_a = flags & kVecA, vec_b = flags & kVecB;

  // this thread's two A chunks (rows tid/4 and tid/4 + 64, 16 bytes at
  // byte offset 16 * (tid % 4) of the tile's K range) and two B chunks
  const int a_col = (tid % 4) * G::CH;
  typename L::Row arow[2];
  int a_off[2], b_k[2], b_n[2], b_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = tid / 4 + i * 64;
    arow[i] = aload.row(m0 + r);
    a_off[i] = (a_col / 16) * G::ASlice + r * 16 + a_col % 16;
    const int c = tid + i * kThreads;
    b_k[i] = c / G::BChunksPerRow;
    const int bn = (c % G::BChunksPerRow) * G::CH;
    b_n[i] = bn;
    b_off[i] = (bn / 16) * G::BSlice + b_k[i] * 16 + bn % 16;
  }

  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], Acc(0));

  uint4 ra[2], rb[2];
  auto fetch = [&](int kt) {
    const int k0 = kt * G::BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ra[i] = aload.load(arow[i], k0 + a_col, vec_a);
      rb[i] = load_b<T>(bmat, K, N, k0 + b_k[i], n0 + b_n[i], vec_b);
    }
  };
  auto stash = [&](int stage) {
    T* s = reinterpret_cast<T*>(smem + stage * kStageBytes);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<uint4*>(s + a_off[i]) = ra[i];
      *reinterpret_cast<uint4*>(s + G::AElems + b_off[i]) = rb[i];
    }
  };

  const int k_tiles = (K + G::BK - 1) / G::BK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const bool more = kt + 1 < k_tiles;
    if (more) fetch(kt + 1);
    const WT* as = reinterpret_cast<const WT*>(smem + (kt & 1) * kStageBytes);
    const WT* bs = as + G::AElems;
#pragma unroll
    for (int s = 0; s < G::ASlices; ++s) {
      FragA a[4];
      FragB b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], as + s * G::ASlice + (wm * 64 + i * 16) * 16,
                               16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], bs + (wn * 2 + j) * G::BSlice + s * 256,
                               16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    if (more) stash((kt + 1) & 1);
    __syncthreads();
  }

  // epilogue: each warp passes its fragments one by one through a 16x16
  // scratch in shared memory; lane l handles row l/2, 8 columns
  Acc* scratch = reinterpret_cast<Acc*>(smem) + warp * 256;
  const int row = lane / 2, col = (lane % 2) * 8;
  const bool vec_out = flags & kVecOut;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long m = m0 + wm * 64 + i * 16 + row;
      const int n = n0 + wn * 32 + j * 16 + col;
      if (m < M && n < N) {
        Acc v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = scratch[row * 16 + col + e];
        store8<OUT>(out, m, n, N, v, ep, vec_out);
      }
      __syncwarp();
    }
  }
}

Scale host_scale(float s) { return {s, s != 0.f ? 1.f / s : 0.f}; }

bool host_aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename L>
int launch(const L& aload, const typename L::Elem* b, void* out, int M, int N,
           int K, int out_mode, Epilogue ep, int flags, cudaStream_t stream) {
  const long long blocks = (long long)((M + kBM - 1) / kBM) *
                           ((N + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  switch (out_mode) {
    case kRaw:
      gemm_kernel<L, kRaw><<<grid, kThreads, 0, stream>>>(aload, b, out, M, N,
                                                          K, ep, flags);
      break;
    case kF32:
      gemm_kernel<L, kF32><<<grid, kThreads, 0, stream>>>(aload, b, out, M, N,
                                                          K, ep, flags);
      break;
    case kBF16:
      gemm_kernel<L, kBF16><<<grid, kThreads, 0, stream>>>(aload, b, out, M,
                                                           N, K, ep, flags);
      break;
    case kI8:
      gemm_kernel<L, kI8><<<grid, kThreads, 0, stream>>>(aload, b, out, M, N,
                                                         K, ep, flags);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int out_flag(const void* out, int N) {
  return (N % 8 == 0 && host_aligned16(out)) ? kVecOut : 0;
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// dtype 0: int8 A, B (out_mode 0 gives int32, 1-3 the conv epilogue);
// dtype 1: bf16 A, B (out_mode 0 only, f32 out);
// dtype 2 / 3: bf16 / f32 A quantized on load with `a_scale`, int8 B
// (as dtype 0). `oscale`/`bias` (length N) are read only for out_mode > 0.
extern "C" int mm_tiled_launch(int dtype, const void* a, const void* b,
                               void* out, int M, int N, int K, float a_scale,
                               const float* oscale, const float* bias,
                               int relu, int out_mode, float s_next,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const Epilogue ep{oscale, bias, host_scale(s_next), relu};
  const auto st = static_cast<cudaStream_t>(stream);
  const int flags_b = (N % 16 == 0 && host_aligned16(b) ? kVecB : 0) |
                      out_flag(out, N);
  const int vec_qa = (K % 16 == 0 && host_aligned16(a)) ? kVecA : 0;
  if (dtype == 2) {
    const QuantA<__nv_bfloat16> L{static_cast<const __nv_bfloat16*>(a), M, K,
                                  host_scale(a_scale)};
    return launch(L, static_cast<const int8_t*>(b), out, M, N, K, out_mode, ep,
                  vec_qa | flags_b, st);
  }
  if (dtype == 3) {
    const QuantA<float> L{static_cast<const float*>(a), M, K,
                          host_scale(a_scale)};
    return launch(L, static_cast<const int8_t*>(b), out, M, N, K, out_mode, ep,
                  vec_qa | flags_b, st);
  }
  if (dtype == 0) {
    const DenseA<int8_t> L{static_cast<const int8_t*>(a), M, K};
    const int flags = (K % 16 == 0 && host_aligned16(a) ? kVecA : 0) |
                      (N % 16 == 0 && host_aligned16(b) ? kVecB : 0) |
                      out_flag(out, N);
    return launch(L, static_cast<const int8_t*>(b), out, M, N, K, out_mode, ep,
                  flags, st);
  }
  if (dtype == 1 && out_mode == kRaw) {
    const DenseA<__nv_bfloat16> L{static_cast<const __nv_bfloat16*>(a), M, K};
    const int flags = (K % 8 == 0 && host_aligned16(a) ? kVecA : 0) |
                      (N % 8 == 0 && host_aligned16(b) ? kVecB : 0) |
                      out_flag(out, N);
    return launch(L, static_cast<const __nv_bfloat16*>(b), out, M, N, K,
                  out_mode, ep, flags, st);
  }
  return (int)cudaErrorInvalidValue;
}

// x (B, H, W, Cin) int8 NHWC, w (k*k*Cin, Cout) int8, out (B, OH, OW, Cout)
// of the out_mode's type. pad is the symmetric zero pad of each side.
extern "C" int conv_int8_launch(const int8_t* x, const int8_t* w, void* out,
                                const float* oscale, const float* bias,
                                int relu, int out_mode, float s_next, int B,
                                int H, int W, int Cin, int OH, int OW,
                                int Cout, int k, int stride, int rate, int pad,
                                void* stream) {
  const long long M = (long long)B * OH * OW;
  const long long K = (long long)k * k * Cin;
  if (M <= 0 || M > 0x7fffffffLL || K > 0x7fffffffLL || Cout <= 0 || k <= 0 ||
      stride <= 0 || rate <= 0 || pad < 0 ||
      (long long)H * W * Cin > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const ConvA L{x, (int)M, (int)K, H, W, Cin, OH, OW, k, stride, rate, pad};
  const int flags = (Cin % 16 == 0 && host_aligned16(x) ? kVecA : 0) |
                    (Cout % 16 == 0 && host_aligned16(w) ? kVecB : 0) |
                    out_flag(out, Cout);
  const Epilogue ep{oscale, bias, host_scale(s_next), relu};
  return launch(L, w, out, (int)M, Cout, (int)K, out_mode, ep, flags,
                static_cast<cudaStream_t>(stream));
}
