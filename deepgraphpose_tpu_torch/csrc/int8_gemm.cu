// Tiled tensor-core GEMM for Hopper (sm_90a): int8 x int8 -> int32 and
// bf16 x bf16 -> f32, and the int8 convolution of the quantized ResNet as an
// implicit GEMM on the same main loop, with the quantization epilogue fused.
//
// Replaces the TPU kernel `pallas_mm` of scripts/int8_conv_probe.py
// (sec_mm_pallas, body mm_kernel): a (M, K) @ (K, N) product on a grid of
// (M/bm, N/bn, K/bk) steps whose accumulator lives in VMEM scratch, zeroed at
// the first K step and stored at the last. Here a block owns one output tile
// and walks K itself, so the accumulator stays in registers and is written
// once.
//
// Two launch functions share the main loop:
//   mm_tiled_launch   row-major A (M, K) times B, given as its transpose: a
//                     row-major (N, K) matrix. int8 gives int32 and bf16
//                     gives f32 (out_mode 0, the probe's function). int8
//                     also takes the conv epilogue below: a 1x1 stride-1
//                     conv over NHWC input is exactly this product with A =
//                     x viewed as (B*H*W, Cin). For such a conv A may also be
//                     the wide (bf16 or f32) activation itself, quantized as
//                     it is loaded with the conv's input scale: clip(rint(x /
//                     s), -127, 127), the same arithmetic as a separate
//                     quantizing pass, without that pass's trip through
//                     device memory.
//   conv_int8_launch  the A tile is gathered by im2col addressing from NHWC
//                     int8 input x (B, H, W, Cin): kernel k x k, stride,
//                     dilation rate, zero pads pad_h above and pad_w left of
//                     the image; the caller's output size (OH, OW) sets the
//                     pads below and right, so slim's symmetric pads and TF
//                     SAME's (one more on the high side for a stride-2 conv
//                     over an even side, MobileNetV2's stem) both address
//                     here. Zero fill is exact because the quantization is
//                     symmetric (zero point 0). B is the HWIO weight
//                     flattened to (K = k*k*Cin, Cout), given as its (Cout,
//                     K) transpose.
// Epilogue (models/quant.py of the JAX package, conv_fn):
//   y = float(acc) * oscale[n] + bias[n], then the activation `act`
//   (0 none, 1 ReLU max(y, 0), 2 ReLU6 min(max(y, 0), 6): the ResNets' and
//   MobileNetV2's), then
//   out_mode 1: f32, 2: bf16 (round to nearest even),
//   3: int8 clip(rint(y / s_next), -127, 127) (round half to even).
// Index arithmetic: element offsets of A, of the image and of the output
// are 64-bit (MobileNetV2's first expand at batch 128 writes M * N = 1.91e9
// outputs, 12% below 2^31); M, N, K and per-image offsets stay 32-bit, and
// the launch functions refuse shapes beyond them.
// The multiply-add is one fused, once-rounded operation (__fmaf_rn): XLA's
// CPU backend contracts the JAX package's `acc * oscale + bias` the same
// way (it equals the fused result on every one of 10^6 random inputs, and
// the twice-rounded result on 75% of them), and the plain PyTorch version
// computes it exactly in float64 and rounds once.
//
// Bound. At the probe's 4096^3 the work is 137 G operations: 0.069 ms at
// 1979 TOPS int8 and 0.139 ms at 989 TFLOP/s bf16 (dense peaks), far above
// the bytes (48-96 MB). At batch 128 the ResNet's 3x3s from block 2 on and
// its widest 1x1 (1024 -> 2048) are bound by their operations; the other
// 1x1s, the block-1 3x3s and the stem (Cin = 3, K = 147) by their bytes,
// most of them the bf16 or int8 output written once.
//
// Design. 128 x 128 output tile per block of two warpgroups (256 threads);
// warpgroup g owns rows 64g..64g+63 and issues wgmma.mma_async m64n128k32
// (s32 += s8 * s8) or m64n128k16 (f32 += bf16 * bf16), 64 accumulators a
// thread in registers. K advances 128 bytes per tile (128 int8 or 64 bf16):
// four wgmmas of 32 bytes each.
//   Shared memory. Both operands are stored K-major, one 128-byte row per M
//   (A) or N (B) index, in the 128-byte swizzle: the 16-byte chunk c of row
//   r lies at r*128 + ((c ^ (r & 7)) << 4) from a 1024-byte aligned tile
//   base. The s8 form of wgmma takes both operands K-major only, which is
//   why B arrives as (N, K); bf16 uses the same layout, so one descriptor
//   serves both types. Descriptor: start address >> 4, leading offset 1
//   (unused by a swizzled K-major layout), stride offset 1024 bytes between
//   8-row groups, layout type 1 (128-byte swizzle); the j-th 32-byte K slice
//   of a tile adds 2 to the address field, and the hardware applies the
//   swizzle to the resulting addresses.
//   Pipeline. A ring of kStages = 3 tiles (32 KB each). Operands whose
//   loader copies bytes unchanged (dense int8 / bf16 rows, the im2col
//   gather when Cin % 16 == 0, and B) are copied by cp.async straight into
//   the swizzled slot, two tiles ahead, one commit group per tile; a chunk
//   out of range or in the zero pad copies 0 source bytes, which
//   zero-fills. The operands that are transformed on the way (A quantized
//   on load; the scalar gathers of the stem and of shapes not 16-byte
//   aligned) are loaded into registers and stored to their slot with
//   st.shared one tile ahead, after the current tile's wgmmas are issued,
//   so that they run beside them. Per tile: cp.async.wait_group 1;
//   fence.proxy.async.shared::cta (cp.async and st.shared write through
//   the generic proxy, wgmma reads through the async proxy: without the
//   fence it may read stale bytes; each thread fences its own writes before
//   the barrier); __syncthreads; cp.async of tile kt + 2 into the slot
//   freed by tile kt - 1; wgmma.fence, four wgmmas, commit; the staged
//   operands of tile kt + 1; wait_group 0.
//   Occupancy. 97 KB of shared memory a block, so two blocks share an SM:
//   one block's barriers, prologue and epilogue overlap the other's wgmmas.
//   That caps a thread at 128 registers; the kernels that stage operands in
//   registers spill a few hundred bytes under the cap and are faster all
//   the same. Ring depth 4 (one block an SM) was slower everywhere.
//   Epilogue. The accumulators pass through the freed ring as a row-major
//   128 x 136 array of words (8 words of padding per row keep the fragment
//   stores free of bank conflicts) to `store8`, which writes 8 consecutive
//   outputs of one row: the fused epilogue and its exact rounding are the
//   same code for every output mode.
// Blocks are numbered N-tile fastest, so blocks that share an A tile run
// together and read it from L2.
//
// What still holds it back: no TMA (every thread spends instructions and
// registers on addresses and copies), no warp specialisation (the wgmmas of
// a tile finish before the next tile's barrier; only the second block on
// the SM fills that gap), 128-wide tiles that are half empty at the N = 64
// sites, the quantize-on-load (repeated for every 128 columns of N) and the
// stem's byte gathers in the consumer warps' own instruction stream, the
// stem's (64, 147) weight read byte by byte (its rows are not a multiple of
// 16 bytes), and an epilogue that does not overlap the next tile's loads
// (no persistent blocks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128;                        // output rows per block
constexpr int kBN = 128;                        // output columns per block
constexpr int kThreads = 256;                   // two warpgroups
constexpr int kTileKBytes = 128;                // one swizzle row per tile
constexpr int kChunkBytes = 16;
constexpr int kStages = 3;                      // ring depth
constexpr int kTileBytes = kBM * kTileKBytes;   // one operand's tile, 16 KB
constexpr int kStageBytes = 2 * kTileBytes;     // A tile, then B tile
constexpr int kRowsPerPass = kThreads / (kTileKBytes / kChunkBytes);  // 32
constexpr int kPasses = kBM / kRowsPerPass;     // chunks per thread, operand
constexpr int kOutStride = kBN + 8;             // epilogue row, in words
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kOutBytes = kBM * kOutStride * 4;
constexpr int kSmemBytes =
    (kRingBytes > kOutBytes ? kRingBytes : kOutBytes) + 1024;  // + alignment
// blocks an SM: two where two rings fit the SM's 228 KB (1 KB of it
// reserved for each block), which caps a thread at 128 registers
constexpr int kBlocksPerSM = 2 * (kSmemBytes + 1024) <= 233472 ? 2 : 1;
constexpr int kMaxDevices = 64;
static_assert(kBM == kBN, "A and B tiles share one geometry");
static_assert(kStages >= 2, "a ring needs two slots");

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

// Tile geometry for element type T (sizes in elements).
template <typename T>
struct Geo {
  static constexpr int BK = kTileKBytes / sizeof(T);  // K per tile
  static constexpr int CH = kChunkBytes / sizeof(T);  // elements per chunk
};

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
__device__ __forceinline__ bool near_half(float t, float r) {
  return 0.5f - fabsf(t - r) <= 2.5e-7f * fabsf(t);
}
__device__ __forceinline__ uint32_t clip8(float r) {
  return (uint32_t)(uint8_t)(int8_t)__float2int_rn(
      fminf(fmaxf(r, -127.f), 127.f));
}
__device__ __forceinline__ uint32_t quant8(float y, Scale q) {
  const float t = y * q.inv;
  float r = rintf(t);
  if (near_half(t, r)) r = rintf(__fdiv_rn(y, q.s));
  return clip8(r);
}

// quant8 of 16 values, packed into 16 bytes. The multiply serves all 16 and
// one test covers them: only a chunk with a value near a half-integer takes
// the division path, so the quantizing loaders stay short, branch-free code.
__device__ __forceinline__ uint4 quant16(const float (&v)[16], Scale q) {
  uint32_t w[4] = {0, 0, 0, 0};
  bool near = false;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const float t = v[e] * q.inv;
    const float r = rintf(t);
    near |= near_half(t, r);
    w[e / 4] |= clip8(r) << (8 * (e % 4));
  }
  if (near) {
    w[0] = w[1] = w[2] = w[3] = 0;
#pragma unroll
    for (int e = 0; e < 16; ++e) w[e / 4] |= quant8(v[e], q) << (8 * (e % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A dense row-major (rows, K) operand: A (M, K), or B given as (N, K).
// kCopies: its vector path copies bytes unchanged, so cp.async can fill it.
template <typename T>
struct DenseA {
  using Elem = T;
  static constexpr bool kCopies = true;
  const T* a;
  int M, K;
  struct Row {
    const T* p;
    bool ok;
  };
  __device__ Row row(long long m) const {
    return {a + (m < M ? m : 0) * (long long)K, m < M};
  }
  // the 16-byte chunk at column k, or nullptr where it is zero fill
  __device__ const T* src(const Row& r, int k) const {
    return (r.ok && k < K) ? r.p + k : nullptr;
  }
  __device__ uint4 load(const Row& r, int k, bool vec) const {
    constexpr int CH = Geo<T>::CH;
    if (vec) {
      const T* p = src(r, k);
      return p ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
    }
    if (!(r.ok && k < K)) return make_uint4(0, 0, 0, 0);  // all zero fill
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
  static constexpr bool kCopies = false;
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
    if (!(r.ok && k < K)) return make_uint4(0, 0, 0, 0);  // all zero fill
    float v[16];
    if (vec) {  // K % 16 == 0: the 16 values are all in or all out
      load16(r.p + k, v);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        v[e] = (r.ok && k + e < K) ? to_float(r.p[k + e]) : 0.f;
    }
    return quant16(v, q);
  }
};

// A operand: the im2col view of NHWC int8 input; column k of row m is
// x[b, oh*stride - pad_h + dy*rate, ow*stride - pad_w + dx*rate, c] with
// k = (dy*ks + dx)*Cin + c (the HWIO weight flattened to (K, N)).
struct ConvA {
  using Elem = int8_t;
  static constexpr bool kCopies = true;
  const int8_t* x;
  int M, K, H, W, Cin, OH, OW, ks, stride, rate, pad_h, pad_w;
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
    return {x + (long long)b * H * W * Cin, oh * stride - pad_h,
            ow * stride - pad_w, true};
  }
  // Cin % 16 == 0: the 16 bytes at column k lie in one tap, contiguous;
  // nullptr where they are zero fill
  __device__ const int8_t* src(const Row& r, int k) const {
    const int tap = k / Cin;
    const int c = k - tap * Cin;
    const int dy = tap / ks;
    const int dx = tap - dy * ks;
    const int ih = r.ih0 + dy * rate, iw = r.iw0 + dx * rate;
    if (r.ok && k < K && ih >= 0 && ih < H && iw >= 0 && iw < W)
      return r.img + ((long long)ih * W + iw) * Cin + c;
    return nullptr;
  }
  __device__ uint4 load(const Row& r, int k, bool vec) const {
    if (vec) {
      const int8_t* p = src(r, k);
      return p ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
    }
    if (!(r.ok && k < K)) return make_uint4(0, 0, 0, 0);  // all zero fill
    int tap = k / Cin;
    int c = k - tap * Cin;
    int dy = tap / ks;
    int dx = tap - dy * ks;
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

enum Act { kNone = 0, kRelu = 1, kRelu6 = 2 };

struct Epilogue {
  const float* oscale;
  const float* bias;
  Scale next;
  int act;
};

__device__ __forceinline__ uint32_t bits(int v) { return (uint32_t)v; }
__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// y = acc * oscale + bias (one rounding), then the activation, for 8
// columns.
template <typename Acc>
__device__ __forceinline__ void affine8(int n, int count, const Acc (&v)[8],
                                        const Epilogue& ep, float (&y)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    y[e] = 0.f;
    if (e < count) {
      y[e] = __fmaf_rn(to_float(v[e]), ep.oscale[n + e], ep.bias[n + e]);
      if (ep.act != kNone) y[e] = fmaxf(y[e], 0.f);
      if (ep.act == kRelu6) y[e] = fminf(y[e], 6.f);
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

// ---- Hopper primitives (PTX) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where src is nullptr (0
// source bytes; `fill` is any valid global address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           const void* fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src ? src : fill), "r"(src ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's generic-proxy writes to shared memory visible to the
// async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4)   // start address
         | (uint64_t)1 << 16                  // leading offset (unused)
         | (uint64_t)(1024 >> 4) << 32        // stride offset: 8 rows
         | (uint64_t)1 << 62;                 // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous wgmmas that own them.
__device__ __forceinline__ void fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define DGP_ACC8(C, d, i)                                               \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), \
      C(d[i + 6]), C(d[i + 7])
#define DGP_ACC64(C, d)                                                  \
  DGP_ACC8(C, d, 0), DGP_ACC8(C, d, 8), DGP_ACC8(C, d, 16),              \
      DGP_ACC8(C, d, 24), DGP_ACC8(C, d, 32), DGP_ACC8(C, d, 40),        \
      DGP_ACC8(C, d, 48), DGP_ACC8(C, d, 56)
#define DGP_R(x) "+r"(x)
#define DGP_F(x) "+f"(x)
#define DGP_REGS64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128 of this warpgroup) += A (64 x 32 bytes) * B (128 x 32 bytes)^T
__device__ __forceinline__ void wgmma_tile(int (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " DGP_REGS64
      ", %64, %65, p;\n}\n"
      : DGP_ACC64(DGP_R, d)
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}
__device__ __forceinline__ void wgmma_tile(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DGP_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : DGP_ACC64(DGP_F, d)
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ void put2(int* p, int x, int y) {
  *reinterpret_cast<int2*>(p) = make_int2(x, y);
}
__device__ __forceinline__ void put2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// ASYNC: both operands by cp.async, no register staging. It is an
// instantiation of its own because the staging code, compiled in, takes
// registers (and spills a little under the 128-register cap) that slow the
// all-copy path down.
template <typename L, int OUT, bool ASYNC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    gemm_kernel(L aload, DenseA<typename L::Elem> bload, void* out, int M,
                int N, int K, Epilogue ep, int flags) {
  using T = typename L::Elem;
  using G = Geo<T>;
  using Acc = typename Types<T>::Acc;

  extern __shared__ __align__(1024) unsigned char dsmem[];
  // the swizzle is a function of address bits 4-9: tiles start 1024-aligned
  unsigned char* smem = dsmem + ((1024 - (smem_addr(dsmem) & 1023)) & 1023);
  const uint32_t sbase = smem_addr(smem);

  const int tid = threadIdx.x;
  const int n_tiles = (N + kBN - 1) / kBN;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const bool vec_a = flags & kVecA, vec_b = flags & kVecB;
  const bool async_a = ASYNC || (L::kCopies && vec_a);
  const bool async_b = ASYNC || vec_b;
  const bool staged = !(async_a && async_b);

  // this thread's chunks: chunk tid % 8 of rows tid / 8 + 32 i of each
  // operand's tile, at the swizzled offset `off` + i * 4096
  const int chunk = tid % 8;
  const int col = chunk * G::CH;
  const uint32_t off =
      (tid / 8) * kTileKBytes + ((chunk ^ ((tid / 8) & 7)) << 4);
  constexpr int kPassBytes = kRowsPerPass * kTileKBytes;
  typename L::Row arow[kPasses];
  typename DenseA<T>::Row brow[kPasses];
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    arow[i] = aload.row(m0 + tid / 8 + kRowsPerPass * i);
    brow[i] = bload.row(n0 + tid / 8 + kRowsPerPass * i);
  }

  const int k_tiles = (K + G::BK - 1) / G::BK;
  // the byte-copying operands of tile kt, by cp.async; one group per call
  auto issue = [&](int kt) {
    if (kt < k_tiles) {
      const uint32_t s = sbase + (kt % kStages) * kStageBytes + off;
      const int k = kt * G::BK + col;
      if constexpr (L::kCopies) {
        if (async_a) {
#pragma unroll
          for (int i = 0; i < kPasses; ++i)
            cp_async16(s + i * kPassBytes, aload.src(arow[i], k), bload.a);
        }
      }
      if (async_b) {
#pragma unroll
        for (int i = 0; i < kPasses; ++i)
          cp_async16(s + kTileBytes + i * kPassBytes, bload.src(brow[i], k),
                     bload.a);
      }
    }
    cp_async_commit();
  };
  // the other operands of tile kt, through registers into their slot
  auto stage_regs = [&](int kt) {
    if constexpr (!ASYNC) {
      const int k = kt * G::BK + col;
      uint4 ra[kPasses], rb[kPasses];
#pragma unroll
      for (int i = 0; i < kPasses; ++i) {
        if (!async_a) ra[i] = aload.load(arow[i], k, vec_a);
        if (!async_b) rb[i] = bload.load(brow[i], k, vec_b);
      }
      unsigned char* s = smem + (kt % kStages) * kStageBytes + off;
#pragma unroll
      for (int i = 0; i < kPasses; ++i) {
        if (!async_a) *reinterpret_cast<uint4*>(s + i * kPassBytes) = ra[i];
        if (!async_b)
          *reinterpret_cast<uint4*>(s + kTileBytes + i * kPassBytes) = rb[i];
      }
    }
  };

  Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = Acc(0);

  for (int kt = 0; kt < kStages - 1; ++kt) issue(kt);
  if (staged) stage_regs(0);
  const uint32_t a_off = (tid / 128) * 64 * kTileKBytes;  // this warpgroup
#pragma unroll 1
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt's copies have landed
    fence_proxy_async();
    __syncthreads();               // ... everyone's, and tile kt - 1 is read
    issue(kt + kStages - 1);       // into tile kt - 1's slot
    const uint32_t s = sbase + (kt % kStages) * kStageBytes;
    const uint64_t da = smem_desc(s + a_off), db = smem_desc(s + kTileBytes);
    fence_operands(acc);
    __syncwarp();                  // .aligned: the warp issues together
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_tile(acc, da + 2 * j, db + 2 * j);
    wgmma_commit();
    // the register-staged loads and their transform overlap the wgmmas
    if (staged && kt + 1 < k_tiles) stage_regs(kt + 1);
    wgmma_wait0();
    fence_operands(acc);
  }

  // epilogue: the fragments to a row-major tile in the freed ring; row
  // 16 * warp + lane / 4 (+8), columns 8 j + 2 (lane % 4) (+1)
  cp_async_wait<0>();
  __syncthreads();
  Acc* tile = reinterpret_cast<Acc*>(smem);
  {
    const int warp = tid / 32, lane = tid % 32;
    Acc* p = tile + (16 * warp + lane / 4) * kOutStride + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      put2(p + 8 * j, acc[4 * j], acc[4 * j + 1]);
      put2(p + 8 * kOutStride + 8 * j, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  // thread tid stores 8 columns from 8 * (tid % 16) of rows tid / 16 + 16 i
  const bool vec_out = flags & kVecOut;
#pragma unroll 1
  for (int i = 0; i < kBM / 16; ++i) {
    const int r = tid / 16 + 16 * i, c = 8 * (tid % 16);
    const long long m = m0 + r;
    const int n = n0 + c;
    if (m < M && n < N) {
      union {
        uint4 u[2];
        Acc v[8];
      } buf;
      const uint4* p =
          reinterpret_cast<const uint4*>(tile + r * kOutStride + c);
      buf.u[0] = p[0];
      buf.u[1] = p[1];
      store8<OUT>(out, m, n, N, buf.v, ep, vec_out);
    }
  }
}

Scale host_scale(float s) { return {s, s != 0.f ? 1.f / s : 0.f}; }

bool host_aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename L, int OUT, bool ASYNC>
int run(const L& aload, const DenseA<typename L::Elem>& bload, void* out,
        int M, int N, int K, Epilogue ep, int flags, dim3 grid,
        cudaStream_t stream) {
  const auto kernel = gemm_kernel<L, OUT, ASYNC>;
  // more than 48 KB of dynamic shared memory needs an opt-in, once per
  // kernel and device (before any graph capture: the first launch is eager)
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(aload, bload, out, M, N, K,
                                                  ep, flags);
  return (int)cudaGetLastError();
}

// the instantiation without register staging where both operands copy
template <typename L, int OUT>
int run_for(const L& aload, const DenseA<typename L::Elem>& bload, void* out,
            int M, int N, int K, Epilogue ep, int flags, dim3 grid,
            cudaStream_t stream) {
  if constexpr (L::kCopies) {
    if ((flags & kVecA) && (flags & kVecB))
      return run<L, OUT, true>(aload, bload, out, M, N, K, ep, flags, grid,
                               stream);
  }
  return run<L, OUT, false>(aload, bload, out, M, N, K, ep, flags, grid,
                            stream);
}

template <typename L>
int launch(const L& aload, const DenseA<typename L::Elem>& bload, void* out,
           int M, int N, int K, int out_mode, Epilogue ep, int flags,
           cudaStream_t stream) {
  const long long blocks = (((long long)M + kBM - 1) / kBM) *
                           (((long long)N + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  if constexpr (std::is_same<typename L::Elem, __nv_bfloat16>::value) {
    if (out_mode != kRaw) return (int)cudaErrorInvalidValue;
    return run_for<L, kRaw>(aload, bload, out, M, N, K, ep, flags, grid,
                            stream);
  } else {
    switch (out_mode) {
      case kRaw:
        return run_for<L, kRaw>(aload, bload, out, M, N, K, ep, flags, grid,
                                stream);
      case kF32:
        return run_for<L, kF32>(aload, bload, out, M, N, K, ep, flags, grid,
                                stream);
      case kBF16:
        return run_for<L, kBF16>(aload, bload, out, M, N, K, ep, flags, grid,
                                 stream);
      case kI8:
        return run_for<L, kI8>(aload, bload, out, M, N, K, ep, flags, grid,
                               stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
}

int out_flag(const void* out, int N) {
  return (N % 8 == 0 && host_aligned16(out)) ? kVecOut : 0;
}

// the vector flag of a row-major (rows, K) operand of `ch`-element chunks
int vec_flag(const void* p, long long K, int ch, int flag) {
  return (K % ch == 0 && host_aligned16(p)) ? flag : 0;
}

}  // namespace

// The depth of the shared-memory ring (tiles in flight).
extern "C" int int8_gemm_stages() { return kStages; }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `bt` is B transposed: row-major (N, K).
// dtype 0: int8 A, B (out_mode 0 gives int32, 1-3 the conv epilogue);
// dtype 1: bf16 A, B (out_mode 0 only, f32 out);
// dtype 2 / 3: bf16 / f32 A quantized on load with `a_scale`, int8 B
// (as dtype 0). `oscale`/`bias` (length N) are read only for out_mode > 0;
// `act` is the epilogue's activation (enum Act).
extern "C" int mm_tiled_launch(int dtype, const void* a, const void* bt,
                               void* out, int M, int N, int K, float a_scale,
                               const float* oscale, const float* bias,
                               int act, int out_mode, float s_next,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || act < kNone || act > kRelu6)
    return (int)cudaErrorInvalidValue;
  const Epilogue ep{oscale, bias, host_scale(s_next), act};
  const auto st = static_cast<cudaStream_t>(stream);
  const int flags_out = out_flag(out, N);
  if (dtype == 1) {
    if (out_mode != kRaw) return (int)cudaErrorInvalidValue;
    using BF = __nv_bfloat16;
    const DenseA<BF> A{static_cast<const BF*>(a), M, K};
    const DenseA<BF> B{static_cast<const BF*>(bt), N, K};
    return launch(A, B, out, M, N, K, out_mode, ep,
                  vec_flag(a, K, 8, kVecA) | vec_flag(bt, K, 8, kVecB) |
                      flags_out,
                  st);
  }
  const DenseA<int8_t> B{static_cast<const int8_t*>(bt), N, K};
  const int flags_b = vec_flag(bt, K, 16, kVecB) | flags_out;
  const int flags_a = vec_flag(a, K, 16, kVecA);
  if (dtype == 0) {
    const DenseA<int8_t> A{static_cast<const int8_t*>(a), M, K};
    return launch(A, B, out, M, N, K, out_mode, ep, flags_a | flags_b, st);
  }
  if (dtype == 2) {
    const QuantA<__nv_bfloat16> A{static_cast<const __nv_bfloat16*>(a), M, K,
                                  host_scale(a_scale)};
    return launch(A, B, out, M, N, K, out_mode, ep, flags_a | flags_b, st);
  }
  if (dtype == 3) {
    const QuantA<float> A{static_cast<const float*>(a), M, K,
                          host_scale(a_scale)};
    return launch(A, B, out, M, N, K, out_mode, ep, flags_a | flags_b, st);
  }
  return (int)cudaErrorInvalidValue;
}

// x (B, H, W, Cin) int8 NHWC, wt (Cout, k*k*Cin) int8 (the flattened HWIO
// weight, transposed), out (B, OH, OW, Cout) of the out_mode's type. pad_h,
// pad_w are the zero pads above and left of the image.
extern "C" int conv_int8_launch(const int8_t* x, const int8_t* wt, void* out,
                                const float* oscale, const float* bias,
                                int act, int out_mode, float s_next, int B,
                                int H, int W, int Cin, int OH, int OW,
                                int Cout, int k, int stride, int rate,
                                int pad_h, int pad_w, void* stream) {
  const long long M = (long long)B * OH * OW;
  const long long K = (long long)k * k * Cin;
  if (M <= 0 || M > 0x7fffffffLL || K > 0x7fffffffLL || Cout <= 0 || k <= 0 ||
      stride <= 0 || rate <= 0 || pad_h < 0 || pad_w < 0 || act < kNone ||
      act > kRelu6 || (long long)H * W * Cin > 0x7fffffffLL ||
      (long long)Cout * K > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const ConvA A{x,  (int)M, (int)K, H,    W,     Cin,
                OH, OW,     k,      stride, rate, pad_h, pad_w};
  const DenseA<int8_t> Bw{wt, Cout, (int)K};
  const int flags = vec_flag(x, Cin, 16, kVecA) | vec_flag(wt, K, 16, kVecB) |
                    out_flag(out, Cout);
  const Epilogue ep{oscale, bias, host_scale(s_next), act};
  return launch(A, Bw, out, (int)M, Cout, (int)K, out_mode, ep, flags,
                static_cast<cudaStream_t>(stream));
}
