// The frozen batch-norm tail of a convolution in one pass: each output is
//   act( round(round(a * inv_a) + shift_a) [+ r'] ),
//   r' = r, or round(round(r * inv_r) + shift_r) for a projection shortcut,
// with act none, ReLU or ReLU6 and round() the rounding to the tensor's
// type after each operation. That is the chain PyTorch runs op by op in
// models/resnet.py and models/mobilenet.py (BN multiply, BN add, the
// residual add, the activation), and the arithmetic here repeats it
// exactly: float32 products and sums with __fmul_rn / __fadd_rn (no FMA
// contraction), bf16 rounded to nearest even after each, NaN passed
// through the activation as PyTorch's clamp does. So a launch gives the
// chain's bits, in bf16 and in float32.
//
// It replaces no TPU kernel: XLA fused this tail into the convolution's
// epilogue there. On the H100 the chain made two to six passes over HBM
// per conv output, two of them through PyTorch's strided broadcast
// kernel at 45% of the card's bandwidth. This pass reads the conv output
// once, the residual once, and writes once, so it is bound by those
// bytes at 3.35 TB/s.
//
// One kernel, frozen_bn_act_nhwc_elementwise_kernel, for channels_last
// tensors whose C is a multiple of 8 (bf16) or 4 (float32), every pointer
// 16-byte aligned: every site of ResNet-50 and MobileNetV2. A thread owns
// one 16-byte group of channels for the whole launch and keeps its
// per-channel factors in registers; its block walks whole pixel rows
// (blockDim a multiple of C / 8), two rows a thread per turn so that 32-64
// bytes a thread are in flight. The residual is the same layout as the
// input, or any view whose channels are contiguous and whose other strides
// are whole vectors (slim's x[:, :, ::2, ::2] subsample shortcut), read
// through its strides with no copy. The launch refuses any other shape;
// the wrapper (ops/kernels/bn_act_kernel.py::takes) sends it none, and the
// models run the plain chain for it.
//
// The kernel allocates nothing; the wrapper allocates the output like the
// input.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kActNone = 0, kActRelu = 1, kActRelu6 = 2;
constexpr int kVecThreads = 256;     // target block size
constexpr int kMaxVecThreads = 1024;

struct F32 {
  using Raw = float;
  static constexpr int kVec = 4;
  __device__ static float load(Raw v) { return v; }
  __device__ static Raw store(float v) { return v; }
  __device__ static float round(float v) { return v; }
};

struct BF16 {
  using Raw = unsigned short;
  static constexpr int kVec = 8;
  __device__ static float load(Raw v) {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
  }
  __device__ static Raw store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static float round(float v) { return load(store(v)); }
};

template <class Raw>
union Pack16 {
  uint4 u;
  Raw e[16 / sizeof(Raw)];
};

struct TailArgs {
  const void* a;
  const void* inv_a;
  const void* shift_a;
  const void* r;        // null: no residual
  const void* inv_r;    // null: the residual is added as it is
  const void* shift_r;
  void* out;
  long long pixels;     // n * h * w
  long long rs0, rs1, rs2;  // the residual's n, h and w strides
  int c, hw, w;
  int act;
};

// x * inv then + shift, each rounded to the type (BN in x's dtype)
template <class D>
__device__ __forceinline__ float affine(float x, float inv, float shift) {
  return D::round(__fadd_rn(D::round(__fmul_rn(x, inv)), shift));
}

// PyTorch's clamp_min / clamp: NaN passes, then max with 0 (and min with 6)
__device__ __forceinline__ float activate(float v, int act) {
  if (act == kActNone || isnan(v)) return v;
  v = fmaxf(v, 0.0f);
  return act == kActRelu6 ? fminf(v, 6.0f) : v;
}

template <class D>
__device__ __forceinline__ uint4 load16(const void* base, long long off) {
  return *reinterpret_cast<const uint4*>(
      static_cast<const typename D::Raw*>(base) + off);
}

// RES: 0 no residual, 1 a residual laid out as the input, 2 a strided one
template <class D, int RES>
__global__ void __launch_bounds__(kMaxVecThreads)
    frozen_bn_act_nhwc_elementwise_kernel(const TailArgs p) {
  using Raw = typename D::Raw;
  constexpr int V = D::kVec;
  constexpr int U = 2;  // pixel rows a thread loads before it computes
  const int groups = p.c / V;
  const int rows = blockDim.x / groups;
  const int g = threadIdx.x % groups;
  const long long first = (long long)blockIdx.x * rows + threadIdx.x / groups;
  const long long step = (long long)gridDim.x * rows;
  Pack16<Raw> inv_a, shift_a, inv_r, shift_r;
  inv_a.u = load16<D>(p.inv_a, g * V);
  shift_a.u = load16<D>(p.shift_a, g * V);
  const bool rbn = RES != 0 && p.inv_r != nullptr;
  if (rbn) {
    inv_r.u = load16<D>(p.inv_r, g * V);
    shift_r.u = load16<D>(p.shift_r, g * V);
  }
  for (long long pix0 = first; pix0 < p.pixels; pix0 += U * step) {
    Pack16<Raw> av[U], rv[U];
    long long off[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long pix = pix0 + u * step;
      off[u] = pix * p.c + g * V;
      if (pix >= p.pixels) continue;
      av[u].u = load16<D>(p.a, off[u]);
      if (RES == 1) {
        rv[u].u = load16<D>(p.r, off[u]);
      } else if (RES == 2) {
        const unsigned q = static_cast<unsigned>(pix);
        const unsigned n = q / static_cast<unsigned>(p.hw);
        const unsigned rem = q - n * static_cast<unsigned>(p.hw);
        const unsigned h = rem / static_cast<unsigned>(p.w);
        const unsigned w = rem - h * static_cast<unsigned>(p.w);
        rv[u].u = load16<D>(p.r, n * p.rs0 + h * p.rs1 + w * p.rs2 + g * V);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (pix0 + u * step >= p.pixels) continue;
      Pack16<Raw> ov;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float y = affine<D>(D::load(av[u].e[i]), D::load(inv_a.e[i]),
                            D::load(shift_a.e[i]));
        if (RES != 0) {
          float s = D::load(rv[u].e[i]);
          if (rbn)
            s = affine<D>(s, D::load(inv_r.e[i]), D::load(shift_r.e[i]));
          y = D::round(__fadd_rn(s, y));
        }
        ov.e[i] = D::store(activate(y, p.act));
      }
      *reinterpret_cast<uint4*>(static_cast<Raw*>(p.out) + off[u]) = ov.u;
    }
  }
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    counts[dev] = 132;
  return counts[dev];
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

template <class K>
long long resident_grid(K kernel, int threads, long long work) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  const long long cap = (long long)sm_count() * per_sm;
  return work < cap ? work : cap;
}

template <class D>
cudaError_t launch(TailArgs p, long long rsc, cudaStream_t stream) {
  constexpr int V = D::kVec;
  const long long groups = p.c / V;
  int res = 0;
  if (p.r != nullptr) {
    // the residual laid out as the input: its strides are the input's
    const bool same = p.rs0 == (long long)p.hw * p.c &&
                      p.rs1 == (long long)p.w * p.c && p.rs2 == p.c;
    res = same ? 1 : 2;
    if (rsc != 1 || p.rs0 % V != 0 || p.rs1 % V != 0 || p.rs2 % V != 0 ||
        !aligned16(p.r))
      return cudaErrorInvalidValue;
  }
  if (p.c % V != 0 || groups > kMaxVecThreads || p.pixels >= 0x7fffffffLL ||
      !aligned16(p.a) || !aligned16(p.out) || !aligned16(p.inv_a) ||
      !aligned16(p.shift_a) ||
      (p.inv_r != nullptr && !(aligned16(p.inv_r) && aligned16(p.shift_r))))
    return cudaErrorInvalidValue;
  const int rows = groups >= kVecThreads ? 1 : kVecThreads / (int)groups;
  const int threads = rows * (int)groups;
  const long long work = (p.pixels + rows - 1) / rows;
  if (res == 0) {
    auto k = frozen_bn_act_nhwc_elementwise_kernel<D, 0>;
    k<<<(unsigned)resident_grid(k, threads, work), threads, 0, stream>>>(p);
  } else if (res == 1) {
    auto k = frozen_bn_act_nhwc_elementwise_kernel<D, 1>;
    k<<<(unsigned)resident_grid(k, threads, work), threads, 0, stream>>>(p);
  } else {
    auto k = frozen_bn_act_nhwc_elementwise_kernel<D, 2>;
    k<<<(unsigned)resident_grid(k, threads, work), threads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// a: (n, c, h, w) channels_last (NHWC in memory); out laid out as a.
// inv/shift: (c,) of a's type. r: null or (n, c, h, w) with strides rsn,
// rsc, rsh, rsw (elements); inv_r/shift_r: null, or (c,) applied to r
// first. bf16: 1 for bfloat16, 0 for float32. act: 0 none, 1 ReLU, 2
// ReLU6. Returns a cudaError_t (0: launched; cudaErrorInvalidValue for a
// shape the kernel does not take, see the top of this file).
extern "C" int frozen_bn_act_launch(
    const void* a, const void* inv_a, const void* shift_a, const void* r,
    const void* inv_r, const void* shift_r, void* out, int bf16, int act,
    long long n, long long c, long long h, long long w, long long rsn,
    long long rsc, long long rsh, long long rsw, void* stream) {
  if (n < 0 || c <= 0 || h < 0 || w < 0 || act < kActNone ||
      act > kActRelu6 || (inv_r == nullptr) != (shift_r == nullptr) ||
      (r == nullptr && inv_r != nullptr) || a == nullptr || out == nullptr ||
      inv_a == nullptr || shift_a == nullptr || c > 0x7fffffffLL ||
      h * w > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n * h * w == 0) return 0;
  TailArgs p;
  p.a = a;
  p.inv_a = inv_a;
  p.shift_a = shift_a;
  p.r = r;
  p.inv_r = inv_r;
  p.shift_r = shift_r;
  p.out = out;
  p.pixels = n * h * w;
  p.c = (int)c;
  p.hw = (int)(h * w);
  p.w = (int)w;
  p.act = act;
  p.rs0 = rsn, p.rs1 = rsh, p.rs2 = rsw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch<BF16>(p, rsc, s) : launch<F32>(p, rsc, s));
}
