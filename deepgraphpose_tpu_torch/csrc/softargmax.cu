// Fused soft-argmax decode + 2x2 max-sigmoid likelihood for Hopper (sm_90a).
//
// Replaces the TPU kernel deepgraphpose_tpu/ops/pallas/softargmax_kernel.py
// (_softargmax_pallas_fwd_impl / _kernel), and fuses the likelihood read of
// deepgraphpose_tpu/infer/predict.py:51-64 into the same pass.
//
// Input:  logits x (B, H, W, C) float32, NHWC contiguous (the part_pred head
//         as the port produces it; no transpose to (B*C, H, W) first). Any
//         4-byte aligned start: a view with an odd storage offset is taken.
// Output: mu (B, C, 2) float32, (row, col) in scoremap cells;
//         lik (B, C) float32, max sigmoid(x) over the 2x2 cells at
//         clip(floor(mu)) and +1, each clipped to the map.
//
// Math. softmax(gamma*x) -> separable Gaussian smoothing (zero pad, radius r,
// normalized taps k) -> renormalize -> expectation over the grid. Smoothing
// is linear and the renormalization divides it out, so no smoothed map is
// ever formed: with e = exp(gamma*x - max),
//   mu_row = sum e*Ar(i)*B(j) / sum e*A(i)*B(j)
//   mu_col = sum e*A(i)*Bc(j) / sum e*A(i)*B(j)
// where A(i) = sum_{d: 0<=i+d<H} k_d, Ar(i) = sum_d k_d*(i+d), and B, Bc
// likewise over W. The host builds them once per (H, W, sigma, truncate)
// as the pairs (A, Ar) and (B, Bc) (ops/kernels/softargmax_kernel.py::
// kernel_weights).
//
// Bound. Each logit is read once and the outputs written once: at the main
// path's B=128, 94x104, C=5 that is 25.0 MB, 7.5 us at 3.35 TB/s, so the
// kernel is bound by bytes. Its arithmetic (an exp and two to four
// multiply-adds a logit, besides the loads and index tests) is far below
// the card's float32 rate, but one CTA's consumers issue it with little
// latency hidden. The design:
//
// * Cluster split. A frame's logits are one contiguous run of H*W*C floats.
//   The grid is (k, joint groups, B) in clusters of k CTAs along x: CTA
//   rank r of a frame's cluster owns pixels [r*HW/k, (r+1)*HW/k), so a
//   batch of fewer frames than SMs still spreads over the card. At B = 128
//   on 132 SMs every k is one wave of the same work an SM, and k = 1 was
//   the fastest (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): the
//   wrapper launches clusters only when the frames fill less than half
//   the SMs.
// * Ring of 1-D bulk copies. Each CTA streams its range in chunks of
//   `steps` pixel rows of consumers through `stages` shared-memory slots.
//   Warp 0 is the producer: its lane 0 bulk-copies the weight vectors, then
//   issues cp.async.bulk for each chunk (global -> shared, completion
//   counted in bytes on the slot's `full` mbarrier) and refills a slot once
//   every consumer warp has released it on its `empty` mbarrier. (With a
//   consumer lane as the producer, every warp moved at the pace of the one
//   whose lane waited and diverged: 0.0244 ms at (128, 94, 104, 5) and one
//   CTA a frame, 0.0220 with the producer warp and ex2.approx, on the same
//   card.) Bytes in flight are the ring's, not the registers': a
//   larger map (output stride 8, many joints) streams through the same
//   code. Bulk copies need 16-byte aligned addresses and sizes: the
//   unaligned head and tail of a chunk (at most 3 floats each) are read
//   with plain loads.
// * Less work a logit. Consumer t keeps joint c0 + t % J and pixel rows
//   t / J + n * R (R = consumers / J), so a warp reads consecutive floats of
//   the slot (no bank conflicts at any C). A chunk's max is taken from the
//   values already loaded, then the sums: one rescale test a chunk, not a
//   logit, and no index test where all of a consumer's steps lie in the
//   copied body. Where R is a multiple of W (the column kernel) a
//   consumer's pixel column j never changes: it keeps B(j), Bc(j) in
//   registers and sums e*A(i) and e*Ar(i) only (sum e*A*B = B * sum e*A),
//   one 8-byte shared load a logit. The exp is an ex2.approx of
//   fma(x, scale, -max): one rounding, so the weights of the logits near
//   the max keep their precision.
// * Merge. Per-consumer partials (max, S0, Sr, Sc) merge inside the CTA
//   with warp shuffles. The other ranks then write their per-joint
//   partials into rank 0's shared memory through distributed shared
//   memory, arrive on an mbarrier there (release at cluster scope) and
//   exit; rank 0 waits on it, merges and writes mu and lik. One cluster
//   barrier, split into an arrive after the mbarriers' init and a wait
//   before the first remote write, makes sure rank 0's barrier exists. The
//   2x2 likelihood reads the frame again from global memory, where it is
//   still in the 50 MB L2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// At most 576 threads (56 registers each), so that two CTAs of a cluster
// layout share an SM.
constexpr int kMaxThreads = 576;
constexpr int kMaxConsumers = kMaxThreads - 32;  // warp 0 produces
constexpr int kMaxStages = 8;
// full[8], empty[8], then wbar (the weights) and mbar (the cluster merge)
constexpr int kBarBytes = 16 * kMaxStages + 16;
constexpr long long kMaxSmem = 232448;      // 227 KB a CTA on sm_90
constexpr uint32_t kPieceBytes = 16384;     // bytes of one bulk copy

struct Acc {
  float m, s0, sr, sc;  // m is a max of log2-scaled logits
};

// 2^x by the SFU alone (exp2f adds a rescale for outputs below 2^-126,
// which no sum here can tell from 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void merge(Acc& a, const Acc& b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return;  // both empty
  const float fa = (a.m == -INFINITY) ? 0.f : ex2(a.m - m);
  const float fb = (b.m == -INFINITY) ? 0.f : ex2(b.m - m);
  a.s0 = a.s0 * fa + b.s0 * fb;
  a.sr = a.sr * fa + b.sr * fb;
  a.sc = a.sc * fa + b.sc * fb;
  a.m = m;
}

__device__ __forceinline__ Acc as_acc(const float4 v) {
  return {v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Arrive on `bar` expecting `bytes`, and copy them (a multiple of 16, both
// addresses 16-byte aligned) from global to shared memory, completing on it.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  for (uint32_t off = 0; off < bytes; off += kPieceBytes)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst) + off),
        "l"(reinterpret_cast<const char*>(src) + off),
        "r"(min(kPieceBytes, bytes - off)), "r"(smem_addr(bar))
        : "memory");
}

// A chunk: `len` floats from global index `ga` of x. The first `head`
// (< 4) precede the first 16-byte aligned address; `body` floats (a
// multiple of 4) are bulk-copied; the rest are the tail. In its slot, float
// l of the chunk sits at l + lead, with head + lead in {0, 4}, so the
// copied body starts 16-byte aligned.
struct Chunk {
  long long ga;
  int head, body, lead;
};

__device__ __forceinline__ Chunk chunk_at(const float* x, long long ga,
                                          int len) {
  Chunk ch;
  ch.ga = ga;
  const int mis = (int)((reinterpret_cast<uintptr_t>(x + ga) >> 2) & 3);
  ch.head = min((4 - mis) & 3, len);
  ch.body = (len - ch.head) & ~3;
  ch.lead = (4 - ch.head) & 3;
  return ch;
}

// scale = gamma * log2(e), so exp(gamma*x - max) = exp2(scale*x - m).
// `slot` is the floats of one ring slot (a multiple of 4).
template <int kSteps, bool kColumn>
__global__ void __launch_bounds__(kMaxThreads, 2) softargmax_likelihood_kernel(
    const float* __restrict__ x, const float* __restrict__ weights,
    float* __restrict__ mu, float* __restrict__ lik, int H, int W, int C,
    int J, int stages, int slot, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kMaxStages;
  uint64_t* wbar = empty + kMaxStages;  // the weight vectors' copy
  uint64_t* mbar = wbar + 1;            // rank 0: the others' partials
  float* ring = reinterpret_cast<float*>(smem_raw + kBarBytes);
  const float2* sAA = reinterpret_cast<const float2*>(ring + stages * slot);
  const float2* sBB = sAA + H;  // (B(j), Bc(j))
  const int wfloats = (2 * (H + W) + 3) & ~3;
  float4* part = reinterpret_cast<float4*>(ring + stages * slot + wfloats);

  cg::cluster_group cluster = cg::this_cluster();
  const int k = gridDim.x;  // CTAs of a frame's cluster
  const int rank = (int)cluster.block_rank();
  // part[r * J + c]: rank r's partial of joint c (rank 0 gathers them all)
  // warp 0 produces (its lane 0 issues the copies); the rest consume
  const int T = blockDim.x - 32;        // consumer threads
  const int t = (int)threadIdx.x - 32;  // consumer index; < 0 in warp 0
  const int lane = threadIdx.x & 31;
  const int R = T / J;  // pixel rows of consumer threads
  const int c0 = blockIdx.y * J;
  const int jg = min(J, C - c0);  // joints in this group
  const int HW = H * W;
  const long long base = (long long)blockIdx.z * HW * C;
  const int p_lo = (int)((long long)rank * HW / k);
  const int p_hi = (int)((long long)(rank + 1) * HW / k);
  const int P = kSteps * R;  // pixels a chunk
  const int nchunks = (p_hi - p_lo + P - 1) / P;

  auto chunk = [&](int n) {
    const int q0 = p_lo + n * P;
    return chunk_at(x, base + (long long)q0 * C, (min(q0 + P, p_hi) - q0) * C);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], (T + 31) >> 5);  // one arrival a consumer warp
    }
    bar_init(wbar, 1);
    bar_init(mbar, (k - 1) * jg);  // one arrival a joint a remote rank
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the cluster's barriers are initialised once every CTA has arrived
  // here; the matching wait comes before the first remote access
  if (k > 1) asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");

  Acc mine = {-INFINITY, 0.f, 0.f, 0.f};
  if (t < 0) {
    // the weights first, then each chunk, refilling a slot once every
    // consumer warp has released it
    if (lane == 0) {
      bulk_load(ring + stages * slot, weights, 4u * wfloats, wbar);
      for (int n = 0; n < nchunks; ++n) {
        const int s = n % stages;
        if (n >= stages) bar_wait(&empty[s], (n / stages - 1) & 1);
        const Chunk ch = chunk(n);
        bulk_load(ring + s * slot + ch.lead + ch.head, x + ch.ga + ch.head,
                  (uint32_t)ch.body * 4u, &full[s]);
      }
    }
  } else {
    const unsigned wmask =
        T - (t & ~31) >= 32 ? 0xffffffffu : (1u << (T & 31)) - 1u;
    const int cl = t % J;
    const int row = t / J;
    const bool active = cl < jg;
    const int RC = R * C;  // floats between a consumer's steps
    // pixel q = i * W + j advances by R a step: carry (i, j) by adds
    const int di = R / W;
    const int dj = R - di * W;
    int q = p_lo + row;
    int i = q / W;
    int j = q - i * W;
    bar_wait(wbar, 0);
    const float2 bb = kColumn ? sBB[j] : make_float2(0.f, 0.f);
    float m = -INFINITY, s0 = 0.f, sr = 0.f, sc = 0.f;
    const float past = scale > 0.f ? -INFINITY : INFINITY;

    for (int n = 0; n < nchunks; ++n) {
      const int s = n % stages;
      const Chunk ch = chunk(n);
      const int q0 = p_lo + n * P;
      const int q1 = min(q0 + P, p_hi);
      const float* buf = ring + s * slot + ch.lead;
      bar_wait(&full[s], (n / stages) & 1);
      if (active) {
        const int l0 = (q - q0) * C + c0 + cl;
        // steps of this consumer inside the chunk, and whether they all
        // lie in the copied body (then no test a logit)
        const int nv = min(kSteps, max(0, (q1 - q + R - 1) / R));
        float v[kSteps];  // raw logits; past the chunk, ones that scale to -inf
        if (nv == kSteps && l0 >= ch.head &&
            l0 + (kSteps - 1) * RC < ch.head + ch.body) {
#pragma unroll
          for (int u = 0; u < kSteps; ++u) v[u] = buf[l0 + u * RC];
        } else {
#pragma unroll
          for (int u = 0; u < kSteps; ++u) {
            const int l = l0 + u * RC;
            v[u] = u >= nv ? past
                   : (l >= ch.head && l < ch.head + ch.body)
                       ? buf[l]
                       : __ldg(x + ch.ga + l);
          }
        }
        float mc = v[0] * scale;
#pragma unroll
        for (int u = 1; u < kSteps; ++u) mc = fmaxf(mc, v[u] * scale);
        if (mc > m) {
          const float f = ex2(m - mc);  // 0 on the first chunk
          s0 *= f;
          sr *= f;
          sc *= f;
          m = mc;
        }
        // the chunk's sums start from 0 and join the running sums once:
        // a consumer's float32 rounding grows with sqrt(steps) +
        // sqrt(chunks), not sqrt(steps * chunks)
        float t0 = 0.f, tr = 0.f, tc = 0.f;
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          if (u < nv) {
            // one rounding of scale * x - m: near the max, where the
            // weight is, the exponent keeps its low bits (a rounded
            // scale * x below 64 is off by up to 2^-19)
            const float e = ex2(fmaf(v[u], scale, -m));
            const float2 aa = sAA[i];  // (A(i), Ar(i))
            if (kColumn) {
              t0 = fmaf(e, aa.x, t0);
              tr = fmaf(e, aa.y, tr);
            } else {
              const float2 bj = sBB[j];
              const float ea = e * aa.x;
              t0 = fmaf(ea, bj.x, t0);
              tc = fmaf(ea, bj.y, tc);
              tr = fmaf(e * aa.y, bj.x, tr);
            }
          }
          i += di;
          if (!kColumn) {
            j += dj;
            if (j >= W) {
              j -= W;
              ++i;
            }
          }
        }
        s0 += t0;
        sr += tr;
        sc += tc;
        q += P;
      }
      __syncwarp(wmask);
      if (lane == 0) bar_arrive(&empty[s]);
    }
    mine = kColumn ? Acc{m, bb.x * s0, bb.x * sr, bb.y * s0}
                   : Acc{m, s0, sr, sc};
  }

  // partials: warp shuffles over the R consumers of each joint, through
  // one float4 a consumer in the (now idle) ring
  __syncthreads();
  float4* red = reinterpret_cast<float4*>(ring);
  if (t >= 0) red[t] = make_float4(mine.m, mine.s0, mine.sr, mine.sc);
  __syncthreads();
  if (T < 32) {
    if (t >= 0 && t < jg) {
      Acc a = as_acc(red[t]);
      for (int r = 1; r < R; ++r) merge(a, as_acc(red[r * J + t]));
      part[t] = make_float4(a.m, a.s0, a.sr, a.sc);
    }
  } else if (t >= 0 && (t >> 5) < T / 32) {  // full consumer warps
    const int fw = T / 32;
    for (int c = t >> 5; c < jg; c += fw) {
      Acc a = {-INFINITY, 0.f, 0.f, 0.f};
      for (int r = lane; r < R; r += 32) merge(a, as_acc(red[r * J + c]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const Acc o = {__shfl_xor_sync(0xffffffffu, a.m, off),
                       __shfl_xor_sync(0xffffffffu, a.s0, off),
                       __shfl_xor_sync(0xffffffffu, a.sr, off),
                       __shfl_xor_sync(0xffffffffu, a.sc, off)};
        merge(a, o);
      }
      if (lane == 0) part[c] = make_float4(a.m, a.s0, a.sr, a.sc);
    }
  }
  __syncthreads();

  // the other ranks push their partials into rank 0's shared memory and
  // arrive on its mbarrier; rank 0 waits for them and merges
  Acc a = {-INFINITY, 0.f, 0.f, 0.f};
  if (k > 1) {
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
    if (rank != 0) {
      if (t >= 0 && t < jg) {
        cluster.map_shared_rank(part, 0)[rank * J + t] = part[t];
        uint32_t remote;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                     : "=r"(remote)
                     : "r"(smem_addr(mbar)), "r"(0));
        asm volatile(
            "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::
                "r"(remote)
            : "memory");
      }
      return;
    }
  }
  if (t >= 0 && t < jg) {
    a = as_acc(part[t]);
    if (k > 1) {
      const uint32_t mb = smem_addr(mbar);
      uint32_t done;
      do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
            "0;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(mb)
            : "memory");
      } while (!done);
      for (int r = 1; r < k; ++r) merge(a, as_acc(part[r * J + t]));
    }
  }

  if (t >= 0 && t < jg) {
    const long long b = blockIdx.z;
    const int c = c0 + t;
    const float mr = a.sr / a.s0;
    const float mcl = a.sc / a.s0;
    mu[(b * C + c) * 2] = mr;
    mu[(b * C + c) * 2 + 1] = mcl;
    const int r0 = min(max((int)floorf(mr), 0), H - 1);
    const int q0 = min(max((int)floorf(mcl), 0), W - 1);
    const int r1 = min(r0 + 1, H - 1);
    const int q1 = min(q0 + 1, W - 1);
    const float* xm = x + base + c;
    const float best = fmaxf(
        fmaxf(xm[((long long)r0 * W + q0) * C], xm[((long long)r0 * W + q1) * C]),
        fmaxf(xm[((long long)r1 * W + q0) * C], xm[((long long)r1 * W + q1) * C]));
    lik[b * C + c] = 1.f / (1.f + expf(-best));
  }
}

using KernelFn = void (*)(const float*, const float*, float*, float*, int, int,
                          int, int, int, int, float);

// the instantiations, by (steps 4 / 8 / 16, column)
const KernelFn kKernels[3][2] = {
    {softargmax_likelihood_kernel<4, false>,
     softargmax_likelihood_kernel<4, true>},
    {softargmax_likelihood_kernel<8, false>,
     softargmax_likelihood_kernel<8, true>},
    {softargmax_likelihood_kernel<16, false>,
     softargmax_likelihood_kernel<16, true>}};
int smem_set[3][2] = {};  // dynamic shared memory allowed so far

}  // namespace

// Floats of one ring slot: `steps` rows of threads / J pixels of C floats,
// plus the alignment lead, rounded to 16 bytes.
static long long slot_floats(int C, int J, int threads, int steps) {
  return ((long long)steps * (threads / J) * C + 7) & ~3LL;
}

// Dynamic shared memory of a launch, in bytes (the wrapper's smem_bytes):
// the barriers, the ring, the weight vectors and the per-joint partials.
static long long smem_bytes(int H, int W, int C, int J, int threads,
                            int stages, int steps, int cluster) {
  const long long floats = stages * slot_floats(C, J, threads, steps) +
                           2LL * (H + W);
  return kBarBytes + 4 * ((floats + 3) & ~3LL) + 16LL * J * cluster;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// Grid (cluster, ceil(C / J), B) in clusters of (cluster, 1, 1); a CTA is
// a producer warp and `threads` consumers, a multiple of J; where threads / J
// is a multiple of W it runs the column kernel. `weights` (16-byte aligned)
// holds the pairs (A(i), Ar(i)) for i < H, then (B(j), Bc(j)) for j < W,
// zero-padded to a multiple of 4 floats.
extern "C" int softargmax_likelihood_launch(
    const float* x, const float* weights, float* mu, float* lik, int B, int H,
    int W, int C, int J, int threads, int cluster, int stages, int steps,
    float gamma, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || J <= 0 ||
      J > C || threads < J || threads % J != 0 || threads > kMaxConsumers ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      stages < 1 || stages > kMaxStages ||
      (steps != 4 && steps != 8 && steps != 16) ||
      (long long)H * W * C > 0x7fffffffLL ||
      (C + J - 1) / J > 65535 ||
      (reinterpret_cast<uintptr_t>(x) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(weights) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long smem =
      smem_bytes(H, W, C, J, threads, stages, steps, cluster);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int si = steps == 4 ? 0 : steps == 8 ? 1 : 2;
  const int ci = (threads / J) % W == 0;  // one pixel column a consumer
  const KernelFn fn = kKernels[si][ci];
  if (smem > 48 * 1024 && smem > smem_set[si][ci]) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[si][ci] = (int)smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (C + J - 1) / J, B);
  cfg.blockDim = dim3(threads + 32);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float scale = gamma * 1.4426950408889634f;  // log2(e)
  const int slot = (int)slot_floats(C, J, threads, steps);
  cudaError_t err = cudaLaunchKernelEx(&cfg, fn, x, weights, mu, lik, H, W, C,
                                       J, stages, slot, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
