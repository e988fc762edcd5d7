// Fused soft-argmax decode + 2x2 max-sigmoid likelihood for Hopper (sm_90a).
//
// Replaces the TPU kernel deepgraphpose_tpu/ops/pallas/softargmax_kernel.py
// (_softargmax_pallas_fwd_impl / _kernel), and fuses the likelihood read of
// deepgraphpose_tpu/infer/predict.py:51-64 into the same pass.
//
// Input:  logits x (B, H, W, C) float32, NHWC contiguous (the part_pred head
//         as the port produces it; no transpose to (B*C, H, W) first).
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
// likewise over W. The host builds [A, Ar, B, Bc] once per (H, W, sigma,
// truncate) (ops/softargmax.py::smoothing_weights).
//
// Bound. Each logit is read once and the outputs written once: at the main
// path's B=128, 94x104, C=5 that is 25.0 MB, ~7.5 us at 3.35 TB/s. The
// arithmetic is an exp and a few multiply-adds per logit. What held a first
// version (4 loads in flight per thread) at 4.5x the bound was loads in
// flight, not instructions: taking out its integer divide per logit gained
// 5-7%, while 16 loads per step, with the next step's loads issued before
// this step's arithmetic, made it 1.6x faster (PERF.md, timed by
// chip_smoke.py). The loop carries (row, col) by adds, and the exp is an
// exp2 of a pre-scaled logit.
//
// Layout. The grid is (joint groups, frames); a block owns one frame and J
// consecutive joints; thread t keeps joint c0 + t % J for its whole life and
// walks pixels t / J, t / J + rows, ..., rows = threads / J. The wrapper
// launches J = C (ops/kernels/softargmax_kernel.py::launch_shape), so a
// block holds whole pixels and a warp reads 32 contiguous floats per load;
// J < C, which splits a frame's joints over blocks, measured slower at the
// main path's maps. The max is an online rescale, so the map is read from
// memory once. Partial (max, S0, Sr, Sc) tuples merge through a
// shared-memory tree.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kUnroll = 16;
constexpr int kMaxThreads = 1024;

struct Acc {
  float m, s0, sr, sc;  // m is a max of log2-scaled logits
};

__device__ __forceinline__ void merge(Acc& a, const Acc& b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return;  // both empty
  const float fa = (a.m == -INFINITY) ? 0.f : exp2f(a.m - m);
  const float fb = (b.m == -INFINITY) ? 0.f : exp2f(b.m - m);
  a.s0 = a.s0 * fa + b.s0 * fb;
  a.sr = a.sr * fa + b.sr * fb;
  a.sc = a.sc * fa + b.sc * fb;
  a.m = m;
}

// scale = gamma * log2(e), so exp(gamma*x - max) = exp2(scale*x - m).
__global__ void __launch_bounds__(kMaxThreads) softargmax_likelihood_kernel(
    const float* __restrict__ x, const float* __restrict__ weights,
    float* __restrict__ mu, float* __restrict__ lik, int H, int W, int C,
    int J, float scale) {
  extern __shared__ float smem[];
  float* sA = smem;
  float* sAr = sA + H;
  float* sB = sAr + H;
  float* sBc = sB + W;
  float* red = sBc + W;  // 4 * blockDim.x: m, s0, sr, sc

  const int nthreads = blockDim.x;
  const int t = threadIdx.x;
  const int rows = nthreads / J;
  const int cl = t % J;
  const int row = t / J;
  const int c0 = blockIdx.x * J;
  const int jg = min(J, C - c0);  // joints in this group
  const long long b = blockIdx.y;
  const int HW = H * W;

  // Each step a thread loads kUnroll pixels, `rows` apart; the next step's
  // loads are issued before this step's arithmetic, and the first step's
  // are in flight while the weights land in shared memory.
  const bool active = cl < jg;
  const float* xb = x + b * HW * C + c0 + (active ? cl : 0);
  const int step = kUnroll * rows;
  float v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int p = row + u * rows;
    v[u] = active && p < HW ? __ldg(xb + p * C) : 0.f;
  }
  for (int k = t; k < 2 * (H + W); k += nthreads) smem[k] = weights[k];
  __syncthreads();

  Acc acc = {-INFINITY, 0.f, 0.f, 0.f};
  // pixel p = i * W + j advances by `rows` per load: carry (i, j) by adds
  const int di = rows / W;
  const int dj = rows - di * W;
  int i = row / W;
  int j = row - i * W;
  for (int p0 = active ? row : HW; p0 < HW; p0 += step) {
    float nv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + step + u * rows;
      nv[u] = p < HW ? __ldg(xb + p * C) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p0 + u * rows < HW) {
        const float vs = v[u] * scale;
        if (vs > acc.m) {
          const float f = exp2f(acc.m - vs);  // 0 on the first element
          acc.s0 *= f;
          acc.sr *= f;
          acc.sc *= f;
          acc.m = vs;
        }
        const float e = exp2f(vs - acc.m);
        const float ea = e * sA[i];
        const float eb = e * sB[j];
        acc.s0 += ea * sB[j];
        acc.sr += eb * sAr[i];
        acc.sc += ea * sBc[j];
      }
      i += di;
      j += dj;
      if (j >= W) {
        j -= W;
        ++i;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = nv[u];
  }

  red[t] = acc.m;
  red[nthreads + t] = acc.s0;
  red[2 * nthreads + t] = acc.sr;
  red[3 * nthreads + t] = acc.sc;
  __syncthreads();
  int span = 1;
  while (span < rows) span <<= 1;
  for (int s = span >> 1; s > 0; s >>= 1) {
    if (row < s && row + s < rows) {
      const int o = t + s * J;
      Acc a = {red[t], red[nthreads + t], red[2 * nthreads + t],
               red[3 * nthreads + t]};
      const Acc other = {red[o], red[nthreads + o], red[2 * nthreads + o],
                         red[3 * nthreads + o]};
      merge(a, other);
      red[t] = a.m;
      red[nthreads + t] = a.s0;
      red[2 * nthreads + t] = a.sr;
      red[3 * nthreads + t] = a.sc;
    }
    __syncthreads();
  }

  if (row == 0 && cl < jg) {
    const int c = c0 + cl;
    const float s0 = red[nthreads + t];
    const float mr = red[2 * nthreads + t] / s0;
    const float mc = red[3 * nthreads + t] / s0;
    mu[(b * C + c) * 2] = mr;
    mu[(b * C + c) * 2 + 1] = mc;
    const int r0 = min(max((int)floorf(mr), 0), H - 1);
    const int q0 = min(max((int)floorf(mc), 0), W - 1);
    const int r1 = min(r0 + 1, H - 1);
    const int q1 = min(q0 + 1, W - 1);
    const float* xm = x + b * HW * C + c;
    const float best =
        fmaxf(fmaxf(xm[((long long)r0 * W + q0) * C], xm[((long long)r0 * W + q1) * C]),
              fmaxf(xm[((long long)r1 * W + q0) * C], xm[((long long)r1 * W + q1) * C]));
    lik[b * C + c] = 1.f / (1.f + expf(-best));
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `threads` must be a multiple of J; `weights` holds [A(H), Ar(H), B(W), Bc(W)].
extern "C" int softargmax_likelihood_launch(
    const float* x, const float* weights, float* mu, float* lik, int B, int H,
    int W, int C, int J, int threads, float gamma, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || J <= 0 || threads < J ||
      threads % J != 0 || threads > kMaxThreads ||
      (long long)H * W * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((C + J - 1) / J, B);
  const size_t smem = sizeof(float) * (2 * (H + W) + 4 * threads);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        softargmax_likelihood_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const float scale = gamma * 1.4426950408889634f;  // log2(e)
  softargmax_likelihood_kernel<<<grid, threads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      x, weights, mu, lik, H, W, C, J, scale);
  return (int)cudaGetLastError();
}
