// Mixture-of-truncated-Normals log-density, backward.
//
// Replaces the custom VJP of `pyprob_tpu/ops/kernels.py:
// mixture_truncated_normal_log_prob_fused` (`_mt_bwd`: the VJP of
// `_mixture_tnorm_ref` with a non-finite cotangent taken as 0 and every
// non-finite gradient set to 0), which the IC training loss reaches through
// the Uniform prior's proposal head.  Per row b and component k, with the
// forward's alpha_k, beta_k, xi_k and terms t_k, phi the standard Normal
// density, Z_k = Phi(beta_k) - Phi(alpha_k) unclipped,
//   r_k = g exp(t_k - out)      (g the cotangent of out[b], 0 if not finite
//                                or if x lies outside [low, high]),
//   c_k = 1 / (sd_k Z_k), or 0 where Z_k < 1e-12 (the clip's zero slope):
//   d logit_k = r_k
//   d mean_k  = r_k (xi_k / sd_k - (phi(alpha_k) - phi(beta_k)) c_k)
//   d sd_k    = r_k ((xi_k^2 - 1) / sd_k - (alpha_k phi(alpha_k) - beta_k phi(beta_k)) c_k)
//   d x       = -sum_k r_k xi_k / sd_k          (only when dx is not null)
//   d low     =  sum_k r_k phi(alpha_k) c_k     (only when dlow is not null)
//   d high    = -sum_k r_k phi(beta_k) c_k      (only when dhigh is not null)
// each set to 0 where it is not finite (the sums after summing, as the JAX
// VJP sums before its filter).  x, low, high, out, g and their gradients:
// [B]; means, stddevs, logits and their gradients: [B, K], row-major,
// float32.
//
// Bound on an H100: memory.  A row reads 20 + 12K bytes (x, low, high,
// out, g and the three parameter arrays) and writes 12K + 12; at the
// serving chunk of B = 2^18, K = 10 that is 71.3 MB, about 21 us at
// 3.35 TB/s, for ~80 operations per component (two erff, two logf, three
// expf), about 3 us at the card's float32 rate.
//
// Design: the mixture-of-Normals backward's.  One thread per row recomputes
// its K terms from the saved inputs and out.  A block's rows are one
// contiguous span of each [B, K] array, so the block copies its spans of
// means, stddevs and logits into shared memory with coalesced loads, each
// thread overwrites its own row there with the three gradients, and the
// block copies the spans back out with coalesced stores: every input byte
// is read once and every output byte written once, and a thread's row, at
// a stride of 4K bytes from its neighbour's, never meets device memory
// directly (that pattern took 7x its bound in the mixture-of-Normals
// backward).  IEEE division, erff, expf and logf (no fast math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLogSqrt2Pi = 0.91893853320467274178f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;
// 1/sqrt 2 as float(1) / float(sqrt 2): the plain version's product
constexpr float kInvSqrt2 = 1.0f / 1.41421356237309504880f;
constexpr int kMaxThreads = 256;
constexpr int64_t kDefaultSmem = 48 * 1024;   // without opt-in
constexpr int64_t kMaxSmem = 227 * 1024;      // a block's most on Hopper

__device__ __forceinline__ float ndtr(float z) {
  return 0.5f * (1.0f + erff(z * kInvSqrt2));
}

__device__ __forceinline__ float finite_or_zero(float v) {
  return isfinite(v) ? v : 0.0f;
}

__global__ void mixture_truncated_normal_log_prob_backward_kernel(
    const float* __restrict__ x, const float* __restrict__ means,
    const float* __restrict__ stddevs, const float* __restrict__ logits,
    const float* __restrict__ low, const float* __restrict__ high,
    const float* __restrict__ out, const float* __restrict__ g,
    float* __restrict__ dx, float* __restrict__ dmeans,
    float* __restrict__ dstddevs, float* __restrict__ dlogits,
    float* __restrict__ dlow, float* __restrict__ dhigh, int64_t B,
    int64_t K) {
  extern __shared__ float tile[];  // [3][blockDim.x * K]: mean, sd, logit
  const int64_t row0 = blockIdx.x * static_cast<int64_t>(blockDim.x);
  const int64_t rows = B - row0 < blockDim.x ? B - row0 : blockDim.x;
  const int64_t n = rows * K;
  const int64_t span = static_cast<int64_t>(blockDim.x) * K;
  const int64_t base = row0 * K;
  float* mu = tile;
  float* sd = tile + span;
  float* lg = tile + 2 * span;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    mu[i] = means[base + i];
    sd[i] = stddevs[base + i];
    lg[i] = logits[base + i];
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    const int64_t row = row0 + threadIdx.x;
    const float xv = x[row];
    const float lo = low[row];
    const float hi = high[row];
    const float o = out[row];
    float gv = g[row];
    if (!isfinite(gv) || !(xv >= lo && xv <= hi)) gv = 0.0f;
    const int64_t r0 = threadIdx.x * K;
    float sum_dx = 0.0f, sum_dlow = 0.0f, sum_dhigh = 0.0f;
    for (int64_t k = r0; k < r0 + K; ++k) {
      const float sdk = sd[k];
      const float mk = mu[k];
      const float alpha = (lo - mk) / sdk;
      const float beta = (hi - mk) / sdk;
      const float zraw = ndtr(beta) - ndtr(alpha);
      const float z = zraw < 1e-12f ? 1e-12f : zraw;
      const float xi = (xv - mk) / sdk;
      const float t = -0.5f * xi * xi - kLogSqrt2Pi - logf(sdk) - logf(z) + lg[k];
      const float r = gv * expf(t - o);
      const float pa = expf(-0.5f * alpha * alpha) * kInvSqrt2Pi;
      const float pb = expf(-0.5f * beta * beta) * kInvSqrt2Pi;
      const float sz = zraw >= 1e-12f ? sdk * zraw : INFINITY;  // c_k = 1/sz
      const float rs = r / sdk;
      const float dm = rs * xi - r * (pa - pb) / sz;
      const float ds = rs * (xi * xi - 1.0f) - r * (alpha * pa - beta * pb) / sz;
      sum_dx += rs * xi;
      sum_dlow += r * pa / sz;
      sum_dhigh += r * pb / sz;
      lg[k] = finite_or_zero(r);
      mu[k] = finite_or_zero(dm);
      sd[k] = finite_or_zero(ds);
    }
    if (dx != nullptr) dx[row] = finite_or_zero(-sum_dx);
    if (dlow != nullptr) dlow[row] = finite_or_zero(sum_dlow);
    if (dhigh != nullptr) dhigh[row] = finite_or_zero(-sum_dhigh);
  }
  __syncthreads();
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    dmeans[base + i] = mu[i];
    dstddevs[base + i] = sd[i];
    dlogits[base + i] = lg[i];
  }
}

}  // namespace

// Returns a cudaError_t; cudaErrorInvalidValue when even a block of 32 rows
// cannot stage its spans (K > 590).
extern "C" int pyprob_mixture_truncated_normal_log_prob_backward_f32(
    const float* x, const float* means, const float* stddevs,
    const float* logits, const float* low, const float* high,
    const float* out, const float* g, float* dx, float* dmeans,
    float* dstddevs, float* dlogits, float* dlow, float* dhigh, int64_t B,
    int64_t K, int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t threads = kMaxThreads;
  while (threads > 32 && 3 * threads * K * 4 > kDefaultSmem) threads -= 32;
  const int64_t smem = 3 * threads * K * 4;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(mixture_truncated_normal_log_prob_backward_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (B + threads - 1) / threads;
  mixture_truncated_normal_log_prob_backward_kernel<<<
      static_cast<unsigned>(blocks), static_cast<unsigned>(threads),
      static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      x, means, stddevs, logits, low, high, out, g, dx, dmeans, dstddevs,
      dlogits, dlow, dhigh, B, K);
  return static_cast<int>(cudaGetLastError());
}
