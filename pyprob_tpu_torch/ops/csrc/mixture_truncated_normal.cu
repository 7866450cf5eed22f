// Mixture-of-truncated-Normals log-density, forward.
//
// Replaces the Pallas kernel `_mixture_tnorm_kernel` behind
// `pyprob_tpu/ops/kernels.py:mixture_truncated_normal_log_prob`, the
// density of the Uniform prior's proposal head.  Per row b, with
//   alpha_k = (low - mean_k) / sd_k,  beta_k = (high - mean_k) / sd_k,
//   Z_k = max(Phi(beta_k) - Phi(alpha_k), 1e-12),  xi_k = (x - mean_k) / sd_k,
//   t_k = -xi_k^2/2 - log(2 pi)/2 - log sd_k - log Z_k + logit_k:
//   out[b] = logsumexp_k t_k  if low <= x <= high,  -inf otherwise.
// x, low, high, out: [B]; means, stddevs, logits: [B, K], row-major,
// float32.  Phi(z) = (1 + erf(z / sqrt 2)) / 2 with the IEEE erff and
// z / sqrt 2 taken as z * (1 / sqrt 2), as the plain PyTorch version
// computes it (torch.erf is erff on CUDA), so the cancellation in
// Phi(beta) - Phi(alpha) near 1 is the same in both; the TPU
// kernel's rational erf approximation (Pallas has no erf) is not carried
// over.
//
// Bound on an H100: memory.  A row reads 12 + 3*4K bytes and writes 4; at
// the serving chunk of B = 2^18, K = 10 that is 35.7 MB, about 10.6 us at
// 3.35 TB/s, for ~60 operations per component (two erff, two logf, one
// expf), about 2 us at the card's float32 rate.
//
// Design: as the mixture-of-Normals forward, one thread per row with an
// online max/sum for the logsumexp, so the [B, K] terms never leave
// registers and every input byte is read once.  The Pallas wrapper pads K
// to 128 lanes and broadcasts low and high to two more [B, K] arrays for
// its (8, 128) tiles; here low and high stay one float per row and there
// is no padding.  A row outside [low, high] writes -inf without reading
// its parameters.  IEEE division, expf and logf (no fast math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLogSqrt2Pi = 0.91893853320467274178f;
// 1/sqrt 2 as float(1) / float(sqrt 2): the plain version's product
constexpr float kInvSqrt2 = 1.0f / 1.41421356237309504880f;
constexpr int kThreads = 256;

__device__ __forceinline__ float ndtr(float z) {
  return 0.5f * (1.0f + erff(z * kInvSqrt2));
}

__global__ void mixture_truncated_normal_log_prob_kernel(
    const float* __restrict__ x, const float* __restrict__ means,
    const float* __restrict__ stddevs, const float* __restrict__ logits,
    const float* __restrict__ low, const float* __restrict__ high,
    float* __restrict__ out, int64_t B, int64_t K) {
  const int64_t row = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (row >= B) return;
  const float xv = x[row];
  const float lo = low[row];
  const float hi = high[row];
  if (!(xv >= lo && xv <= hi)) {  // NaN x is outside too
    out[row] = -INFINITY;
    return;
  }
  const float* mu = means + row * K;
  const float* sd = stddevs + row * K;
  const float* lg = logits + row * K;
  float m = -INFINITY;  // running max
  float s = 0.0f;       // running sum of exp(term - m)
  for (int64_t k = 0; k < K; ++k) {
    const float sdk = sd[k];
    const float mk = mu[k];
    const float zraw = ndtr((hi - mk) / sdk) - ndtr((lo - mk) / sdk);
    const float z = zraw < 1e-12f ? 1e-12f : zraw;  // NaN stays NaN, as clamp
    const float xi = (xv - mk) / sdk;
    const float t = -0.5f * xi * xi - kLogSqrt2Pi - logf(sdk) - logf(z) + lg[k];
    if (t > m) {
      s = s * expf(m - t) + 1.0f;  // expf(-inf) = 0 on the first finite term
      m = t;
    } else if (t != -INFINITY) {
      s += expf(t - m);  // NaN terms propagate, as in logsumexp
    }
  }
  out[row] = (m == -INFINITY) ? -INFINITY : m + logf(s);
}

}  // namespace

extern "C" int pyprob_mixture_truncated_normal_log_prob_f32(
    const float* x, const float* means, const float* stddevs,
    const float* logits, const float* low, const float* high, float* out,
    int64_t B, int64_t K, int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  mixture_truncated_normal_log_prob_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                             static_cast<cudaStream_t>(stream)>>>(
      x, means, stddevs, logits, low, high, out, B, K);
  return static_cast<int>(cudaGetLastError());
}
