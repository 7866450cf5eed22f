// Mixture-of-Normals log-density, backward.
//
// Replaces the custom VJP of `pyprob_tpu/ops/kernels.py:
// mixture_normal_log_prob_fused` (`_mn_bwd`, the VJP of
// `_mixture_normal_ref`), which the IC training loss reaches through the
// proposal head's mixture.  Per row b and component k, with
//   z_k = (x - mean_k) / sd_k,
//   t_k = -z_k^2/2 - log sd_k - log(2 pi)/2 + logit_k,
//   r_k = exp(t_k - out)            (the component's responsibility),
// and g the cotangent of out[b]:
//   d logit_k = g r_k
//   d mean_k  = g r_k z_k / sd_k
//   d sd_k    = g r_k (z_k^2 - 1) / sd_k
//   d x       = -sum_k d mean_k      (only when dx is not null)
// x, out, g, dx: [B]; means, stddevs, logits and their gradients: [B, K],
// row-major, float32.  A degenerate row (out = -inf) gives NaN, as the
// logsumexp backward of PyTorch and of JAX does; a component with logit
// -inf in a finite row gives 0.
//
// Bound on an H100: memory.  A row reads 12 + 12K bytes (x, out, g and
// the three parameter arrays) and writes 12K (+4 for dx); at the serving
// chunk of B = 2^18, K = 10 that is 67 MB, about 20 us at 3.35 TB/s, for
// ~25 operations and 2 transcendentals per component.
//
// Design: one thread per row with the K terms recomputed from the saved
// inputs and out (nothing of the forward is stored but out).  A block's
// rows are one contiguous span of each [B, K] array, so the block first
// copies its spans of means, stddevs and logits into shared memory with
// coalesced loads, each thread then works on its own row there and
// overwrites it in place with the three gradients, and the block copies
// the spans back out with coalesced stores.  Every input byte is read once
// and every output byte written once; a thread's own row, at a stride of
// 4K bytes from its neighbour's, never touches device memory directly
// (a first version that did, reading through L1 and storing row by row,
// took 7x its bound at B = 2^18, K = 10: stores bypass L1, and each warp
// store scattered 32 four-byte writes over 40 sectors).  IEEE expf/logf,
// no fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLogSqrt2Pi = 0.91893853320467274178f;
constexpr int kMaxThreads = 256;
constexpr int64_t kDefaultSmem = 48 * 1024;   // without opt-in
constexpr int64_t kMaxSmem = 227 * 1024;      // a block's most on Hopper

__global__ void mixture_normal_log_prob_backward_kernel(
    const float* __restrict__ x, const float* __restrict__ means,
    const float* __restrict__ stddevs, const float* __restrict__ logits,
    const float* __restrict__ out, const float* __restrict__ g,
    float* __restrict__ dx, float* __restrict__ dmeans,
    float* __restrict__ dstddevs, float* __restrict__ dlogits, int64_t B,
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
    const float o = out[row];
    const float gv = g[row];
    const int64_t r = threadIdx.x * K;
    float sum_dmean = 0.0f;
    for (int64_t k = r; k < r + K; ++k) {
      const float sdk = sd[k];
      const float z = (xv - mu[k]) / sdk;
      const float t = -0.5f * z * z - logf(sdk) - kLogSqrt2Pi + lg[k];
      const float gr = gv * expf(t - o);
      const float dm = gr * z / sdk;
      lg[k] = gr;
      mu[k] = dm;
      sd[k] = gr * (z * z - 1.0f) / sdk;
      sum_dmean += dm;
    }
    if (dx != nullptr) dx[row] = -sum_dmean;
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
extern "C" int pyprob_mixture_normal_log_prob_backward_f32(
    const float* x, const float* means, const float* stddevs,
    const float* logits, const float* out, const float* g, float* dx,
    float* dmeans, float* dstddevs, float* dlogits, int64_t B, int64_t K,
    int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t threads = kMaxThreads;
  while (threads > 32 && 3 * threads * K * 4 > kDefaultSmem) threads -= 32;
  const int64_t smem = 3 * threads * K * 4;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(mixture_normal_log_prob_backward_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (B + threads - 1) / threads;
  mixture_normal_log_prob_backward_kernel<<<
      static_cast<unsigned>(blocks), static_cast<unsigned>(threads),
      static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      x, means, stddevs, logits, out, g, dx, dmeans, dstddevs, dlogits, B, K);
  return static_cast<int>(cudaGetLastError());
}
