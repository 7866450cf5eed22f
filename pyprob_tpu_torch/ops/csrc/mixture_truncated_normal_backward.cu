// Mixture-of-truncated-Normals log-density, backward.
//
// Replaces the custom VJP of `pyprob_tpu/ops/kernels.py:275` (`_mt_bwd`:
// the VJP of `_mixture_tnorm_ref` behind
// `mixture_truncated_normal_log_prob_fused`, with a non-finite cotangent
// taken as 0 and every non-finite gradient set to 0), which the IC
// training loss reaches through the Uniform prior's proposal head.  Per
// row b and component k, with the forward's alpha_k, beta_k, xi_k and
// terms t_k, phi the standard Normal density, Z_k = Phi(beta_k) -
// Phi(alpha_k) unclipped,
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
// out, g and the three parameter arrays) and writes 12K + 12; at B =
// 2^18, K = 10 that is 71.3 MB, about 21 us at 3.35 TB/s, for ~80
// operations per component (two erff, two logf, three expf), about 3 us
// at the card's float32 rate.  At the rows a training step launches it
// with (256, K = 10) the bound is 0.02 us: there a launch costs its
// latency, not its bytes.
//
// Design: the mixture-of-Normals backward's.  One lane per component: a
// row's K components lie on S = min(K, 32) consecutive lanes of a warp,
// 32 / S rows a warp (three at K = 10, 30 of 32 lanes busy), and lane j
// of a row takes components j, j + S, ....  Each lane reads its
// components straight from device memory (a warp's lanes touch
// consecutive addresses, so the loads and stores are coalesced as they
// are, with no staging in shared memory) and issues all its loads before
// any arithmetic uses them; x, low, high, out and g are one address for
// the row's lanes (a broadcast: read once per row).  Each component is one
// short chain (the cotangent's filter sits after the loads, so it does not
// hold them back).  dx, dlow and dhigh are three trees of shuffles down
// the row's lanes, interleaved, in a fixed order that leaves the row's
// sums in its lane 0, which writes them: no atomics.  The block halves
// from 256 threads until the grid covers the card's SMs, so a 256-row
// launch at K = 10 runs 86 one-warp blocks on as many SMs, where one
// thread a row made it one block on one SM, its K components a serial
// chain.  At 2^18 rows the launch is bound by the issue rate of its
// arithmetic (eight IEEE divisions, each a reciprocal, its refinement and
// a check with a slow path, two erff, two logf, three expf), not by its
// bytes; rows packed on K lanes, not on groups of the next power of two
// >= K with 6 of 16 lanes idle at K = 10, keep every issued lane busy
// (PERF.md).  IEEE division, erff, expf and logf (no fast math): the same
// rounding per component as the plain version's expressions.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mixture_lanes.cuh"

namespace {

constexpr float kLogSqrt2Pi = 0.91893853320467274178f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;
// 1/sqrt 2 as float(1) / float(sqrt 2): the plain version's product
constexpr float kInvSqrt2 = 1.0f / 1.41421356237309504880f;
using mixture_lanes::kMaxThreads;

__device__ __forceinline__ float ndtr(float z) {
  return 0.5f * (1.0f + erff(z * kInvSqrt2));
}

__device__ __forceinline__ float finite_or_zero(float v) {
  return isfinite(v) ? v : 0.0f;
}

__global__ void __launch_bounds__(kMaxThreads) mixture_truncated_normal_log_prob_backward_kernel(
    const float* __restrict__ x, const float* __restrict__ means,
    const float* __restrict__ stddevs, const float* __restrict__ logits,
    const float* __restrict__ low, const float* __restrict__ high,
    const float* __restrict__ out, const float* __restrict__ g,
    float* __restrict__ dx, float* __restrict__ dmeans,
    float* __restrict__ dstddevs, float* __restrict__ dlogits,
    float* __restrict__ dlow, float* __restrict__ dhigh, int64_t B,
    int64_t K) {
  const int S = K < 32 ? static_cast<int>(K) : 32;  // lanes a row
  const int lane = static_cast<int>(threadIdx.x % 32);
  const int seg = lane / S;  // the warp's row this lane works on
  const int j = lane - seg * S;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int64_t row = warp * (32 / S) + seg;
  const bool live = seg < 32 / S && row < B;
  // this lane's shares of the three per-row sums
  float sum_dx = 0.0f, sum_dlow = 0.0f, sum_dhigh = 0.0f;
  if (live) {
    // ---- load: the row's scalars, then this lane's components
    const float xv = x[row];
    const float lo = low[row];
    const float hi = high[row];
    const float o = out[row];
    const float graw = g[row];
    for (int64_t k = row * K + j; k < (row + 1) * K; k += S) {
      const float mk = means[k];
      const float sdk = stddevs[k];
      const float lk = logits[k];
      // ---- compute
      const float gv = isfinite(graw) && xv >= lo && xv <= hi ? graw : 0.0f;
      const float alpha = (lo - mk) / sdk;
      const float beta = (hi - mk) / sdk;
      const float zraw = ndtr(beta) - ndtr(alpha);
      const float z = zraw < 1e-12f ? 1e-12f : zraw;
      const float xi = (xv - mk) / sdk;
      const float t = -0.5f * xi * xi - kLogSqrt2Pi - logf(sdk) - logf(z) + lk;
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
      // ---- store
      dlogits[k] = finite_or_zero(r);
      dmeans[k] = finite_or_zero(dm);
      dstddevs[k] = finite_or_zero(ds);
    }
  }
  // ---- the row's sums down its lanes (every lane of the warp takes part)
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2) {
    if (offset < S) {  // the same for the whole warp
      const float other_dx = __shfl_down_sync(0xffffffffu, sum_dx, offset);
      const float other_dlow = __shfl_down_sync(0xffffffffu, sum_dlow, offset);
      const float other_dhigh = __shfl_down_sync(0xffffffffu, sum_dhigh, offset);
      if (j + offset < S) {
        sum_dx += other_dx;
        sum_dlow += other_dlow;
        sum_dhigh += other_dhigh;
      }
    }
  }
  if (live && j == 0) {
    if (dx != nullptr) dx[row] = finite_or_zero(-sum_dx);
    if (dlow != nullptr) dlow[row] = finite_or_zero(sum_dlow);
    if (dhigh != nullptr) dhigh[row] = finite_or_zero(-sum_dhigh);
  }
}

}  // namespace

// Returns a cudaError_t.
extern "C" int pyprob_mixture_truncated_normal_log_prob_backward_f32(
    const float* x, const float* means, const float* stddevs,
    const float* logits, const float* low, const float* high,
    const float* out, const float* g, float* dx, float* dmeans,
    float* dstddevs, float* dlogits, float* dlow, float* dhigh, int64_t B,
    int64_t K, int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t lanes = mixture_lanes::lane_threads(B, K);
  const int threads = mixture_lanes::block_threads(lanes, sms);
  const int64_t blocks = (lanes + threads - 1) / threads;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  mixture_truncated_normal_log_prob_backward_kernel<<<
      static_cast<unsigned>(blocks), threads, 0,
      static_cast<cudaStream_t>(stream)>>>(
      x, means, stddevs, logits, low, high, out, g, dx, dmeans, dstddevs,
      dlogits, dlow, dhigh, B, K);
  return static_cast<int>(cudaGetLastError());
}
