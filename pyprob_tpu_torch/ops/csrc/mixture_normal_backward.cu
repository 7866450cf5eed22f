// Mixture-of-Normals log-density, backward.
//
// Replaces the custom VJP of `pyprob_tpu/ops/kernels.py:255`
// (`_mn_bwd`, the VJP of `_mixture_normal_ref` behind
// `mixture_normal_log_prob_fused`), which the IC training loss reaches
// through the proposal head's mixture.  Per row b and component k, with
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
// the three parameter arrays) and writes 12K (+4 for dx); at B = 2^18,
// K = 10 that is 67 MB, about 20 us at 3.35 TB/s, for ~25 operations and
// 2 transcendentals per component.  At the rows a training step launches
// it with (256 or 512, K = 10) the bound is under 0.04 us: there a launch
// costs its latency, not its bytes.
//
// Design: one lane per component.  A row's K components lie on S = min(K,
// 32) consecutive lanes of a warp, 32 / S rows a warp (three at K = 10, 30
// of 32 lanes busy); lane j of a row takes components j, j + S, ..., so
// any K >= 1 works.  Each lane reads its components straight from device
// memory: a warp's lanes touch consecutive addresses of the row-major
// [B, K] arrays, so the loads and stores are coalesced as they are, with
// no staging in shared memory, and a lane issues all its loads before any
// arithmetic uses them.  The row's scalars x, out and g are one address
// for the row's lanes (a broadcast: read once per row).  Each component is
// one short chain; nothing is serial over K below K = 33.  dx is a tree of
// shuffles down the row's lanes in a fixed order (lane j adds lane j +
// offset while that lane is the row's, offsets 16, 8, ..., 1), which
// leaves the row's sum in its lane 0, which writes it: no atomics.  The
// block halves from 256 threads until the grid covers the card's SMs, so
// a 256-row launch at K = 10 runs 86 one-warp blocks on as many SMs,
// where one thread a row made it one block on one SM, its rows staged
// through shared memory in a loop of dependent loads.  Rows packed on K
// lanes rather than groups of the next power of two >= K lanes (G = 16 at
// K = 10), which leave 6 of 16 lanes idle: at 2^18 rows, where the launch
// is bound by the issue rate of its arithmetic and not by its bytes, the
// idle lanes cost time (PERF.md).  IEEE division, expf and logf, no fast
// math: the same rounding per component as the plain version's
// expressions.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mixture_lanes.cuh"

namespace {

constexpr float kLogSqrt2Pi = 0.91893853320467274178f;
using mixture_lanes::kMaxThreads;

__global__ void __launch_bounds__(kMaxThreads) mixture_normal_log_prob_backward_kernel(
    const float* __restrict__ x, const float* __restrict__ means,
    const float* __restrict__ stddevs, const float* __restrict__ logits,
    const float* __restrict__ out, const float* __restrict__ g,
    float* __restrict__ dx, float* __restrict__ dmeans,
    float* __restrict__ dstddevs, float* __restrict__ dlogits, int64_t B,
    int64_t K) {
  const int S = K < 32 ? static_cast<int>(K) : 32;  // lanes a row
  const int lane = static_cast<int>(threadIdx.x % 32);
  const int seg = lane / S;  // the warp's row this lane works on
  const int j = lane - seg * S;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int64_t row = warp * (32 / S) + seg;
  const bool live = seg < 32 / S && row < B;
  float sum_dmean = 0.0f;  // this lane's share of sum_k d mean_k
  if (live) {
    // ---- load: the row's scalars, then this lane's components
    const float xv = x[row];
    const float o = out[row];
    const float gv = g[row];
    for (int64_t k = row * K + j; k < (row + 1) * K; k += S) {
      const float mk = means[k];
      const float sdk = stddevs[k];
      const float lk = logits[k];
      // ---- compute
      const float z = (xv - mk) / sdk;
      const float t = -0.5f * z * z - logf(sdk) - kLogSqrt2Pi + lk;
      const float gr = gv * expf(t - o);
      const float dm = gr * z / sdk;
      const float ds = gr * (z * z - 1.0f) / sdk;
      sum_dmean += dm;
      // ---- store
      dlogits[k] = gr;
      dmeans[k] = dm;
      dstddevs[k] = ds;
    }
  }
  // ---- the row's sum down its lanes (every lane of the warp takes part)
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2) {
    if (offset < S) {  // the same for the whole warp
      const float other = __shfl_down_sync(0xffffffffu, sum_dmean, offset);
      if (j + offset < S) sum_dmean += other;
    }
  }
  if (dx != nullptr && live && j == 0) dx[row] = -sum_dmean;
}

}  // namespace

// Returns a cudaError_t.
extern "C" int pyprob_mixture_normal_log_prob_backward_f32(
    const float* x, const float* means, const float* stddevs,
    const float* logits, const float* out, const float* g, float* dx,
    float* dmeans, float* dstddevs, float* dlogits, int64_t B, int64_t K,
    int64_t device, void* stream) {
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
  mixture_normal_log_prob_backward_kernel<<<
      static_cast<unsigned>(blocks), threads, 0,
      static_cast<cudaStream_t>(stream)>>>(
      x, means, stddevs, logits, out, g, dx, dmeans, dstddevs, dlogits, B, K);
  return static_cast<int>(cudaGetLastError());
}
