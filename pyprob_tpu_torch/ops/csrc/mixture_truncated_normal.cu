// Mixture-of-truncated-Normals log-density, forward.
//
// Replaces the Pallas kernel `_mixture_tnorm_kernel` behind
// `pyprob_tpu/ops/kernels.py:mixture_truncated_normal_log_prob`, the
// density of the Uniform prior's proposal head.  Per row b, with
//   alpha_k = (low - mean_k) / sd_k,  beta_k = (high - mean_k) / sd_k,
//   Z_k = max(Phi(beta_k) - Phi(alpha_k), 1e-12),  xi_k = (x - mean_k) / sd_k,
//   t_k = -xi_k^2/2 - log(2 pi)/2 - log sd_k - log Z_k + logit_k:
//   out[b] = logsumexp_k t_k  if low <= x <= high,  -inf otherwise
// (NaN x is outside too).  x, low, high, out: [B]; means, stddevs,
// logits: [B, K], row-major, float32.  The logsumexp has the reference's
// semantics (torch.logsumexp and jax.scipy.special.logsumexp): with m the
// row's max, NaN if any term is NaN, the shift is m, or 0 where m is
// +-inf, and the logsumexp is shift + log sum_k exp(t_k - shift); a row
// with a +inf term and no NaN gives +inf.  Phi(z) = (1 + erf(z / sqrt 2))
// / 2 with the IEEE erff and z / sqrt 2 taken as z * (1 / sqrt 2), as the
// plain PyTorch version computes it (torch.erf is erff on CUDA), so the
// cancellation in Phi(beta) - Phi(alpha) near 1 is the same in both; the
// TPU kernel's rational erf approximation (Pallas has no erf) is not
// carried over.
//
// Bound on an H100: memory.  A row reads 12 + 3*4K bytes and writes 4; at
// the serving chunk of B = 2^18, K = 10 that is 35.7 MB, 10.6 us at 3.35
// TB/s, for ~60 operations per component (two erff, two logf, one expf),
// about 2 us at the card's float32 rate.  At the rows a training step
// launches it with (256, K = 10) the bound is 0.010 us: there a launch
// costs its latency (the launch floor is 1.75 us, PERF.md), not its bytes.
//
// Design: the mixture-of-Normals forward's two mappings
// (mixture_normal.cu).  Below kThreadRowsFrom rows (mixture_lanes.cuh;
// the training step's 256), a row's K components lie on S = min(K, 32)
// consecutive lanes of a warp, 32 / S rows a warp (three at K = 10), lane
// j of a row takes components j, j + S, ...; each lane reads its
// components straight from device memory, coalesced across the warp, and
// issues all its loads before any arithmetic uses them; x, low and high
// are one address for the row's lanes (a broadcast).  Every row reads its
// parameters, also a row whose x lies outside [low, high]: a load that
// waited on the bounds check would put a second round of load latency
// into every launch.  The logsumexp is mixture_lanes::fold_chunk: a
// max.NaN scan up the row's lanes gives each term the running max before
// it, each lane takes its exp, and the row's lanes apply the exps in
// component order with the operations of one thread folding the row, so a
// row of finite (or -inf) terms gives bit for bit what one thread a row
// gives, and a training step's loss keeps the bits it had before the
// lanes (the trees of the reference's form moved the trained Marsaglia
// network chip_smoke.py judges, PERF.md); a NaN or +inf term writes the
// scan's max (NaN; +inf where no term is NaN), and the row's lane 0 writes
// -inf where x lies outside.  For K > 32 the components go in chunks of
// 32, each folded into the running max and sum.  The block halves from
// 256 threads until the grid covers the card's SMs, so a 256-row launch
// runs 86 one-warp blocks on as many SMs, where one thread a row made it
// one block on one SM, each thread a serial chain over K of two erff, two
// logf, three divisions and an expf a component.  From kThreadRowsFrom
// rows on (the serving rounds, up to 2^18 rows), one thread a row: there
// the launch is bound by its issue rate, and the lanes' work a warp beside
// the component (index arithmetic, the scan and shuffles, the final log)
// for three rows costs more than one thread's chain for a whole row.  IEEE
// division, erff, expf and logf (no fast math): the same rounding per
// component as the plain version's expressions.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; profile_mixture_forward.py,
// PERF.md): 2.92 us at 256 rows (one thread a row before: 6.59; the launch
// floor 1.88), every output on random finite rows bit for bit the earlier
// kernel's; at 2^18 rows the lanes take 45.5 us, one thread a row 24.0
// (before: 23.9).  The mappings cross between 24,576 and 28,672 rows.
// Dropped after measuring, at 2^18 rows: the term through tnorm_term,
// whose call reads the logit before the arithmetic (24.7-24.9 us); the
// grid capped at 6 blocks an SM, which helps kernel 1 (25.9 us).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mixture_lanes.cuh"

namespace {

using mixture_lanes::kMaxThreads;
using mixture_lanes::kThreadRowsFrom;
using mixture_lanes::RowLanes;

constexpr float kLogSqrt2Pi = 0.91893853320467274178f;
// 1/sqrt 2 as float(1) / float(sqrt 2): the plain version's product
constexpr float kInvSqrt2 = 1.0f / 1.41421356237309504880f;

__device__ __forceinline__ float ndtr(float z) {
  return 0.5f * (1.0f + erff(z * kInvSqrt2));
}

__device__ __forceinline__ float tnorm_term(float xv, float lo, float hi, float mk,
                                            float sdk, float lk) {
  const float zraw = ndtr((hi - mk) / sdk) - ndtr((lo - mk) / sdk);
  const float z = zraw < 1e-12f ? 1e-12f : zraw;  // NaN stays NaN, as clamp
  const float xi = (xv - mk) / sdk;
  return -0.5f * xi * xi - kLogSqrt2Pi - logf(sdk) - logf(z) + lk;
}

__global__ void __launch_bounds__(kMaxThreads) mixture_truncated_normal_log_prob_kernel(
    const float* __restrict__ x, const float* __restrict__ means,
    const float* __restrict__ stddevs, const float* __restrict__ logits,
    const float* __restrict__ low, const float* __restrict__ high,
    float* __restrict__ out, int64_t B, int64_t K) {
  const RowLanes r(B, K);
  float xv = 0.0f, lo = 0.0f, hi = 0.0f;
  float m = -INFINITY;  // the row's running max
  float s = 0.0f;       // the row's sum of exp(term - m)
  for (int64_t c = 0; c < K; c += r.S) {  // one chunk for K <= 32
    float t = -INFINITY;
    if (r.live && c + r.j < K) {
      // ---- load: the row's x, low and high, then this lane's component of the chunk
      const int64_t at = r.row * K + c + r.j;
      xv = x[r.row];
      lo = low[r.row];
      hi = high[r.row];
      const float mk = means[at];
      const float sdk = stddevs[at];
      const float lk = logits[at];
      // ---- compute: the term, then the chunk folded into the row's m and s
      t = tnorm_term(xv, lo, hi, mk, sdk, lk);
    }
    mixture_lanes::fold_chunk(t, static_cast<int>(K - c < r.S ? K - c : r.S), r, m, s);
  }
  // ---- store: -inf where x lies outside [low, high] (NaN x too)
  if (r.live && r.j == 0)
    out[r.row] = xv >= lo && xv <= hi ? mixture_lanes::row_logsumexp(m, s) : -INFINITY;
}

// One thread a row, from kThreadRowsFrom rows on: the K components a
// serial chain with an online max and sum, as in mixture_normal.cu, its
// term written out so that the logit is read last; a row outside [low,
// high] writes -inf without reading its parameters.
__global__ void mixture_truncated_normal_log_prob_rows_kernel(
    const float* __restrict__ x, const float* __restrict__ means,
    const float* __restrict__ stddevs, const float* __restrict__ logits,
    const float* __restrict__ low, const float* __restrict__ high,
    float* __restrict__ out, int64_t B, int64_t K) {
  const int64_t row = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (row >= B) return;
  const float xv = x[row];
  const float lo = low[row];
  const float hi = high[row];
  if (!(xv >= lo && xv <= hi)) {
    out[row] = -INFINITY;
    return;
  }
  const float* mu = means + row * K;
  const float* sd = stddevs + row * K;
  const float* lg = logits + row * K;
  float m = -INFINITY;  // the running max: the shift of s while finite
  float s = 0.0f;       // the sum of exp(term - m)
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
      // a second +inf term adds exp(0) = 1, not exp(inf - inf); NaN
      // propagates
      s += expf(t == m ? 0.0f : t - m);
    }
  }
  // the shift is 0 where no term is above -inf: -inf, or NaN after a NaN
  out[row] = (m == -INFINITY ? 0.0f : m) + logf(s);
}

}  // namespace

// Returns a cudaError_t.
extern "C" int pyprob_mixture_truncated_normal_log_prob_f32(
    const float* x, const float* means, const float* stddevs,
    const float* logits, const float* low, const float* high, float* out,
    int64_t B, int64_t K, int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool by_rows = B >= kThreadRowsFrom;
  // the threads to launch: one a row, or a warp for each 32 / S rows
  const int64_t n = by_rows ? B : mixture_lanes::lane_threads(B, K);
  const int threads = mixture_lanes::block_threads(n, sms);
  const int64_t blocks = (n + threads - 1) / threads;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (by_rows) {
    mixture_truncated_normal_log_prob_rows_kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        x, means, stddevs, logits, low, high, out, B, K);
  } else {
    mixture_truncated_normal_log_prob_kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        x, means, stddevs, logits, low, high, out, B, K);
  }
  return static_cast<int>(cudaGetLastError());
}
