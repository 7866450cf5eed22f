// Mixture-of-Normals log-density, forward.
//
// Replaces the Pallas kernel `_mixture_normal_kernel` behind
// `pyprob_tpu/ops/kernels.py:mixture_normal_log_prob`.  Per row b:
//   out[b] = logsumexp_k( -z^2/2 - log sd[b,k] - log(2 pi)/2 + logit[b,k] ),
//   z = (x[b] - mean[b,k]) / sd[b,k].
// x, out: [B]; means, stddevs, logits: [B, K], row-major, float32.  The
// logsumexp has the reference's semantics (torch.logsumexp and
// jax.scipy.special.logsumexp): with m the row's max, NaN if any term is
// NaN, the shift is m, or 0 where m is +-inf, and out = shift +
// log sum_k exp(t_k - shift).  So a row with a +inf term and no NaN gives
// +inf, one whose terms are all -inf gives -inf.
//
// Bound on an H100: memory.  A row reads 4 + 3*4K bytes and writes 4; at
// the serving path's chunk of B = 2^18, K = 10 that is 33.6 MB, 10.0 us at
// 3.35 TB/s, for ~15 operations and 2 transcendentals per component.  At
// the rows a training step launches it with (256 and 512, K = 10) the
// bound is 0.010 and 0.020 us: there a launch costs its latency (the
// launch floor is 1.75 us, PERF.md), not its bytes.
//
// Design: two mappings, by the number of rows.  Below kThreadRowsFrom
// (mixture_lanes.cuh; the rows a training step launches it at: 256 and
// 512), the backward kernel's layout (mixture_normal_backward.cu): a row's
// K components lie on S = min(K, 32) consecutive lanes of a warp, 32 / S
// rows a warp (three at K = 10, 30 of 32 lanes busy), and lane j of a row
// takes components j, j + S, ..., so any K >= 1 works.  Each lane reads its
// components straight from device memory: a warp's lanes touch
// consecutive addresses of the row-major [B, K] arrays, so the loads are
// coalesced as they are, with no staging in shared memory, and a lane
// issues all its loads before any arithmetic uses them; x is one address
// for the row's lanes (a broadcast).  The logsumexp
// (mixture_lanes::fold_chunk) keeps the order and the operations of one
// thread folding the row, this kernel's loop before the lanes: where t >
// m, s = s exp(m - t) + 1 and m = t, else s += exp(t - m).  The running
// max before each term is a scan up the row's lanes with max.NaN (a max
// is exact, so the scan's order does not change its bits), each lane takes
// its own exp at once, and the row's lanes read the exps from lanes 0,
// 1, ... by shuffles and apply them in component order, K dependent adds
// of a few cycles after the shuffles: no atomics, no shared memory.  So a
// row of finite (or -inf) terms gives bit for bit what one thread a row
// gives, and the training path runs the same arithmetic as before the
// lanes.  That is the reason for this order: the two trees of the
// reference's form (the max, then the sum of exp(t - max)) change the
// last bits of a training step's loss, and the trained Marsaglia network
// that chip_smoke.py judges is one chaotic trajectory whose ESS fraction
// fell from 0.039 to 0.0019 under the trees' rounding (PERF.md).  A NaN
// term makes the scan's max NaN, and a +inf term (no NaN) makes it +inf;
// such a row, and a row whose terms are all -inf, writes that max, as the
// reference's logsumexp (torch, jax.scipy) gives it, where the loop alone
// added exp(inf - inf) = NaN for a second +inf term.  For K > 32 the row's
// components go in chunks of 32 in order, each folded into the running
// max and sum (an online pair, no second pass); the training and serving
// paths run K = 10, one chunk.  The block halves from 256 threads until
// the grid covers the card's SMs, so a 256-row launch runs 86 one-warp
// blocks on as many SMs, where one thread a row made it one block on one
// SM, each thread a serial chain over K whose online max/sum waited on a
// data-dependent branch every step.  From kThreadRowsFrom rows on (the
// serving chunks, up to 2^18), one thread a row (the kernel below): there
// the launch is bound by its issue rate and its L1, not by its latency,
// and the lanes' work a warp (the index arithmetic, the scan, the shuffles
// and the final log) for three rows costs more than a serial chain of ~45
// instructions a component for a whole row.  IEEE division, expf and logf
// (no fast math): the same rounding per component as the plain version's
// expressions; the parity tolerance is 1e-5 absolute.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; profile_mixture_forward.py,
// PERF.md): 2.66-2.68 us at 256 rows and 2.69-2.72 at
// 512 (one thread a row before: 4.60 and 4.78; the launch floor 1.88),
// every output on random finite rows bit for bit the earlier kernel's; at
// 2^18 rows the lanes take 32.2 us, one thread a row 15.4 (before: 17.2).
// The mappings cross between 24,576 and 28,672 rows.
// Dropped after measuring, for the row kernel at 2^18 rows: the term
// through normal_term, whose call reads all three parameters before the
// division (18-20 us against 16.5 with the logit read after it); a
// branch-free update, one expf(-|t - m|) a component with no divergence
// (19.8 us); a grid of every row's block, 8 blocks an SM in flight, whose
// rows' lines overflow L1 (19.2 us against 15.0 with the grid capped at 6
// blocks an SM).  For the lanes: the trees of the reference's form, 2.50
// us at 256 rows, for the trajectory above.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mixture_lanes.cuh"

namespace {

using mixture_lanes::kMaxThreads;
using mixture_lanes::kThreadRowsFrom;
using mixture_lanes::RowLanes;

constexpr float kLogSqrt2Pi = 0.91893853320467274178f;
// one thread a row: at most this many blocks an SM, so that the lines of
// the rows in flight (3 x 1,280 bytes a warp, 48 warps) stay in L1
constexpr int64_t kRowBlocksPerSm = 6;

__device__ __forceinline__ float normal_term(float xv, float mk, float sdk, float lk) {
  const float z = (xv - mk) / sdk;
  return -0.5f * z * z - logf(sdk) - kLogSqrt2Pi + lk;
}

__global__ void __launch_bounds__(kMaxThreads) mixture_normal_log_prob_kernel(
    const float* __restrict__ x, const float* __restrict__ means,
    const float* __restrict__ stddevs, const float* __restrict__ logits,
    float* __restrict__ out, int64_t B, int64_t K) {
  const RowLanes r(B, K);
  float m = -INFINITY;  // the row's running max
  float s = 0.0f;       // the row's sum of exp(term - m)
  for (int64_t c = 0; c < K; c += r.S) {  // one chunk for K <= 32
    float t = -INFINITY;
    if (r.live && c + r.j < K) {
      // ---- load: the row's x, then this lane's component of the chunk
      const int64_t at = r.row * K + c + r.j;
      const float xv = x[r.row];
      const float mk = means[at];
      const float sdk = stddevs[at];
      const float lk = logits[at];
      // ---- compute: the term, then the chunk folded into the row's m and s
      t = normal_term(xv, mk, sdk, lk);
    }
    mixture_lanes::fold_chunk(t, static_cast<int>(K - c < r.S ? K - c : r.S), r, m, s);
  }
  // ---- store
  if (r.live && r.j == 0) out[r.row] = mixture_lanes::row_logsumexp(m, s);
}

// One thread a row, from kThreadRowsFrom rows on: the K components a
// serial chain with an online max and sum, the running max the shift
// while it is finite, the special terms as the reference takes them
// (+inf where a term is +inf, NaN where one is NaN, -inf where all are
// -inf): the two-sided loop of one thread a row before the lanes, with
// t == m adding exp(0) and a max of -inf writing 0 + log(s).  Its term is
// written out, not normal_term's call, so that the logit is read after
// the division, as that loop read it; a grid of at most kRowBlocksPerSm
// blocks an SM walks the rows (PERF.md).
__global__ void mixture_normal_log_prob_rows_kernel(
    const float* __restrict__ x, const float* __restrict__ means,
    const float* __restrict__ stddevs, const float* __restrict__ logits,
    float* __restrict__ out, int64_t B, int64_t K) {
  for (int64_t row = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; row < B;
       row += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float xv = x[row];
    const float* mu = means + row * K;
    const float* sd = stddevs + row * K;
    const float* lg = logits + row * K;
    float m = -INFINITY;  // the running max: the shift of s while finite
    float s = 0.0f;       // the sum of exp(term - m)
    for (int64_t k = 0; k < K; ++k) {
      const float sdk = sd[k];
      const float z = (xv - mu[k]) / sdk;
      const float t = -0.5f * z * z - logf(sdk) - kLogSqrt2Pi + lg[k];
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
}

}  // namespace

// Returns a cudaError_t.
extern "C" int pyprob_mixture_normal_log_prob_f32(
    const float* x, const float* means, const float* stddevs,
    const float* logits, float* out, int64_t B, int64_t K, int64_t device,
    void* stream) {
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
  int64_t blocks = (n + threads - 1) / threads;
  if (by_rows && blocks > kRowBlocksPerSm * sms) blocks = kRowBlocksPerSm * sms;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (by_rows) {
    mixture_normal_log_prob_rows_kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        x, means, stddevs, logits, out, B, K);
  } else {
    mixture_normal_log_prob_kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        x, means, stddevs, logits, out, B, K);
  }
  return static_cast<int>(cudaGetLastError());
}
