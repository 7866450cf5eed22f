// One-pass log-weight statistics, in one launch.
//
// Replaces the Pallas kernel `_lw_stats_kernel` behind
// `pyprob_tpu/ops/kernels.py:log_weight_stats` (`pallas_call` at :325).
// Over lw [N] float32:
//   out = (m, s1, s2) = (max lw, sum exp(lw - m), sum exp(2 (lw - m))),
// from which ESS = s1^2 / s2 and log Z = m + log s1.  As in the reference
// (`_log_weight_stats_ref`), m is NaN where any weight is NaN, and s1 and
// s2 are NaN where m is NaN or +inf (exp(inf - inf)), and where every
// weight is -inf the result is (-inf, NaN, NaN), the reference's
// exp(-inf - -inf).  (The batched tier maps m = -inf to ESS 0 and log Z
// -inf itself.)
//
// Bound on an H100: the bytes (N = 10^6 weights are 4 MB, 1.19 us at
// 3.35 TB/s) and, at every size the path launches it at, the launch itself
// (about 1.8 us).  So the design is one launch with all of its loads in
// flight at once:
// - Grid: a tile of 512 threads x kVec float4 (8,192 weights) a block, so
//   123 blocks at N = 10^6, capped at the scratch's capacity (kBlocksPerSm
//   blocks an SM); past the cap the blocks stride over the tiles.  Up to
//   N = 2,048 (+ 6) one block of 128 threads, the only tile.  Each thread
//   issues its kVec 16-byte loads (ld.global.nc.v4) before any arithmetic.
//   Where the pointer is not 16-byte aligned or N not a multiple of 4, the
//   at most 3 + 3 weights before and after the float4 body go to the first
//   threads of block 0, beside their first tile.
// - Max first: the thread's max, then its warp's (max.NaN shuffles); then
//   one exp a weight against the warp's max, and s1 and s2 summed with
//   plain shuffle adds: no rescale a weight, and a warp that holds only
//   -inf (padding) takes no exp.  Warp 0 merges the warps' triples, one
//   exp a warp against the block's max, and the blocks' triples the same
//   way (warp_merge).  (A block max before the exps, with no merge of the
//   warps, costs two more barriers and every warp's exps: 0.3 us a launch
//   more at N = 256 and 512, 0.07 at 10^6, both with 512 threads and expf,
//   in turns on an H100.  Past the cap a warp folds tile after tile into
//   sums kept against its running max: one rescale a thread a tile.)
// - Across blocks, in the same launch: each block's warp 0 writes the
//   block's (m, s1, s2) to the scratch and takes a ticket from a counter
//   with one acq_rel atomic (0.4 us a launch less at 10^6 than a fence
//   and a relaxed atomic); the last block's warp 0 merges the triples in
//   block order, writes out[3] and resets the counter to 0, so the next
//   launch needs no memset.  A grid of one block (N <= 8,192 + 6) writes
//   out[3] itself.  The wrapper keeps one scratch and counter a (device,
//   stream): two streams would otherwise share a counter.
// - Deterministic: every sum is taken in an order fixed by N, the
//   pointer's alignment and the grid, whichever block ends last; there are
//   no float atomics, so two launches on the same weights give the same
//   bits.
// - __expf (ex2.approx): s1 and s2 stay within rtol 1e-5 of float64 at
//   10^6 weights spread as chip_smoke.py's stats_inputs, which checks
//   every size, and it takes 0.08-0.17 us a launch off expf's range
//   reduction (in turns on an H100).
// The CPU mirror of this reduction is `_stats_mirror` in
// tests/test_torch_ops.py; profile_log_weight_stats.py times it and
// splits a block's cycles at the `// ---- ` comments.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;       // a block, where the grid has more than one
constexpr int kSmallThreads = 128;  // the one block of N <= 2,048 + 6
constexpr int kVec = 4;             // float4 loads a thread a tile
constexpr int kBlocksPerSm = 2;
constexpr int kMergePerLane = 9;  // the last block's warp merges <= 288 triples
constexpr unsigned kFull = 0xffffffffu;

// the larger of a and b, NaN if either is NaN (fmaxf drops a NaN)
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = nan_max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// the warp's sums of a and b in lane 0: a shuffle-down tree
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(kFull, a, off);
    b += __shfl_down_sync(kFull, b, off);
  }
}

// Merges P triples a lane (m[k], s1[k], s2[k]), sums of exp(w - m[k]) and
// exp(2 (w - m[k])), into the warp's (M, a1, a2) in lane 0: M the max of
// every m (in every lane), then one exp a triple against it, each lane
// folding its triples in order with fmas, then the warp's trees.  A triple
// of -inf weights (padding, or a warp or block that met only -inf) is
// (-inf, 0, 0) inside the reduction: r = 0 adds nothing.
template <int P>
__device__ __forceinline__ void warp_merge(const float (&m)[P], const float (&s1)[P],
                                           const float (&s2)[P], float& M, float& a1,
                                           float& a2) {
  M = m[0];
#pragma unroll
  for (int k = 1; k < P; ++k) M = nan_max(M, m[k]);
  M = warp_max(M);
  a1 = a2 = 0.0f;
  if (isfinite(M)) {  // else write_result sets the sums
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float r = __expf(m[k] - M);
      a1 = fmaf(s1[k], r, a1);
      a2 = fmaf(s2[k], r * r, a2);
    }
  }
  warp_sum2(a1, a2);
}

// The block's place in the order the blocks finish: an add to the counter
// that releases this thread's earlier stores (the block's triple) and
// acquires those of the blocks before it.
__device__ __forceinline__ unsigned take_ticket(unsigned* counter) {
  unsigned ticket;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(ticket) : "l"(counter) : "memory");
  return ticket;
}

// (m, s1, s2) as the reference has them where m is not finite: NaN sums
// for a NaN max, +inf (exp(inf - inf)) and -inf (exp(-inf - -inf)).
__device__ __forceinline__ void write_result(float* out, float m, float s1, float s2) {
  if (!isfinite(m)) s1 = s2 = NAN;
  out[0] = m;
  out[1] = s1;
  out[2] = s2;
}

template <int Threads>
__global__ void __launch_bounds__(Threads, kBlocksPerSm)
lw_stats_kernel(const float* __restrict__ lw, int64_t n, float* __restrict__ scratch,
                unsigned* __restrict__ counter, float* __restrict__ out) {
  constexpr int kWarps = Threads / 32;
  constexpr int64_t kTile = static_cast<int64_t>(Threads) * kVec;  // float4 a tile
  __shared__ float red[3 * kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // the float4 body starts at the first 16-byte boundary
  const int64_t aligned_at = ((16 - (reinterpret_cast<uintptr_t>(lw) & 15)) & 15) / 4;
  const int64_t head = aligned_at < n ? aligned_at : n;
  const int64_t nv = (n - head) / 4;
  const int64_t tiles = (nv + kTile - 1) / kTile;
  const float4* body = reinterpret_cast<const float4*>(lw + head);
  const int extras = static_cast<int>(n - 4 * nv);  // head + tail, at most 6

  // the warp's running max (the same in its lanes) and this thread's sums
  // of exp(w - m) and exp(2 (w - m))
  float m = -INFINITY, s1 = 0.0f, s2 = 0.0f;
  int64_t tile = blockIdx.x;
  do {
    // ---- load
    float4 v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int64_t i = tile * kTile + k * Threads + t;
      v[k] = i < nv ? __ldg(body + i) : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    }
    // weight t of the head, or of the tail past it
    const float x = tile == 0 && t < extras ? lw[t < head ? t : 4 * nv + t] : -INFINITY;
    // ---- compute
    float tm = x;
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      tm = nan_max(tm, nan_max(nan_max(v[k].x, v[k].y), nan_max(v[k].z, v[k].w)));
    const float mt = nan_max(m, warp_max(tm));
    if (isfinite(mt)) {  // else write_result sets the sums
      const float r = __expf(m - mt);  // 1 where the max did not rise, 0 from -inf
      s1 *= r;
      s2 *= r * r;
      float e = __expf(x - mt);
      s1 += e;
      s2 = fmaf(e, e, s2);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float w[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          e = __expf(w[j] - mt);
          s1 += e;
          s2 = fmaf(e, e, s2);
        }
      }
    }
    m = mt;
    tile += gridDim.x;
  } while (tile < tiles);
  warp_sum2(s1, s2);
  if (lane == 0) {
    red[warp] = m;
    red[kWarps + warp] = s1;
    red[2 * kWarps + warp] = s2;
  }
  __syncthreads();

  if (warp == 0) {
    // the block's triple, from its warps' (lane 0 holds it)
    const bool have = lane < kWarps;
    const float wm[1] = {have ? red[lane] : -INFINITY};
    const float w1[1] = {have ? red[kWarps + lane] : 0.0f};
    const float w2[1] = {have ? red[2 * kWarps + lane] : 0.0f};
    warp_merge(wm, w1, w2, m, s1, s2);
    // ---- merge
    const unsigned grid = gridDim.x;
    if (grid == 1) {
      if (lane == 0) write_result(out, m, s1, s2);
    } else {
      unsigned ticket = 0;
      if (lane == 0) {
        scratch[blockIdx.x] = m;
        scratch[grid + blockIdx.x] = s1;
        scratch[2 * grid + blockIdx.x] = s2;
        ticket = take_ticket(counter);  // releases the triple, acquires the others
      }
      if (__shfl_sync(kFull, ticket, 0) == grid - 1) {  // the last block
        __syncwarp();  // lane 0's acquire comes before the lanes' loads
        // lane l merges blocks l, l + 32, ..., all loaded before any
        // arithmetic
        float bm[kMergePerLane], b1[kMergePerLane], b2[kMergePerLane];
#pragma unroll
        for (int k = 0; k < kMergePerLane; ++k) {
          const unsigned b = lane + 32 * k;
          bm[k] = b < grid ? __ldcg(scratch + b) : -INFINITY;
          b1[k] = b < grid ? __ldcg(scratch + grid + b) : 0.0f;
          b2[k] = b < grid ? __ldcg(scratch + 2 * grid + b) : 0.0f;
        }
        float M, a1, a2;
        warp_merge(bm, b1, b2, M, a1, a2);
        if (lane == 0) {
          write_result(out, M, a1, a2);
          *counter = 0u;  // every other block has taken its ticket
        }
      }
    }
  }
  // ---- end
}

}  // namespace

// The blocks a launch may use on this device: the scratch the wrapper
// allocates holds 3 floats for each.
extern "C" int64_t pyprob_log_weight_stats_capacity(int64_t device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, static_cast<int>(device)) !=
      cudaSuccess)
    return -1;
  const int64_t blocks = static_cast<int64_t>(sms) * kBlocksPerSm;
  return blocks < 32 * kMergePerLane ? blocks : 32 * kMergePerLane;
}

// lw [n] float32, n >= 1, at any 4-byte alignment; scratch [3 capacity]
// float32 and counter (0 before the first launch) kept for this stream;
// out [3] float32.
extern "C" int pyprob_log_weight_stats_f32(const float* lw, float* scratch, unsigned* counter,
                                           float* out, int64_t n, int64_t capacity,
                                           int64_t device, void* stream) {
  if (n < 1 || capacity < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (capacity > 32 * kMergePerLane) capacity = 32 * kMergePerLane;
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t head = ((16 - (reinterpret_cast<uintptr_t>(lw) & 15)) & 15) / 4;
  const int64_t nv = n > head ? (n - head) / 4 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nv <= static_cast<int64_t>(kSmallThreads) * kVec) {
    lw_stats_kernel<kSmallThreads><<<1, kSmallThreads, 0, s>>>(lw, n, scratch, counter, out);
  } else {
    const int64_t tile = static_cast<int64_t>(kThreads) * kVec;
    const int64_t tiles = (nv + tile - 1) / tile;
    const int64_t grid = tiles < capacity ? tiles : capacity;
    lw_stats_kernel<kThreads><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        lw, n, scratch, counter, out);
  }
  return static_cast<int>(cudaGetLastError());
}
