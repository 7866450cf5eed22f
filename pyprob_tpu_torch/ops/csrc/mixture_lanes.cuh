// What the four mixture kernels share (mixture_normal.cu,
// mixture_truncated_normal.cu and their backwards): the layout of a row's
// K components on S = min(K, 32) consecutive lanes of a warp, 32 / S rows
// a warp, lane j of a row taking components j, j + S, ...; the launch
// plan that spreads those warps over the card's SMs; and the forwards'
// logsumexp over a row's lanes.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mixture_lanes {

constexpr int kMaxThreads = 256;

// The forwards run one thread a row from this many rows on: where their
// two mappings cross on an H100 (PERF.md).  profile_mixture_forward.py
// defines it to force one mapping.
#ifndef MIXTURE_THREAD_ROWS_FROM
#define MIXTURE_THREAD_ROWS_FROM 28672
#endif
constexpr int64_t kThreadRowsFrom = MIXTURE_THREAD_ROWS_FROM;

// The threads of a launch with B rows of K components on lanes: a warp for
// each 32 / S rows.
inline int64_t lane_threads(int64_t B, int64_t K) {
  const int64_t rows_per_warp = K < 32 ? 32 / K : 1;
  return (B + rows_per_warp - 1) / rows_per_warp * 32;
}

// The block for a launch of n threads: 256 threads, halved until the grid
// covers the card's sms SMs (down to one warp), so that a launch at the
// rows a training step gives (256) runs on 86 SMs, not one.
inline int block_threads(int64_t n, int sms) {
  int threads = kMaxThreads;
  while (threads > 32 && (n + threads - 1) / threads < sms) threads /= 2;
  return threads;
}

// A lane's place: its row's lane count S, its lane in the warp and in the
// row (j), its row, and whether it works on one (the warp's last 32 mod S
// lanes and the lanes past row B - 1 do not).
struct RowLanes {
  int S, lane, j;
  int64_t row;
  bool live;
  __device__ __forceinline__ RowLanes(int64_t B, int64_t K) {
    S = K < 32 ? static_cast<int>(K) : 32;
    lane = static_cast<int>(threadIdx.x % 32);
    const int seg = lane / S;  // the warp's row this lane works on
    j = lane - seg * S;
    const int64_t warp =
        static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
    row = warp * (32 / S) + seg;
    live = seg < 32 / S && row < B;
  }
};

// the larger of a and b, NaN if either is NaN (fmaxf drops a NaN)
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Folds a chunk of a row's terms into the row's running max m and sum s of
// exp(term - m), which every lane of the row holds: the row's lane j holds
// the term of component c + j, j < n (-inf on the row's other lanes), and
// the chunk goes in component order with the operations of one thread
// folding the row alone (the one-thread-a-row kernels, and the kernels
// before the lanes): where t > m, s = s exp(m - t) + 1 (one fma) and m = t,
// else s += exp(t - m), nothing for a -inf term.  The running max before
// each term is a scan up the row's lanes (max.NaN, in any order the same
// bits), so each lane takes its exp at once; the row's lanes then read the
// n exps from lanes 0..n-1 by shuffles, the sign of each carrying its
// branch, and apply them in order: n dependent adds.  For a row whose
// terms are finite or -inf the output is bit for bit that of one thread
// folding the row; a NaN term makes m NaN, a +inf one (no NaN) makes it
// +inf, and the caller writes m for those rows, as the reference's
// logsumexp gives them.  Every lane of the warp takes part.
__device__ __forceinline__ void fold_chunk(float t, int n, const RowLanes& r, float& m,
                                           float& s) {
  float v = r.j == 0 ? nan_max(m, t) : t;  // the max up to this lane's term
#pragma unroll
  for (int offset = 1; offset < 32; offset *= 2) {
    if (offset < r.S) {  // the same for the whole warp
      const float other = __shfl_up_sync(0xffffffffu, v, offset);
      if (r.j >= offset) v = nan_max(v, other);
    }
  }
  const float before = __shfl_up_sync(0xffffffffu, v, 1);
  const float q = r.j == 0 ? m : before;  // the running max before this term
  const bool raise = t > q;
  float e = expf(raise ? q - t : t - q);
  if (t == -INFINITY) e = 0.0f;  // adds nothing, as one thread skips it
  const float sent = raise ? -e : e;
  const int first = r.lane - r.j;  // the row's lane 0
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const float u = __shfl_sync(0xffffffffu, sent, first + i);
    s = __float_as_int(u) < 0 ? fmaf(s, -u, 1.0f) : s + u;
  }
  m = __shfl_sync(0xffffffffu, v, first + n - 1);
}

// The row's logsumexp from its running max and sum: m + log s, or m where
// m is +-inf or NaN.
__device__ __forceinline__ float row_logsumexp(float m, float s) {
  return isfinite(m) ? m + logf(s) : m;
}

}  // namespace mixture_lanes
