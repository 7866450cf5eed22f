// One-pass log-weight statistics.
//
// Replaces the Pallas kernel `_lw_stats_kernel` behind
// `pyprob_tpu/ops/kernels.py:log_weight_stats`.  Over lw [N] float32:
//   out = (m, s1, s2) = (max lw, sum exp(lw - m), sum exp(2 (lw - m))),
// from which ESS = s1^2 / s2 and log Z = m + log s1.
//
// Bound on an H100: memory, and at the serving path's size launch latency.
// N = 10^6 weights are 4 MB, about 1.2 us at 3.35 TB/s, shorter than two
// kernel launches; a handful of operations per weight is far below the
// compute rates.  Recorded, not tuned.
//
// Design: a blocked reduction with no size limit (the TPU version is one
// grid point holding at most 2^20 floats in VMEM).  Pass 1: each thread
// strides over the input keeping its own (m, s1, s2), rescaling s1 by
// e^(m_old - m_new) and s2 by its square whenever its max rises; warps
// merge with shuffles, warps of a block through shared memory, and each
// block writes one triple to a [blocks, 3] scratch the wrapper allocates.
// Pass 2: one block merges the triples.  A triple whose max is -inf holds
// no weight and contributes nothing; -inf - (-inf) is never computed.  If
// every weight is -inf the result is (-inf, 0, 0).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Stats {
  float m, s1, s2;
};

__device__ __forceinline__ Stats merge(Stats a, Stats b) {
  if (a.m == -INFINITY) return b;
  if (b.m == -INFINITY) return a;
  const float m = fmaxf(a.m, b.m);
  const float ra = expf(a.m - m);
  const float rb = expf(b.m - m);
  return {m, a.s1 * ra + b.s1 * rb, a.s2 * ra * ra + b.s2 * rb * rb};
}

__device__ __forceinline__ Stats block_merge(Stats v) {
  __shared__ Stats warp_stats[kWarps];
  for (int offset = 16; offset > 0; offset >>= 1) {
    Stats o;
    o.m = __shfl_down_sync(0xffffffffu, v.m, offset);
    o.s1 = __shfl_down_sync(0xffffffffu, v.s1, offset);
    o.s2 = __shfl_down_sync(0xffffffffu, v.s2, offset);
    v = merge(v, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_stats[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? warp_stats[lane] : Stats{-INFINITY, 0.0f, 0.0f};
    for (int offset = 16; offset > 0; offset >>= 1) {
      Stats o;
      o.m = __shfl_down_sync(0xffffffffu, v.m, offset);
      o.s1 = __shfl_down_sync(0xffffffffu, v.s1, offset);
      o.s2 = __shfl_down_sync(0xffffffffu, v.s2, offset);
      v = merge(v, o);
    }
  }
  return v;  // valid in thread 0
}

__global__ void lw_stats_partial_kernel(const float* __restrict__ lw, int64_t n,
                                        float* __restrict__ partial) {
  Stats v{-INFINITY, 0.0f, 0.0f};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += stride) {
    const float w = lw[i];
    if (w > v.m) {
      const float r = expf(v.m - w);  // 0 while v.m is -inf
      v.s1 = v.s1 * r + 1.0f;
      v.s2 = v.s2 * r * r + 1.0f;
      v.m = w;
    } else if (w != -INFINITY) {
      const float e = expf(w - v.m);  // NaN weights propagate
      v.s1 += e;
      v.s2 += e * e;
    }
  }
  v = block_merge(v);
  if (threadIdx.x == 0) {
    partial[3 * blockIdx.x + 0] = v.m;
    partial[3 * blockIdx.x + 1] = v.s1;
    partial[3 * blockIdx.x + 2] = v.s2;
  }
}

__global__ void lw_stats_final_kernel(const float* __restrict__ partial,
                                      int64_t blocks, float* __restrict__ out) {
  Stats v{-INFINITY, 0.0f, 0.0f};
  for (int64_t b = threadIdx.x; b < blocks; b += blockDim.x) {
    v = merge(v, Stats{partial[3 * b], partial[3 * b + 1], partial[3 * b + 2]});
  }
  v = block_merge(v);
  if (threadIdx.x == 0) {
    out[0] = v.m;
    out[1] = v.s1;
    out[2] = v.s2;
  }
}

}  // namespace

extern "C" int64_t pyprob_log_weight_stats_blocks(int64_t n) {
  // enough blocks to fill the card (132 SMs, 8 blocks of 256 each), and
  // at least ~8 weights per thread before the grid strides
  const int64_t per_block = static_cast<int64_t>(kThreads) * 8;
  const int64_t want = (n + per_block - 1) / per_block;
  const int64_t cap = 132 * 8;
  return want < 1 ? 1 : (want > cap ? cap : want);
}

extern "C" int pyprob_log_weight_stats_f32(const float* lw, float* partial,
                                           float* out, int64_t n, int64_t blocks,
                                           int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  lw_stats_partial_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      lw, n, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lw_stats_final_kernel<<<1, kThreads, 0, s>>>(partial, blocks, out);
  return static_cast<int>(cudaGetLastError());
}
