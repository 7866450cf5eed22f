// Fused multivariate-normal quadratic form and half log-determinant.
//
// Replaces both Pallas kernels of `pyprob_tpu/ops/mvn_logpdf.py`:
// `_quad_logdet_stacked` (`_chol_solve_stacked_kernel`, particles stacked
// per grid cell) and `_quad_logdet_single` (`_chol_solve_kernel`, one
// matrix), behind the entry point `mvn_quad_logdet`.  Per particle b, with
// K = cov[b] ([N, N] row-major, float32, symmetric positive definite; only
// its lower triangle is read) and r = diff[b] ([N]):
//   K = L L^T,  z = L^-1 r,
//   out[b] = (z^T z, sum_j log L[j][j])          (= diff^T K^-1 diff, log|K|/2)
// by a right-looking column loop that fuses the forward substitution and
// the log-determinant into the factorization:
//   d = rsqrt(A[j][j]),  L[j][j] = A[j][j] d,  z_j = r_j / L[j][j],
//   L[i][j] = A[i][j] d and r_i -= L[i][j] z_j        (i > j),
//   A[i][k] -= L[i][j] L[k][j]                        (j < k <= i).
// A matrix that is not positive definite gives NaN in both outputs, as
// rsqrt of a negative number does in the TPU kernels.  Any N; no padding
// (the TPU kernels pad N to a multiple of 128 with an identity block).
//
// Bound on an H100: operations.  A particle reads N(N+1)/2 + N floats (the
// lower triangle and r) and does N^3/3 floating-point operations; at
// B = 8,192, N = 256 that is 1.09 GB (0.32 ms at 3.35 TB/s) and 45.8 GFLOP
// (0.68 ms at 67 TFLOP/s float32); at B = 2,048, N = 512, 91.6 GFLOP,
// 1.37 ms.
//
// Design: one block of 512 threads per particle, 2 barriers per column.
// The block copies the lower triangle of its K into a packed triangle A
// (row i at offset i(i+1)/2), factors it in place, keeps r and the current
// column of L in shared memory, and writes two floats.  Where the triangle
// fits in shared memory (N <= 338: 133.6 KB at N = 256) A lives there;
// larger N use a packed workspace per particle in device memory, which the
// wrapper allocates (1.05 GB at B = 2,048, N = 512) and which the blocks in
// flight keep partly in L2.  The trailing update gives row i to one warp
// and its columns to the lanes, so each warp reads and writes one
// contiguous span.  Thread 0 sums z_j^2 and log L[j][j] in column order.
// Every thread runs every column, so no thread leaves the loop before a
// barrier.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kDefaultSmem = 48 * 1024;  // without opt-in
constexpr int64_t kMaxSmem = 227 * 1024;     // a block's most on Hopper

__device__ __forceinline__ int64_t tri(int64_t i) { return i * (i + 1) / 2; }

__global__ void __launch_bounds__(kThreads) mvn_quad_logdet_kernel(
    const float* __restrict__ cov, const float* __restrict__ diff,
    float* __restrict__ work, float* __restrict__ out, int N) {
  extern __shared__ float smem[];  // r [N], lcol [N], then A when work == null
  float* r = smem;
  float* lcol = smem + N;
  const int64_t b = blockIdx.x;
  const int64_t T = tri(N);
  float* A = work == nullptr ? smem + 2 * N : work + b * T;
  const float* C = cov + b * static_cast<int64_t>(N) * N;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int i = warp; i < N; i += kWarps) {
    float* row = A + tri(i);
    const float* src = C + static_cast<int64_t>(i) * N;
    for (int k = lane; k <= i; k += 32) row[k] = src[k];
  }
  for (int t = tid; t < N; t += kThreads) r[t] = diff[b * N + t];
  __syncthreads();
  float quad = 0.0f, logdet = 0.0f;  // thread 0's
  for (int j = 0; j < N; ++j) {
    const float ajj = A[tri(j) + j];
    const float d = rsqrtf(ajj);
    const float ljj = ajj * d;
    const float zj = r[j] / ljj;
    for (int i = j + 1 + tid; i < N; i += kThreads) {
      const float lij = A[tri(i) + j] * d;
      lcol[i] = lij;
      r[i] -= lij * zj;
    }
    if (tid == 0) {
      quad += zj * zj;
      logdet += logf(ljj);
    }
    __syncthreads();
    for (int i = j + 1 + warp; i < N; i += kWarps) {
      float* row = A + tri(i);
      const float li = lcol[i];
      for (int k = j + 1 + lane; k <= i; k += 32) row[k] -= li * lcol[k];
    }
    __syncthreads();
  }
  if (tid == 0) {
    out[2 * b] = quad;
    out[2 * b + 1] = logdet;
  }
}

int64_t shared_bytes(int64_t N, bool matrix_in_smem) {
  return 4 * (2 * N + (matrix_in_smem ? N * (N + 1) / 2 : 0));
}

}  // namespace

// Whether a particle's packed triangle fits in a block's shared memory; if
// not, the caller passes a workspace of B * N(N+1)/2 floats.
extern "C" int pyprob_mvn_quad_logdet_in_smem(int64_t N) {
  return shared_bytes(N, true) <= kMaxSmem ? 1 : 0;
}

// cov [B, N, N], diff [B, N] -> out [B, 2]; work is null when the triangle
// fits in shared memory.  Returns a cudaError_t.
extern "C" int pyprob_mvn_quad_logdet_f32(const float* cov, const float* diff,
                                          float* work, float* out, int64_t B,
                                          int64_t N, int64_t device,
                                          void* stream) {
  const bool in_smem = work == nullptr;
  if (N < 1 || B < 1 || B > 0x7fffffff || N > 46340 ||
      (in_smem && !pyprob_mvn_quad_logdet_in_smem(N))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t smem = shared_bytes(N, in_smem);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(mvn_quad_logdet_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mvn_quad_logdet_kernel<<<static_cast<unsigned>(B), kThreads,
                           static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(
      cov, diff, work, out, static_cast<int>(N));
  return static_cast<int>(cudaGetLastError());
}
