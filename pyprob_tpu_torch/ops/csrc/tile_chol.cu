// Joint Cholesky factor and inverse of batched SPD diagonal tiles.
//
// Replaces `pyprob_tpu/ops/tile_chol.py: chol_inv_tile_T` (`_tile_kernel`,
// behind the wrapper `chol_inv_tile`), which the panel Cholesky
// (`ops/blocked_linalg.py: chol_panels`) calls for every P x P diagonal
// tile: the GP family's MultivariateNormal factors one [N, N] kernel matrix
// per particle, N/64 tiles each.  For every tile A (row-major [P, P],
// float32, P <= 64) it writes L = chol(A) and M = L^-1, both lower
// triangular with zeros above the diagonal, by the right-looking column
// loop of the TPU kernel with R = I:
//   d      = rsqrt(S[j][j])
//   L[:,j] = S[:,j] d                  (rows >= j)
//   S     -= L[:,j] L[:,j]^T           (rows and columns > j)
//   M[j,:] = R[j,:] d                  (columns <= j)
//   R     -= L[:,j] M[j,:]             (rows > j, columns <= j)
// A tile that is not positive definite gives NaN from the first failing
// column on, as rsqrt of a negative number does in the TPU kernel.  The
// products and differences are rounded one by one (__fmul_rn, __fsub_rn:
// no fused multiply-add), as the plain PyTorch version rounds them.
//
// Bound on an H100: memory.  The column loop reads only the lower triangle
// of a tile, so a tile's P(P+1)/2 floats are read and two P x P tiles
// written, 4 (P(P+1)/2 + 2 P^2) bytes; at B = 8,192, P = 64 that is
// 336.6 MB, 0.100 ms at 3.35 TB/s.  The useful work is P^3/3 for the factor
// and P^3/3 for the inverse (1.43 GFLOP at that size, 0.021 ms at
// 67 TFLOP/s float32); the TPU kernel's cost estimate counts 4 P^3, the
// dense updates of its first version.
//
// Design: one block of 256 threads per tile.  The tile and R live in shared
// memory with a row stride of 65 floats, so that the column read of each
// step (thread t reads row t) falls on 32 different banks; 33.8 KB per
// block.  Each column takes two barriers: the first after the column of L
// and the row of M are staged in two small vectors, the second after the
// rank-1 updates, which also store that column and row in place (S turns
// into L, R into M).  In the updates a thread owns one column and every
// fourth row, so a warp touches 32 neighbouring floats of one row (a first
// version split a flat index by the runtime P, an integer division per
// element, and took 2.18 ms at B = 8,192, P = 64 on an H100 SXM at 700 W,
// against 1.21 ms for this one).  Every thread runs every column, so no
// thread leaves the loop before a barrier.  The load skips the entries
// above the diagonal (the loop never reads them, and the stores write
// zeros there); loads and stores of the tiles are coalesced.  Any P <= 64,
// so a ragged last panel (N = 200: 64, 64, 64, 8) runs here too.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxP = 64;
constexpr int kStride = kMaxP + 1;  // padded row stride of the shared tiles
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / kMaxP;

__global__ void __launch_bounds__(kThreads) tile_chol_inv_kernel(
    const float* __restrict__ a, float* __restrict__ l_out,
    float* __restrict__ m_out, int P) {
  __shared__ float S[kMaxP * kStride];
  __shared__ float R[kMaxP * kStride];
  __shared__ float lcol[kMaxP];
  __shared__ float mrow[kMaxP];
  const int tid = threadIdx.x;
  const int c = tid % kMaxP;
  const int row_group = tid / kMaxP;
  const int PP = P * P;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * PP;
  for (int t = tid; t < PP; t += kThreads) {
    const int i = t / P;
    const int k = t - i * P;
    if (k <= i) S[i * kStride + k] = a[base + t];
    R[i * kStride + k] = i == k ? 1.0f : 0.0f;
  }
  __syncthreads();
  for (int j = 0; j < P; ++j) {
    const float d = rsqrtf(S[j * kStride + j]);
    if (tid < P) {
      if (tid > j) lcol[tid] = __fmul_rn(S[tid * kStride + j], d);
      else mrow[tid] = __fmul_rn(R[j * kStride + tid], d);
    }
    __syncthreads();
    // rows i > j: columns c <= j update R, columns j < c <= i update S;
    // thread (row group, c) takes column c of every kRowGroups-th row
    for (int i = j + 1 + row_group; i < P; i += kRowGroups) {
      if (c <= j) {
        R[i * kStride + c] = __fsub_rn(R[i * kStride + c], __fmul_rn(lcol[i], mrow[c]));
      } else if (c <= i) {
        S[i * kStride + c] = __fsub_rn(S[i * kStride + c], __fmul_rn(lcol[i], lcol[c]));
      }
    }
    if (tid < P) {
      if (tid > j) S[tid * kStride + j] = lcol[tid];
      else R[j * kStride + tid] = mrow[tid];
      if (tid == j) S[j * kStride + j] = __fmul_rn(S[j * kStride + j], d);
    }
    __syncthreads();
  }
  for (int t = tid; t < PP; t += kThreads) {
    const int i = t / P;
    const int k = t - i * P;
    const bool lower = k <= i;
    l_out[base + t] = lower ? S[i * kStride + k] : 0.0f;
    m_out[base + t] = lower ? R[i * kStride + k] : 0.0f;
  }
}

}  // namespace

// Returns a cudaError_t; cudaErrorInvalidValue unless 1 <= P <= 64.
extern "C" int pyprob_tile_chol_inv_f32(const float* a, float* l, float* m,
                                        int64_t B, int64_t P, int64_t device,
                                        void* stream) {
  if (P < 1 || P > kMaxP || B < 1 || B > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_chol_inv_kernel<<<static_cast<unsigned>(B), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      a, l, m, static_cast<int>(P));
  return static_cast<int>(cudaGetLastError());
}
