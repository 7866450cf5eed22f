// Joint Cholesky factor and inverse of batched SPD diagonal tiles.
//
// Replaces `pyprob_tpu/ops/tile_chol.py: chol_inv_tile_T` (`_tile_kernel`,
// behind the wrapper `chol_inv_tile`), which the panel Cholesky
// (`ops/blocked_linalg.py: chol_panels`) calls for every P x P diagonal
// tile: the GP family's MultivariateNormal factors one [N, N] kernel matrix
// per particle, N/64 tiles each.  For every tile A (float32, P <= 64, read
// in place through its batch and row strides, lower triangle only) it
// writes L = chol(A) and M = L^-1, both lower triangular with zeros above
// the diagonal, by the right-looking column loop of the TPU kernel with
// R = I:
//   d      = rsqrt(S[j][j])
//   L[:,j] = S[:,j] d                  (rows >= j)
//   S     -= L[:,j] L[:,j]^T           (rows and columns > j)
//   M[j,:] = R[j,:] d                  (columns <= j)
//   R     -= L[:,j] M[j,:]             (rows > j, columns <= j)
// A tile that is not positive definite gives NaN from the first failing
// column on, as rsqrt of a negative number does in the TPU kernel.  Each
// product and difference is rounded on its own (__fmul_rn, __fsub_rn: no
// fused multiply-add), as the plain PyTorch version rounds them, so the two
// agree bit for bit but for rsqrt.  L goes to rows of width `width` >= P
// (row and batch strides given): columns P .. width - 1 of each row get
// zeros, so the panel loop hands the kernel the panel's rows of the full L
// and needs no fill of its own; M goes to a contiguous [B, P, P].
//
// Bound on an H100: memory.  The column loop reads only the lower triangle
// of a tile, so a tile's P(P+1)/2 floats are read and P x width + P x P
// written, 4 (P(P+1)/2 + P width + P^2) bytes; at B = 8,192, P = width = 64
// that is 336.6 MB, 0.100 ms at 3.35 TB/s.  The useful work is P^3/3 for
// the factor and P^3/3 for the inverse (1.43 GFLOP at that size, 0.021 ms
// at 67 TFLOP/s float32).
//
// Design: the live state in registers.  S's lower triangle (with the
// diagonal) and R's strict lower triangle fill one square [64, 64] X
// exactly: X[i][k] = S[i][k] for k <= i, X[i][k] = R[k][i] for k > i (R's
// diagonal stays 1 until its row is scaled, and M's diagonal is d, kept in
// a small shared vector).  Then column j of X holds all a step needs:
// S[i][j] for i >= j (the raw column of L) and R[j][c] for c < j (the raw
// row of M).  A tile of P <= 4G takes G x G threads, thread (rg, cg)
// keeping the 4 x 4 micro-tile X[4rg .. 4rg+3][4cg .. 4cg+3] in registers;
// a block of 256 threads holds one tile of 8 < P <= 64 (G = 16; warp w
// the column groups 2w and 2w + 1) or 64 tiles of P <= 8 (G = 2), so the
// ragged last panels (P = 8 at N = 200, 2 at N = 130) fill a block too.  Per column j, the owners of column j publish it raw (one 16-byte
// store each) into a vector double-buffered by the parity of j; after one
// barrier every thread reads its 4 row values and 4 column values (two
// 16-byte broadcast loads) and the pivot, scales them by d = rsqrt(pivot)
// itself, and updates its 16 elements.  An element of S takes L[i] L[k],
// one of R takes L[k] M[i] with M[i] = 0 for rows past j (R there is still
// 0 and stays so, as in the plain version); which of the two is fixed per
// thread above and below its micro-tile's diagonal, so there is no select
// per element.  The columns are unrolled by 4, so the micro-tile column
// being finished (written as L[:,j] or M[j,:] in place) is known at compile
// time; threads whose columns are all finished skip the update, so at G =
// 16 warp w idles after column 8w + 7 and the other blocks on the SM take
// its issue slots.  One barrier per column.  The tile comes in through
// shared memory (coalesced rows, scalar loads all in flight at once, so any
// row stride and alignment will do) and goes out the same way: L row by
// row, M transposed out of X's upper half.
//
// Budget: 17,408 bytes of static shared memory a block at G = 16 (the
// staging tile at row stride 65, the vectors), 24,576 at G = 2;
// registers capped at 64 (__launch_bounds__(256, 4)), 4 blocks per SM.
// ptxas (sm_90a): 57 registers at G = 16, 56 at G = 2, no spills.  On an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6): 0.47 ms at B = 8,192, P =
// 64 as the panel loop launches it (bound 0.221 ms with the zeros of L's
// rows; the earlier column loop in shared memory, two barriers a column:
// 1.20 ms on contiguous tiles).  A block spends about 70 % of its cycles
// in the column loop, which is issue-bound: by count of this source about
// 70 instructions a column for each warp whose columns are live, 32 of
// them the unfused products and differences that keep the plain version's
// rounding; about 14 % loading its tile and 15 % storing L and M.  Capping
// registers for 5 or 6 blocks per SM was not told apart from 4 (identical
// builds spread as widely); a persistent variant that loaded the next
// tile by cp.async during the column loop was slower (the load hidden,
// the loop slower).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxP = 64;
constexpr int kThreads = 256;

// Column j = 4q + S of the loop (S a template argument, so the micro-tile
// column it finishes is known at compile time): every thread reads the raw
// column j of X published last step, updates its micro-tile, and the owners
// of column j + 1 publish it; one barrier.
template <int G, int S>
__device__ __forceinline__ void column_step(float (&x)[4][4], float (*vec)[4 * G], float* dinv,
                                            int q, int P, int t, int rg, int cg, int ncg,
                                            bool lo_s, bool hi_s) {
  const int j = 4 * q + S;
  if (j >= P) return;  // the same for the whole block
  const float* v = vec[j & 1];
  const float d = rsqrtf(v[j]);
  if (t == 0) dinv[j] = d;
  if (cg >= q && cg < ncg) {
    const float4 rv = *reinterpret_cast<const float4*>(&v[4 * rg]);
    const float4 cv = *reinterpret_cast<const float4*>(&v[4 * cg]);
    // row values scaled: L[i][j] for the rows of S, M[j][i] for those of R
    const float rs[4] = {__fmul_rn(rv.x, d), __fmul_rn(rv.y, d), __fmul_rn(rv.z, d),
                         __fmul_rn(rv.w, d)};
    const float cs[4] = {__fmul_rn(cv.x, d), __fmul_rn(cv.y, d), __fmul_rn(cv.z, d),
                         __fmul_rn(cv.w, d)};
    float lo[4], hi[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // M[j][i] for i = 4rg + r: scaled for i < j, d for i = j, 0 past j
      const float mi = rg < q ? rs[r] : rg > q ? 0.0f : r < S ? rs[r] : r == S ? d : 0.0f;
      lo[r] = lo_s ? rs[r] : mi;
      hi[r] = hi_s ? rs[r] : mi;
    }
    if (cg > q) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          x[r][c] = __fsub_rn(x[r][c], __fmul_rn(cs[c], c <= r ? lo[r] : hi[r]));
    } else {  // cg == q: column S is finished here, those before it already are
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        x[r][S] = rs[r];
#pragma unroll
        for (int c = S + 1; c < 4; ++c)
          x[r][c] = __fsub_rn(x[r][c], __fmul_rn(cs[c], c <= r ? lo[r] : hi[r]));
      }
    }
  }
  // publish column j + 1, raw, for the next step
  constexpr int c = (S + 1) % 4;
  if (j + 1 < P && cg == (S < 3 ? q : q + 1)) {
    *reinterpret_cast<float4*>(&vec[(j + 1) & 1][4 * rg]) =
        make_float4(x[0][c], x[1][c], x[2][c], x[3][c]);
  }
  __syncthreads();
}

// G x G micro-tiles of 4 x 4 hold tiles of P <= 4G; 256 / G^2 tiles a block.
template <int G>
__global__ void __launch_bounds__(kThreads, 4) tile_chol_inv_kernel(
    const float* __restrict__ a, int64_t sab, int64_t sar, float* __restrict__ l,
    int64_t slb, int64_t slr, int width, float* __restrict__ m, int64_t B, int P) {
  constexpr int W = 4 * G;                 // rows and columns held
  constexpr int TPT = G * G;               // threads a tile
  constexpr int TILES = kThreads / TPT;    // tiles a block
  constexpr int LD = W + 1;                // padded row stride of the staging tile
  __shared__ float T_all[TILES * W * LD];
  __shared__ __align__(16) float vec_all[TILES][2][W];
  __shared__ float dinv_all[TILES][W];
  const int tile = threadIdx.x / TPT;
  const int t = threadIdx.x % TPT;
  // at G = 16 a warp holds rows 4rg of all 16 row groups and the column
  // groups 2w, 2w + 1
  const int rg = t % G;   // rows 4rg .. 4rg + 3
  const int cg = t / G;   // columns 4cg .. 4cg + 3
  const int ncg = (P + 3) / 4;             // column groups holding the tile
  const int64_t b = static_cast<int64_t>(blockIdx.x) * TILES + tile;
  const bool valid = b < B;                // the last block may hold fewer tiles
  float* T = T_all + tile * W * LD;
  float(*vec)[W] = vec_all[tile];
  float* dinv = dinv_all[tile];

  // ---- the lower triangle into the staging tile, coalesced rows ----
  const float* A = a + b * sab;
  // (a loop of fixed trip count: its 16 loads are all in flight at once)
  float in[W * W / TPT];
#pragma unroll
  for (int n = 0; n < W * W / TPT; ++n) {
    const int f = t + n * TPT, i = f / W, k = f % W;
    if (valid && i < P && k <= i) in[n] = A[i * sar + k];
  }
#pragma unroll
  for (int n = 0; n < W * W / TPT; ++n) {
    const int f = t + n * TPT, i = f / W, k = f % W;
    if (valid && i < P && k <= i) T[i * LD + k] = in[n];
  }
  __syncthreads();
  // rows past P (and a missing tile) are identity rows: they never touch
  // the tile's entries
  float x[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 4 * rg + r, k = 4 * cg + c;
      x[r][c] = k > i ? 0.0f : valid && i < P ? T[i * LD + k] : (i == k ? 1.0f : 0.0f);
    }
  }
  if (cg == 0) {
    *reinterpret_cast<float4*>(&vec[0][4 * rg]) = make_float4(x[0][0], x[1][0], x[2][0], x[3][0]);
  }
  __syncthreads();

  // ---- the column loop ----
  // elements on or below the micro-tile's diagonal (c <= r) belong to S
  // when rg >= cg, those above it when rg > cg; the rest to R
  const bool lo_s = rg >= cg;
  const bool hi_s = rg > cg;
  for (int q = 0; q < ncg; ++q) {
    column_step<G, 0>(x, vec, dinv, q, P, t, rg, cg, ncg, lo_s, hi_s);
    column_step<G, 1>(x, vec, dinv, q, P, t, rg, cg, ncg, lo_s, hi_s);
    column_step<G, 2>(x, vec, dinv, q, P, t, rg, cg, ncg, lo_s, hi_s);
    column_step<G, 3>(x, vec, dinv, q, P, t, rg, cg, ncg, lo_s, hi_s);
  }

  // ---- out: X through the staging tile; L row by row, M = X's upper half
  // transposed with dinv on its diagonal ----
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) T[(4 * rg + r) * LD + 4 * cg + c] = x[r][c];
  __syncthreads();
  if (!valid) return;
  constexpr int TW = TPT < 32 ? TPT : 32;  // threads along a row
  float* Lb = l + b * slb;
  float* Mb = m + b * P * P;
  for (int i = t / TW; i < P; i += TPT / TW) {
    for (int k = t % TW; k < width; k += TW) Lb[i * slr + k] = k <= i ? T[i * LD + k] : 0.0f;
    for (int k = t % TW; k < P; k += TW) {
      Mb[i * P + k] = k < i ? T[k * LD + i] : k == i ? dinv[i] : 0.0f;
    }
  }
}

template <int G>
cudaError_t launch(const float* a, int64_t sab, int64_t sar, float* l, int64_t slb, int64_t slr,
                   int width, float* m, int64_t B, int P, cudaStream_t stream) {
  constexpr int tiles = kThreads / (G * G);
  const int64_t blocks = (B + tiles - 1) / tiles;
  tile_chol_inv_kernel<G><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      a, sab, sar, l, slb, slr, width, m, B, P);
  return cudaGetLastError();
}

}  // namespace

// a: B tiles [P, P] at a + b sab + i sar + k; l: L's rows at l + b slb + i slr
// + k, k < width (zeros past the diagonal); m: [B, P, P] contiguous.
// Returns a cudaError_t; cudaErrorInvalidValue unless 1 <= P <= 64 and
// width >= P.
extern "C" int pyprob_tile_chol_inv_f32(const float* a, int64_t sab, int64_t sar, float* l,
                                        int64_t slb, int64_t slr, int64_t width, float* m,
                                        int64_t B, int64_t P, int64_t device, void* stream) {
  if (P < 1 || P > kMaxP || B < 1 || B > 0x7fffffff || width < P || width > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  const int p = static_cast<int>(P), w = static_cast<int>(width);
  if (P <= 8) {
    err = launch<2>(a, sab, sar, l, slb, slr, w, m, B, p, st);
  } else {
    err = launch<16>(a, sab, sar, l, slb, slr, w, m, B, p, st);
  }
  return static_cast<int>(err);
}
