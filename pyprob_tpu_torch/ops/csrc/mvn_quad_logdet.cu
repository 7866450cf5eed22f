// Fused multivariate-normal quadratic form and half log-determinant.
//
// Replaces both Pallas kernels of `pyprob_tpu/ops/mvn_logpdf.py`:
// `_quad_logdet_stacked` (`_chol_solve_stacked_kernel`, particles stacked
// per grid cell) and `_quad_logdet_single` (`_chol_solve_kernel`, one
// matrix), behind the entry point `mvn_quad_logdet`.  Per matrix b, with
// K = cov[b] ([N, N] row-major, float32, symmetric positive definite; only
// its lower triangle is read) and r = diff[b] ([N]):
//   K = L L^T,  z = L^-1 r,
//   out[b] = (z^T z, sum_j log L[j][j])          (= diff^T K^-1 diff, log|K|/2)
// A matrix that is not positive definite gives NaN in both outputs, as
// rsqrt of a negative pivot does in the TPU kernels.  Any N >= 1 and
// B >= 1; no padding of K (the TPU kernels pad N to a multiple of 128).
//
// Bound on an H100: operations.  A matrix reads N(N+1)/2 + N floats (the
// lower triangle and r) and needs N^3/3 + N^2 floating-point operations; at
// B = 8,192, N = 256 that is 1.09 GB (0.32 ms at 3.35 TB/s) and 46.3 GFLOP
// (0.69 ms at 67 TFLOP/s float32); at B = 2,048, N = 512, 92.2 GFLOP,
// 1.38 ms.  All arithmetic is float32 FFMA on the CUDA cores.
//
// Algorithm: the TPU kernels' left-looking panel Cholesky with the forward
// substitution folded in, by factoring the augmented [N + 1, N] matrix
// A = [K; r^T] (its row N is r; its own diagonal is never factored).  For
// each panel of NB = 32 columns j0 .. j0 + w - 1 (w < 32 only in the last):
//   P = A[j0:, j0:j0+w] - L[j0:, :j0] L[j0:j0+w, :j0]^T     (the GEMM)
//   L_jj = chol(P[:w])                                     (the diagonal tile)
//   L[i, j0:j0+w] = P[i] L_jj^-T, row by row               (rows below, and z)
// Row N of L is z, so quad = sum z^2 and half_logdet = sum log diag L_jj.
// In the tile and the row solves d = rsqrt(pivot), L_jj = pivot d and each
// entry below is (P - sum) d, as in the TPU kernels' column recurrence.
//
// Design: a persistent grid; each block owns a slot of device memory that
// the wrapper allocates with torch.empty, N columns of the augmented L
// (rows 0 .. N, stride ldr = N + 1 rounded up to 4), and walks over the
// matrices b = blockIdx.x, blockIdx.x + gridDim.x, ...  Finished panels go
// to the slot column by column and come back through L2 as the GEMM's
// operands: each element of L is read about N / 64 times, and no pass over
// a triangle in device memory is made per column.  Per panel, in chunks
// of MC = 256 rows:
// - A: the chunk's w columns of K (r for row N) go into a staged panel by
//   cp.async, zero-filled above the diagonal and past w.
// - GEMM: the operands L^T[k0:k0+32, chunk rows] and L^T[k0:k0+32, j0:j0+32]
//   stream into shared memory by cp.async, two stages, already k-major (the
//   slot is column-major), so nothing passes through registers.  Groups of
//   128 threads split each 32-deep step (2 groups at 256 threads, 4 at
//   512); a thread holds an 8 x 8 register micro-tile, and per k four
//   16-byte shared loads feed its 64 FFMA.  Warps whose 64 rows lie past
//   the chunk skip the multiply.  The groups then subtract their partial
//   sums from the panel in turn, 16 bytes at a time.
// - Diagonal tile: warp 0 alone, a row per lane in registers, the column
//   loop by __shfl_sync, 4 columns per step of a rolled loop; a ragged
//   last tile is padded with identity rows.
// - Rows below: a thread per row, its 32 values in registers, forward
//   substitution against the tile column by column (16-byte broadcast
//   reads), stored to the slot column by column (a warp writes 32
//   neighbouring rows); the thread of row N adds its z^2.
// That is 2 barriers per 32-deep GEMM step and 4 or 6 per chunk (one per
// split-k group, the tile, the chunk's start): about 100 per matrix at
// N = 256, and none per column.
//
// Budget: 112.1 KB of dynamic shared memory a block (operand stages 72 KB,
// staged panel 36 KB, tile 4 KB), registers capped at 128 a thread
// (__launch_bounds__): 2 blocks of 256 threads per SM, whose phases
// overlap; the grid is the occupancy the runtime reports times the SMs, at
// most B.  Fewer matrices than SMs (B = 1, kernel 6) take 512 threads a
// block, so a lone matrix has 16 warps and 4 split-k groups.  The slots
// take 0.28 GB at B = 2,048, N = 512 (264 blocks).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NB = 32;      // panel width
constexpr int MC = 256;     // panel rows per chunk
constexpr int KC = 32;      // depth of one staged GEMM step
constexpr int PP = NB + 4;  // row stride of the staged panel (16-byte rows)
constexpr int GT = 128;     // threads of a split-k group: 4 warps of 64 rows x 32 columns
constexpr unsigned kFull = 0xffffffffu;

struct Smem {
  float a[2][KC][MC];   // L^T[k0:k0+KC, chunk rows], two stages
  float b[2][KC][NB];   // L^T[k0:k0+KC, j0:j0+32]
  float panel[MC][PP];  // the chunk's A, then P = A - L L^T
  float tcol[NB][NB];   // tcol[c][k] = L_jj[k][c]; identity past w
  float dinv[NB];       // rsqrt of each pivot
  float quad;
};

// 16 bytes from global to shared memory, asynchronously; bytes < 16 reads
// only the first `bytes` and zero-fills the rest.
__device__ __forceinline__ void copy16(void* dst, const float* src, int bytes = 16) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void copy4(void* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// acc[i][j] += sum_k a[k][row(i)] b[k][col(j)] over k = k0 .. k0 + KS - 1, with
// rows row0 + {0..3} and row0 + 32 + {0..3}, columns col0 + {0..3} and
// col0 + 16 + {0..3}: per k, four 16-byte shared loads feed 64 FFMA.
template <int KS>
__device__ __forceinline__ void multiply(const float (&a)[KC][MC], const float (&b)[KC][NB],
                                         float (&acc)[8][8], int row0, int col0, int k0) {
#pragma unroll
  for (int k = k0; k < k0 + KS; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&a[k][row0]);
    const float4 a1 = *reinterpret_cast<const float4*>(&a[k][row0 + 32]);
    const float4 b0 = *reinterpret_cast<const float4*>(&b[k][col0]);
    const float4 b1 = *reinterpret_cast<const float4*>(&b[k][col0 + 16]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int T>
__global__ void __launch_bounds__(T, 512 / T) mvn_quad_logdet_kernel(
    const float* __restrict__ cov, const float* __restrict__ diff, float* work,
    float* __restrict__ out, int B, int N, int ldr, bool aligned) {
  constexpr int G = T / GT;   // split-k groups
  constexpr int KS = KC / G;  // depth of a group's share of a step
  static_assert(T == 256 || T == 512, "256 or 512 threads");
  static_assert(MC <= T, "a thread per row of a chunk");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = tid / GT;
  const int warp_row = 64 * (warp % (GT / 32));  // the warp's 64 rows
  // lane = 4x + y: rows row0 + {0..3} and row0 + 32 + {0..3}, columns
  // col0 + {0..3} and col0 + 16 + {0..3}; a quarter-warp reads 2 row
  // groups and 4 column groups, so both the GEMM's loads and the
  // epilogue's 16-byte read-modify-writes of the panel hit no bank twice
  const int row0 = warp_row + 4 * (lane / 4);
  const int col0 = 4 * (lane % 4);
  auto row_of = [&](int i) { return row0 + (i & 3) + 32 * (i >> 2); };
  auto col_of = [&](int j) { return col0 + (j & 3) + 16 * (j >> 2); };
  // the slot: column k of the augmented L (rows 0 .. N) at Lt + k * ldr
  float* Lt = work + static_cast<int64_t>(blockIdx.x) * N * ldr;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const float* K = cov + static_cast<int64_t>(b) * N * N;
    const float* r = diff + static_cast<int64_t>(b) * N;
    float logdet = 0.0f;  // thread 0's
    if (tid == 0) s.quad = 0.0f;
    for (int j0 = 0; j0 < N; j0 += NB) {
      const int w = min(NB, N - j0);
      const int R = N + 1 - j0;  // rows j0 .. N
      for (int r0 = 0; r0 < R; r0 += MC) {
        // the last panel's columns are in the slot, and the last chunk's
        // tile and solves are done with the panel
        __syncthreads();
        const int rows = min(MC, R - r0);
        const int i0 = j0 + r0;
        // ---- A into the panel, zero outside P (past w, above the
        // diagonal): K's upper triangle is never read; row N is r ----
        for (int f = tid; f < rows * (NB / 4); f += T) {
          const int m = f / (NB / 4), c = 4 * (f % (NB / 4));
          const int i = i0 + m;
          const float* src = i == N ? r + j0 : K + static_cast<int64_t>(i) * N + j0;
          const int valid = i >= j0 + w ? w : min(w, i - j0 + 1);  // leading entries of the row
          const int n = min(max(valid - c, 0), 4);
          if (aligned) {
            copy16(&s.panel[m][c], n > 0 ? src + c : K, 4 * n);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) copy4(&s.panel[m][c + e], e < n ? src + c + e : K, e < n ? 4 : 0);
          }
        }
        // ---- GEMM: L[i0:i0+rows, :j0] L[j0:j0+32, :j0]^T, cp.async double-buffered,
        // each step's KC columns split between the G groups ----
        // (rows past the chunk and right-operand rows past N are not
        // loaded: their products land only in outputs that are dropped)
        const int rows4 = (rows + 3) / 4;
        auto stage = [&](int k0, int buf) {
          for (int f = tid; f < KC * (MC / 4); f += T) {
            const int k = f / (MC / 4), m = 4 * (f % (MC / 4));
            if (m < 4 * rows4) {
              copy16(&s.a[buf][k][m], Lt + static_cast<int64_t>(k0 + k) * ldr + i0 + m);
            }
          }
          for (int f = tid; f < KC * (NB / 4); f += T) {
            const int k = f / (NB / 4), n = 4 * (f % (NB / 4));
            if (j0 + n <= N) copy16(&s.b[buf][k][n], Lt + static_cast<int64_t>(k0 + k) * ldr + j0 + n);
          }
        };
        const int steps = j0 / KC;
        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
        if (steps > 0) stage(0, 0);
        copy_commit();  // A and the first step's operands
        for (int t = 0; t < steps; ++t) {
          if (t + 1 < steps) {
            stage((t + 1) * KC, (t + 1) % 2);
            copy_commit();
            copy_wait<1>();
          } else {
            copy_wait<0>();
          }
          __syncthreads();  // step t's operands are in shared memory
          if (warp_row < rows) {
            multiply<KS>(s.a[t % 2], s.b[t % 2], acc, row0, col0, group * KS);
          }
          __syncthreads();  // step t's buffer is free for step t + 2
        }
        // ---- epilogue: the groups subtract their sums from the panel in turn ----
        if (steps == 0) {
          copy_wait<0>();
          __syncthreads();
        } else {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (group == g && warp_row < rows) {
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const int m = row_of(i);
                if (m < rows) {
                  const int valid = i0 + m >= j0 + w ? w : min(w, i0 + m - j0 + 1);
#pragma unroll
                  for (int j = 0; j < 8; j += 4) {
                    const int c = col_of(j);
                    float4* p = reinterpret_cast<float4*>(&s.panel[m][c]);
                    float4 v = *p;
                    v.x -= c < valid ? acc[i][j] : 0.0f;
                    v.y -= c + 1 < valid ? acc[i][j + 1] : 0.0f;
                    v.z -= c + 2 < valid ? acc[i][j + 2] : 0.0f;
                    v.w -= c + 3 < valid ? acc[i][j + 3] : 0.0f;
                    *p = v;
                  }
                }
              }
            }
            __syncthreads();
          }
        }
        // ---- diagonal tile: warp 0, row `lane` in registers.  Columns in
        // steps of 4, a rolled loop over the steps (on an H100 both the
        // fully unrolled loop and a step per column, whose lane arithmetic
        // and register moves triple a column's instructions, were slower);
        // the row is rotated by 4 each step, so no register is indexed at
        // run time.  Every lane updates every
        // column: entries above the diagonal take garbage that nothing
        // reads (the pivot, the shuffled column and the solve's tcol
        // entries all lie on or below it), and no lane branches. ----
        if (r0 == 0) {
          if (warp == 0) {
            float a[NB];
#pragma unroll
            for (int k = 0; k < NB; k += 4) {
              const float4 v = *reinterpret_cast<const float4*>(&s.panel[lane][k]);
              a[k] = v.x;
              a[k + 1] = v.y;
              a[k + 2] = v.z;
              a[k + 3] = v.w;
            }
#pragma unroll
            for (int k = 0; k < NB; ++k) a[k] = lane < w ? a[k] : (k == lane ? 1.0f : 0.0f);
            float d_own = 1.0f, l_own = 1.0f;
#pragma unroll 1
            for (int j4 = 0; j4 < NB; j4 += 4) {  // a[k] holds column j4 + k
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int j = j4 + q;
                // column j from lanes j4 + k, before scaling, so the
                // shuffles do not wait for the pivot's rsqrt (a lane
                // index past 31 wraps, into columns past the tile)
                float raw[NB];
#pragma unroll
                for (int k = q; k < NB; ++k) raw[k] = __shfl_sync(kFull, a[q], j4 + k);
                const float d = rsqrtf(raw[q]);
                const float l = a[q] * d;  // L[lane][j] for lane >= j
                s.tcol[j][lane] = l;
                d_own = lane == j ? d : d_own;
                l_own = lane == j ? l : l_own;
                const float t = l * d;  // L[lane][j] / L[j][j]
#pragma unroll
                for (int k = q + 1; k < NB; ++k) a[k] = fmaf(-t, raw[k], a[k]);
              }
#pragma unroll
              for (int k = 0; k < NB - 4; ++k) a[k] = a[k + 4];
#pragma unroll
              for (int k = NB - 4; k < NB; ++k) a[k] = 0.0f;
            }
            s.dinv[lane] = d_own;
            float ld = lane < w ? logf(l_own) : 0.0f;
#pragma unroll
            for (int o = 16; o > 0; o /= 2) ld += __shfl_xor_sync(kFull, ld, o);
            logdet += ld;  // lane 0 of warp 0 keeps it
          }
          __syncthreads();
        }
        // ---- rows below the tile: forward substitution, a thread per row,
        // column by column (each column's updates are independent FMAs).
        // A chunk has no more rows than threads: as a loop over rows, the
        // tile's loads would be hoisted out of it and spill. ----
        const int m = tid;
        if (m < rows && (r0 > 0 || m >= w)) {
          float v[NB];
#pragma unroll
          for (int c = 0; c < NB; c += 4) {
            const float4 p = *reinterpret_cast<const float4*>(&s.panel[m][c]);
            v[c] = p.x;
            v[c + 1] = p.y;
            v[c + 2] = p.z;
            v[c + 3] = p.w;
          }
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            v[c] *= s.dinv[c];
#pragma unroll
            for (int k = (c + 1) / 4 * 4; k < NB; k += 4) {
              const float4 t = *reinterpret_cast<const float4*>(&s.tcol[c][k]);
              if (k > c) v[k] = fmaf(-v[c], t.x, v[k]);
              if (k + 1 > c) v[k + 1] = fmaf(-v[c], t.y, v[k + 1]);
              if (k + 2 > c) v[k + 2] = fmaf(-v[c], t.z, v[k + 2]);
              if (k + 3 > c) v[k + 3] = fmaf(-v[c], t.w, v[k + 3]);
            }
          }
          const int i = i0 + m;
          // column c of L at Lt + (j0 + c) ldr: a warp stores 32 neighbouring rows
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            if (c < w) Lt[static_cast<int64_t>(j0 + c) * ldr + i] = v[c];
          }
          if (i == N) {
            float zz = 0.0f;
#pragma unroll
            for (int c = 0; c < NB; ++c) zz = fmaf(v[c], v[c], zz);
            s.quad += zz;
          }
        }
      }
    }
    __syncthreads();
    if (tid == 0) {
      out[2 * static_cast<int64_t>(b)] = s.quad;
      out[2 * static_cast<int64_t>(b) + 1] = logdet;
    }
  }
}

struct Plan {
  int threads;
  int blocks;
  int64_t ldr;
  int64_t workspace;  // floats
};

// Opts the instance in to its dynamic shared memory (above the default
// 48 KB), then asks the runtime how many of its blocks fit on an SM.
template <int T>
cudaError_t occupancy(int* per_sm) {
  const cudaError_t err = cudaFuncSetAttribute(
      mvn_quad_logdet_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, mvn_quad_logdet_kernel<T>, T,
                                                       sizeof(Smem));
}

cudaError_t make_plan(int64_t B, int64_t N, int64_t device, Plan* plan) {
  if (N < 1 || B < 1 || B > 0x7fffffff || N > 46340) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, static_cast<int>(device));
  if (err != cudaSuccess) return err;
  plan->threads = B < sms ? 512 : 256;
  err = plan->threads == 512 ? occupancy<512>(&per_sm) : occupancy<256>(&per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  plan->blocks = static_cast<int>(B < resident ? B : resident);
  plan->ldr = (N + 1 + 3) / 4 * 4;
  plan->workspace = plan->blocks * N * plan->ldr;
  return cudaSuccess;
}

}  // namespace

// The launch for B matrices of size N on `device`: plan = (panel width,
// threads per block, blocks, workspace floats, dynamic shared memory bytes
// a block).  Returns a cudaError_t.
extern "C" int pyprob_mvn_quad_logdet_plan(int64_t B, int64_t N, int64_t device, int64_t* plan) {
  Plan p;
  const cudaError_t err = make_plan(B, N, device, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = NB;
  plan[1] = p.threads;
  plan[2] = p.blocks;
  plan[3] = p.workspace;
  plan[4] = sizeof(Smem);
  return 0;
}

// cov [B, N, N], diff [B, N] -> out [B, 2]; work holds the plan's workspace
// floats.  Returns a cudaError_t.
extern "C" int pyprob_mvn_quad_logdet_f32(const float* cov, const float* diff, float* work,
                                          float* out, int64_t B, int64_t N, int64_t device,
                                          void* stream) {
  Plan p;
  cudaError_t err = make_plan(B, N, device, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(N), ldr = static_cast<int>(p.ldr), b = static_cast<int>(B);
  // K's and r's rows start on 16 bytes: the panel loads go 16 bytes at a time
  const bool aligned = N % 4 == 0 && reinterpret_cast<uintptr_t>(cov) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(diff) % 16 == 0;
  if (p.threads == 512) {
    mvn_quad_logdet_kernel<512><<<p.blocks, 512, sizeof(Smem), st>>>(cov, diff, work, out, b, n,
                                                                     ldr, aligned);
  } else {
    mvn_quad_logdet_kernel<256><<<p.blocks, 256, sizeof(Smem), st>>>(cov, diff, work, out, b, n,
                                                                     ldr, aligned);
  }
  return static_cast<int>(cudaGetLastError());
}
