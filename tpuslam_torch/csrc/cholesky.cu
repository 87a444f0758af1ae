// Tiled Cholesky in FP32 of the Schur-reduced pose system, for Hopper: one
// cooperative launch of persistent blocks factors a batch of S matrices.
//
// Replaces the TPU kernel tpuslam/ops/cholesky.py:_chol_kernel (entry
// cholesky_pallas, which the JAX package's batched sessions vmap over S).
// A_s = L_s L_s^T for each SPD A_s [n, n] of a batch [S, n, n], row-major,
// factored in place: L in the lower triangle, the strict upper triangle
// zeroed. Pivots are rsqrtf(fmaxf(pivot, 1e-30f)) exactly as cholesky.py:69
// clamps them, so a non-positive pivot does not stop the factorization.
// S = 1 is the single factorization.
//
// What bounds it: at the sizes the GN solve reaches (n = 384..1536; 768 at the
// trackdrive closure) the work is n^3/3 = 0.15 GFLOP at n = 768, 2.25 us at
// the card's 67 TFLOP/s FP32 rate, and the 4.7 MB it must move take 1.4 us.
// Neither is what costs time: the factorization is a chain of n/32 dependent
// steps (factor a diagonal tile, solve the tile below it against it, update
// the next diagonal tile), and the latency of that chain bounds it: a warp's
// sequential column loops and the hand-over of each result through L2.
//
// Design: the matrix is cut into 32x32 tiles, and each tile of the lower
// triangle is computed once, left-looking: A_ij - sum_{k<j} L_ik L_jk^T in
// registers, then a triangular solve against L_jj, or for a diagonal tile its
// factorization. Tasks are numbered column by column and claimed in that order
// from an atomic counter by a grid of co-resident persistent blocks
// (cudaLaunchCooperativeKernel, so a grid that cannot be co-resident is refused
// rather than deadlocking). A task depends only on lower-numbered tasks, so the
// lowest unfinished task can always run. In a batch, task k of matrix s is
// global task k * S + s: the S independent chains advance together, step by
// step, and the blocks spread over S chains instead of waiting on one; each
// matrix has its own tile flags and inverse pivots. Each finished tile sets
// its own ready flag (release); a block waits (acquire) only for the tiles it
// reads, and reads them past L1 (__ldcg), since L1 is not coherent across
// SMs. That gives look-ahead for free: while the chain advances, the other
// blocks sum the tiles of later columns from what is already finished. The
// sub-diagonal tile (j + 1, j) and the diagonal tile (j + 1, j + 1) are one
// task, so the chain hands over once per step: the block sums both from the
// same L_{j+1,k} tiles, waits for L_jj, solves, publishes L_{j+1,j},
// subtracts its product from the diagonal tile and factors it. A diagonal
// tile is factored once, by one warp, a row per lane in registers, the pivot
// broadcast with __shfl_sync, the pivot column through shared memory, and no
// block-wide barrier in the column loop.
//
// Sums: each earlier tile's 32 products are summed by FMA from zero, and that
// partial sum is subtracted from the tile; inside a tile the column loops
// subtract one FMA-rounded rank-1 term at a time. The order is fixed per tile,
// whichever block runs it, so every run gives the same bits. The closure's
// Schur matrix is ill-conditioned in its last pose rows (condition ~2e6):
// there the FP32 factor is held to float64, not to the plain twin's op order
// (chip_smoke.py phase 5). Arithmetic is FP32 on the CUDA cores: no TF32 and
// no tensor cores (the GN contract is full FP32), which at these sizes cost
// nothing. One matrix stays in L2 (2.4 MB at n = 768, 9.4 MB at n = 1536); a
// batch need not: at S = 16, n = 1152 the matrices take 85 MB against L2's
// 50 MB, and since the chains advance together, the tiles a step reads come
// from HBM.
// Tiles above the diagonal are zeroing tasks after the last lower tile, for
// blocks that have run out of work. Ragged n is masked (rows and columns past
// n are zero, the diagonal's padding the identity), so the input is not
// padded. Scratch (the claim counter, the tile flags and the inverse pivots)
// comes from the wrapper; the kernel zeroes the counter and flags itself,
// behind one grid-wide barrier at its start.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kT = 32;                        // tile edge: one lane per tile row
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = kT / kWarps;   // tile rows each thread sums
constexpr int kMaxBlocksPerSm = 2;            // more blocks only add flag polling
constexpr unsigned kFull = 0xffffffffu;
// A flag wait longer than this means a broken ordering invariant (a whole
// factorization at n = 1536 takes well under a millisecond).
constexpr unsigned long long kWaitLimitNs = 2'000'000'000ull;

using Tile = float[kT][kT + 1];               // +1: column reads without bank conflicts

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.global.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// x - a * b, rounded once (FMA).
__device__ __forceinline__ float rank1(float x, float a, float b) { return fmaf(-a, b, x); }

// Flag index of lower tile (i, j), i >= j.
__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// One thread waits until `flag` is set; the caller then barriers the block.
// A wait past kWaitLimitNs on the device clock traps, so the launch fails
// with an error instead of hanging the card (the trap also ends the
// process's CUDA context).
__device__ __forceinline__ void wait_flag(const int* flag) {
  if (ld_acquire(flag)) return;
  const unsigned long long deadline = now_ns() + kWaitLimitNs;
  for (unsigned spins = 0; !ld_acquire(flag); ++spins) {
    if (spins < 64) continue;
    __nanosleep(32);
    if (now_ns() > deadline) __trap();
  }
}

// Tile (ti, tj) of `a` into shared memory, zero past n, read past L1.
__device__ __forceinline__ void load_tile(Tile& s, const float* a, int n, int ti, int tj) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = tj * kT + lane;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int rr = warp + q * kWarps, r = ti * kT + rr;
    s[rr][lane] = (r < n && c < n) ? __ldcg(a + (size_t)r * n + c) : 0.f;
  }
}

__device__ __forceinline__ void store_tile(const Tile& s, float* a, int n, int ti, int tj) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = tj * kT + lane;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int rr = warp + q * kWarps, r = ti * kT + rr;
    if (r < n && c < n) a[(size_t)r * n + c] = s[rr][lane];
  }
}

// One warp factors the diagonal tile in `s` in place: lane r holds row r,
// the right-looking column loop of the twin. The pivot comes from its lane by
// __shfl_sync; the scaled column goes through `col` in shared memory and
// comes back as float4 broadcasts, a quarter of the instructions of one
// shuffle per element. Writes the inverse pivots to `inv` and zeroes the
// strict upper triangle of the tile. Entries above the diagonal are updated
// in registers but never read.
__device__ __forceinline__ void factor_diagonal(Tile& s, float* inv, float* col) {
  const int lane = threadIdx.x & 31;
  float x[kT];
#pragma unroll
  for (int c = 0; c < kT; ++c) x[c] = s[lane][c];
  float my_inv = 0.f;
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    const float d = rsqrtf(fmaxf(__shfl_sync(kFull, x[j], j), 1e-30f));
    if (lane == j) my_inv = d;
    x[j] *= d;
    col[lane] = x[j];
    __syncwarp();
#pragma unroll
    for (int g = (j + 1) / 4; g < kT / 4; ++g) {
      const float4 v = reinterpret_cast<const float4*>(col)[g];
      const float l[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * g + u > j) x[4 * g + u] = rank1(x[4 * g + u], x[j], l[u]);
    }
    __syncwarp();
  }
#pragma unroll
  for (int c = 0; c < kT; ++c) s[lane][c] = c <= lane ? x[c] : 0.f;
  inv[lane] = my_inv;
}

// One warp solves the off-diagonal tile in `s` against the factored diagonal
// tile `l` (X L^T = S, row by row, a row per lane) with its inverse pivots.
__device__ __forceinline__ void solve_rows(Tile& s, const Tile& l, const float* inv) {
  const int lane = threadIdx.x & 31;
  float x[kT];
#pragma unroll
  for (int c = 0; c < kT; ++c) x[c] = s[lane][c];
  const float my_inv = __ldcg(inv + lane);
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    x[j] *= __shfl_sync(kFull, my_inv, j);
#pragma unroll
    for (int c = j + 1; c < kT; ++c) x[c] = rank1(x[c], x[j], l[c][j]);
  }
#pragma unroll
  for (int c = 0; c < kT; ++c) s[lane][c] = x[c];
}

// The tile task's running value: rows warp + q * kWarps, column lane, of
// A_ij - sum_k L_ik L_jk^T.
struct TileSum {
  float x[kRowsPerThread];
};

// x = tile (i, j) of A, zero past n but the identity on the diagonal.
__device__ __forceinline__ void init_sum(TileSum& t, const float* a, int n, int i, int j) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = j * kT + lane;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int r = i * kT + warp + q * kWarps;
    t.x[q] = (r < n && c < n) ? __ldcg(a + (size_t)r * n + c) : (r == c ? 1.f : 0.f);
  }
}

// Subtract L_ik L_jk^T (tiles `li`, `lj` in shared memory) from the sum:
// the 32 products summed by FMA from zero, then subtracted.
__device__ __forceinline__ void subtract_products(TileSum& t, const Tile& li, const Tile& lj) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float p[kRowsPerThread] = {};
#pragma unroll 8
  for (int kk = 0; kk < kT; ++kk) {
    const float b = lj[lane][kk];
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) p[q] = fmaf(li[warp + q * kWarps][kk], b, p[q]);
  }
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) t.x[q] -= p[q];
}

__device__ __forceinline__ void sum_to_shared(const TileSum& t, Tile& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) s[warp + q * kWarps][lane] = t.x[q];
}

// Store the finished tile (i, j) from shared memory and set its flag.
__device__ __forceinline__ void publish_tile(const Tile& s, float* a, int* flags, int n, int i,
                                             int j) {
  store_tile(s, a, n, i, j);
  __syncthreads();
  if (threadIdx.x == 0) st_release(flags + tri(i, j), 1);   // after the barrier: cumulative
}

// Task t -> tile (i, j). Task 0 is the diagonal tile (0, 0); then, column j
// by column j (j < p - 1), the tiles (i, j), i > j, top down, where the first,
// (j + 1, j), also factors the diagonal tile (j + 1, j + 1) that waits on it;
// after them the strict upper tiles, row by row.
__device__ __forceinline__ void task_tile(int t, int p, int n_lower, int& i, int& j) {
  if (t == 0) {
    i = j = 0;
  } else if (t < n_lower) {
    for (t -= 1, j = 0; t >= p - 1 - j; ++j) t -= p - 1 - j;
    i = j + 1 + t;
  } else {
    t -= n_lower;
    for (i = 0; t >= p - 1 - i; ++i) t -= p - 1 - i;
    j = i + 1 + t;
  }
}

__global__ void __launch_bounds__(kThreads)
persistent_cholesky(float* __restrict__ a_all, int* __restrict__ work,
                    float* __restrict__ inv_all, int n, int batch) {
  __shared__ Tile s_a, s_b;
  __shared__ __align__(16) float s_col[kT];
  __shared__ int s_task;
  const int p = (n + kT - 1) / kT;
  const int n_lower = 1 + p * (p - 1) / 2, n_tasks = n_lower + p * (p - 1) / 2;
  const int n_flags = p * (p + 1) / 2;
  int* counter = work;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (long long t = blockIdx.x * kThreads + threadIdx.x; t <= (long long)batch * n_flags;
       t += gridDim.x * kThreads)
    work[t] = 0;
  cg::this_grid().sync();

  for (;;) {
    if (threadIdx.x == 0) s_task = atomicAdd(counter, 1);
    __syncthreads();
    const int g = s_task;
    __syncthreads();
    if (g >= n_tasks * batch) break;
    // global task g is task t of matrix ms
    const int t = g / batch, ms = g - t * batch;
    float* a = a_all + (size_t)ms * n * n;
    int* flags = work + 1 + (size_t)ms * n_flags;
    float* inv = inv_all + (size_t)ms * p * kT;
    int i, j;
    task_tile(t, p, n_lower, i, j);
    if (t >= n_lower) {   // strict upper tile: zeros
      const int c = j * kT + lane;
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const int r = i * kT + warp + q * kWarps;
        if (r < n && c < n) a[(size_t)r * n + c] = 0.f;
      }
      continue;
    }
    if (i == 0) {   // tile (0, 0): nothing to subtract
      TileSum d;
      init_sum(d, a, n, 0, 0);
      sum_to_shared(d, s_a);
      __syncthreads();
      if (warp == 0) factor_diagonal(s_a, inv, s_col);
      __syncthreads();
      publish_tile(s_a, a, flags, n, 0, 0);
      continue;
    }

    // Off-diagonal tile (i, j); the sub-diagonal one (i == j + 1) also sums
    // the diagonal tile (i, i) from the same L_ik tiles as it goes.
    const bool merged = i == j + 1;
    TileSum x, d;
    init_sum(x, a, n, i, j);
    if (merged) init_sum(d, a, n, i, i);
    for (int k = 0; k < j; ++k) {
      if (threadIdx.x == 0) {
        wait_flag(flags + tri(i, k));
        wait_flag(flags + tri(j, k));
      }
      __syncthreads();
      load_tile(s_a, a, n, i, k);
      load_tile(s_b, a, n, j, k);
      __syncthreads();
      subtract_products(x, s_a, s_b);
      if (merged) subtract_products(d, s_a, s_a);
      __syncthreads();
    }
    sum_to_shared(x, s_a);
    if (threadIdx.x == 0) wait_flag(flags + tri(j, j));
    __syncthreads();
    load_tile(s_b, a, n, j, j);
    __syncthreads();
    if (warp == 0) solve_rows(s_a, s_b, inv + j * kT);
    __syncthreads();
    publish_tile(s_a, a, flags, n, i, j);
    if (merged) {
      subtract_products(d, s_a, s_a);
      __syncthreads();
      sum_to_shared(d, s_a);
      __syncthreads();
      if (warp == 0) factor_diagonal(s_a, inv + i * kT, s_col);
      __syncthreads();
      publish_tile(s_a, a, flags, n, i, i);
    }
  }
}

}  // namespace

// Factors `batch` matrices [n, n] stored one after the other at a_ptr.
// Scratch from the caller: `work` int32 [1 + batch p(p+1)/2] (claim counter,
// each matrix's tile flags) and `inv` f32 [batch 32 p], p = ceil(n / 32).
// One cooperative launch on `stream`; returns its cudaError_t.
extern "C" int tpuslam_cholesky(void* a_ptr, void* work_ptr, void* inv_ptr, int n, int batch,
                                void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, persistent_cholesky, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int p = (n + kT - 1) / kT;
  const int blocks = per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm;
  int grid = blocks * sms;
  const long long tasks = (long long)batch * (1 + p * (p - 1));
  if (tasks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (grid > tasks) grid = static_cast<int>(tasks);
  if (grid < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  float* a = static_cast<float*>(a_ptr);
  int* work = static_cast<int*>(work_ptr);
  float* inv = static_cast<float*>(inv_ptr);
  void* args[] = {&a, &work, &inv, &n, &batch};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(persistent_cholesky), dim3(grid),
                                    dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpuslam_cholesky_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
