// Blocked right-looking Cholesky in FP32 of the Schur-reduced pose system,
// for Hopper.
//
// Replaces the TPU kernel tpuslam/ops/cholesky.py:_chol_kernel (entry
// cholesky_pallas). A = L L^T for SPD A [n, n], row-major, factored in place:
// L in the lower triangle, the strict upper triangle zeroed at the end.
// Pivots are rsqrtf(fmaxf(pivot, 1e-30f)) exactly as cholesky.py:69 clamps
// them, so a non-positive pivot does not stop the factorization.
//
// What bounds it: at the sizes the GN solve reaches (n = 384..1536; 768 at the
// trackdrive closure) the work is n^3/3 = 0.15 GFLOP at n = 768, far below
// what the card can do in the time the sequential panel chain takes. The
// chain of n/64 dependent panels, each a short sequence of launches and
// block-wide barriers, bounds it: launch latency and the column-by-column
// panel factorization, not bytes or FLOPs.
//
// Design: a host loop over 64-wide panels with two launches per panel.
//  (a) panel kernel: every block loads the 64x64 diagonal block into shared
//      memory and factors it column by column (clamped rsqrt pivot, scale the
//      column, rank-1 update of the rest of the block); block 0 stores the
//      factor in a scratch buffer that the wrapper provides. The matrix's own
//      diagonal block is not written during the panel, so no block can read
//      a half-written one and no grid-wide barrier is needed. Each thread then
//      updates one row of the sub-panel below (L21 = A21 L11^-T) with the row
//      held in registers, in the operation order of the right-looking update
//      (scale column j by its inverse pivot, then subtract its rank-1 term
//      from the columns after it).
//  (b) trailing update: A22 -= L21 L21^T over a 2-D grid of 32x32 output
//      tiles on and below the diagonal (tiles above it exit at once), both
//      operand strips staged in shared memory, FP32 FMA. No TF32 and no
//      tensor cores.
// A last launch writes the stored diagonal factors back and zeroes the strict
// upper triangle. The 128-wide panels of the TPU kernel came from its 128x128
// matrix unit; 64 keeps the diagonal block and a sub-panel row within one
// block's shared memory and one thread's registers. Ragged n is masked in
// every kernel, so the input is not padded. At n = 768 that is 12 panel + 11
// trailing launches plus the final one: 24 launches.
#include <cuda_runtime.h>

namespace {

constexpr int kPanel = 64;          // panel width
constexpr int kPanelThreads = 64;   // one per panel column; sub-panel rows per block
static_assert(kPanelThreads == kPanel, "the diagonal factorization maps a thread to a column");
constexpr int kTile = 32;           // trailing-update output tile
constexpr int kTileRowsPerPass = 8;

__global__ void __launch_bounds__(kPanelThreads)
panel_kernel(float* __restrict__ a, float* __restrict__ diag, int n, int k0) {
  __shared__ float d[kPanel][kPanel + 1];
  __shared__ float inv_d[kPanel];
  const int nb = min(kPanel, n - k0);
  const int tid = threadIdx.x;

  for (int t = tid; t < nb * nb; t += kPanelThreads) {
    const int r = t / nb, c = t % nb;
    d[r][c] = a[(size_t)(k0 + r) * n + k0 + c];
  }
  __syncthreads();
  for (int j = 0; j < nb; ++j) {
    const float inv = rsqrtf(fmaxf(d[j][j], 1e-30f));
    __syncthreads();  // every thread has read the pivot
    for (int r = j + tid; r < nb; r += kPanelThreads) d[r][j] *= inv;
    if (tid == 0) inv_d[j] = inv;
    __syncthreads();
    // rank-1 update of the trailing triangle: thread c owns column c
    const int c = tid;
    if (c > j && c < nb) {
      const float l_cj = d[c][j];
      for (int r = c; r < nb; ++r) d[r][c] -= d[r][j] * l_cj;
    }
    __syncthreads();
  }
  if (blockIdx.x == 0) {
    float* out = diag + (size_t)(k0 / kPanel) * kPanel * kPanel;
    for (int t = tid; t < nb * nb; t += kPanelThreads) out[t] = d[t / nb][t % nb];
  }
  // Sub-panel rows exist only below a full panel (nb == kPanel).
  const int r = k0 + kPanel + blockIdx.x * kPanelThreads + tid;
  if (r >= n) return;
  float* row = a + (size_t)r * n + k0;
  float x[kPanel];
#pragma unroll
  for (int j = 0; j < kPanel; ++j) x[j] = row[j];
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    x[j] *= inv_d[j];
#pragma unroll
    for (int k = j + 1; k < kPanel; ++k) x[k] -= x[j] * d[k][j];
  }
#pragma unroll
  for (int j = 0; j < kPanel; ++j) row[j] = x[j];
}

__global__ void trailing_kernel(float* __restrict__ a, int n, int k0) {
  const int ti = blockIdx.y, tj = blockIdx.x;
  if (tj > ti) return;  // strictly above the diagonal: not needed
  __shared__ float sa[kTile][kPanel + 1];
  __shared__ float sb[kTile][kPanel + 1];
  const int k1 = k0 + kPanel;
  const int r0 = k1 + ti * kTile, c0 = k1 + tj * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int rr = ty; rr < kTile; rr += kTileRowsPerPass) {
    for (int kk = tx; kk < kPanel; kk += kTile) {
      const int r = r0 + rr, c = c0 + rr;
      sa[rr][kk] = r < n ? a[(size_t)r * n + k0 + kk] : 0.f;
      sb[rr][kk] = c < n ? a[(size_t)c * n + k0 + kk] : 0.f;
    }
  }
  __syncthreads();
  const int c = c0 + tx;
  for (int rr = ty; rr < kTile; rr += kTileRowsPerPass) {
    const int r = r0 + rr;
    if (r >= n || c >= n) continue;
    float acc = 0.f;
#pragma unroll 16
    for (int kk = 0; kk < kPanel; ++kk) acc = fmaf(sa[rr][kk], sb[tx][kk], acc);
    a[(size_t)r * n + c] -= acc;
  }
}

// Diagonal blocks from the stored factors, zeros above the diagonal.
__global__ void finish_kernel(float* __restrict__ a, const float* __restrict__ diag, int n) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)n * n) return;
  const int r = t / n, c = t % n;
  if (c > r) {
    a[t] = 0.f;
  } else if (r / kPanel == c / kPanel) {
    const int k0 = r / kPanel * kPanel;
    const int nb = min(kPanel, n - k0);
    a[t] = diag[(size_t)(k0 / kPanel) * kPanel * kPanel + (r - k0) * nb + (c - k0)];
  }
}

}  // namespace

// `diag` is scratch for ceil(n / 64) diagonal 64x64 factors.
extern "C" int tpuslam_cholesky(void* a_ptr, void* diag_ptr, int n, void* stream) {
  if (n <= 0) return 0;
  float* a = static_cast<float*>(a_ptr);
  float* diag = static_cast<float*>(diag_ptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int k0 = 0; k0 < n; k0 += kPanel) {
    const int below = n - k0 - kPanel;  // sub-panel / trailing rows
    const int blocks = below > 0 ? (below + kPanelThreads - 1) / kPanelThreads : 1;
    panel_kernel<<<blocks, kPanelThreads, 0, s>>>(a, diag, n, k0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (below > 0) {
      const int tiles = (below + kTile - 1) / kTile;
      trailing_kernel<<<dim3(tiles, tiles), dim3(kTile, kTileRowsPerPass), 0, s>>>(a, n, k0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  const int threads = 256;
  const size_t total = (size_t)n * n;
  finish_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(a, diag, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpuslam_cholesky_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
