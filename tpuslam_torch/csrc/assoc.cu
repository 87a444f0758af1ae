// Type-gated nearest association of observations to landmarks, for Hopper.
//
// Replaces the TPU kernel tpuslam/ops/pallas_assoc.py:_assoc_kernel
// (entry associate_pallas). For each observation i, over all landmarks j:
//   cost = dx*dx + dy*dy                          (Euclidean), or
//   cost = a*dx*dx + 2*b*dx*dy + c*dy*dy          (Mahalanobis, packed (a,b,c))
// with dx = ox - lx, dy = oy - ly; a landmark counts only when
// type_obs == type_lm and cost < gate2. Outputs the lowest-index minimum
// (idx, matched = cost < 1e30, cost); an unmatched observation gets idx 0 and
// cost 1e30, as on the TPU.
//
// What bounds it: at the per-frame shape (N = 64 observations, M = 256
// landmarks) the whole problem is one block and 16k cost evaluations, so the
// launch latency bounds it, not bytes or FLOPs. Larger maps are bound by the
// FP32 issue rate of the cost loop (8 flops per pair, every landmark read
// from shared memory as a broadcast).
//
// Design: one thread per observation, blocks of 128 observations. Each block
// walks the landmarks in tiles of 256 staged through shared memory with
// coalesced loads (xy as float2, type, and the packed covariance as a flat
// run of 3*256 floats). Each thread keeps its running (min, argmin) in
// registers and takes a candidate only on a strict '<', so the lowest
// landmark index wins ties, as the TPU kernel's argmin-then-strict-'<' does.
// Ragged N and M are masked here; no padding landmarks are needed.
// The cost is evaluated with __fmul_rn/__fadd_rn in the order of
// pallas_assoc.py:53-55, so no FMA contraction changes a last bit: the
// kernel agrees bit for bit with the plain PyTorch version (one op per
// arithmetic step) and a gate decision cannot flip between the two.
#include <cuda_runtime.h>

namespace {

constexpr int kObsPerBlock = 128;
constexpr int kLmTile = 256;
constexpr float kBig = 1e30f;

template <bool kMahalanobis>
__global__ void assoc_kernel(const float2* __restrict__ obs_xy,
                             const int* __restrict__ obs_type,
                             const float2* __restrict__ lm_xy,
                             const int* __restrict__ lm_type,
                             const float* __restrict__ lm_cov, int n, int m,
                             float gate2, int* __restrict__ idx_out,
                             bool* __restrict__ matched_out,
                             float* __restrict__ cost_out) {
  __shared__ float2 s_xy[kLmTile];
  __shared__ int s_type[kLmTile];
  __shared__ float s_cov[kMahalanobis ? 3 * kLmTile : 1];

  const int i = blockIdx.x * kObsPerBlock + threadIdx.x;
  const bool active = i < n;
  float2 o = make_float2(0.f, 0.f);
  int ot = 0;
  if (active) {
    o = obs_xy[i];
    ot = obs_type[i];
  }
  float best = kBig;
  int arg = 0;

  for (int base = 0; base < m; base += kLmTile) {
    const int cnt = min(kLmTile, m - base);
    __syncthreads();  // previous tile fully consumed
    for (int t = threadIdx.x; t < cnt; t += kObsPerBlock) {
      s_xy[t] = lm_xy[base + t];
      s_type[t] = lm_type[base + t];
    }
    if constexpr (kMahalanobis) {
      for (int t = threadIdx.x; t < 3 * cnt; t += kObsPerBlock)
        s_cov[t] = lm_cov[3 * base + t];
    }
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < cnt; ++k) {
      const float dx = __fsub_rn(o.x, s_xy[k].x);
      const float dy = __fsub_rn(o.y, s_xy[k].y);
      float cost;
      if constexpr (kMahalanobis) {
        const float a = s_cov[3 * k], b = s_cov[3 * k + 1], c = s_cov[3 * k + 2];
        const float t1 = __fmul_rn(__fmul_rn(a, dx), dx);
        const float t2 = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, b), dx), dy);
        const float t3 = __fmul_rn(__fmul_rn(c, dy), dy);
        cost = __fadd_rn(__fadd_rn(t1, t2), t3);
      } else {
        cost = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      }
      if (s_type[k] == ot && cost < gate2 && cost < best) {
        best = cost;
        arg = base + k;
      }
    }
  }
  if (active) {
    idx_out[i] = arg;
    matched_out[i] = best < kBig;
    cost_out[i] = best;
  }
}

}  // namespace

extern "C" int tpuslam_assoc(const void* obs_xy, const void* obs_type,
                             const void* lm_xy, const void* lm_type,
                             const void* lm_cov, int n, int m, float gate2,
                             int mahalanobis, void* idx_out, void* matched_out,
                             void* cost_out, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kObsPerBlock - 1) / kObsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = mahalanobis ? assoc_kernel<true> : assoc_kernel<false>;
  launch<<<grid, kObsPerBlock, 0, s>>>(
      static_cast<const float2*>(obs_xy), static_cast<const int*>(obs_type),
      static_cast<const float2*>(lm_xy), static_cast<const int*>(lm_type),
      static_cast<const float*>(lm_cov), n, m, gate2,
      static_cast<int*>(idx_out), static_cast<bool*>(matched_out),
      static_cast<float*>(cost_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpuslam_assoc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
