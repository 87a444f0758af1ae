// Type-gated nearest association of observations to landmarks, for Hopper.
//
// Replaces the TPU kernel tpuslam/ops/pallas_assoc.py:_assoc_kernel
// (entry associate_pallas). For each observation i, over all landmarks j:
//   cost = dx*dx + dy*dy                          (Euclidean), or
//   cost = a*dx*dx + 2*b*dx*dy + c*dy*dy          (Mahalanobis, packed (a,b,c))
// with dx = ox - lx, dy = oy - ly; a landmark counts only when
// type_obs == type_lm and cost < gate2. Outputs the lowest-index minimum
// (idx, matched = cost < 1e30, cost); an unmatched observation gets idx 0 and
// cost 1e30, as on the TPU. Optional masks: an observation with
// obs_valid[i] false, or a landmark at j >= *lm_count, never matches (the
// TPU caller's types -2 and -1).
//
// Sessions: every input and output may carry a leading session axis S (the
// JAX package vmaps its kernel over independent sessions, which puts S on
// the Pallas grid). Session s reads its own observations, landmarks,
// covariances and landmark count and writes its own outputs; one launch
// covers all S, with the session as the grid's y dimension, so a cluster
// never spans two sessions. S = 1 is the unbatched call.
//
// What bounds it, on the H100 (67 TFLOP/s FP32, 3.35 TB/s): at the
// per-frame shape (N = 64, M = 256) the 4.4 KB it must move take 1.3 ns, at
// the blocked pipeline's (N = 2048, M = 256) and the pod-scale map's
// (N = 512, M = 4096) the 5 flops per pair take 39 ns and 157 ns. All three
// are far below a launch, so what bounds a call is latency: the length of
// the longest thread's serial walk over landmarks, and the launch itself.
// The cost is evaluated with __fmul_rn/__fadd_rn in the order of
// pallas_assoc.py:53-55, so no FMA contraction changes a last bit: the
// kernel agrees bit for bit with the plain PyTorch version (one op per
// arithmetic step) and a gate decision cannot flip between the two. Without
// FMA the reachable FP32 rate is half the peak the bound assumes.
//
// Design: the N x M pairs are cut into tiles of 32 observations times
// landmark chunks of 256. A block of 8 warps holds one tile, one
// observation per lane, in every warp; it stages a chunk in shared memory,
// one landmark per thread with coalesced loads (xy and type as one float4,
// the covariance as (a, 2b, c)), issues the loads of its next chunk, and
// walks the staged one: warp w takes landmarks w, w + 8, ... of it, so a
// thread's walk is 32 long. The blocks of one tile form a thread-block
// cluster of up to 8 along the landmark axis: rank r takes chunks r, r + C,
// r + 2C, ... The running (cost, idx) of a thread takes a candidate on a
// strict '<' in increasing index order; the 8 warps' partials are reduced in
// shared memory and the ranks' through distributed shared memory by rank 0,
// both by the lexicographic rule (smaller cost, then smaller index), which
// gives the lowest index among equal minima in any order of combination.
// One launch, no scratch, no atomics; invalid or ragged entries are staged as
// NaN coordinates, whose cost fails the gate. The caller picks the cluster
// size (ops/assoc_kernel.py:_plan): a cluster barrier costs
// about as much as a 256-landmark walk, so only a map of more than one chunk
// is split over a cluster, as wide as one wave of blocks allows.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = kThreads;  // one staged landmark per thread
constexpr int kMaxCluster = 8;
constexpr float kBig = 1e30f;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

// (c, j) before (best, arg) in the lexicographic order
__device__ __forceinline__ bool before(float c, int j, float best, int arg) {
  return c < best || (c == best && j < arg);
}

template <bool kMahalanobis>
__global__ void __launch_bounds__(kThreads)
    assoc_kernel(const float2* __restrict__ obs_xy, const void* __restrict__ obs_type,
                 long long obs_type_stride, int obs_type_float,
                 const bool* __restrict__ obs_valid, const float2* __restrict__ lm_xy,
                 const int* __restrict__ lm_type, const float* __restrict__ lm_cov,
                 const int* __restrict__ lm_count, int n, int m, float gate2,
                 long long obs_type_sstride, int* __restrict__ idx_out,
                 float* __restrict__ cost_out, bool* __restrict__ matched_out) {
  __shared__ float4 s_lm[kThreads];                          // (x, y, type bits, -)
  __shared__ float4 s_cov[kMahalanobis ? kThreads : 1];      // (a, 2b, c, -)
  __shared__ float s_cost[kWarps][32];
  __shared__ int s_idx[kWarps][32];

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = (blockIdx.x / csize) * 32 + lane;

  // this block's session: shift every pointer to its rows
  const long long sn = static_cast<long long>(blockIdx.y) * n;
  const long long sm = static_cast<long long>(blockIdx.y) * m;
  obs_xy += sn;
  obs_type = static_cast<const int*>(obs_type) + blockIdx.y * obs_type_sstride;
  if (obs_valid != nullptr) obs_valid += sn;
  lm_xy += sm;
  lm_type += sm;
  if constexpr (kMahalanobis) lm_cov += 3 * sm;
  if (lm_count != nullptr) lm_count += blockIdx.y;
  idx_out += sn;
  cost_out += sn;
  matched_out += sn;

  float ox = nan_f(), oy = nan_f();
  int ot = 0;
  if (i < n && (obs_valid == nullptr || obs_valid[i])) {
    const float2 o = obs_xy[i];
    ox = o.x;
    oy = o.y;
    ot = obs_type_float
             ? __float2int_rz(static_cast<const float*>(obs_type)[i * obs_type_stride])
             : static_cast<const int*>(obs_type)[i * obs_type_stride];
  }
  const int m_valid = lm_count == nullptr ? m : min(m, *lm_count);

  // Thread t stages landmark base + t of each chunk; the next chunk's loads
  // are issued before the current one is walked.
  float4 lm = make_float4(0.f, 0.f, 0.f, 0.f), cov = lm;
  auto fetch = [&](int base) {
    const int j = base + static_cast<int>(threadIdx.x);
    if (j < m) {
      const float2 p = j < m_valid ? lm_xy[j] : make_float2(nan_f(), nan_f());
      lm = make_float4(p.x, p.y, __int_as_float(lm_type[j]), 0.f);
      if constexpr (kMahalanobis) {
        const float* c = lm_cov + 3 * static_cast<long long>(j);
        cov = make_float4(c[0], __fmul_rn(2.0f, c[1]), c[2], 0.f);
      }
    }
  };
  const int stride = csize * kChunk;
  float best = kBig;
  int arg = 0;
  if (rank * kChunk < m) fetch(rank * kChunk);
  for (int base = rank * kChunk; base < m; base += stride) {
    const int cnt = min(kChunk, m - base);
    __syncthreads();  // the previous chunk is consumed
    s_lm[threadIdx.x] = lm;
    if constexpr (kMahalanobis) s_cov[threadIdx.x] = cov;
    __syncthreads();
    if (base + stride < m) fetch(base + stride);
    for (int k = warp; k < cnt; k += kWarps) {
      const float4 l = s_lm[k];
      const float dx = __fsub_rn(ox, l.x);
      const float dy = __fsub_rn(oy, l.y);
      float cost;
      if constexpr (kMahalanobis) {
        const float4 q = s_cov[k];
        const float t1 = __fmul_rn(__fmul_rn(q.x, dx), dx);
        const float t2 = __fmul_rn(__fmul_rn(q.y, dx), dy);
        const float t3 = __fmul_rn(__fmul_rn(q.z, dy), dy);
        cost = __fadd_rn(__fadd_rn(t1, t2), t3);
      } else {
        cost = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      }
      if (__float_as_int(l.z) == ot && cost < gate2 && cost < best) {
        best = cost;
        arg = base + k;
      }
    }
  }

  s_cost[warp][lane] = best;
  s_idx[warp][lane] = arg;
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < kWarps; ++w) {
      const float c = s_cost[w][lane];
      const int j = s_idx[w][lane];
      if (before(c, j, best, arg)) {
        best = c;
        arg = j;
      }
    }
    s_cost[0][lane] = best;
    s_idx[0][lane] = arg;
  }
  if (csize > 1) {
    cluster.sync();  // every rank's row 0 is written and visible
    if (rank == 0 && warp == 0) {
      for (int r = 1; r < csize; ++r) {
        const float c = cluster.map_shared_rank(&s_cost[0][0], r)[lane];
        const int j = cluster.map_shared_rank(&s_idx[0][0], r)[lane];
        if (before(c, j, best, arg)) {
          best = c;
          arg = j;
        }
      }
    }
    cluster.sync();  // no rank leaves while rank 0 still reads its shared memory
  }
  if (rank == 0 && warp == 0 && i < n) {
    idx_out[i] = arg;
    cost_out[i] = best;
    matched_out[i] = best < kBig;
  }
}

// Whether a cluster of `csize` blocks of the kernel fits on the card: checked
// once per (form, size) with cudaOccupancyMaxActiveClusters, then cached
// (0 unknown, 1 fits, else the error to return).
int g_fits[2][kMaxCluster + 1];

template <bool kMahalanobis>
int cluster_fits(const cudaLaunchConfig_t& cfg, int csize) {
  int& state = g_fits[kMahalanobis][csize];
  if (state == 0) {
    int clusters = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, assoc_kernel<kMahalanobis>, &cfg);
    if (err == cudaSuccess && clusters < 1) err = cudaErrorInvalidClusterSize;
    state = err == cudaSuccess ? 1 : static_cast<int>(err);
  }
  return state == 1 ? 0 : state;
}

template <bool kMahalanobis>
int launch(cudaLaunchConfig_t& cfg, int csize, const void* obs_xy, const void* obs_type,
           long long obs_type_stride, int obs_type_float, const void* obs_valid,
           const void* lm_xy, const void* lm_type, const void* lm_cov, const void* lm_count,
           int n, int m, float gate2, long long obs_type_sstride, void* idx, void* cost,
           void* matched) {
  if (const int err = cluster_fits<kMahalanobis>(cfg, csize)) return err;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, assoc_kernel<kMahalanobis>, static_cast<const float2*>(obs_xy), obs_type,
      obs_type_stride, obs_type_float, static_cast<const bool*>(obs_valid),
      static_cast<const float2*>(lm_xy), static_cast<const int*>(lm_type),
      static_cast<const float*>(lm_cov), static_cast<const int*>(lm_count), n, m, gate2,
      obs_type_sstride, static_cast<int*>(idx), static_cast<float*>(cost),
      static_cast<bool*>(matched));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on `stream` for `sessions` sessions, each of n observations and
// m landmarks, stored session after session: obs_xy [S, n, 2], lm_xy
// [S, m, 2], lm_type [S, m], lm_cov [S, m, 3]. obs_type is int32, or float32
// when obs_type_float (truncated toward zero), read at
// obs_type[s * obs_type_sstride + i * obs_type_stride]; obs_valid ([S, n]
// bool) and lm_count ([S] int32 on the device) may be null. Writes idx int32,
// cost f32 and matched bool, each [S, n]. `csize` (1..8) blocks of one
// cluster share 32 observations of one session; each walks landmark chunks
// of 256. Returns a cudaError_t; n <= 0 or sessions <= 0 launches nothing.
extern "C" int tpuslam_assoc(const void* obs_xy, const void* obs_type,
                             long long obs_type_stride, long long obs_type_sstride,
                             int obs_type_float, const void* obs_valid, const void* lm_xy,
                             const void* lm_type, const void* lm_cov, const void* lm_count,
                             int sessions, int n, int m, float gate2, int mahalanobis,
                             int csize, void* idx, void* cost, void* matched, void* stream) {
  if (n <= 0 || sessions <= 0) return 0;
  if (csize < 1 || csize > kMaxCluster || sessions > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((n + 31) / 32) * csize, sessions);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto go = mahalanobis ? launch<true> : launch<false>;
  return go(cfg, csize, obs_xy, obs_type, obs_type_stride, obs_type_float, obs_valid, lm_xy,
            lm_type, lm_cov, lm_count, n, m, gate2, obs_type_sstride, idx, cost, matched);
}

extern "C" const char* tpuslam_assoc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
