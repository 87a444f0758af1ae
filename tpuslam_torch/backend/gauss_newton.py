"""Gauss-Newton with landmark Schur elimination (counterpart of
`tpuslam.backend.gauss_newton`).

The same normal equations as the JAX package: block-tridiagonal odometry
blocks plus landmark-edge blocks, gauge clamping of the first two poses and
landmarks by identity rows, Schur elimination of the [L, 2, 2] landmark
diagonal, and a Cholesky of the reduced pose system S. The reduced system
is solved on the smallest 128-pose bucket covering `n_poses`, as the JAX
package does, so the factorized sizes are the same (768 at the trackdrive
closure). Where the JAX package used one-hot matmuls for the TPU, this
module scatters with `index_add_`; on CUDA those sums use atomics, so their
order (and the last bits) vary from run to run.

`GNConfig.matmul_precision` sets the precision of the assembly's matmuls
(the Jacobian products) for the length of one GN call (`precision`):
"highest" is full FP32 and requires TF32 to be off for CUDA matmuls;
"high" runs them in TF32 and "default" under PyTorch's float32 matmul
precision "medium" (bf16 where PyTorch has a fast path for it; on the H100
its cuBLAS matmul measured TF32's error, `chip_smoke.py` phase 5), the
JAX package's mixed-precision GN ("~1e-3 relative error"; "default" is
unsafe near closure-scale graphs). The previous setting comes back on
exit, on error too. The reduced system (the Schur product, its Cholesky and the
triangular solves) runs in FP32 under every setting: a TF32 Schur product
leaves the closure's Schur matrix (condition ~2.4e6) indefinite on the
H100, and its factor NaN.

The fixed-lag window (`window_gn_step`) gathers its W trailing poses and
EW trailing edges at device-side indices, so it needs no host read; its
per-landmark counts and its [3W, L] coupling are `index_add_` scatters.

Batched sessions: `gn_step` and `optimize` also take a stacked graph of S
independent sessions (a leading axis S on every field), as the JAX package's
vmapped closure GN does. A batch of S > 1 is assembled and solved at full
capacity (its `vmap_safe_gn`: no buckets, which would differ between
sessions; a batch of one is solved as its single graph), with
one Cholesky of the [S, 3P, 3P] reduced systems per iteration, and each
session stops at its own iteration count and tolerance: a session that has
converged, or is not enabled, is held by a mask while the others go on.
`window_gn_step` / `optimize_window` take a stacked graph too, with each
session's window anchored at its own `end` / `end_obs`: the sessions that
fire in a block of the batched pipeline are one batched solve.

Host synchronisation: each single-graph `gn_step` reads (n_poses, n_obs)
once to pick its buckets, and `optimize` and `optimize_window` read the
update size once per iteration for their early exit (a batch: its [S]
running mask, once per iteration).
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass

import torch

from tpuslam_torch import compat
from tpuslam_torch.backend.graph import FactorGraph
from tpuslam_torch.backend.residuals import landmark_residuals, odometry_residuals
from tpuslam_torch.geometry import se2
from tpuslam_torch.runtime.tracing import stage

__all__ = ["GNConfig", "assemble", "schur_solve", "schur_solve_split",
           "gn_step", "optimize", "window_gn_step", "optimize_window", "chi2"]


@dataclass(frozen=True)
class GNConfig:
    odo_info: float = compat.REF_ODOMETRY_INFO
    lm_info: float = compat.REF_LANDMARK_INFO
    iterations: int = compat.REF_GN_ITERATIONS
    fix_first_poses: int = 2
    fix_first_landmarks: int = 2
    damping: float = 0.0
    use_cholesky_kernel: bool = False   # factor S with the hand-written
    # CUDA kernel (ops/cholesky.py) instead of torch.linalg.cholesky_ex
    matmul_precision: str = "highest"   # 'highest' (FP32) | 'high' (TF32) | 'default' (medium)
    solve_bucket_step: int = 128        # pose-count granularity of the reduced solve
    edge_bucket_step: int = 2048        # edge-count granularity of the assembly
    early_exit_tol: float = 0.0         # stop once max|update| <= tol (0 = never)


def _edge_weights(g: FactorGraph, cfg: GNConfig):
    dtype = g.poses.dtype
    return torch.tensor(cfg.lm_info, dtype=dtype, device=g.poses.device) \
        * g.obs_valid.to(dtype)


def chi2(g: FactorGraph, cfg: GNConfig):
    """Weighted squared error, including absolute pose priors."""
    dtype = g.poses.dtype
    k = torch.arange(g.poses.shape[0], device=g.poses.device)
    odo_valid = (k >= 1) & (k < g.n_poses)
    p_prev = g.poses[torch.clamp(k - 1, min=0)]
    r_o, _, _ = odometry_residuals(p_prev, g.poses, g.odo_meas)
    w_o = cfg.odo_info * odo_valid.to(dtype) * g.odo_w
    op, ol = _edge_index(g.obs_pose, g.obs_lm, g.poses.shape[0], g.lm_xy.shape[0])
    r_l, _, _ = landmark_residuals(g.poses[op], g.lm_xy[ol], g.obs_xy)
    w_l = _edge_weights(g, cfg)
    pv = g.pose_valid.to(dtype)
    r_pr = g.poses - g.prior_pose
    r_pr = torch.cat([r_pr[:, :2], se2.wrap_angle(r_pr[:, 2:])], dim=1)
    prior = torch.sum(pv * (g.prior_info[:, 0] * torch.sum(r_pr[:, :2] ** 2, -1)
                            + g.prior_info[:, 1] * r_pr[:, 2] ** 2))
    return (torch.sum(w_o * torch.sum(r_o * r_o, -1))
            + torch.sum(w_l * torch.sum(r_l * r_l, -1)) + prior)


def assemble_odometry(g: FactorGraph, cfg: GNConfig):
    """Odometry-chain contribution (+ absolute priors): returns
    (h_diag [P,3,3], h_off [P,3,3], gp [P,3]), each with the graph's leading
    session axis if it has one; h_off[k] is block (k-1, k)."""
    dtype = g.poses.dtype
    k = torch.arange(g.poses.shape[-2], device=g.poses.device)
    n_poses = g.n_poses[..., None]
    odo_valid = (k >= 1) & (k < n_poses)
    p_prev = g.poses[..., torch.clamp(k - 1, min=0), :]
    r_o, j_oi, j_oj = odometry_residuals(p_prev, g.poses, g.odo_meas)
    w_o = cfg.odo_info * odo_valid.to(dtype) * g.odo_w

    w3 = w_o[..., None, None]
    jti = j_oi.transpose(-1, -2)
    jtj = j_oj.transpose(-1, -2)
    a_ii = w3 * (jti @ j_oi)
    a_jj = w3 * (jtj @ j_oj)
    h_off = w3 * (jti @ j_oj)
    g_i = w_o[..., None] * (jti @ r_o[..., None])[..., 0]
    g_j = w_o[..., None] * (jtj @ r_o[..., None])[..., 0]

    h_diag = torch.cat([a_jj[..., :-1, :, :] + a_ii[..., 1:, :, :], a_jj[..., -1:, :, :]], dim=-3)
    gp = torch.cat([g_j[..., :-1, :] + g_i[..., 1:, :], g_j[..., -1:, :]], dim=-2)

    pose_valid = (k < n_poses).to(dtype)
    ixy = g.prior_info[..., 0] * pose_valid
    ith = g.prior_info[..., 1] * pose_valid
    eye_xy = torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=dtype, device=k.device))
    eye_th = torch.diag(torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=k.device))
    h_diag = h_diag + ixy[..., None, None] * eye_xy + ith[..., None, None] * eye_th
    r_prior = g.poses - g.prior_pose
    r_prior = torch.cat([r_prior[..., :2], se2.wrap_angle(r_prior[..., 2:])], dim=-1)
    gp = gp + r_prior * torch.stack([ixy, ixy, ith], dim=-1)
    return h_diag, h_off, gp


def _edge_index(obs_pose, obs_lm, n_pose_rows: int, n_lm_rows: int):
    """Edge rows' pose and landmark indices as long, clamped into range as
    the JAX package's gathers clamp them. Rows past `n_obs` carry zero
    weight but may hold any index: the mapping step leaves its dropped rows
    there, whose landmark slot is the capacity once the store is full (an
    out-of-range index raises on the CPU and asserts on CUDA)."""
    return (torch.clamp(obs_pose.long(), 0, n_pose_rows - 1),
            torch.clamp(obs_lm.long(), 0, n_lm_rows - 1))


def landmark_edge_blocks(poses, lm_xy, obs_pose, obs_lm, obs_xy, w_l):
    """Landmark-edge contribution summed over the given edges, any slice of
    the edge list: returns (h_diag_lm [P,3,3], w [P,3,L,2], hll [L,2,2],
    gp_lm [P,3], gl [L,2]), each with the inputs' leading session axis if
    they have one; w[p, i, l, j] is entry (3p+i, 2l+j) of the coupling W
    [3P, 2L]. The sessions' sums are scattered into one buffer, each at its
    own row offset. Sums over disjoint edge slices add up to the whole
    list's: the distributed Schur reduction's building block."""
    lead = tuple(poses.shape[:-2])
    P, L = poses.shape[-2], lm_xy.shape[-2]
    op, ol = _edge_index(obs_pose, obs_lm, P, L)
    wi = op * L + ol
    if lead:
        sess = torch.arange(poses.shape[0], device=poses.device)[:, None]
        op, ol, wi = op + sess * P, ol + sess * L, wi + sess * (P * L)
    op, ol, wi = op.reshape(-1), ol.reshape(-1), wi.reshape(-1)
    r_l, j_lp, j_ll = landmark_residuals(poses.reshape(-1, 3)[op], lm_xy.reshape(-1, 2)[ol],
                                         obs_xy.reshape(-1, 2))
    w_l = w_l.reshape(-1)
    wl3 = w_l[:, None, None]
    jtp = j_lp.transpose(-1, -2)                       # [E, 3, 2]
    jtl = j_ll.transpose(-1, -2)
    S = poses.shape[0] if lead else 1
    h_diag_lm = torch.zeros((S * P, 3, 3), dtype=poses.dtype, device=poses.device)
    h_diag_lm.index_add_(0, op, wl3 * (jtp @ j_lp))
    gp_lm = torch.zeros((S * P, 3), dtype=poses.dtype, device=poses.device)
    gp_lm.index_add_(0, op, w_l[:, None] * (jtp @ r_l[..., None])[..., 0])
    w = torch.zeros((S * P * L, 3, 2), dtype=poses.dtype, device=poses.device)
    w.index_add_(0, wi, wl3 * (jtp @ j_ll))
    w = w.reshape(*lead, P, L, 3, 2).transpose(-3, -2)
    hll = torch.zeros((S * L, 2, 2), dtype=poses.dtype, device=poses.device)
    hll.index_add_(0, ol, wl3 * (jtl @ j_ll))
    gl = torch.zeros((S * L, 2), dtype=poses.dtype, device=poses.device)
    gl.index_add_(0, ol, w_l[:, None] * (jtl @ r_l[..., None])[..., 0])
    return (h_diag_lm.reshape(*lead, P, 3, 3), w, hll.reshape(*lead, L, 2, 2),
            gp_lm.reshape(*lead, P, 3), gl.reshape(*lead, L, 2))


def _landmark_edge_blocks_split(poses, lm_xy, obs_pose, obs_lm, obs_xy, w_l, n_landmarks: int):
    """`landmark_edge_blocks` of one graph with W as its even/odd column
    halves W0, W1 [3P, L]: (h_diag_lm, w0, w1, hll, gp_lm, gl), the layout
    the pose-chain solvers eliminate from. `n_landmarks` is the number of
    landmark rows, `lm_xy.shape[0]`."""
    if lm_xy.shape[0] != n_landmarks:
        raise ValueError(f"{lm_xy.shape[0]} landmark rows, not {n_landmarks}")
    h_diag_lm, w, hll, gp_lm, gl = landmark_edge_blocks(poses, lm_xy, obs_pose, obs_lm,
                                                        obs_xy, w_l)
    P = poses.shape[0]
    return (h_diag_lm, w[..., 0].reshape(3 * P, n_landmarks),
            w[..., 1].reshape(3 * P, n_landmarks), hll, gp_lm, gl)


def _bucket(count: int, cap: int, step: int) -> int:
    """Smallest multiple of `step` covering `count`, capped at `cap`
    (`cap` itself when bucketing is off)."""
    if step <= 0 or step >= cap:
        return cap
    return min(max(-(-count // step), 1) * step, cap)


def _assemble_blocked(g: FactorGraph, cfg: GNConfig, n_obs: int):
    """Normal-equation blocks before densification: (h_diag, h_off,
    w [P,3,L,2], hll, gp [P,3], gl). Edges run on the smallest edge bucket
    covering `n_obs`; the edge list is append-only, so the tail dropped is
    zero-weight padding."""
    h_diag, h_off, gp_o = assemble_odometry(g, cfg)
    w_l = _edge_weights(g, cfg)
    e = _bucket(n_obs, g.obs_pose.shape[-1], cfg.edge_bucket_step)
    h_diag_lm, w, hll, gp_lm, gl = landmark_edge_blocks(
        g.poses, g.lm_xy, g.obs_pose[..., :e], g.obs_lm[..., :e], g.obs_xy[..., :e, :],
        w_l[..., :e])
    return h_diag + h_diag_lm, h_off, w, hll, gp_o + gp_lm, gl


def densify_hpp(h_diag, h_off):
    """(P,3,3) diagonal + (P,3,3) super-diagonal blocks -> dense [3P, 3P],
    batched over leading axes."""
    lead, P = tuple(h_diag.shape[:-3]), h_diag.shape[-3]
    h = h_diag.new_zeros((*lead, P, P, 3, 3))
    i = torch.arange(P, device=h_diag.device)
    h[..., i, i, :, :] = h_diag
    h[..., i[:-1], i[1:], :, :] = h_off[..., 1:, :, :]
    h[..., i[1:], i[:-1], :, :] = h_off[..., 1:, :, :].transpose(-1, -2)
    return h.transpose(-3, -2).reshape(*lead, 3 * P, 3 * P)


def assemble(g: FactorGraph, cfg: GNConfig):
    """Dense-blocked normal equations: (Hpp [3P,3P], W [3P,2L], Hll [L,2,2],
    gp [3P], gl [L,2]) — the JAX package's public layout."""
    if g.n_obs.dim():
        raise ValueError("assemble: one graph, not a stacked batch")
    h_diag, h_off, w, hll, gp, gl = _assemble_blocked(g, cfg, int(g.n_obs))
    P, L = w.shape[0], w.shape[2]
    return densify_hpp(h_diag, h_off), w.reshape(3 * P, 2 * L), hll, gp.reshape(-1), gl


def _inv2x2(m):
    """Batched closed-form 2x2 inverse."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    det = torch.where(torch.abs(det) < 1e-20, torch.ones_like(det), det)
    inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return inv / det[..., None, None]


def schur_solve(hpp, w_mat, hll, gp, gl, use_cholesky_kernel=False):
    """Solve the gauged system via landmark Schur elimination (interleaved
    W [3P, 2L] form):  S dp = -gp + W Hll^-1 gl,  dl = -Hll^-1 (gl + W^T dp),
    with S = Hpp - W Hll^-1 W^T."""
    return schur_solve_split(hpp, w_mat[:, 0::2], w_mat[:, 1::2], hll, gp, gl,
                             use_cholesky_kernel=use_cholesky_kernel)


def _mv(a, x):
    """Matrix-vector product, batched over leading axes."""
    return a @ x if a.dim() == 2 else (a @ x[..., None])[..., 0]


def schur_solve_split(hpp, w0, w1, hll, gp, gl, use_cholesky_kernel=False):
    """`schur_solve` on the even/odd W column halves W0/W1 [3P, L], batched
    over leading axes (one Cholesky call for the batch). The reduced
    system (its Schur product, factor and solves) is FP32 whatever the
    GN's matmul precision (`_fp32`)."""
    with _fp32():
        s_w, r_w, hll_inv = _schur_eliminate(w0, w1, hll, gl)
        return _schur_back(hpp - s_w, -gp + r_w, w0, w1, gl, hll_inv, use_cholesky_kernel)


def _schur_eliminate(w0, w1, hll, gl):
    """The landmarks' elimination, batched: (W Hll^-1 W^T [3P, 3P],
    W Hll^-1 gl [3P], Hll^-1 as its packed entries (a, b, c)). Sums of these
    over disjoint landmark sets add up (the map-sharded solves)."""
    hll_inv = _inv2x2(hll)
    ia, ib, ic = hll_inv[..., 0, 0], hll_inv[..., 0, 1], hll_inv[..., 1, 1]
    wa0 = w0 * ia[..., None, :] + w1 * ib[..., None, :]
    wa1 = w0 * ib[..., None, :] + w1 * ic[..., None, :]
    return (wa0 @ w0.mT + wa1 @ w1.mT, _mv(wa0, gl[..., 0]) + _mv(wa1, gl[..., 1]),
            (ia, ib, ic))


def _schur_back(s, rhs, w0, w1, gl, hll_inv, use_cholesky_kernel=False):
    """(dp, dl): the reduced system S dp = rhs factored and solved, then
    dl = -Hll^-1 (gl + W^T dp), with `hll_inv` from `_schur_eliminate`."""
    if use_cholesky_kernel:
        from tpuslam_torch.ops.cholesky import cholesky
        c = cholesky(s)
    else:
        c = torch.linalg.cholesky_ex(s).L
    dp = torch.cholesky_solve(rhs[..., None], c)[..., 0]
    r0, r1 = gl[..., 0] + _mv(w0.mT, dp), gl[..., 1] + _mv(w1.mT, dp)
    ia, ib, ic = hll_inv
    return dp, -torch.stack([ia * r0 + ib * r1, ib * r0 + ic * r1], dim=-1)


def _apply_gauge_blocked(g: FactorGraph, cfg: GNConfig, h_diag, h_off, w, hll, gp, gl):
    """Clamp fixed + padding variables on the block form: identity diagonal
    blocks, zeroed couplings and gradients (batched over a leading session
    axis)."""
    P, L = g.poses.shape[-2], g.lm_xy.shape[-2]
    dtype, dev = h_diag.dtype, h_diag.device
    kp = torch.arange(P, device=dev)
    free_pose = (kp >= cfg.fix_first_poses) & (kp < g.n_poses[..., None])
    kl = torch.arange(L, device=dev)
    free_lm = (kl >= cfg.fix_first_landmarks) & (kl < g.n_landmarks[..., None])

    fpb = free_pose.to(dtype)[..., None, None]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    h_diag = h_diag * fpb + eye3 * (1.0 - fpb)
    pair = free_pose & torch.roll(free_pose, 1, dims=-1)
    pair[..., 0] = False
    h_off = h_off * pair.to(dtype)[..., None, None]

    fl = free_lm.to(dtype)
    w = w * free_pose.to(dtype)[..., None, None, None] * fl[..., None, None, :, None]
    eye2 = torch.eye(2, dtype=dtype, device=dev)
    flb = fl[..., None, None]
    hll = hll * flb + eye2 * (1.0 - flb)
    gp = gp * free_pose.to(dtype)[..., None]
    gl = gl * fl[..., None]
    if cfg.damping:
        h_diag = h_diag + eye3 * cfg.damping * fpb
        hll = hll + eye2 * cfg.damping * flb
    return h_diag, h_off, w, hll, gp, gl


# GNConfig.matmul_precision -> torch.set_float32_matmul_precision
_TORCH_PRECISION = {"highest": "highest", "high": "high", "default": "medium"}


@contextlib.contextmanager
def _matmul_precision(name: str):
    """torch's float32 matmul precision set to `name` inside, the previous
    one back on exit (on error too)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(name)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


@contextlib.contextmanager
def _fp32():
    """Full FP32 matmuls inside (the reduced system), whatever the GN's
    precision; nothing is set when they are FP32 already."""
    if torch.get_float32_matmul_precision() == "highest":
        yield
    else:
        with _matmul_precision("highest"):
            yield


@contextlib.contextmanager
def precision(cfg: GNConfig, t: torch.Tensor):
    """The scope of one GN call under `cfg.matmul_precision`. 'highest'
    sets nothing and refuses a global TF32 on CUDA; 'high' and 'default'
    set torch's 'high' (TF32) and 'medium' for the call and restore the
    previous setting after it, on error too."""
    name = cfg.matmul_precision
    if name not in _TORCH_PRECISION:
        raise ValueError(f"GNConfig.matmul_precision={name!r}: 'highest', 'high' or 'default'")
    if name == "highest":
        if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise ValueError("GN needs full FP32 matmuls: set "
                             "torch.backends.cuda.matmul.allow_tf32 = False")
        yield
        return
    with _matmul_precision(_TORCH_PRECISION[name]):
        yield


def solve_blocks(g: FactorGraph, cfg: GNConfig, blocks, b: int | None = None) -> FactorGraph:
    """`g` moved by one GN update from its normal-equation blocks (h_diag,
    h_off, w [P,3,L,2], hll, gp [P,3], gl; batched over a leading session
    axis): gauged, the reduced pose system solved on its first `b` poses
    (all when None), and the headings of the active poses wrapped."""
    h_diag, h_off, w, hll, gp, gl = _apply_gauge_blocked(g, cfg, *blocks)
    lead = tuple(g.poses.shape[:-2])
    P, L = g.poses.shape[-2], w.shape[-2]
    b = P if b is None else b
    wb = w[..., :b, :, :, :].reshape(*lead, 3 * b, L, 2)
    dp_b, dl = schur_solve_split(
        densify_hpp(h_diag[..., :b, :, :], h_off[..., :b, :, :]), wb[..., 0], wb[..., 1],
        hll, gp[..., :b, :].reshape(*lead, -1), gl, use_cholesky_kernel=cfg.use_cholesky_kernel)
    d_pose = torch.zeros_like(g.poses)
    d_pose[..., :b, :] = dp_b.reshape(*lead, b, 3)
    poses = g.poses + d_pose
    # wrap only active rows: rows past n_poses get an exact-zero update and
    # wrap_angle is not a bit-exact identity in f32
    act = torch.arange(P, device=poses.device) < g.n_poses[..., None]
    theta = torch.where(act, se2.wrap_angle(poses[..., 2]), poses[..., 2])
    poses = torch.cat([poses[..., :2], theta[..., None]], dim=-1)
    return dataclasses.replace(g, poses=poses, lm_xy=g.lm_xy + dl)


def gn_step(g: FactorGraph, cfg: GNConfig) -> FactorGraph:
    """One Gauss-Newton iteration over the full graph, or over each graph of
    a stacked batch [S] at full capacity (no host read)."""
    P, E = g.poses.shape[-2], g.obs_pose.shape[-1]
    n_poses, n_obs = (P, E) if g.n_poses.dim() else torch.stack([g.n_poses, g.n_obs]).tolist()
    # the gauged rows past n_poses are exact identity/zero, so solving on the
    # leading bucket gives the full solve's update
    with precision(cfg, g.poses):
        return solve_blocks(g, cfg, _assemble_blocked(g, cfg, n_obs),
                            _bucket(n_poses, P, cfg.solve_bucket_step))


def _iterate_batched(g: FactorGraph, cfg: GNConfig, step, enable) -> FactorGraph:
    """`_iterate` over a stacked batch [S], each session stopping at its own
    iteration count and tolerance as the JAX package's vmapped while loop
    does: every iteration steps all sessions, keeps the result only for the
    ones still running, and reads the [S] running mask once (only with an
    early-exit tolerance); the loop ends when no session runs. `enable`
    ([S] bool, None for all) is not read: with every session disabled the
    loop steps and discards once."""
    tol = cfg.early_exit_tol
    running = (torch.ones(g.poses.shape[:1], dtype=torch.bool, device=g.poses.device)
               if enable is None else enable.to(device=g.poses.device, dtype=torch.bool))
    for _ in range(cfg.iterations):
        with stage("slam.gn.iteration"):
            g2 = step(g)
            delta = torch.maximum(torch.amax(torch.abs(g2.poses - g.poses), dim=(-2, -1)),
                                  torch.amax(torch.abs(g2.lm_xy - g.lm_xy), dim=(-2, -1)))
            g = dataclasses.replace(
                g, poses=torch.where(running[:, None, None], g2.poses, g.poses),
                lm_xy=torch.where(running[:, None, None], g2.lm_xy, g.lm_xy))
            if tol > 0.0:
                running = running & (delta > tol)
                if not bool(running.any()):
                    break
    return g


def _iterate(g: FactorGraph, cfg: GNConfig, step, enable) -> FactorGraph:
    """Up to `cfg.iterations` calls of `step`, stopping early once an
    iteration's max |update| (poses and landmarks) drops to
    `cfg.early_exit_tol` (0 = never); `enable=False` returns `g`. A stacked
    batch goes to `_iterate_batched`, and a stack of one session to this
    loop (the same ops as its single graph)."""
    if g.n_poses.dim() and g.n_poses.shape[0] > 1:
        return _iterate_batched(g, cfg, step, enable)
    if g.n_poses.dim():
        def squeeze(x):
            return _graph_fields(lambda v: v[0], x)

        def unsqueeze(x):
            return _graph_fields(lambda v: v[None], x)

        return unsqueeze(_iterate(squeeze(g), cfg, lambda gg: squeeze(step(unsqueeze(gg))),
                                  None if enable is None else enable.reshape(())))
    if enable is not None and not bool(enable):
        return g
    for _ in range(cfg.iterations):
        with stage("slam.gn.iteration"):
            g2 = step(g)
            delta = torch.maximum(torch.max(torch.abs(g2.poses - g.poses)),
                                  torch.max(torch.abs(g2.lm_xy - g.lm_xy)))
            g = g2
            if cfg.early_exit_tol > 0.0 and float(delta) <= cfg.early_exit_tol:
                break
    return g


def optimize(g: FactorGraph, cfg: GNConfig, enable=None) -> FactorGraph:
    """Run up to `cfg.iterations` GN iterations, stopping early once an
    iteration's max |update| (poses and landmarks) drops to
    `cfg.early_exit_tol` (0 = never). `enable=False` returns `g` unchanged.
    A stacked graph [S] is optimized session by session in one batch, with
    `enable` [S]: each session stops at its own iteration, and a disabled
    one comes back unchanged. A stack of one session is optimized as its
    single graph (bucketed as `cfg` says), so both give the same bits."""
    if g.n_poses.dim() and g.n_poses.shape[0] == 1:
        if enable is not None and not bool(enable.reshape(-1)[0]):
            return g
        return _graph_fields(lambda x: x[None],
                             optimize(_graph_fields(lambda x: x[0], g), cfg))
    with precision(cfg, g.poses):
        return _iterate(g, cfg, lambda gg: gn_step(gg, cfg), enable)


def _graph_fields(fn, g: FactorGraph) -> FactorGraph:
    """`fn` applied to every field of `g`."""
    return FactorGraph(**{f.name: fn(getattr(g, f.name)) for f in dataclasses.fields(g)})


def _take(x, idx, sess):
    """Rows `idx` [S, K] of each session's `x` [S, R, ...]; `sess` is
    arange(S)[:, None], or None for one session (one plain gather)."""
    return x[0][idx[0]][None] if sess is None else x[sess, idx]


def _flat(idx, stride: int, sess):
    """Per-session indices [S, K] into one flat buffer of S blocks of
    `stride` rows, flattened: session s at offset s * stride (`sess` as in
    `_take`)."""
    return (idx if sess is None else idx + sess * stride).reshape(-1)


def window_gn_step(g: FactorGraph, cfg: GNConfig, window: int, edge_window: int,
                   landmarks: bool = True, lm_prior=None, end=None,
                   end_obs=None) -> FactorGraph:
    """One fixed-lag GN iteration: refine the trailing `window` poses (and,
    with `landmarks=True`, the map) with everything older held constant.

    The system is the window's odometry chain, whose boundary edge (the
    fixed pose before the window to window row 0) contributes only its
    J_j half, the GPS/heading priors of window poses, and the landmark
    edges among the trailing `edge_window` rows whose pose lies in the
    window; the first `fix_first_poses` global rows are clamped as in
    `gn_step`. With `landmarks=True` every landmark joins the system: an
    edge's landmark Jacobian is a rotation, so its Hll is `lm_info * n *
    I2` with n the landmark's edge count before `end_obs`, and the
    out-of-window edges act as a prior centred at `lm_prior` (None: at the
    current estimate, which gives no gradient). The reduced [3W, 3W]
    system goes through `schur_solve_split`. With `landmarks=False` the
    map is constant and the pose system is factored by
    `torch.linalg.cholesky_ex`.

    `end` / `end_obs` (int32 tensors) anchor the window at a past pose and
    edge count instead of the graph head; later poses and edges are left
    out and receive an exact-zero update.

    A stacked graph [S] takes `end` / `end_obs` [S] (and `lm_prior` [S, L,
    2]): each session's window and edge window sit at its own offsets, and
    the S systems are assembled and solved as one batch. One session (a
    single graph, or S = 1) solves an unbatched system, so both give the
    same bits."""
    if g.n_poses.dim() == 0:
        one = _graph_fields(lambda x: x[None], g)
        out = window_gn_step(one, cfg, window, edge_window, landmarks,
                             None if lm_prior is None else lm_prior[None],
                             None if end is None else end.reshape(1),
                             None if end_obs is None else end_obs.reshape(1))
        return _graph_fields(lambda x: x[0], out)
    with precision(cfg, g.poses):
        W, EW = window, edge_window
        S, P = g.poses.shape[:2]
        L, E = g.lm_xy.shape[1], g.obs_pose.shape[1]
        if W > P or EW > E:
            raise ValueError(f"window {W} / edge window {EW} exceed the graph's capacity "
                             f"({P} poses, {E} edges)")
        dtype, dev = g.poses.dtype, g.poses.device
        sess = torch.arange(S, device=dev)[:, None] if S > 1 else None
        n = (g.n_poses if end is None else end)[:, None]
        e_stop = (g.n_obs if end_obs is None else end_obs)[:, None]
        w0, kg, poses_w, h_diag, h_off, gp = _window_chain(g, cfg, W, n, sess)
        kgl = kg.long()

        # trailing landmark edges whose pose lies in the window; each session's
        # sums go to its own rows of one flat buffer
        e0 = torch.clamp(e_stop - EW, min=0)
        ke = (e0 + torch.arange(EW, device=dev)).long()
        op = _take(g.obs_pose, ke, sess)
        ol = torch.clamp(_take(g.obs_lm, ke, sess).long(), 0, L - 1)
        in_win = (ke < e_stop) & (op >= w0)
        w_l = cfg.lm_info * in_win.to(dtype)
        local = torch.clamp(op - w0, 0, W - 1).long()
        r_l, j_lp, j_ll = landmark_residuals(_take(poses_w, local, sess), _take(g.lm_xy, ol, sess),
                                             _take(g.obs_xy, ke, sess))
        wl3 = w_l[..., None, None]
        jtp = j_lp.transpose(-1, -2)
        row = _flat(local, W, sess)
        h_diag = h_diag.reshape(S * W, 3, 3).index_add(
            0, row, (wl3 * (jtp @ j_lp)).reshape(-1, 3, 3)).reshape(S, W, 3, 3)
        gp = gp.reshape(S * W, 3).index_add(
            0, row, (w_l[..., None] * (jtp @ r_l[..., None])[..., 0]).reshape(-1, 3)
        ).reshape(S, W, 3)

        # gauge clamping by global index (the rows gn_step clamps)
        free = (kg >= cfg.fix_first_poses) & (kg < n)
        fpb = free.to(dtype)[..., None, None]
        eye3 = torch.eye(3, dtype=dtype, device=dev)
        h_diag = h_diag * fpb + eye3 * (1.0 - fpb)
        prev_free = torch.cat([free.new_zeros(S, 1), free[:, :-1]], dim=1)
        h_off = h_off * (free & prev_free).to(dtype)[..., None, None]
        gp = gp * free.to(dtype)[..., None]
        if cfg.damping:
            h_diag = h_diag + eye3 * cfg.damping * fpb

        # one session solves unbatched (see the docstring)
        solve_in = (lambda x: x[0]) if S == 1 else (lambda x: x)
        solve_out = (lambda x: x[None]) if S == 1 else (lambda x: x)
        hpp = densify_hpp(h_diag, h_off)
        if landmarks:
            # Hll from each landmark's total edge count (the out-of-window
            # edges' marginal prior plus the in-window ones), the coupling and
            # gl from the in-window edges only
            kl = torch.arange(L, device=dev)
            lm_all = g.obs_lm.long()
            counted = (torch.arange(E, device=dev) < e_stop) & (lm_all >= 0) & (lm_all < L)
            n_tot = torch.zeros(S * (L + 1), dtype=dtype, device=dev).index_add(
                0, _flat(torch.where(counted, lm_all, L), L + 1, sess),
                counted.to(dtype).reshape(-1)).reshape(S, L + 1)[:, :L]
            flm = ((kl >= cfg.fix_first_landmarks) & (kl < g.n_landmarks[:, None])).to(dtype)
            eye2 = torch.eye(2, dtype=dtype, device=dev)
            hll_d = cfg.lm_info * n_tot * flm
            hll = torch.where(hll_d > 0, hll_d, 1.0)[..., None, None] * eye2
            if cfg.damping:
                hll = hll + eye2 * cfg.damping * flm[..., None, None]
            w_e = wl3 * (jtp @ j_ll)                             # [S, EW, 3, 2]
            wc = torch.zeros((S * W * L, 3, 2), dtype=dtype, device=dev).index_add(
                0, _flat(local * L + ol, W * L, sess), w_e.reshape(-1, 3, 2))
            wc = wc.reshape(S, W, L, 3, 2).permute(0, 1, 3, 2, 4).reshape(S, 3 * W, L, 2)
            mask = free.to(dtype).repeat_interleave(3, dim=1)[..., None] * flm[:, None, :]
            jtl = j_ll.transpose(-1, -2)
            lrow = _flat(ol, L, sess)
            gl = torch.zeros((S * L, 2), dtype=dtype, device=dev).index_add(
                0, lrow, (w_l[..., None] * (jtl @ r_l[..., None])[..., 0]).reshape(-1, 2)
            ).reshape(S, L, 2) * flm[..., None]
            if lm_prior is not None:
                # the marginalized edges' restoring gradient, centred at lm_prior
                n_in = torch.zeros(S * L, dtype=dtype, device=dev).index_add(
                    0, lrow, in_win.to(dtype).reshape(-1)).reshape(S, L)
                n_out = torch.clamp(n_tot - n_in, min=0.0)
                gl = gl + (cfg.lm_info * n_out * flm)[..., None] * (g.lm_xy - lm_prior)
            dp, dl = schur_solve_split(*(solve_in(x) for x in (
                hpp, wc[..., 0] * mask, wc[..., 1] * mask, hll, gp.reshape(S, -1), gl)))
            dp, dl = solve_out(dp), solve_out(dl)
            lm_xy = g.lm_xy + dl
        else:
            with _fp32():
                c = torch.linalg.cholesky_ex(solve_in(hpp)).L
                dp = solve_out(torch.cholesky_solve(solve_in(-gp.reshape(S, -1, 1)), c)[..., 0])
            lm_xy = g.lm_xy
        new_w = poses_w + dp.reshape(S, W, 3)
        # clamped rows get an exact-zero update; wrap_angle is not a bit-exact
        # identity in f32, so they keep their value
        theta = torch.where(free, se2.wrap_angle(new_w[..., 2]), new_w[..., 2])
        new_w = torch.cat([new_w[..., :2], theta[..., None]], dim=-1)
        poses = g.poses.reshape(S * P, 3).index_put((_flat(kgl, P, sess),), new_w.reshape(-1, 3))
        return dataclasses.replace(g, poses=poses.reshape(S, P, 3), lm_xy=lm_xy)


def _window_chain(g: FactorGraph, cfg: GNConfig, W: int, n, sess):
    """The pose side of a stacked graph's [S] fixed-lag window ending before
    pose `n` [S, 1]: (w0 [S, 1] its first pose, kg [S, W] the global pose
    index of each row, the window's poses [S, W, 3], and the blocks h_diag,
    h_off (block (r-1, r)) [S, W, 3, 3] and gp [S, W, 3] of its odometry
    chain, the boundary edge's J_j half included, and of its poses'
    GPS/heading priors). `sess` as in `_take`."""
    dtype, dev = g.poses.dtype, g.poses.device
    w0 = torch.clamp(n - W, min=0)
    kg = w0 + torch.arange(W, device=dev)
    kgl = kg.long()
    poses_w = _take(g.poses, kgl, sess)

    # odometry chain within the window, plus the boundary edge's J_j half
    prev0 = _take(g.poses, torch.clamp(w0 - 1, min=0).long(), sess)
    p_prev = torch.cat([prev0, poses_w[:, :-1]], dim=1)
    odo_valid = (kg >= 1) & (kg < n)
    r_o, j_oi, j_oj = odometry_residuals(p_prev, poses_w, _take(g.odo_meas, kgl, sess))
    w_o = cfg.odo_info * odo_valid.to(dtype) * _take(g.odo_w, kgl, sess)
    w3 = w_o[..., None, None]
    jti = j_oi.transpose(-1, -2)
    jtj = j_oj.transpose(-1, -2)
    a_ii = w3 * (jti @ j_oi)
    a_jj = w3 * (jtj @ j_oj)
    h_off = w3 * (jti @ j_oj)
    g_i = w_o[..., None] * (jti @ r_o[..., None])[..., 0]
    g_j = w_o[..., None] * (jtj @ r_o[..., None])[..., 0]
    h_diag = torch.cat([a_jj[:, :-1] + a_ii[:, 1:], a_jj[:, -1:]], dim=1)
    h_off = torch.cat([torch.zeros_like(h_off[:, :1]), h_off[:, 1:]], dim=1)
    gp = torch.cat([g_j[:, :-1] + g_i[:, 1:], g_j[:, -1:]], dim=1)

    # GPS/heading priors of window poses
    prior_info_w = _take(g.prior_info, kgl, sess)
    pose_valid = (kg < n).to(dtype)
    ixy = prior_info_w[..., 0] * pose_valid
    ith = prior_info_w[..., 1] * pose_valid
    eye_xy = torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=dtype, device=dev))
    eye_th = torch.diag(torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev))
    h_diag = h_diag + ixy[..., None, None] * eye_xy + ith[..., None, None] * eye_th
    r_pr = poses_w - _take(g.prior_pose, kgl, sess)
    r_pr = torch.cat([r_pr[..., :2], se2.wrap_angle(r_pr[..., 2:])], dim=-1)
    return w0, kg, poses_w, h_diag, h_off, gp + r_pr * torch.stack([ixy, ixy, ith], dim=-1)


def optimize_window(g: FactorGraph, cfg: GNConfig, window: int, edge_window: int,
                    enable=None, landmarks: bool = True, end=None,
                    end_obs=None) -> FactorGraph:
    """`optimize`'s loop around `window_gn_step` (fixed-lag refinement).
    With `landmarks=True` the out-of-window edges' prior is centred at the
    entry estimate of the map for every iteration. `enable=False` returns
    `g` unchanged; `end` / `end_obs` as in `window_gn_step`. A stacked
    graph [S] takes `enable`, `end` and `end_obs` [S]: one batched step per
    iteration for all sessions, each stopping at its own iteration, and a
    disabled session comes back bit for bit."""
    lm_prior = g.lm_xy if landmarks else None
    with precision(cfg, g.poses):
        return _iterate(g, cfg, lambda gg: window_gn_step(
            gg, cfg, window, edge_window, landmarks=landmarks, lm_prior=lm_prior,
            end=end, end_obs=end_obs), enable)
