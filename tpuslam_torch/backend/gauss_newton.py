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

Everything runs in full FP32. `matmul_precision="highest"` is the only
supported setting and requires TF32 to be off for CUDA matmuls.

Host synchronisation: each `gn_step` reads (n_poses, n_obs) once to pick its
buckets, and `optimize` reads the update size once per iteration for its
early exit. Fixed-lag windows (`window_gn_step`, `optimize_window`) are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from tpuslam_torch import compat
from tpuslam_torch.backend.graph import FactorGraph
from tpuslam_torch.backend.residuals import landmark_residuals, odometry_residuals
from tpuslam_torch.geometry import se2

__all__ = ["GNConfig", "assemble", "schur_solve", "schur_solve_split",
           "gn_step", "optimize", "chi2"]


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
    matmul_precision: str = "highest"
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
    r_l, _, _ = landmark_residuals(g.poses[g.obs_pose.long()], g.lm_xy[g.obs_lm.long()],
                                   g.obs_xy)
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
    (h_diag [P,3,3], h_off [P,3,3], gp [P,3]); h_off[k] is block (k-1, k)."""
    dtype = g.poses.dtype
    k = torch.arange(g.poses.shape[0], device=g.poses.device)
    odo_valid = (k >= 1) & (k < g.n_poses)
    p_prev = g.poses[torch.clamp(k - 1, min=0)]
    r_o, j_oi, j_oj = odometry_residuals(p_prev, g.poses, g.odo_meas)
    w_o = cfg.odo_info * odo_valid.to(dtype) * g.odo_w

    w3 = w_o[:, None, None]
    jti = j_oi.transpose(-1, -2)
    jtj = j_oj.transpose(-1, -2)
    a_ii = w3 * (jti @ j_oi)
    a_jj = w3 * (jtj @ j_oj)
    h_off = w3 * (jti @ j_oj)
    g_i = w_o[:, None] * (jti @ r_o[..., None])[..., 0]
    g_j = w_o[:, None] * (jtj @ r_o[..., None])[..., 0]

    h_diag = torch.cat([a_jj[:-1] + a_ii[1:], a_jj[-1:]])
    gp = torch.cat([g_j[:-1] + g_i[1:], g_j[-1:]])

    pose_valid = (k < g.n_poses).to(dtype)
    ixy = g.prior_info[:, 0] * pose_valid
    ith = g.prior_info[:, 1] * pose_valid
    eye_xy = torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=dtype, device=k.device))
    eye_th = torch.diag(torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=k.device))
    h_diag = h_diag + ixy[:, None, None] * eye_xy + ith[:, None, None] * eye_th
    r_prior = g.poses - g.prior_pose
    r_prior = torch.cat([r_prior[:, :2], se2.wrap_angle(r_prior[:, 2:])], dim=1)
    gp = gp + r_prior * torch.stack([ixy, ixy, ith], dim=-1)
    return h_diag, h_off, gp


def landmark_edge_blocks(poses, lm_xy, obs_pose, obs_lm, obs_xy, w_l):
    """Landmark-edge contribution summed over the given edges: returns
    (h_diag_lm [P,3,3], w [P,3,L,2], hll [L,2,2], gp_lm [P,3], gl [L,2]);
    w[p, i, l, j] is entry (3p+i, 2l+j) of the coupling W [3P, 2L]."""
    P, L = poses.shape[0], lm_xy.shape[0]
    op, ol = obs_pose.long(), obs_lm.long()
    r_l, j_lp, j_ll = landmark_residuals(poses[op], lm_xy[ol], obs_xy)
    wl3 = w_l[:, None, None]
    jtp = j_lp.transpose(-1, -2)                       # [E, 3, 2]
    jtl = j_ll.transpose(-1, -2)
    h_diag_lm = torch.zeros((P, 3, 3), dtype=poses.dtype, device=poses.device)
    h_diag_lm.index_add_(0, op, wl3 * (jtp @ j_lp))
    gp_lm = torch.zeros((P, 3), dtype=poses.dtype, device=poses.device)
    gp_lm.index_add_(0, op, w_l[:, None] * (jtp @ r_l[..., None])[..., 0])
    w = torch.zeros((P * L, 3, 2), dtype=poses.dtype, device=poses.device)
    w.index_add_(0, op * L + ol, wl3 * (jtp @ j_ll))
    w = w.reshape(P, L, 3, 2).permute(0, 2, 1, 3)
    hll = torch.zeros((L, 2, 2), dtype=poses.dtype, device=poses.device)
    hll.index_add_(0, ol, wl3 * (jtl @ j_ll))
    gl = torch.zeros((L, 2), dtype=poses.dtype, device=poses.device)
    gl.index_add_(0, ol, w_l[:, None] * (jtl @ r_l[..., None])[..., 0])
    return h_diag_lm, w, hll, gp_lm, gl


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
    e = _bucket(n_obs, g.obs_pose.shape[0], cfg.edge_bucket_step)
    h_diag_lm, w, hll, gp_lm, gl = landmark_edge_blocks(
        g.poses, g.lm_xy, g.obs_pose[:e], g.obs_lm[:e], g.obs_xy[:e], w_l[:e])
    return h_diag + h_diag_lm, h_off, w, hll, gp_o + gp_lm, gl


def densify_hpp(h_diag, h_off):
    """(P,3,3) diagonal + (P,3,3) super-diagonal blocks -> dense [3P, 3P]."""
    P = h_diag.shape[0]
    h = torch.zeros((P, 3, P, 3), dtype=h_diag.dtype, device=h_diag.device)
    i = torch.arange(P, device=h_diag.device)
    h[i, :, i, :] = h_diag
    h[i[:-1], :, i[1:], :] = h_off[1:]
    h[i[1:], :, i[:-1], :] = h_off[1:].transpose(-1, -2)
    return h.reshape(3 * P, 3 * P)


def assemble(g: FactorGraph, cfg: GNConfig):
    """Dense-blocked normal equations: (Hpp [3P,3P], W [3P,2L], Hll [L,2,2],
    gp [3P], gl [L,2]) — the JAX package's public layout."""
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


def schur_solve_split(hpp, w0, w1, hll, gp, gl, use_cholesky_kernel=False):
    """`schur_solve` on the even/odd W column halves W0/W1 [3P, L]."""
    hll_inv = _inv2x2(hll)
    ia, ib, ic = hll_inv[:, 0, 0], hll_inv[:, 0, 1], hll_inv[:, 1, 1]
    wa0 = w0 * ia[None, :] + w1 * ib[None, :]
    wa1 = w0 * ib[None, :] + w1 * ic[None, :]
    s = hpp - (wa0 @ w0.T + wa1 @ w1.T)
    gl0, gl1 = gl[:, 0], gl[:, 1]
    rhs = -gp + (wa0 @ gl0 + wa1 @ gl1)
    if use_cholesky_kernel:
        from tpuslam_torch.ops.cholesky import cholesky
        c = cholesky(s)
    else:
        c = torch.linalg.cholesky_ex(s).L
    dp = torch.cholesky_solve(rhs[:, None], c)[:, 0]
    r0, r1 = gl0 + w0.T @ dp, gl1 + w1.T @ dp
    dl = -torch.stack([ia * r0 + ib * r1, ib * r0 + ic * r1], dim=-1)
    return dp, dl


def _apply_gauge_blocked(g: FactorGraph, cfg: GNConfig, h_diag, h_off, w, hll, gp, gl):
    """Clamp fixed + padding variables on the block form: identity diagonal
    blocks, zeroed couplings and gradients."""
    P, L = g.poses.shape[0], g.lm_xy.shape[0]
    dtype, dev = h_diag.dtype, h_diag.device
    kp = torch.arange(P, device=dev)
    free_pose = (kp >= cfg.fix_first_poses) & (kp < g.n_poses)
    kl = torch.arange(L, device=dev)
    free_lm = (kl >= cfg.fix_first_landmarks) & (kl < g.n_landmarks)

    fpb = free_pose.to(dtype)[:, None, None]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    h_diag = h_diag * fpb + eye3 * (1.0 - fpb)
    pair = free_pose & torch.roll(free_pose, 1)
    pair[0] = False
    h_off = h_off * pair.to(dtype)[:, None, None]

    fl = free_lm.to(dtype)
    w = w * free_pose.to(dtype)[:, None, None, None] * fl[None, None, :, None]
    eye2 = torch.eye(2, dtype=dtype, device=dev)
    flb = fl[:, None, None]
    hll = hll * flb + eye2 * (1.0 - flb)
    gp = gp * free_pose.to(dtype)[:, None]
    gl = gl * fl[:, None]
    if cfg.damping:
        h_diag = h_diag + eye3 * cfg.damping * fpb
        hll = hll + eye2 * cfg.damping * flb
    return h_diag, h_off, w, hll, gp, gl


def _check_precision(cfg: GNConfig, t: torch.Tensor):
    if cfg.matmul_precision != "highest":
        raise NotImplementedError(
            f"GNConfig.matmul_precision={cfg.matmul_precision!r}: only 'highest' "
            "(full FP32) is ported")
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("GN needs full FP32 matmuls: set "
                         "torch.backends.cuda.matmul.allow_tf32 = False")


def gn_step(g: FactorGraph, cfg: GNConfig) -> FactorGraph:
    """One Gauss-Newton iteration over the full graph."""
    _check_precision(cfg, g.poses)
    n_poses, n_obs = torch.stack([g.n_poses, g.n_obs]).tolist()
    h_diag, h_off, w, hll, gp, gl = _apply_gauge_blocked(
        g, cfg, *_assemble_blocked(g, cfg, n_obs))
    # the gauged rows past n_poses are exact identity/zero, so solving on the
    # leading bucket gives the full solve's update
    P, L = w.shape[0], w.shape[2]
    b = _bucket(n_poses, P, cfg.solve_bucket_step)
    wb = w[:b].reshape(3 * b, L, 2)
    dp_b, dl = schur_solve_split(densify_hpp(h_diag[:b], h_off[:b]), wb[..., 0], wb[..., 1],
                                 hll, gp[:b].reshape(-1), gl,
                                 use_cholesky_kernel=cfg.use_cholesky_kernel)
    d_pose = torch.zeros_like(g.poses)
    d_pose[:b] = dp_b.reshape(b, 3)
    poses = g.poses + d_pose
    # wrap only active rows: rows past n_poses get an exact-zero update and
    # wrap_angle is not a bit-exact identity in f32
    act = torch.arange(P, device=poses.device) < g.n_poses
    theta = torch.where(act, se2.wrap_angle(poses[:, 2]), poses[:, 2])
    poses = torch.cat([poses[:, :2], theta[:, None]], dim=1)
    return dataclasses.replace(g, poses=poses, lm_xy=g.lm_xy + dl)


def optimize(g: FactorGraph, cfg: GNConfig, enable=None) -> FactorGraph:
    """Run up to `cfg.iterations` GN iterations, stopping early once an
    iteration's max |update| (poses and landmarks) drops to
    `cfg.early_exit_tol` (0 = never). `enable=False` returns `g` unchanged."""
    if enable is not None and not bool(enable):
        return g
    for _ in range(cfg.iterations):
        g2 = gn_step(g, cfg)
        delta = torch.maximum(torch.max(torch.abs(g2.poses - g.poses)),
                              torch.max(torch.abs(g2.lm_xy - g.lm_xy)))
        g = g2
        if cfg.early_exit_tol > 0.0 and float(delta) <= cfg.early_exit_tol:
            break
    return g
