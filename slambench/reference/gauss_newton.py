"""Plain PyTorch Gauss-Newton for the 2D pose-landmark graph, written from
the problem's textbook form: one dense Jacobian J over every free variable,
built in blocks of rows with the residual r as one more column, so that one
matrix product [J r]^T W [J r] gives H = J^T W J and g = J^T W r together,
and a dense LU solve of H dx = -g (as the JAX package's float64 oracle
does), which gives a number where H is indefinite. No Schur elimination,
no Cholesky, no buckets, no scatter assembly: nothing of the program's
solver. It runs in the dtype it is given (float64 for the reference) on the
device it is given.

The problem (reference src/slam.cpp:456, :546 and the program's GNConfig):
odometry edges k-1 -> k weighted `odo_info * odo_w[k]`, landmark edges
weighted `lm_info`, absolute pose priors weighted by `prior_info`, the first
`fix_poses` poses and `fix_landmarks` landmarks held, at most `iterations`
updates, stopping after the first whose largest change of a pose or landmark
value is at most `early_exit_tol` (0: never)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

EDGE_BLOCK = 4096        # landmark edges per block of Jacobian rows


@dataclass(frozen=True)
class Problem:
    odo_info: float
    lm_info: float
    iterations: int
    fix_poses: int
    fix_landmarks: int
    early_exit_tol: float


def _wrap(t):
    return torch.pi - torch.remainder(torch.pi - t, 2.0 * torch.pi)


def _rot_t(th):
    c, s = torch.cos(th), torch.sin(th)
    return torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)], -2)


def _drot_t(th):
    c, s = torch.cos(th), torch.sin(th)
    return torch.stack([torch.stack([-s, c], -1), torch.stack([-c, -s], -1)], -2)


def _block(n_rows: int, V: "_Vars", dtype, device):
    """A block of Jacobian rows over the free variables, plus the residual
    column."""
    return torch.zeros((n_rows, V.n + 1), dtype=dtype, device=device)


def _put(J, rows, cols, blocks):
    """J[rows[e] + a, cols[e] + b] = blocks[e, a, b] for every edge e, and
    for the columns that are free (cols >= 0)."""
    e, ra, cb = blocks.shape
    r = rows[:, None, None] + torch.arange(ra, device=J.device)[None, :, None]
    c = cols[:, None, None] + torch.arange(cb, device=J.device)[None, None, :]
    ok = (cols >= 0)[:, None, None].expand(e, ra, cb)
    J.index_put_((r.expand(e, ra, cb)[ok], c.expand(e, ra, cb)[ok]), blocks[ok])


class _Vars:
    """Column offsets of the free variables: pose k at 3 * (k - fix_poses),
    landmark l after all poses; held variables get -1."""

    def __init__(self, n_poses, n_lm, fix_p, fix_l, device):
        fp, fl = min(fix_p, n_poses), min(fix_l, n_lm)
        self.np_free, self.nl_free = n_poses - fp, n_lm - fl
        kp = torch.arange(n_poses, device=device)
        kl = torch.arange(n_lm, device=device)
        self.pose_col = torch.where(kp >= fp, 3 * (kp - fp), -1)
        self.lm_col = torch.where(kl >= fl, 3 * self.np_free + 2 * (kl - fl), -1)
        self.n = 3 * self.np_free + 2 * self.nl_free


def _normal_equations(P, L, odo, odo_w, e_pose, e_lm, e_xy, prior_pose, prior_info,
                      prob: Problem, V: _Vars):
    """(H, g) of the linearized problem at poses P and landmarks L."""
    dtype, dev = P.dtype, P.device
    H = torch.zeros((V.n, V.n), dtype=dtype, device=dev)
    g = torch.zeros(V.n, dtype=dtype, device=dev)

    def add(A, r, w):
        A[:, -1] = r
        M = A.mT @ (A * w[:, None])
        H.add_(M[:-1, :-1])
        g.add_(M[:-1, -1])

    n_p = P.shape[0]
    if n_p > 1:
        # odometry edges k-1 -> k
        pi, pj, m = P[:-1], P[1:], odo[1:]
        rm_t, ri_t = _rot_t(m[:, 2]), _rot_t(pi[:, 2])
        d = pj[:, :2] - pi[:, :2]
        rel = (ri_t @ d[..., None])[..., 0]
        r_xy = (rm_t @ (rel - m[:, :2])[..., None])[..., 0]
        r_th = _wrap(pj[:, 2] - pi[:, 2] - m[:, 2])
        rm_ri = rm_t @ ri_t
        k = n_p - 1
        ji = torch.zeros((k, 3, 3), dtype=dtype, device=dev)
        ji[:, :2, :2] = -rm_ri
        ji[:, :2, 2] = (rm_t @ (_drot_t(pi[:, 2]) @ d[..., None]))[..., 0]
        ji[:, 2, 2] = -1.0
        jj = torch.zeros((k, 3, 3), dtype=dtype, device=dev)
        jj[:, :2, :2] = rm_ri
        jj[:, 2, 2] = 1.0
        rows = 3 * torch.arange(k, device=dev)
        J = _block(3 * k, V, dtype, dev)
        _put(J, rows, V.pose_col[:-1], ji)
        _put(J, rows, V.pose_col[1:], jj)
        r = torch.cat([r_xy, r_th[:, None]], dim=1).reshape(-1)
        w = (prob.odo_info * odo_w[1:])[:, None].expand(k, 3).reshape(-1)
        add(J, r, w)
    if bool((prior_info > 0).any()):
        r = torch.cat([P[:, :2] - prior_pose[:, :2], _wrap(P[:, 2:] - prior_pose[:, 2:])], 1)
        J = _block(3 * n_p, V, dtype, dev)
        eye = torch.eye(3, dtype=dtype, device=dev).expand(n_p, 3, 3)
        _put(J, 3 * torch.arange(n_p, device=dev), V.pose_col, eye)
        w = torch.stack([prior_info[:, 0], prior_info[:, 0], prior_info[:, 1]], 1)
        add(J, r.reshape(-1), w.reshape(-1))
    for lo in range(0, e_pose.shape[0], EDGE_BLOCK):
        ep, el, z = e_pose[lo:lo + EDGE_BLOCK], e_lm[lo:lo + EDGE_BLOCK], e_xy[lo:lo + EDGE_BLOCK]
        p, lm = P[ep], L[el]
        ri_t = _rot_t(p[:, 2])
        d = lm - p[:, :2]
        r = (ri_t @ d[..., None])[..., 0] - z
        jp = torch.cat([-ri_t, (_drot_t(p[:, 2]) @ d[..., None])], dim=2)
        rows = 2 * torch.arange(ep.shape[0], device=dev)
        J = _block(2 * ep.shape[0], V, dtype, dev)
        _put(J, rows, V.pose_col[ep], jp)
        _put(J, rows, V.lm_col[el], ri_t)
        add(J, r.reshape(-1), torch.full((J.shape[0],), prob.lm_info, dtype=dtype, device=dev))
    return H, g


def optimize(graph: dict, prob: Problem, dtype=torch.float64, device="cpu"):
    """Solve one graph: `graph` holds numpy arrays poses [n, 3], odo [n, 3]
    (row k: the measurement from pose k-1, row 0 unused), odo_w [n], lm
    [m, 2], e_pose / e_lm [E] and e_xy [E, 2], prior_pose [n, 3] and
    prior_info [n, 2]. Returns (poses, landmarks) as numpy arrays in
    `dtype`, and the number of updates made."""
    def t(name, dt=dtype):
        return torch.as_tensor(np.asarray(graph[name]), device=device).to(dt)

    P, L = t("poses"), t("lm")
    odo, odo_w = t("odo"), t("odo_w")
    e_pose, e_lm, e_xy = t("e_pose", torch.long), t("e_lm", torch.long), t("e_xy")
    prior_pose, prior_info = t("prior_pose"), t("prior_info")
    V = _Vars(P.shape[0], L.shape[0], prob.fix_poses, prob.fix_landmarks, device)
    done = 0
    for done in range(1, prob.iterations + 1):
        H, g = _normal_equations(P, L, odo, odo_w, e_pose, e_lm, e_xy, prior_pose,
                                 prior_info, prob, V)
        dx = torch.linalg.solve_ex(H, -g).result
        dP = torch.zeros_like(P)
        fp = P.shape[0] - V.np_free
        dP[fp:] = dx[:3 * V.np_free].reshape(-1, 3)
        dL = torch.zeros_like(L)
        fl = L.shape[0] - V.nl_free
        dL[fl:] = dx[3 * V.np_free:].reshape(-1, 2)
        P2 = P + dP
        P2 = torch.cat([P2[:, :2], _wrap(P2[:, 2:])], dim=1)
        L2 = L + dL
        step = max(float((P2 - P).abs().max()) if P.numel() else 0.0,
                   float((L2 - L).abs().max()) if L.numel() else 0.0)
        P, L = P2, L2
        if prob.early_exit_tol > 0.0 and step <= prob.early_exit_tol:
            break
    return P.cpu().numpy(), L.cpu().numpy(), done
