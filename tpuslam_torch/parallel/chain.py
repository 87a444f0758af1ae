"""Pose-chain (sequence) parallelism: contiguous keyframe blocks per rank
(counterpart of `tpuslam.parallel.chain`).

The keyframe chain is cut into D contiguous pose blocks along a ('chain',)
mesh (`mesh.make_chain_mesh`). Each rank passes the global graph, takes its
block of poses and the landmark edges whose observing pose it owns (the
edge list reordered by `partition_edges_by_pose_block`), and assembles its
rows of the normal equations. Communication, through
`parallel.collectives`:

- `ppermute` halo shifts around the ring: each block's last pose to its
  right neighbour (the odometry edge across a block boundary needs it), the
  boundary edge's J_i half back to the left, and the gauge flag of the
  block's last pose;
- `psum` of the landmark blocks Hll and gl (landmarks are seen from many
  blocks).

Two reduced solves (`chain_optimize(solver=...)`):

- 'replicated': `all_gather` of every block's Hpp rows, W rows, gp and
  poses, and the full reduced system gauged and solved on every rank by
  `gauss_newton.solve_blocks`, the update `gn_step` makes (comm O(P·L) per
  iteration);
- 'dd' (`chain_gn_step_dd`): domain decomposition. Each block's last pose is
  a separator; each rank eliminates the landmarks seen from its block alone
  and factors its interior poses, and only the interface (the separators
  and the landmarks seen from several blocks, m = 3D + 3 + 2·shared_cap) is
  summed and solved on every rank; the interiors back-substitute locally.
  Comm per iteration O(L + m²).
- 'hier' and 'hier3' nest the interface solve in two or three levels
  (`parallel/hier.py`, `parallel/hier3.py`) on the resident layout of
  `parallel/resident.py`.

SPMD over `torch.distributed`: every rank of the mesh calls with the same
graph, iterates on its own block and gathers the poses once at the end, so
every rank returns the same graph. The JAX package's jitted runners, cached
per plan, are a Python loop over `cfg.iterations` here; pass a plan to reuse
its partition. The factorizations are `torch.linalg.cholesky_ex` in FP32,
where the JAX package calls `jnp.linalg.cholesky`; the other matmuls run
under `cfg.matmul_precision` (`gauss_newton.precision`). A rank outside the
mesh raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend.graph import FactorGraph
from tpuslam_torch.backend.residuals import odometry_residuals
from tpuslam_torch.geometry import se2
from tpuslam_torch.parallel.collectives import all_gather, ppermute, psum, shard

__all__ = ["partition_edges_by_pose_block", "chain_gn_step", "chain_optimize",
           "ChainPlan", "partition_chain", "chain_gn_step_dd",
           "assemble_pose_rows", "default_tray"]

AXIS = "chain"


def _ring(n: int):
    return [(i, (i + 1) % n) for i in range(n)]


def assemble_pose_rows(poses_l, odo_l, odo_w_sh, prior_pose_l, prior_info_l,
                       cfg: gn.GNConfig, n_poses, n_dev: int, base: int, mesh,
                       dim: str = AXIS):
    """This rank's odometry and prior rows, shared by every chain solver:
    (h_diag_l [b,3,3], h_off_l [b,3,3] (block (k-1, k)), gp_l [b,3]), with
    the boundary edges' halves from the neighbours folded in. The two
    ring shifts are its only communication."""
    b = poses_l.shape[0]
    dtype, dev = poses_l.dtype, poses_l.device
    halo = ppermute(poses_l[-1:], mesh, dim, _ring(n_dev))[0]
    k_global = base + torch.arange(b, device=dev)
    p_prev = torch.cat([halo[None], poses_l[:-1]])
    odo_valid = (k_global >= 1) & (k_global < n_poses)
    r_o, j_oi, j_oj = odometry_residuals(p_prev, poses_l, odo_l)
    w_o = cfg.odo_info * odo_valid.to(dtype) * odo_w_sh
    w3 = w_o[:, None, None]
    jti = j_oi.transpose(-1, -2)
    jtj = j_oj.transpose(-1, -2)
    a_ii = w3 * (jti @ j_oi)
    a_jj = w3 * (jtj @ j_oj)
    h_off_l = w3 * (jti @ j_oj)          # block (k-1, k)
    g_i = w_o[:, None] * (jti @ r_o[..., None])[..., 0]
    g_j = w_o[:, None] * (jtj @ r_o[..., None])[..., 0]
    back = [((i + 1) % n_dev, i) for i in range(n_dev)]
    a_ii_halo = ppermute(a_ii[:1], mesh, dim, back)[0]
    g_i_halo = ppermute(g_i[:1], mesh, dim, back)[0]
    h_diag_l = torch.cat([a_jj[:-1] + a_ii[1:], (a_jj[-1] + a_ii_halo)[None]])
    gp_l = torch.cat([g_j[:-1] + g_i[1:], (g_j[-1] + g_i_halo)[None]])

    pose_valid = (k_global < n_poses).to(dtype)
    ixy = prior_info_l[:, 0] * pose_valid
    ith = prior_info_l[:, 1] * pose_valid
    eye_xy = torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=dtype, device=dev))
    eye_th = torch.diag(torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev))
    h_diag_l = h_diag_l + ixy[:, None, None] * eye_xy + ith[:, None, None] * eye_th
    r_pr = poses_l - prior_pose_l
    r_pr = torch.cat([r_pr[:, :2], se2.wrap_angle(r_pr[:, 2:])], dim=1)
    gp_l = gp_l + r_pr * torch.stack([ixy, ixy, ith], dim=-1)
    return h_diag_l, h_off_l, gp_l


def partition_edges_by_pose_block(g: FactorGraph, n_shards: int):
    """The edge list reordered on the host so that block d's edges (those
    whose pose lies in pose block d) fill slice [d·Eb, d·Eb + count_d) with
    Eb = max_obs / n_shards, the rest zero padding. Returns (the graph with
    its edges reordered, `n_obs` unchanged; counts [D] int32). Use the
    result only with the chain solvers. Raises `ValueError` when a block
    has more than Eb edges."""
    cap = g.capacity
    d = n_shards
    e_cap = cap.max_obs
    eb = e_cap // d
    n_obs = int(g.n_obs)
    block = cap.max_poses // d
    op = g.obs_pose[:n_obs].cpu().numpy()
    ol = g.obs_lm[:n_obs].cpu().numpy()
    oxy = g.obs_xy[:n_obs].cpu().numpy()
    owner = op // block
    new_op = np.zeros(e_cap, np.int32)
    new_ol = np.zeros(e_cap, np.int32)
    new_oxy = np.zeros((e_cap, 2), np.float32)
    counts = np.zeros(d, np.int64)
    for dev in range(d):
        sel = np.flatnonzero(owner == dev)
        if len(sel) > eb:
            raise ValueError(f"block {dev} has {len(sel)} edges > per-block "
                             f"capacity {eb}; raise max_obs")
        base = dev * eb
        counts[dev] = len(sel)
        new_op[base:base + len(sel)] = op[sel]
        new_ol[base:base + len(sel)] = ol[sel]
        new_oxy[base:base + len(sel)] = oxy[sel]
    dv = g.poses.device
    g2 = dataclasses.replace(
        g, obs_pose=torch.from_numpy(new_op).to(dv), obs_lm=torch.from_numpy(new_ol).to(dv),
        obs_xy=torch.from_numpy(new_oxy).to(dv))
    return g2, torch.from_numpy(counts.astype(np.int32)).to(dv)


@dataclasses.dataclass(frozen=True)
class _Shard:
    """One rank's view of a partitioned graph: its coordinate on the chain
    axis and its slices of the per-pose rows and of the reordered edges."""
    d: int                   # this rank's block
    n_dev: int
    b: int                   # poses per block
    base: int                # first global pose of the block
    odo: torch.Tensor
    odo_w: torch.Tensor
    prior_pose: torch.Tensor
    prior_info: torch.Tensor
    obs_pose: torch.Tensor
    obs_lm: torch.Tensor
    obs_xy: torch.Tensor
    w_l: torch.Tensor        # landmark-edge weights (0 past the block's count)
    n_poses: torch.Tensor
    n_landmarks: torch.Tensor


def _shard_of(g2: FactorGraph, counts, cfg: gn.GNConfig, mesh, n_dev: int) -> _Shard:
    """This rank's `_Shard` of a graph whose edges `partition_edges_by_pose_block`
    reordered (`counts` [D] per block)."""
    d, n = shard(mesh, AXIS)
    if n != n_dev:
        raise ValueError(f"a plan for {n_dev} blocks on a chain axis of {n} ranks")
    P, E = g2.poses.shape[0], g2.obs_pose.shape[0]
    b, eb = P // n, E // n
    rows, edges = slice(d * b, (d + 1) * b), slice(d * eb, (d + 1) * eb)
    dtype = g2.poses.dtype
    w_l = cfg.lm_info * (torch.arange(eb, device=g2.poses.device) < counts[d]).to(dtype)
    return _Shard(d=d, n_dev=n, b=b, base=d * b, odo=g2.odo_meas[rows], odo_w=g2.odo_w[rows],
                  prior_pose=g2.prior_pose[rows], prior_info=g2.prior_info[rows],
                  obs_pose=g2.obs_pose[edges], obs_lm=g2.obs_lm[edges], obs_xy=g2.obs_xy[edges],
                  w_l=w_l, n_poses=g2.n_poses, n_landmarks=g2.n_landmarks)


def _pose_rows(poses_l, lm_table, sh: _Shard, cfg: gn.GNConfig, mesh, split: bool):
    """The rank's pose rows with its landmark edges folded in, against the
    landmark rows `lm_table` its edges index: (h_diag_l, h_off_l, gp_l,
    landmark blocks...), the W coupling as [b,3,L,2] or, `split`, as its
    halves W0, W1 [3b, L]."""
    h_diag_l, h_off_l, gp_l = assemble_pose_rows(
        poses_l, sh.odo, sh.odo_w, sh.prior_pose, sh.prior_info, cfg, sh.n_poses, sh.n_dev,
        sh.base, mesh)
    local_idx = torch.clamp(sh.obs_pose - sh.base, 0, sh.b - 1)
    if split:
        h_diag_lm, w0, w1, hll, gp_lm, gl = gn._landmark_edge_blocks_split(
            poses_l, lm_table, local_idx, sh.obs_lm, sh.obs_xy, sh.w_l, lm_table.shape[0])
        return h_diag_l + h_diag_lm, h_off_l, gp_l + gp_lm, w0, w1, hll, gl
    h_diag_lm, w, hll, gp_lm, gl = gn.landmark_edge_blocks(
        poses_l, lm_table, local_idx, sh.obs_lm, sh.obs_xy, sh.w_l)
    return h_diag_l + h_diag_lm, h_off_l, gp_l + gp_lm, w, hll, gl


def _wrapped(p):
    return torch.cat([p[:, :2], se2.wrap_angle(p[:, 2:])], dim=1)


# ---------------------------------------------------------------------------
# The replicated reduced solve
# ---------------------------------------------------------------------------

def _replicated_iteration(g2: FactorGraph, poses_l, lm_xy, sh: _Shard, cfg, mesh):
    """One replicated iteration: (this rank's new block, new landmarks, new
    poses of every block)."""
    h_diag_l, h_off_l, gp_l, w_rows, hll_part, gl_part = _pose_rows(
        poses_l, lm_xy, sh, cfg, mesh, split=False)
    hll, gl = psum([hll_part, gl_part], mesh, AXIS)
    blocks = [all_gather(x, mesh, AXIS) for x in (h_diag_l, h_off_l, w_rows)]
    gp = all_gather(gp_l, mesh, AXIS)
    poses = all_gather(poses_l, mesh, AXIS)
    h_diag, h_off, w = blocks
    new = gn.solve_blocks(dataclasses.replace(g2, poses=poses, lm_xy=lm_xy), cfg,
                          (h_diag, h_off, w, hll, gp, gl))
    return new.poses[sh.base:sh.base + sh.b], new.lm_xy, new.poses


def chain_gn_step(g: FactorGraph, edge_counts, cfg: gn.GNConfig, mesh) -> FactorGraph:
    """One GN iteration with the poses and their edges sharded along
    'chain' (`g`'s edges reordered by `partition_edges_by_pose_block`, its
    `counts`): the replicated solve, every rank's update that of
    `gauss_newton.gn_step` up to the order of the sums."""
    return _chain_replicated(g, edge_counts, cfg, mesh, 1)


def _chain_replicated(g2: FactorGraph, counts, cfg, mesh, iterations: int) -> FactorGraph:
    with gn.precision(cfg, g2.poses):
        sh = _shard_of(g2, counts, cfg, mesh, shard(mesh, AXIS)[1])
        poses_l, lm_xy, poses = g2.poses[sh.base:sh.base + sh.b], g2.lm_xy, g2.poses
        for _ in range(iterations):
            poses_l, lm_xy, poses = _replicated_iteration(g2, poses_l, lm_xy, sh, cfg, mesh)
    return dataclasses.replace(g2, poses=poses, lm_xy=lm_xy)


def default_tray(n_dev: int, cap: int = 16) -> int:
    """Largest divisor of n_dev <= cap: the default group (tray) size of
    the hierarchical solve when the caller does not pin one."""
    return max(t for t in range(1, min(cap, n_dev) + 1) if n_dev % t == 0)


def chain_optimize(g: FactorGraph, cfg: gn.GNConfig, mesh, edge_counts=None,
                   solver: str = "replicated", plan=None, tray: int | None = None,
                   pod: int | None = None) -> FactorGraph:
    """Chain-parallel GN over the ('chain',) `mesh`: the edges partitioned
    once, `cfg.iterations` iterations (no early exit), the poses gathered
    at the end. `solver`: 'replicated' (every rank gathers and solves the
    full reduced system), 'dd' (`chain_gn_step_dd`, the interface
    m = 3D + 3 + 2·shared_cap), 'hier' (`hier.chain_optimize_hier`; `tray`
    ranks per group, default `default_tray`) or 'hier3'
    (`hier3.chain_optimize_hier3`; `pod` ranks per pod, default the whole
    axis up to 256, and at least two trays per pod). `plan`: a plan of the
    solver's partitioner, reused as it is."""
    n = shard(mesh, AXIS)[1]
    if solver == "hier3":
        from tpuslam_torch.parallel.hier3 import chain_optimize_hier3
        if pod is None:
            pod = min(n, 256)
        if tray is None:
            # at least two trays per pod, so that level 2 is not empty
            tray = default_tray(pod, cap=max(2, min(16, pod // 2)))
        return chain_optimize_hier3(g, cfg, mesh, tray, pod, plan=plan)
    if solver == "hier":
        from tpuslam_torch.parallel.hier import chain_optimize_hier
        if tray is None:
            tray = default_tray(n)
        return chain_optimize_hier(g, cfg, mesh, tray, plan=plan)
    if solver == "dd":
        if plan is None:
            plan = partition_chain(g, n)
            g2 = plan.graph
        else:
            g2, _ = partition_edges_by_pose_block(g, n)
        return _chain_dd(g2, plan, cfg, mesh, cfg.iterations)
    if solver != "replicated":
        raise ValueError(f"unknown chain solver {solver!r} (replicated | dd | hier | hier3)")
    if edge_counts is None:
        g, edge_counts = partition_edges_by_pose_block(g, n)
    return _chain_replicated(g, edge_counts, cfg, mesh, cfg.iterations)


# ---------------------------------------------------------------------------
# The domain-decomposition solve: no gather of W or Hpp, no replicated full
# factorization.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ChainPlan:
    """Host-side partition for the DD chain solve (static per graph layout).

    The pose chain splits into n_dev contiguous blocks; each block's LAST
    pose is a separator. A landmark is local to block d when every pose
    observing it lies in block d; else it is shared and joins the
    interface, of m = 3·n_dev + 3 + 2·shared_cap variables (the +3 a
    scratch slot for block 0's previous-separator column)."""
    graph: FactorGraph          # edges reordered per block
    edge_counts: torch.Tensor   # [D] valid edges per block
    owner: torch.Tensor         # [L] owning block of a local landmark, -1 else
    shared_idx: torch.Tensor    # [shared_cap] landmark index, padded with L
    n_shared: int
    shared_cap: int             # static interface landmark capacity
    n_dev: int


def _classify(g: FactorGraph, n_shards: int):
    """(min and max observing block per landmark [L], valid [L]) from the
    graph's edges, on the host."""
    cap = g.capacity
    block = cap.max_poses // n_shards
    n_obs = int(g.n_obs)
    op = g.obs_pose[:n_obs].cpu().numpy()
    ol = g.obs_lm[:n_obs].cpu().numpy()
    owner_blk = op // block
    L = cap.max_landmarks
    min_o = np.full(L, n_shards, np.int64)
    max_o = np.full(L, -1, np.int64)
    np.minimum.at(min_o, ol, owner_blk)
    np.maximum.at(max_o, ol, owner_blk)
    valid = np.arange(L) < int(g.n_landmarks)
    return min_o, max_o, valid


def _shared_layout(shared, L: int, shared_cap: int | None):
    """(shared_idx [shared_cap] padded with L, n_shared, shared_cap)."""
    sh_list = np.flatnonzero(shared)
    n_shared = len(sh_list)
    if shared_cap is None:
        shared_cap = max(16, -(-max(n_shared, 1) // 16) * 16)
    if n_shared > shared_cap:
        raise ValueError(f"{n_shared} shared landmarks > capacity {shared_cap}")
    shared_idx = np.full(shared_cap, L, np.int32)
    shared_idx[:n_shared] = sh_list
    return shared_idx, n_shared, int(shared_cap)


def partition_chain(g: FactorGraph, n_shards: int, shared_cap: int | None = None) -> ChainPlan:
    """Host-side: the edge partition and the local/shared classification of
    the landmarks. Raises `ValueError` for fewer than 3 poses per block (a
    separator must not be a gauge-fixed pose) or too many shared
    landmarks."""
    cap = g.capacity
    if cap.max_poses // n_shards < 3:
        raise ValueError("DD chain solve needs >= 3 poses per block "
                         "(separator must not be a gauge-fixed pose)")
    g2, counts = partition_edges_by_pose_block(g, n_shards)
    min_o, max_o, valid = _classify(g, n_shards)
    L = cap.max_landmarks
    shared = valid & (max_o >= 0) & (max_o != min_o)
    first = np.where(max_o >= 0, min_o, -1)
    shared_idx, n_shared, shared_cap = _shared_layout(shared, L, shared_cap)
    # landmarks observed from nowhere have no owner and no update; they are
    # outside every W column too, so the solve ignores them
    owner = np.where(valid & ~shared & (first >= 0), first, -1).astype(np.int32)
    dv = g.poses.device
    return ChainPlan(graph=g2, edge_counts=counts, owner=torch.from_numpy(owner).to(dv),
                     shared_idx=torch.from_numpy(shared_idx).to(dv), n_shared=n_shared,
                     shared_cap=shared_cap, n_dev=n_shards)


@dataclasses.dataclass
class _Eliminated:
    """A rank's block after its local landmarks are eliminated and its
    interior factored: what the interface solves and the back-substitution
    need."""
    chol_a: torch.Tensor     # [3ni, 3ni] factor of the interior system
    b_full: torch.Tensor     # [3ni, m] interior-to-interface coupling
    g_int: torch.Tensor      # [3ni]
    s_if: torch.Tensor       # [m, m] this rank's interface Schur part
    g_if: torch.Tensor       # [m]
    hll_inv: tuple           # (ia, ib, ic) of the landmark table's 2x2 inverse
    w0_loc: torch.Tensor     # [3b, L'] coupling to the eliminated landmarks
    w1_loc: torch.Tensor
    gl: torch.Tensor         # [L', 2]
    locf: torch.Tensor       # [L'] 1 for the eliminated landmarks


def _gauge(h_diag_l, h_off_l, gp_l, w0, w1, hll, gl, free_lm, sh: _Shard, cfg, mesh):
    """`gauss_newton._apply_gauge_blocked` on a rank's rows: the gauge flag
    of the previous block's last pose comes by a ring shift."""
    dtype, dev = h_diag_l.dtype, h_diag_l.device
    k_global = sh.base + torch.arange(sh.b, device=dev)
    free_pose = (k_global >= cfg.fix_first_poses) & (k_global < sh.n_poses)
    fpb = free_pose.to(dtype)[:, None, None]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    h_diag_l = h_diag_l * fpb + eye3 * (1.0 - fpb)
    prev_free = torch.cat([ppermute(free_pose[-1:], mesh, AXIS, _ring(sh.n_dev)),
                           free_pose[:-1]])
    pair = (free_pose & prev_free & (k_global >= 1)).to(dtype)
    h_off_l = h_off_l * pair[:, None, None]
    flm = free_lm.to(dtype)
    fp3 = free_pose.to(dtype).repeat_interleave(3)[:, None] * flm[None, :]
    w0, w1 = w0 * fp3, w1 * fp3
    eye2 = torch.eye(2, dtype=dtype, device=dev)
    flb = flm[:, None, None]
    hll = hll * flb + eye2 * (1.0 - flb)
    gp_l = gp_l * free_pose.to(dtype)[:, None]
    gl = gl * flm[:, None]
    if cfg.damping:
        h_diag_l = h_diag_l + eye3 * cfg.damping * fpb
        hll = hll + eye2 * cfg.damping * flb
    return h_diag_l, h_off_l, gp_l, w0, w1, hll, gl


def _block_diag2(hll):
    """[K, 2, 2] blocks -> the [2K, 2K] block diagonal."""
    k = hll.shape[0]
    out = hll.new_zeros((k, 2, k, 2))
    i = torch.arange(k, device=hll.device)
    out[i, :, i, :] = hll
    return out.reshape(2 * k, 2 * k)


def _eliminate(h_diag_l, h_off_l, gp_l, w0, w1, hll, gl, locf, w_sh, hll_sh, gl_sh, add,
               sh: _Shard, m: int) -> _Eliminated:
    """Eliminate the landmarks of `locf` into the rank's block, split it
    into interior | separator, factor the interior and form this rank's
    part of the interface system [m, m]: its separator's row and column
    (3·d), block 0's previous-separator coupling (3·(d-1), or the scratch
    slot 3·D), and the shared landmarks' columns from 3·D + 3, whose own
    Hll and gl (`hll_sh` [lsh,2,2], `gl_sh` [lsh,2]) are added with weight
    `add` (a number, [lsh], or None for none)."""
    d, n_dev, b = sh.d, sh.n_dev, sh.b
    ni = b - 1
    dtype, dev = h_diag_l.dtype, h_diag_l.device
    ia, ib, ic = (lambda v: (v[:, 0, 0], v[:, 0, 1], v[:, 1, 1]))(gn._inv2x2(hll))
    w0_loc, w1_loc = w0 * locf[None, :], w1 * locf[None, :]
    wa0 = w0_loc * ia[None, :] + w1_loc * ib[None, :]
    wa1 = w0_loc * ib[None, :] + w1_loc * ic[None, :]
    s_block = gn.densify_hpp(h_diag_l, h_off_l) - (wa0 @ w0_loc.T + wa1 @ w1_loc.T)
    g_eff = gp_l.reshape(-1) - (wa0 @ gl[:, 0] + wa1 @ gl[:, 1])
    a_mat, b_own, c_sep = s_block[:3 * ni, :3 * ni], s_block[:3 * ni, 3 * ni:], \
        s_block[3 * ni:, 3 * ni:]
    g_int, g_sep = g_eff[:3 * ni], g_eff[3 * ni:]

    lo = 3 * n_dev + 3                        # first shared-landmark column
    b_full = torch.zeros((3 * ni, m), dtype=dtype, device=dev)
    b_full[:, 3 * d:3 * d + 3] = b_own
    # the edge into the block's first pose couples it to the previous
    # separator; block 0 writes its (zero-weight) one to the scratch slot
    prev = 3 * (d - 1) if d > 0 else 3 * n_dev
    b_full[:3, prev:prev + 3] = h_off_l[0].T
    b_full[:, lo:] = w_sh[:3 * ni]

    c_full = torch.zeros((m, m), dtype=dtype, device=dev)
    c_full[3 * d:3 * d + 3, 3 * d:3 * d + 3] = c_sep
    w_sep_sh = w_sh[3 * ni:]
    c_full[3 * d:3 * d + 3, lo:] = w_sep_sh
    c_full[lo:, 3 * d:3 * d + 3] = w_sep_sh.T
    g_if = torch.zeros(m, dtype=dtype, device=dev)
    g_if[3 * d:3 * d + 3] = g_sep
    if add is not None:
        # a number, or a weight per shared landmark (for its two rows)
        per = torch.is_tensor(add)
        w2 = add.repeat_interleave(2) if per else add
        c_full[lo:, lo:] += _block_diag2(hll_sh) * (w2[:, None] if per else w2)
        g_if[lo:] += w2 * gl_sh.reshape(-1)

    chol_a = torch.linalg.cholesky_ex(a_mat).L
    x_b = torch.cholesky_solve(b_full, chol_a)
    y_g = torch.cholesky_solve(g_int[:, None], chol_a)[:, 0]
    return _Eliminated(chol_a=chol_a, b_full=b_full, g_int=g_int,
                       s_if=c_full - b_full.T @ x_b, g_if=g_if - b_full.T @ y_g,
                       hll_inv=(ia, ib, ic), w0_loc=w0_loc, w1_loc=w1_loc, gl=gl, locf=locf)


def _interface_activity(sh_ok, sh: _Shard, mesh):
    """[m] 1 for the active interface slots, 0 for separators past n_poses
    (one flag per block, gathered), the scratch slot and the padded shared
    columns."""
    mine = ((sh.base + sh.b - 1) < sh.n_poses).to(sh_ok.dtype).reshape(1)
    sep_valid = all_gather(mine, mesh, AXIS).repeat_interleave(3)
    return torch.cat([sep_valid, sep_valid.new_zeros(3), sh_ok.repeat_interleave(2)])


def _masked(s, g, act):
    """Identity rows and zero gradient for the inactive slots of `act`."""
    return s * act[:, None] * act[None, :] + torch.diag(1.0 - act), g * act


def _solve_spd(a, rhs):
    """`a` x = rhs for an SPD `a` through its Cholesky factor."""
    return torch.cholesky_solve(rhs[:, None], torch.linalg.cholesky_ex(a).L)[:, 0]


def _back_substitute(e: _Eliminated, dx_flat, poses_l, sh: _Shard):
    """(new block poses, headings wrapped; the eliminated landmarks'
    update [L', 2]) from the interface solution `dx_flat` [m]."""
    dp_int = torch.cholesky_solve((-e.g_int - e.b_full @ dx_flat)[:, None], e.chol_a)[:, 0]
    dp_blk = torch.cat([dp_int, dx_flat[3 * sh.d:3 * sh.d + 3]]).reshape(sh.b, 3)
    dp_flat = dp_blk.reshape(-1)
    ia, ib, ic = e.hll_inv
    r0 = e.gl[:, 0] + e.w0_loc.T @ dp_flat
    r1 = e.gl[:, 1] + e.w1_loc.T @ dp_flat
    dl = -torch.stack([ia * r0 + ib * r1, ib * r0 + ic * r1], dim=-1) * e.locf[:, None]
    return _wrapped(poses_l + dp_blk), dl


def _dd_iteration(poses_l, lm_xy, plan: ChainPlan, sh: _Shard, cfg, mesh):
    """One DD iteration on this rank: (new block poses, new landmarks)."""
    lsh, n_dev = plan.shared_cap, plan.n_dev
    m = 3 * n_dev + 3 + 2 * lsh
    L = lm_xy.shape[0]
    dtype, dev = poses_l.dtype, poses_l.device
    h_diag_l, h_off_l, gp_l, w0, w1, hll_part, gl_part = _pose_rows(
        poses_l, lm_xy, sh, cfg, mesh, split=True)
    hll, gl = psum([hll_part, gl_part], mesh, AXIS)
    kl = torch.arange(L, device=dev)
    free_lm = (kl >= cfg.fix_first_landmarks) & (kl < sh.n_landmarks)
    h_diag_l, h_off_l, gp_l, w0, w1, hll, gl = _gauge(
        h_diag_l, h_off_l, gp_l, w0, w1, hll, gl, free_lm, sh, cfg, mesh)

    # the reduced system in FP32, whatever the assembly's precision
    with gn._fp32():
        locf = ((plan.owner == sh.d) & free_lm).to(dtype)
        sh_clip = torch.clamp(plan.shared_idx, 0, L - 1).long()
        sh_ok = (plan.shared_idx < L).to(dtype)
        w_sh = torch.stack([w0[:, sh_clip] * sh_ok, w1[:, sh_clip] * sh_ok],
                           -1).reshape(-1, 2 * lsh)
        e = _eliminate(h_diag_l, h_off_l, gp_l, w0, w1, hll, gl, locf, w_sh,
                       hll[sh_clip] * sh_ok[:, None, None], gl[sh_clip] * sh_ok[:, None],
                       1.0 if sh.d == 0 else None, sh, m)

        # THE reduction: O(m^2) instead of O(P·L + P^2)
        s_if, g_hat = psum([e.s_if, e.g_if], mesh, AXIS)
        s_if, g_hat = _masked(s_if, g_hat, _interface_activity(sh_ok, sh, mesh))
        dx_if = _solve_spd(s_if, -g_hat)
        new_local, dl_loc = _back_substitute(e, dx_if, poses_l, sh)
        dl = psum(dl_loc, mesh, AXIS)                 # the owners are disjoint
        dl_sh = dx_if[3 * n_dev + 3:].reshape(lsh, 2) * sh_ok[:, None]
        return new_local, lm_xy + dl.index_add(0, sh_clip, dl_sh)


def chain_gn_step_dd(g: FactorGraph, plan: ChainPlan, cfg: gn.GNConfig, mesh) -> FactorGraph:
    """One GN iteration with the distributed reduced solve (`g`'s edges
    reordered as `plan.graph`'s): each rank eliminates its local landmarks,
    factors its interior poses and sums only the interface Schur complement
    (separators and shared landmarks, m x m), solved on every rank; the
    interiors back-substitute locally. The same linear algebra as the
    replicated solve up to the order of the sums. Comm per iteration: psum
    of Hll/gl (O(L)), of the [m, m] interface and of the local landmark
    updates (O(L))."""
    return _chain_dd(g, plan, cfg, mesh, 1)


def _chain_dd(g2: FactorGraph, plan: ChainPlan, cfg, mesh, iterations: int) -> FactorGraph:
    with gn.precision(cfg, g2.poses):
        sh = _shard_of(g2, plan.edge_counts, cfg, mesh, plan.n_dev)
        poses_l, lm_xy = g2.poses[sh.base:sh.base + sh.b], g2.lm_xy
        for _ in range(iterations):
            poses_l, lm_xy = _dd_iteration(poses_l, lm_xy, plan, sh, cfg, mesh)
    return dataclasses.replace(g2, poses=all_gather(poses_l, mesh, AXIS), lm_xy=lm_xy)
