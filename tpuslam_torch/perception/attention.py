"""Cone detection from lidar point clouds (counterpart of
`tpuslam.perception.attention`): the "attention" front-end, in plain
PyTorch on the points' device.

The reference's detector is the sibling `cfsd18-sensation-attention`
microservice (reference usecase/docker-compose.yml:34: ROI boundaries, a
RANSAC ground plane with dot/inlier thresholds and 10 iterations, connected
clustering at 0.4 m, 2..80 points per cone, near/far radius gating). As in
the JAX package:

- ROI and ground removal are masked vector ops; the RANSAC hypotheses are
  evaluated at once ([N, iterations] point-plane distances).
- Clustering is connected components by min-label propagation, int32
  labels. The dense provider builds the [N, N] radius adjacency (up to
  `dense_max_points`) and runs 2 x `label_iterations` rounds; the grid
  provider hashes points into connect-radius cells over the static ROI
  extent, packs them into a [cells, cell_capacity] table and propagates
  over the 3x3 neighbourhood (nine static rolls), with min-slot hooking and
  double pointer jumping, for full ~29k-return VLP-16 sweeps.
- Cluster statistics are segment reductions: `index_add_` for the sums and
  `scatter_reduce("amax")` for the radius (an empty segment is -inf, as
  `jax.ops.segment_max` gives).

The RANSAC triples are `jax.random.randint`'s from the same seed, the
Threefry-2x32 hash computed in numpy on the host and moved to the device,
so a CPU run, a GPU run and the JAX package fit the same hypotheses;
`detect_cones` also takes the caller's triples (`ransac_idx`). On the card the sums of
`index_add_` are atomics (centroids and cone tuples within a tolerance of
the CPU run; counts and labels exact), and a division by a constant divides
by a 0-dim tensor on the device: CUDA computes `x / python_float` as a
product with the reciprocal, which would move points across cell bounds.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from tpuslam_torch.geometry.spherical import lane_uniform

__all__ = ["AttentionConfig", "detect_cones", "grid_cell_overflow", "ransac_triples"]


@dataclass(frozen=True)
class AttentionConfig:
    # defaults = reference usecase/docker-compose.yml:34 flags; the same
    # fields and defaults as the JAX package's (see it for each one)
    x_boundary: float = 4.0            # lateral half-width of ROI [m]
    y_boundary: float = 12.0           # forward extent of ROI [m]
    ground_layer_z: float = -0.3       # fallback ground height [m]
    cone_height: float = 0.5
    connect_distance_threshold: float = 0.4
    min_points: int = 2
    max_points: int = 80
    far_cone_radius: float = 0.2
    near_cone_radius: float = 0.25
    near_range: float = 6.0            # near/far split for radius gating
    z_range_threshold: float = 0.08    # unused spare from the reference set
    inlier_range_threshold: float = 0.06
    dot_threshold: float = 0.1         # |normal x z| tolerance
    inlier_found_threshold: int = 150
    ransac_iterations: int = 10
    label_iterations: int = 8          # min-label propagation rounds
    max_cones: int = 64
    sensor_height: float = 0.0         # sensor z above ground
    # 'dense' = exact NxN adjacency; 'grid' = hashed 3x3-cell candidate
    # lists (full-sweep scale); 'auto' picks grid above dense_max_points
    clustering: str = "auto"
    dense_max_points: int = 4096
    cell_capacity: int = 32            # cell-table slots per grid cell
    point_capacity: int = 4096         # service-side device buffer size
    host_prefilter: bool = True        # ROI-filter on host before device pad


_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(x, d: int):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def _threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2) under
    the key (k1, k2), all numpy uint32 with wrapping arithmetic: what
    `jax.random`'s default PRNG computes."""
    ks = (np.uint32(k1), np.uint32(k2), np.uint32(k1) ^ np.uint32(k2) ^ np.uint32(0x1BD11BDA))
    x = [x1 + ks[0], x2 + ks[1]]
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = x[0] ^ _rotl32(x[1], r)
        x = [x[0] + ks[(i + 1) % 3], x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)]
    return x


def _random_bits32(key, size: int):
    """`jax.random.bits(key, (size,))` for uint32 under the partitionable
    Threefry (the counters are the flat indices, high word then low)."""
    lo = np.arange(size, dtype=np.uint32)
    b1, b2 = _threefry2x32(key[0], key[1], np.zeros(size, np.uint32), lo)
    return b1 ^ b2


def ransac_triples(n: int, cfg: AttentionConfig, seed: int, device) -> torch.Tensor:
    """[ransac_iterations, 3] point indices in [0, n) on `device`: exactly
    `jax.random.randint(jax.random.PRNGKey(seed), (iters, 3), 0, n)`, drawn
    on the host in numpy. The key is (seed >> 32, seed & 0xffffffff); it is
    split in two (fold-like counters 0 and 1), each half gives 32 random bits
    per value, and the 64 bits are reduced modulo n as `randint` does, its
    2^32 mod n multiplier squared with uint32 wrap."""
    shape = (cfg.ransac_iterations, 3)
    size = shape[0] * shape[1]
    with np.errstate(over="ignore"):
        s1, s2 = _threefry2x32(np.uint32((seed >> 32) & 0xFFFFFFFF), np.uint32(seed & 0xFFFFFFFF),
                               np.zeros(2, np.uint32), np.arange(2, dtype=np.uint32))
        hi, lo = (_random_bits32((s1[i], s2[i]), size) for i in (0, 1))
        span = np.uint32(max(n, 1))
        mult = np.uint32(2 ** 16) % span
        mult = (mult * mult) % span
        off = ((hi % span) * mult + (lo % span)) % span
    return torch.from_numpy(off.astype(np.int64).reshape(shape)).to(device)


def _const(x: torch.Tensor, v: float) -> torch.Tensor:
    """`v` as a 0-dim float32 tensor on `x`'s device (an exact divisor)."""
    return torch.full((), v, dtype=torch.float32, device=x.device)


def _ransac_ground(points, valid, cfg: AttentionConfig, idx):
    """Vectorized RANSAC plane fit over the triples `idx` [I, 3]; returns the
    signed height above ground [N]."""
    tri = points[idx]                                  # [I, 3, 3]
    v1 = tri[:, 1] - tri[:, 0]
    v2 = tri[:, 2] - tri[:, 0]
    normal = torch.linalg.cross(v1, v2)
    norm = torch.sqrt(torch.sum(normal * normal, dim=-1, keepdim=True))
    normal = normal / torch.clamp(norm, min=1e-9)
    # plane must be near-horizontal (reference dotThreshold)
    horiz = torch.abs(normal[:, 2]) > (1.0 - cfg.dot_threshold)
    d = -torch.sum(normal * tri[:, 0], dim=-1)         # [I]
    dist = torch.abs(points @ normal.T + d[None, :])   # [N, I]
    inliers = torch.sum((dist < cfg.inlier_range_threshold) & valid[:, None], dim=0)
    score = torch.where(horiz, inliers, -1)
    # the winner as a one-element index: gathers on the device, where a
    # 0-dim index would be read back to the host
    best = torch.argmax(score).reshape(1)
    nb, db = normal[best][0], d[best][0]
    ok = score[best][0] >= cfg.inlier_found_threshold
    height_plane = (points @ nb + db) * torch.sign(nb[2])
    height_flat = points[:, 2] - cfg.ground_layer_z
    return torch.where(ok, height_plane, height_flat)


def _connected_components(points_xy, valid, cfg: AttentionConfig):
    """Min-label propagation over the radius graph -> root labels [N] (int32,
    n for an invalid point)."""
    n = points_xy.shape[0]
    dx = points_xy[:, None, 0] - points_xy[None, :, 0]
    dy = points_xy[:, None, 1] - points_xy[None, :, 1]
    d2 = dx * dx + dy * dy
    thr2 = cfg.connect_distance_threshold ** 2
    adj = (d2 < thr2) & valid[:, None] & valid[None, :]
    del dx, dy, d2
    no = ~adj
    lab = torch.where(valid, torch.arange(n, dtype=torch.int32, device=valid.device), n)
    # 2x plain rounds, as the JAX package (its pointer-jump reach in rounds)
    for _ in range(2 * cfg.label_iterations):
        neigh = lab[None, :].expand(n, n).masked_fill(no, n)
        lab = torch.minimum(lab, torch.amin(neigh, dim=1))
    return lab


def _grid(cfg: AttentionConfig):
    """(h, nx, ny): the cell side and the static grid over the ROI, with one
    pad cell each side."""
    h = cfg.connect_distance_threshold
    return h, int(math.ceil(cfg.y_boundary / h)) + 3, int(math.ceil(2.0 * cfg.x_boundary / h)) + 3


def _cells(points_xy, valid, cfg: AttentionConfig):
    """Each point's grid cell id, int32, c = nx * ny for an invalid point."""
    h, nx, ny = _grid(cfg)
    hh = _const(points_xy, h)
    cx = torch.clamp(torch.floor(points_xy[:, 0] / hh).to(torch.int32) + 1, 0, nx - 1)
    cy = torch.clamp(torch.floor((points_xy[:, 1] + cfg.x_boundary) / hh).to(torch.int32) + 1,
                     0, ny - 1)
    return torch.where(valid, cx * ny + cy, nx * ny)


def _connected_components_grid(points_xy, valid, cfg: AttentionConfig):
    """Grid-hashed connected components for full-sweep point counts: the
    JAX package's algorithm (see its docstring for the capacity caveat:
    points beyond `cell_capacity` in one cell join the cell's rank-0
    component). Labels are table-slot ids while propagating, mapped back to
    each point's representative original index at the end."""
    n = points_xy.shape[0]
    dev = points_xy.device
    h, nx, ny = _grid(cfg)
    c = nx * ny
    k = cfg.cell_capacity
    i32 = torch.int32
    cell = _cells(points_xy, valid, cfg)
    order = torch.argsort(cell, stable=True)               # ties by index
    sorted_cell = cell[order]
    bounds = torch.searchsorted(sorted_cell, torch.arange(c + 1, dtype=i32, device=dev),
                                out_int32=True)

    # dense cell table: tbl[cell, rank] = original point index (n = empty)
    cnt = bounds[1:] - bounds[:-1]                                   # [C]
    ar_k = torch.arange(k, dtype=i32, device=dev)
    slot = bounds[:c, None] + ar_k[None, :]                          # [C, K]
    occ = ar_k[None, :] < cnt[:, None]
    tbl = torch.where(occ, order[torch.clamp(slot, 0, n - 1)].to(i32), n)
    txy = points_xy[torch.clamp(tbl, 0, n - 1)]                      # [C, K, 2]

    def neigh(x):
        """[C, K, ...] -> [C, 9K, ...]: the 3x3 cell neighbourhood, by
        static rolls."""
        g = x.reshape(nx, ny, *x.shape[1:])
        rolls = [torch.roll(g, (-dx, -dy), (0, 1)) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
        return torch.stack(rolls, dim=2).reshape(c, 9 * k, *x.shape[2:])

    nbr_occ = neigh(occ)                                             # [C, 9K]
    nbr_xy = neigh(txy)                                              # [C, 9K, 2]
    dx = txy[:, :, None, 0] - nbr_xy[:, None, :, 0]
    dy = txy[:, :, None, 1] - nbr_xy[:, None, :, 1]
    adj = occ[:, :, None] & nbr_occ[:, None, :] & (dx * dx + dy * dy < h * h)  # [C, K, 9K]
    del dx, dy
    no = ~adj

    sent = c * k                                                     # sentinel slot id
    lab = torch.where(occ, torch.arange(sent, dtype=i32, device=dev).reshape(c, k), sent)
    sent_t = torch.full((1,), sent, dtype=i32, device=dev)
    for _ in range(cfg.label_iterations):
        nbr_lab = neigh(lab)                                         # [C, 9K]
        m = torch.amin(nbr_lab[:, None, :].expand(c, k, 9 * k).masked_fill(no, sent), dim=2)
        fl = torch.minimum(lab, m).reshape(-1)
        fl = torch.minimum(fl, torch.cat([fl, sent_t])[fl])          # pointer jumping x2
        fl = torch.minimum(fl, torch.cat([fl, sent_t])[fl])
        lab = fl.reshape(c, k)

    # slot labels -> per-point labels (representative = root slot's point)
    n_t = torch.full((1,), n, dtype=i32, device=dev)
    root_pt = torch.cat([tbl.reshape(-1), n_t])[lab.reshape(-1)]     # [C*K]
    sc = torch.clamp(sorted_cell, 0, c - 1)
    rank = torch.arange(n, dtype=i32, device=dev) - bounds[sc]
    real = sorted_cell < c
    slot_of = torch.where(real & (rank < k), sc * k + torch.clamp(rank, 0, k - 1),
                          torch.where(real, sc * k, sent))
    lab_sorted = torch.cat([root_pt, n_t])[slot_of]
    out = torch.full((n,), n, dtype=i32, device=dev)
    out[order] = lab_sorted
    return out


def grid_cell_overflow(points, valid, cfg: AttentionConfig):
    """Diagnostic counter for the grid clustering's capacity caveat: the
    number of points beyond `cell_capacity` in their hash cell (0-dim
    int32). Run on ground-masked points, the [N, 2] xy and validity the
    label loop sees."""
    _, nx, ny = _grid(cfg)
    c = nx * ny
    cell = _cells(points[:, :2], valid, cfg)
    cnt = torch.zeros(c + 1, dtype=torch.int32, device=points.device)
    cnt.index_add_(0, cell, torch.ones_like(cell))
    return torch.sum(torch.clamp(cnt[:c] - cfg.cell_capacity, min=0)).to(torch.int32)


def _segment_sum(x, labels, n):
    """Sums of `x` [N, ...] over segments `labels` [N] in [0, n], rows 0..n-1."""
    out = torch.zeros((n + 1,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add_(0, labels, x)[:n]


def detect_cones(points, valid, cfg: AttentionConfig, seed=0, intensity=None, ransac_idx=None):
    """Point cloud [N,3] (sensor frame: x fwd, y left, z up) -> cone tuples,
    on the points' device.

    Returns (cones [K,4] = (azimuth_deg, zenith_deg, distance_m, type),
    cone_valid [K], n_cones). Types come from mean cluster intensity via the
    convention type=round(intensity/10); 0 when no intensity is given. The
    RANSAC triples are `ransac_idx` [ransac_iterations, 3] when given, else
    `ransac_triples(N, cfg, seed, points.device)`.
    """
    n = points.shape[0]
    if ransac_idx is None:
        ransac_idx = ransac_triples(n, cfg, seed, points.device)

    roi = (valid
           & (torch.abs(points[:, 1]) <= cfg.x_boundary)
           & (points[:, 0] > 0.1) & (points[:, 0] <= cfg.y_boundary))
    height = _ransac_ground(points, roi, cfg, ransac_idx.to(points.device))
    obstacle = roi & (height > cfg.inlier_range_threshold) & (height < cfg.cone_height + 0.3)

    use_grid = cfg.clustering == "grid" or (
        cfg.clustering == "auto" and n > cfg.dense_max_points)
    cc = _connected_components_grid if use_grid else _connected_components
    labels = cc(points[:, :2], obstacle, cfg)

    w = obstacle.to(points.dtype)
    counts = _segment_sum(w, labels, n)
    sums = _segment_sum(points * w[:, None], labels, n)
    safe = torch.clamp(counts, min=1.0)
    centroid = sums / safe[:, None]

    # xy scatter radius per cluster
    dxy = points[:, :2] - centroid[torch.clamp(labels, 0, n - 1), :2]
    r2 = (dxy[:, 0] * dxy[:, 0] + dxy[:, 1] * dxy[:, 1]) * w
    rmax2 = torch.full((n + 1,), -math.inf, dtype=points.dtype, device=points.device)
    rmax2 = rmax2.scatter_reduce_(0, labels.long(), torch.where(obstacle, r2, -1.0),
                                  "amax")[:n]

    is_root = counts > 0
    cx, cy = centroid[:, 0], centroid[:, 1]
    dist = torch.sqrt(cx * cx + cy * cy)
    r_gate = torch.where(dist < cfg.near_range, cfg.near_cone_radius, cfg.far_cone_radius)
    good = (is_root
            & (counts >= cfg.min_points) & (counts <= cfg.max_points)
            & (rmax2 <= r_gate ** 2))

    # rank clusters by distance, take the first max_cones
    order = torch.argsort(torch.where(good, dist, math.inf), stable=True)
    k = cfg.max_cones
    sel = order[:k]
    sel_good = good[sel]
    c = centroid[sel]
    az = torch.rad2deg(lane_uniform(torch.atan2, c[:, 1], c[:, 0]))
    rng = torch.sqrt(c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2])
    ratio = torch.clamp((c[:, 2] + cfg.sensor_height) / torch.clamp(rng, min=1e-6), -1, 1)
    zen = torch.rad2deg(lane_uniform(torch.asin, ratio))
    if intensity is not None:
        isum = _segment_sum(intensity * w, labels, n)
        ctype = torch.round(isum[sel] / torch.clamp(counts[sel], min=1.0) / _const(points, 10.0))
    else:
        ctype = torch.zeros(k, dtype=points.dtype, device=points.device)
    cones = torch.stack([az, zen, rng, ctype], dim=-1)
    return cones, sel_good, torch.sum(sel_good.to(torch.int32))
