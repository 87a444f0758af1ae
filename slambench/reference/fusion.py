"""Plain NumPy/PyTorch reference of a map server's fusion of S sessions
into one map, and the judge that holds the program's fused maps to it.

The steps, written from their definitions and sharing no code with the
program: the landmark slots of all sessions on one axis; duplicates as the
labels of `ROUNDS` rounds of min-label propagation over the type-gated
radius graph (each slot's label the smallest among itself and its
neighbours); one merged landmark per label, the information-weighted mean
(sum Lambda)^-1 sum Lambda x (a member without information weighs as the
fleet's mean information per sighting times its sightings); the pose chains
back to back with the edge into each session's first pose cut; every
observation edge moved onto the merged landmarks; then the joint
Gauss-Newton of `reference.gauss_newton` in float64. Sessions in one GPS
datum need no registration; a mix that asks for it (`align`) is refused.

The judge finds the reference map whose dedup the program's reproduces (its
own, or one with the gate moved by a float32 tie) and compares every fused
pose (x, y and heading) and landmark with that map.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from slambench.reference import gauss_newton as gn
from slambench.reference.replay import heading_gap, worst

EPS_D2 = 1e-4          # m^2: a radius test this close to the gate is a tie
ROUNDS = 8             # min-label propagation rounds (fuse_sessions' dedup_iters)


def labels_of(xy, types, valid, gate2):
    """`ROUNDS` rounds of min-label propagation over the type-gated radius
    graph: labels [n] (invalid slots get n)."""
    n = len(xy)
    d2 = np.sum((xy[:, None, :] - xy[None, :, :]) ** 2, axis=-1)
    adj = (d2 < gate2) & (types[:, None] == types[None, :]) & valid[:, None] & valid[None, :]
    lab = np.where(valid, np.arange(n), n)
    for _ in range(ROUNDS):
        lab = np.minimum(lab, np.min(np.where(adj, lab[None, :], n), axis=1))
    return lab


@dataclass
class Fused:
    labels: np.ndarray
    n_merged: int
    cross: int
    lm_type: np.ndarray
    graph: dict          # the fused graph before the joint GN


def fuse(graphs: list[dict], gate: float, gate2=None) -> Fused:
    """Dedup and merge of S session graphs (numpy dicts with the program's
    FactorGraph fields and `lm_info`), in float64."""
    S = len(graphs)
    L = graphs[0]["lm_xy"].shape[0]
    xy = np.concatenate([g["lm_xy"] for g in graphs]).astype(np.float64)
    types = np.concatenate([g["lm_type"] for g in graphs]).astype(np.int64)
    valid = np.concatenate([np.arange(L) < g["n_landmarks"] for g in graphs])
    lab = labels_of(xy, types, valid, gate * gate if gate2 is None else gate2)
    n = len(xy)
    root = valid & (lab == np.arange(n))
    rank = np.cumsum(root) - root
    n_merged = int(root.sum())
    to = np.where(valid, rank[np.minimum(lab, n - 1)], -1)
    # sightings per landmark slot
    counts = np.zeros(n)
    for s, g in enumerate(graphs):
        np.add.at(counts, s * L + g["obs_lm"][:g["n_obs"]].astype(np.int64), 1.0)
    w = np.where(valid, np.maximum(counts, 1.0), 0.0)
    info = np.concatenate([g["lm_info"] for g in graphs]).astype(np.float64)
    has = (info[:, 0] + info[:, 2]) > 0.0
    hv = has & valid
    tot_obs = float(np.sum(w * hv))
    nominal = float(np.sum(0.5 * (info[:, 0] + info[:, 2]) * hv)) / max(tot_obs, 1.0) \
        if tot_obs > 0 else 1.0
    a = np.where(has, info[:, 0], nominal * w)
    b = np.where(has, info[:, 1], 0.0)
    c = np.where(has, info[:, 2], nominal * w)
    sums = np.zeros((n_merged, 5))
    v = np.flatnonzero(valid)
    np.add.at(sums, to[v], np.stack([a, b, c, a * xy[:, 0] + b * xy[:, 1],
                                     b * xy[:, 0] + c * xy[:, 1]], -1)[v])
    sa, sb, sc, sx, sy = sums.T
    det = np.maximum(sa * sc - sb * sb, 1e-12)
    merged = np.stack([(sc * sx - sb * sy) / det, (sa * sy - sb * sx) / det], -1)
    lm_type = np.zeros(n_merged, np.int64)
    np.maximum.at(lm_type, to[v], types[v])
    sess = np.arange(n) // L
    lo = np.full(n_merged, S)
    hi = np.full(n_merged, -1)
    np.minimum.at(lo, to[v], sess[v])
    np.maximum.at(hi, to[v], sess[v])
    cross = int(np.sum(hi > lo))
    # pose chains back to back, each cut at its first pose; edges remapped
    poses, odo, odo_w, pp, pi, ep, el, ex = ([] for _ in range(8))
    off = 0
    for s, g in enumerate(graphs):
        k, e = int(g["n_poses"]), int(g["n_obs"])
        poses.append(g["poses"][:k])
        odo.append(g["odo_meas"][:k])
        ow = g["odo_w"][:k].astype(np.float64).copy()
        ow[0] = 0.0
        odo_w.append(ow)
        pp.append(g["prior_pose"][:k])
        pi.append(g["prior_info"][:k])
        ep.append(off + g["obs_pose"][:e].astype(np.int64))
        el.append(to[s * L + g["obs_lm"][:e].astype(np.int64)])
        ex.append(g["obs_xy"][:e])
        off += k
    cat = np.concatenate
    graph = dict(poses=cat(poses).astype(np.float64), odo=cat(odo).astype(np.float64),
                 odo_w=cat(odo_w), lm=merged, e_pose=cat(ep), e_lm=cat(el),
                 e_xy=cat(ex).astype(np.float64), prior_pose=cat(pp).astype(np.float64),
                 prior_info=cat(pi).astype(np.float64))
    return Fused(labels=lab, n_merged=n_merged, cross=cross, lm_type=lm_type, graph=graph)


class Reference:
    """The reference's fused map of one fleet, and the maps with the gate
    moved by a tie (`EPS_D2` either way); each variant's merge and GN are
    made the first time a program's labels match it."""

    SHIFTS = (0.0, EPS_D2, -EPS_D2)

    def __init__(self, graphs, gate, prob: gn.Problem, dtype=None, device="cpu"):
        self.graphs, self.gate, self.prob = graphs, gate, prob
        self.dtype, self.device = dtype, device
        self._fused, self._maps = {}, {}

    def fused(self, shift: float) -> Fused:
        if shift not in self._fused:
            self._fused[shift] = fuse(self.graphs, self.gate, self.gate * self.gate + shift)
        return self._fused[shift]

    def map(self, shift: float):
        """(Fused, poses, landmarks) with the gate moved by `shift` m^2."""
        if shift not in self._maps:
            import torch
            f = self.fused(shift)
            poses, lm, _ = gn.optimize(f.graph, self.prob, dtype=self.dtype or torch.float64,
                                       device=self.device)
            self._maps[shift] = (f, poses, lm)
        return self._maps[shift]


@dataclass
class Verdict:
    wrong: int = 0           # maps whose labels, counts or types the reference does not give
    adopted: int = 0         # maps whose labels the reference gives only as a tie
    map_gap_m: float = 0.0
    heading_gap_rad: float = 0.0
    first_wrong: str = ""

    def readings(self) -> dict:
        return {"wrong_maps": self.wrong, "map_gap_m": self.map_gap_m,
                "heading_gap_rad": self.heading_gap_rad}


def judge(ref: Reference, prog: dict, v: Verdict) -> None:
    """Hold one fused map of the program (`prog`: labels, n_merged, cross,
    lm_type, poses [n, 3] and lm [n_merged, 2] as numpy) to the reference
    whose labels, merged count and cross-session count it gives: the
    reference's own, else one with the gate moved by a tie (`adopted`).
    Its poses (x, y and heading) and landmarks are compared with that map."""
    for shift in ref.SHIFTS:
        f = ref.fused(shift)
        if np.array_equal(prog["labels"], f.labels) and prog["n_merged"] == f.n_merged \
                and prog["cross"] == f.cross:
            break
    else:
        f = ref.fused(0.0)
        v.wrong += 1
        v.first_wrong = (f"program merged {prog['n_merged']} landmarks ({prog['cross']} "
                         f"across sessions), reference {f.n_merged} ({f.cross}); labels "
                         f"differ at {int(np.sum(prog['labels'] != f.labels))} slots")
        return
    v.adopted += shift != 0.0
    f, ref_poses, ref_lm = ref.map(shift)
    if not np.array_equal(prog["lm_type"][:f.n_merged], f.lm_type) or \
            len(prog["poses"]) != len(ref_poses):
        v.wrong += 1
        v.first_wrong = "fused landmark types or pose count differ"
        return
    v.map_gap_m = worst(v.map_gap_m, np.max(np.abs(prog["poses"][:, :2] - ref_poses[:, :2])),
                        np.max(np.abs(prog["lm"] - ref_lm), initial=0.0))
    v.heading_gap_rad = worst(v.heading_gap_rad, heading_gap(prog["poses"], ref_poses))
