"""Plain NumPy reference of a session replay, and the judge that holds the
program's outputs to it.

The reference re-derives, keyframe by keyframe and in float64, what a
session of the cfsd18 landmark SLAM produces under a configuration of the
reference-compatible family (`SlamConfig` without the improved mode): the
GPS outlier guard, the pose and odometry edge, association of the frame's
cones against the map as it stood before the frame ('first' or nearest,
type-gated within `same_cone_threshold`), landmark creation with in-frame
duplicates folded onto their first representative, the reference's
`currentConeIndex` carry, loop-closure detection and the one-shot closure
Gauss-Newton (`reference.gauss_newton`), then localization against the
frozen map and the `cones_per_packet` cone packet of every keyframe. It
imports nothing of the program.

The judge walks the same keyframes beside the program's outputs. A keyframe
whose discrete outcome (the edges it appends and their landmarks, the
landmark count, the closure flag, the send flag and the packet's cones)
differs from the reference's is tried again with every gate moved by the
rounding the program's float32 can carry (`EPS_D2` in m^2, and after the
closure the gap between the two closure solutions) and nearest ties broken
toward the program's choice. If one of those reproduces the program's
keyframe, the decision was a tie, and the reference goes on from it
(`adopted`); if none does, the keyframe is wrong and the session is not
judged further (the reference runs on alone to its final map). Values are
compared as one gap in metres: the final map's poses, landmarks and edge
measurements, the published poses, and the packets' distances and
azimuths; the headings of the final map's poses and of the published
poses as a second gap, in radians.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from slambench.reference import gauss_newton as gn
from slambench.reference.geometry import body_xy, between, to_body_spherical, to_global

EPS_D2 = 1e-4          # m^2: a squared-distance test this close to its bound is a tie


def worst(*gaps) -> float:
    """The largest gap, NaN if any is NaN (Python's max would drop it)."""
    gaps = [float(g) for g in gaps]
    return float("nan") if any(g != g for g in gaps) else max(gaps)


def heading_gap(a, b) -> float:
    """The largest gap in radians between the headings a[..., 2] and
    b[..., 2], wrapped to [0, pi]."""
    d = np.abs(np.mod(np.asarray(a)[..., 2] - np.asarray(b)[..., 2] + np.pi, 2 * np.pi) - np.pi)
    return float(np.max(d, initial=0.0))


@dataclass(frozen=True)
class Semantics:
    """What a configuration asks of a session (from its `slam` fields)."""
    gate: float
    map_range: float
    loop_radius: float
    loop_min_index: int
    lever: float
    compat: bool
    first: bool                 # 'first' association, else nearest
    indexed: bool               # index-provider localization (the kernel path)
    type_bug: bool              # the reference's signed type compare in localization
    packet: int
    gps_bound: float
    dup_depth: int
    cap: tuple                  # (poses, landmarks, edges)
    gn: gn.Problem

    @classmethod
    def from_config(cls, slam: dict, capacity) -> "Semantics":
        refused = {"use_gps_prior": False, "periodic_gn_every": 0, "localizer_refine": False,
                   "mapping_publish_refine": False, "vectorized_mapping": True,
                   "use_ekf_fusion": False}
        for key, want in refused.items():
            if slam.get(key, want) != want:
                raise NotImplementedError(f"the replay reference has no {key}={slam[key]!r}")
        assoc = slam.get("association", "first")
        if assoc not in ("first", "nearest"):
            raise NotImplementedError(f"the replay reference has no association={assoc!r}")
        compat = slam.get("reference_compat", True)
        return cls(
            gate=slam.get("same_cone_threshold", 1.2),
            map_range=slam.get("cone_mapping_threshold", 50.0),
            loop_radius=slam.get("loop_closure_radius", 1.0),
            loop_min_index=slam.get("loop_closure_min_index", 20),
            lever=slam.get("lidar_to_cog", 1.5), compat=compat, first=assoc == "first",
            indexed=slam.get("use_pallas_association", False) and assoc != "first",
            type_bug=compat and slam.get("localizer_type_bug", True),
            packet=slam.get("cones_per_packet", 20),
            gps_bound=slam.get("gps_outlier_bound", 200.0),
            dup_depth=slam.get("in_frame_dup_depth", 4), cap=tuple(capacity),
            gn=gn.Problem(odo_info=slam.get("odo_info", 5.0), lm_info=slam.get("lm_info", 0.01),
                          iterations=slam.get("gn_iterations", 10), fix_poses=2,
                          fix_landmarks=2, early_exit_tol=slam.get("gn_early_exit_tol", 1e-4)))


class Session:
    """One session's map and carry, in `dtype`."""

    def __init__(self, sem: Semantics, dtype):
        cp, cl, ce = sem.cap
        self.poses = np.zeros((cp, 3), dtype)
        self.odo = np.zeros((cp, 3), dtype)
        self.n_p = 0
        self.lm = np.zeros((cl, 2), dtype)
        self.lt = np.zeros(cl, np.int64)
        self.n_l = 0
        self.e_pose = np.zeros(ce, np.int64)
        self.e_lm = np.zeros(ce, np.int64)
        self.e_xy = np.zeros((ce, 2), dtype)
        self.n_e = 0
        self.cur = 0
        self.closing = False
        self.complete = False

    def graph(self) -> dict:
        n, m, e = self.n_p, self.n_l, self.n_e
        return dict(poses=self.poses[:n], odo=self.odo[:n], odo_w=np.ones(n), lm=self.lm[:m],
                    e_pose=self.e_pose[:e], e_lm=self.e_lm[:e], e_xy=self.e_xy[:e],
                    prior_pose=np.zeros((n, 3)), prior_info=np.zeros((n, 2)))


@dataclass
class Frame:
    """A keyframe's outcome before it is applied to its session."""
    ran: bool = False           # the pose passed the GPS guard
    mapping: bool = False
    new_lm: list = dataclasses.field(default_factory=list)   # (slot, xy, type)
    rows: list = dataclasses.field(default_factory=list)     # (landmark, body xy)
    cur: int = 0
    closing: bool = False
    closed: bool = False        # the closure GN runs on this keyframe
    send: bool = False


def _pick(d2, ok, first, prefer, tie):
    """Landmark index per row of the [N, M] test `ok` (first true, or the
    least `d2`, the lower index on equal values; with `prefer`, a preferred
    index within `tie` of the least), and whether any matched."""
    matched = ok.any(axis=1)
    if ok.shape[1] == 0:
        return np.zeros(ok.shape[0], np.int64), matched
    if first:
        return np.argmax(ok, axis=1), matched
    dm = np.where(ok, d2, np.inf)
    j = np.argmin(dm, axis=1)
    if prefer:
        best = dm[np.arange(len(j)), j]
        for i in np.flatnonzero(matched):
            for c in np.flatnonzero(ok[i] & (dm[i] <= best[i] + tie)):
                if c in prefer:
                    j[i] = c
                    break
    return j, matched


def _mapping(st: Session, sem: Semantics, glob, body, otype, dist, valid, pose_idx,
             shift, prefer, tie) -> Frame:
    """The mapping update of one keyframe against `st` (not modified)."""
    cap_l = sem.cap[1]
    g2 = sem.gate * sem.gate + shift
    n = st.n_l
    fr = Frame(ran=True, mapping=True)
    lm, lt = st.lm[:n].copy(), st.lt[:n].copy()
    boot = n == 0 and bool(valid[0])
    if boot:
        lm, lt = glob[:1].copy(), otype[:1].copy()
        fr.new_lm.append((0, glob[0], int(otype[0])))
        fr.rows.append((0, body[0]))
        n = 1
    # phase A: against the map before the frame (and the bootstrap landmark)
    d2 = np.sum((glob[:, None, :] - lm[None, :, :]) ** 2, axis=-1)
    ok = (lt[None, :] == otype[:, None]) & (d2 < g2) & valid[:, None]
    j, matched0 = _pick(d2, ok, sem.first, prefer, tie)
    N = len(valid)
    # the running current index before each observation (prefix over k < i)
    cur_before = np.empty(N, np.int64)
    best_d, best_j = np.inf, -1
    for i in range(N):
        cur_before[i] = best_j if best_d < 100.0 else st.cur
        if matched0[i] and dist[i] < best_d:
            best_d, best_j = dist[i], j[i]
    d_first = np.sum((lm[j] - lm[0]) ** 2, axis=-1) if n else np.full(N, np.inf)
    r2 = sem.loop_radius ** 2 + shift
    closure0 = (matched0 & (d_first < r2) & (cur_before > sem.loop_min_index)
                & (dist < sem.map_range))
    closed_before = st.closing | ((np.cumsum(closure0) - closure0) > 0)
    fr.closing = st.closing or bool(closure0.any())
    matched = matched0 & ~closed_before
    # phase B: new landmarks, in-frame duplicates onto their first representative
    cand = valid & ~matched0 & ~closed_before & (dist < sem.map_range)
    gd2 = np.sum((glob[:, None, :] - glob[None, :, :]) ** 2, axis=-1)
    lower = np.arange(N)[:, None] > np.arange(N)[None, :]
    gsame = (otype[:, None] == otype[None, :]) & (gd2 < g2) & lower
    is_new = cand.copy()
    for _ in range(sem.dup_depth):
        is_new = cand & ~np.any(gsame & is_new[None, :], axis=1)
    rep_ok = gsame & is_new[None, :]
    rep = np.argmax(rep_ok, axis=1)
    is_dup = cand & rep_ok.any(axis=1)
    new_rank = np.cumsum(is_new) - is_new
    slot_self = n + new_rank
    slot = np.where(is_new, slot_self, slot_self[rep])
    slot_ok = slot < cap_l
    for i in np.flatnonzero(is_new & slot_ok):
        fr.new_lm.append((int(slot[i]), glob[i], int(otype[i])))
    target = np.where(matched, j, slot)
    cur_cand = matched | (is_dup & slot_ok)
    vals = np.where(cur_cand, dist, np.inf)
    b = int(np.argmin(vals))
    fr.cur = int(target[b]) if vals[b] < 100.0 else st.cur
    keep = matched | ((is_new | is_dup) & slot_ok)
    fr.rows += [(int(target[i]), body[i]) for i in np.flatnonzero(keep)]
    if st.n_e + len(fr.rows) > sem.cap[2]:
        raise NotImplementedError("the replay reference does not fill the edge store")
    fr.closed = fr.closing and not st.complete
    return fr


def _localization(st: Session, sem: Semantics, glob, otype, dist, valid, shift, prefer,
                  tie) -> Frame:
    fr = Frame(ran=True, cur=st.cur, closing=st.closing)
    if int(valid.sum()) <= 1:
        return fr
    fr.send = True
    n = st.n_l
    lm, lt = st.lm[:n], st.lt[:n]
    d2 = np.sum((glob[:, None, :] - lm[None, :, :]) ** 2, axis=-1)
    if sem.indexed:
        type_ok = lt[None, :] == otype[:, None]
        first = False
    else:
        type_ok = ((lt[None, :] - otype[:, None]) < 1e-4) if sem.type_bug \
            else lt[None, :] == otype[:, None]
        first = True
    ok = type_ok & (d2 < sem.gate * sem.gate + shift) & valid[:, None]
    j, matched = _pick(d2, ok, first, prefer, tie)
    if matched.any():
        b = int(np.argmin(np.where(matched, dist, np.inf)))
        fr.cur = int(j[b])
    return fr


def _apply(st: Session, fr: Frame, sem: Semantics, device) -> None:
    for slot, xy, t in fr.new_lm:
        st.lm[slot], st.lt[slot] = xy, t
    st.n_l = min(st.n_l + len(fr.new_lm), sem.cap[1])
    pose_idx = st.n_p - 1
    for lm, xy in fr.rows:
        st.e_pose[st.n_e], st.e_lm[st.n_e], st.e_xy[st.n_e] = pose_idx, lm, xy
        st.n_e += 1
    st.cur, st.closing = fr.cur, fr.closing
    if fr.mapping:
        st.complete = st.complete or fr.closing
    if fr.closed:
        poses, lm, _ = gn.optimize(st.graph(), sem.gn, dtype=_torch_dtype(st.poses.dtype),
                                   device=device)
        st.poses[:st.n_p], st.lm[:st.n_l] = poses, lm


def _torch_dtype(dt):
    import torch
    return torch.float64 if dt == np.float64 else torch.float32


def _packet(st: Session, sem: Semantics, pose):
    k = np.arange(sem.packet)
    n = max(st.n_l, 1)
    idx = st.cur + k
    idx = np.where(idx < n, idx, idx - n)
    idx = np.minimum(np.maximum(idx, 0), n - 1)
    az, dist = to_body_spherical(pose, st.lm[idx], sem.compat)
    return az, dist, st.lt[idx]


class Replay:
    """The reference's run of one session, keyframe by keyframe: `step(t)`
    computes keyframe t's outcome (with gates moved by `shift` and ties
    broken toward `prefer`), `commit` applies one."""

    def __init__(self, sem: Semantics, obs, valid, poses, dtype=np.float64, device="cpu"):
        self.sem, self.dtype, self.device = sem, dtype, device
        self.obs = np.asarray(obs).astype(dtype)
        self.valid = np.asarray(valid).astype(bool)
        self.in_poses = np.asarray(poses).astype(dtype)
        self.st = Session(sem, dtype)
        o = self.obs
        self.body = body_xy(o[..., 0], o[..., 1], o[..., 2], sem.lever, sem.compat)
        self.otype = o[..., 3].astype(np.int64)

    def step(self, t, shift=0.0, prefer=None, tie=0.0):
        st, sem, pose = self.st, self.sem, self.in_poses[t]
        if abs(pose[0]) > sem.gps_bound or abs(pose[1]) > sem.gps_bound:
            return Frame(cur=st.cur, closing=st.closing)
        glob = to_global(pose[None, :], self.body[t])
        dist, valid, otype = self.obs[t, :, 2], self.valid[t], self.otype[t]
        if st.complete:
            return _localization(st, sem, glob, otype, dist, valid, shift, prefer, tie)
        return _mapping(st, sem, glob, self.body[t], otype, dist, valid, st.n_p, shift,
                        prefer, tie)

    def commit(self, t, fr: Frame):
        """Apply keyframe t's outcome; returns (published pose, packet
        azimuths, distances, types)."""
        st, pose = self.st, self.in_poses[t]
        if fr.ran:
            prev = st.poses[st.n_p - 1] if st.n_p else None
            st.odo[st.n_p] = between(prev, pose) if prev is not None else 0.0
            st.poses[st.n_p] = pose
            st.n_p += 1
            _apply(st, fr, self.sem, self.device)
        return (pose,) + _packet(st, self.sem, pose)


def run_session(sem: Semantics, obs, valid, poses, dtype=np.float64, device="cpu") -> dict:
    """The reference run of one session alone, in the layout the judge
    reads: per keyframe the published pose, the packet, the send and
    closure flags and the landmark count; the final graph."""
    rp = Replay(sem, obs, valid, poses, dtype, device)
    frames = []
    for t in range(len(poses)):
        fr = rp.step(t)
        frames.append(rp.commit(t, fr) + (fr, rp.st.n_l))
    st = rp.st
    return dict(
        out_pose=np.stack([f[0] for f in frames]), az=np.stack([f[1] for f in frames]),
        dist=np.stack([f[2] for f in frames]), ctype=np.stack([f[3] for f in frames]),
        send=np.array([f[4].send for f in frames]), closed=np.array([f[4].closed for f in frames]),
        n_lm=np.array([f[5] for f in frames]), poses=st.poses[:st.n_p].copy(),
        lm=st.lm[:st.n_l].copy(), lt=st.lt[:st.n_l].copy(), e_pose=st.e_pose[:st.n_e].copy(),
        e_lm=st.e_lm[:st.n_e].copy(), e_xy=st.e_xy[:st.n_e].copy(), n_p=st.n_p, n_l=st.n_l,
        n_e=st.n_e)


# ---------------------------------------------------------------------------
# the judge
# ---------------------------------------------------------------------------

@dataclass
class Verdict:
    """One session's reading: wrong keyframes (discrete outcomes the
    reference does not reproduce even as a tie), ties adopted, the largest
    gap in metres of a value (a pose or landmark of the final map, an
    edge's measurement, a published pose, a packet cone's distance or its
    azimuth as lateral metres at that distance), and the largest gap in
    radians of a heading (the final map's poses, the published poses)."""
    wrong: int = 0
    adopted: int = 0
    map_gap_m: float = 0.0
    heading_gap_rad: float = 0.0
    first_wrong: str = ""

    def add(self, other: "Verdict") -> None:
        """Fold another session's reading into this one."""
        self.wrong += other.wrong
        self.adopted += other.adopted
        self.map_gap_m = worst(self.map_gap_m, other.map_gap_m)
        self.heading_gap_rad = worst(self.heading_gap_rad, other.heading_gap_rad)

    def readings(self) -> dict:
        return {"wrong_keyframes": self.wrong, "map_gap_m": self.map_gap_m,
                "heading_gap_rad": self.heading_gap_rad}


def _rows_of(prog, pose_idx):
    lo, hi = np.searchsorted(prog["e_pose"][:prog["n_e"]], [pose_idx, pose_idx + 1])
    return list(prog["e_lm"][lo:hi])


def _same(fr: Frame, out, n_l: int, want) -> bool:
    """Whether the reference's committed keyframe (`out` its packet, `n_l`
    its landmark count after it) shows the program's discrete outcome
    `want` = (rows, landmark count, closed, send, packet types, packet
    distances)."""
    rows, n_lm, closed, send, ctype, dist = want
    _, _, r_dist, r_ctype = out
    # the packet's cones: the same types, each within a metre of the
    # program's (a different current cone moves them by a cone spacing)
    return ([r[0] for r in fr.rows] == rows and n_l == n_lm and fr.closed == closed
            and fr.send == send and np.array_equal(r_ctype, ctype)
            and bool(np.all(np.abs(r_dist - dist) < 1.0)))


def judge_session(sem: Semantics, obs, valid, poses, prog: dict, dtype=np.float64,
                  device="cpu") -> Verdict:
    """Hold the program's run of one session (`prog`: numpy arrays out_pose
    [T, 3], az / dist / ctype [T, K], send / closed / n_lm [T], and the final
    graph poses, lm, lt, e_pose, e_lm, e_xy with n_p, n_l, n_e) to the
    reference. After a wrong keyframe the reference runs on alone and only
    the final map is compared."""
    v = Verdict()
    rp = Replay(sem, obs, valid, poses, dtype, device)
    lm_gap = 0.0
    judging = True
    for t in range(len(poses)):
        st = rp.st
        mapping = not st.complete
        rows_prog = _rows_of(prog, st.n_p) if mapping else []
        want = (rows_prog, int(prog["n_lm"][t]), bool(prog["closed"][t]),
                bool(prog["send"][t]), prog["ctype"][t], prog["dist"][t])
        tie = EPS_D2 if mapping else EPS_D2 + 4.0 * sem.gate * lm_gap
        snapshot = _copy(st)
        fr = rp.step(t)
        out = rp.commit(t, fr)
        if judging and not _same(fr, out, rp.st.n_l, want):
            cur_prog = _current_of(rp.st, sem, poses[t], want[4], want[5])
            prefer = set(int(x) for x in rows_prog) | {cur_prog}
            for shift in (tie, -tie, 0.0):
                rp.st = _copy(snapshot)
                fr = rp.step(t, shift, prefer, tie)
                out = rp.commit(t, fr)
                if _same(fr, out, rp.st.n_l, want):
                    v.adopted += 1
                    break
            else:
                v.wrong += 1
                v.first_wrong = (
                    f"keyframe {t}: program rows {rows_prog[:8]} landmarks {want[1]} closed "
                    f"{want[2]} send {want[3]}; reference rows {[r[0] for r in fr.rows][:8]} "
                    f"landmarks {rp.st.n_l} closed {fr.closed} send {fr.send}")
                judging = False
        if fr.closed:
            n = min(prog["n_l"], rp.st.n_l)
            lm_gap = worst(np.max(np.abs(prog["lm"][:n] - rp.st.lm[:n]), initial=0.0))
        if judging:
            # the packet's cones as distances and as lateral metres at their
            # distance; the published pose
            _, az, dist, _ = out
            daz = np.radians((az - prog["az"][t] + 180.0) % 360.0 - 180.0)
            v.map_gap_m = worst(v.map_gap_m, np.max(np.abs(dist - prog["dist"][t])),
                                np.max(np.abs(daz) * dist),
                                np.max(np.abs(prog["out_pose"][t, :2] - out[0][:2])))
            v.heading_gap_rad = worst(v.heading_gap_rad, heading_gap(prog["out_pose"][t], out[0]))
    st = rp.st
    if (st.n_p, st.n_l, st.n_e) != (prog["n_p"], prog["n_l"], prog["n_e"]) or \
            not np.array_equal(st.lt[:st.n_l], prog["lt"][:prog["n_l"]]) or \
            not np.array_equal(st.e_lm[:st.n_e], prog["e_lm"][:prog["n_e"]]):
        v.wrong += 1
        v.first_wrong = v.first_wrong or (
            f"final graph: program (poses, landmarks, edges) "
            f"{(prog['n_p'], prog['n_l'], prog['n_e'])}, reference {(st.n_p, st.n_l, st.n_e)}")
        return v
    v.map_gap_m = worst(
        v.map_gap_m,
        np.max(np.abs(prog["poses"][:st.n_p, :2] - st.poses[:st.n_p, :2]), initial=0.0),
        np.max(np.abs(prog["lm"][:st.n_l] - st.lm[:st.n_l]), initial=0.0),
        np.max(np.abs(prog["e_xy"][:st.n_e] - st.e_xy[:st.n_e]), initial=0.0))
    v.heading_gap_rad = worst(v.heading_gap_rad,
                              heading_gap(prog["poses"][:st.n_p], st.poses[:st.n_p]))
    return v


def _current_of(st: Session, sem: Semantics, pose, ctype_prog, dist_prog) -> int:
    """The current cone index whose packet, on the reference's map, lies
    nearest the program's packet of the same types."""
    best, best_c = np.inf, st.cur
    saved = st.cur
    for c in range(max(st.n_l, 1)):
        st.cur = c
        _, dist, ctype = _packet(st, sem, pose)
        if np.array_equal(ctype, ctype_prog):
            gap = float(np.max(np.abs(dist - dist_prog)))
            if gap < best:
                best, best_c = gap, c
    st.cur = saved
    return best_c


def _copy(st: Session) -> Session:
    new = Session.__new__(Session)
    new.__dict__ = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                    for k, v in st.__dict__.items()}
    return new
