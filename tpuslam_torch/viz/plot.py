"""Map / trajectory / factor-graph rendering — the Pangolin viewer, reborn
(counterpart of `tpuslam.viz.plot`).

The reference's optional viewer build renders live cones, the pose trail,
the current pose + heading ray, and pose->cone graph edges with immediate-
mode OpenGL on a Pangolin window (reference viewerbuild/src/drawer.cpp:22-118,
viewer.cpp:43-60). Here the same four layers render with matplotlib to a
window or PNG from a Slam instance, a SlamState, or a checkpoint file; the
live render-thread equivalent is `tpuslam_torch.viz.LiveViewer` (`slamctl run
--viz-png` / `slamctl replay --viz-png`).

Cone colors by type follow the reference drawer (drawer.cpp:22-41):
1 = yellow, 2 = blue, 3/4 = orange.

The state's tensors may be on the card: each render copies the fields it
reads to the host once (`host_graph`) and draws from that copy. matplotlib
is imported on first render, so the module imports without it; asking for a
render without it raises ImportError naming it.
"""
from __future__ import annotations

import numpy as np
import torch

CONE_COLORS = {0: "#888888", 1: "#e6c800", 2: "#1f4fd6", 3: "#ff8c1a",
               4: "#d95000"}


_GRAPH_FIELDS = ("n_landmarks", "n_poses", "n_obs", "lm_xy", "lm_type", "poses", "obs_pose",
                 "obs_lm")


def _mpl():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("rendering the map needs matplotlib, which is not installed") from e
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def host_graph(state) -> dict:
    """The graph fields a render reads, copied to the host once: numpy
    arrays keyed by field name, holding no reference into `state`."""
    return {f: _host(getattr(state.graph, f)) for f in _GRAPH_FIELDS}


def plot_state(state, ax=None, **kw):
    """Draw a SlamState (its tensors on any device) onto a matplotlib axes."""
    return plot_graph(host_graph(state), ax=ax, **kw)


def plot_graph(g: dict, ax=None, show_graph=True, show_poses=True,
               show_cones=True, show_current=True, gt_track=None):
    """Draw a graph copied to the host by `host_graph`."""
    plt = _mpl()
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 8))
    n_lm = int(g["n_landmarks"])
    n_p = int(g["n_poses"])
    lm = g["lm_xy"][:n_lm]
    lt = g["lm_type"][:n_lm]
    poses = g["poses"][:n_p]

    if gt_track is not None:
        ax.plot(gt_track.cones_xy[:, 0], gt_track.cones_xy[:, 1], "x",
                color="#cccccc", ms=4, label="ground-truth cones")

    if show_graph and n_p and n_lm:
        n_obs = int(g["n_obs"])
        op = g["obs_pose"][:n_obs]
        ol = g["obs_lm"][:n_obs]
        for p_i, l_i in zip(op, ol):
            if p_i < n_p and l_i < n_lm:
                ax.plot([poses[p_i, 0], lm[l_i, 0]],
                        [poses[p_i, 1], lm[l_i, 1]],
                        color="#bbbbbb", lw=0.2, zorder=1)

    if show_poses and n_p:
        ax.plot(poses[:, 0], poses[:, 1], "-", color="#2a9d2a", lw=1.2,
                label="trajectory", zorder=2)

    if show_cones and n_lm:
        for t in sorted(set(lt.tolist())):
            sel = lt == t
            ax.plot(lm[sel, 0], lm[sel, 1], "o", ms=5,
                    color=CONE_COLORS.get(int(t), "#888888"),
                    label=f"type {t}", zorder=3)

    if show_current and n_p:
        cur = poses[-1]
        ax.plot(cur[0], cur[1], "r^", ms=10, zorder=4)
        ax.plot([cur[0], cur[0] + 2.5 * np.cos(cur[2])],
                [cur[1], cur[1] + 2.5 * np.sin(cur[2])], "r-", lw=2, zorder=4)

    ax.set_aspect("equal")
    ax.grid(alpha=0.3)
    ax.legend(loc="upper right", fontsize=8)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    return ax


def save_state_png(state, path: str, **kw):
    plt = _mpl()
    ax = plot_state(state, **kw)
    ax.figure.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(ax.figure)
    return path
