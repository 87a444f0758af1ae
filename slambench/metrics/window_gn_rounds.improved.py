"""Batched rounds of the window GN per fleet pass: the `slam.window_gn`
spans over the profiled passes (an exact count: one round per block for
each firing of the session that fires most in it). Layer: window GN
(`frontend/blocked.py`, `backend/gauss_newton.py` `optimize_window`);
moves `keyframes_per_s`."""
from slambench import spans


def read(t, run):
    rounds = spans.named(t, "slam.window_gn")
    return len(rounds) / t.steps if rounds else None
