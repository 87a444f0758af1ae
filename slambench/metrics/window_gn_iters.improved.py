"""Iterations of the window GN per fleet pass: the `slam.gn.iteration`
spans inside `slam.window_gn` over the profiled passes (an exact count:
each round stops at its iteration cap or when every firing session has
met its tolerance). Layer: window GN (`frontend/blocked.py`,
`backend/gauss_newton.py` `optimize_window`); moves `keyframes_per_s`."""
from slambench import spans


def read(t, run):
    rounds = spans.named(t, "slam.window_gn")
    if not rounds:
        return None
    return len(spans.inside(spans.named(t, "slam.gn.iteration"), rounds)) / t.steps
