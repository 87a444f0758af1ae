"""Host time of the window GN per fleet pass: the summed `slam.window_gn`
spans (each batched round of the periodic GN between the blocks: its
iterations, factors, solves and early-exit reads) over the profiled
passes. Layer: window GN (`frontend/blocked.py`, `backend/gauss_newton.py`
`optimize_window`); moves `keyframes_per_s`."""
from slambench import spans


def read(t, run):
    rounds = spans.named(t, "slam.window_gn")
    return spans.total_ms(rounds) / t.steps if rounds else None
