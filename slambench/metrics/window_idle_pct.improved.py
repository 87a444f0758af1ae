"""Share of the window GN's host time in which the card was idle: no
kernel, copy or memset of the trace ran inside the union of the
`slam.window_gn` spans, over their summed time. Layer: window GN
(`frontend/blocked.py`, `backend/gauss_newton.py` `optimize_window`);
moves `keyframes_per_s`."""
from slambench import spans


def read(t, run):
    rounds = spans.named(t, "slam.window_gn")
    if not rounds:
        return None
    return 100.0 * spans.idle_us(t, rounds) / (1e3 * spans.total_ms(rounds))
