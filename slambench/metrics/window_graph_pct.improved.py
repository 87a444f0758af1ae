"""Share of the window GN's rounds that ran by replaying their CUDA graphs:
the `slam.window_gn` spans that hold a `slam.window_graph` span, over all
of them, in percent. None where no round ran, and where rounds ran but
none holds the span (a program that runs its rounds eagerly). Layer:
window GN (`frontend/blocked.py`, `backend/gauss_newton.py`
`optimize_window`); moves `keyframes_per_s`."""
from slambench import spans


def read(t, run):
    rounds = spans.named(t, "slam.window_gn")
    graphs = spans.named(t, "slam.window_graph")
    replayed = [r for r in rounds if spans.inside(graphs, [r])]
    if not replayed:
        return None
    return 100.0 * len(replayed) / len(rounds)
