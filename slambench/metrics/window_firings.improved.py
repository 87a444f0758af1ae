"""Session windows the window GN solved per fleet pass: the program's
`window_gn_firings` counter (each round's firing sessions, summed) over
the profiled passes, as the driver reads it around them. None for a
program without the counter. Layer: window GN (`frontend/blocked.py`,
`backend/gauss_newton.py` `optimize_window`); moves `keyframes_per_s`."""


def read(t, run):
    firings = run.get("window_gn_firings")
    return None if firings is None else firings / t.steps
