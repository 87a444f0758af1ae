"""The window GN's factorizations' share of their roofline over a fleet
pass: each `torch.linalg.cholesky_ex` whose host op lies inside a
`slam.window_gn` span, at S n^3 / 3 FP32 operations (or its bytes, where
they bound it) for the [S, n, n] it was given (`roofline.cholesky_bound`),
over the device time of the kernels whose launch ran inside the op on its
thread. The closure GN's factors lie outside those spans and are not
counted. None where no window GN ran; `ShortTrace` for a factorization
whose kernels the trace lacks. Layer: window GN (`frontend/blocked.py`,
`backend/gauss_newton.py` `optimize_window`); moves `keyframes_per_s`."""
import bisect

import numpy as np

from slambench import spans
from slambench.profiling import CHOLESKY_OP, ShortTrace
from slambench.roofline import cholesky_bound


def read(t, run):
    rounds = spans.named(t, "slam.window_gn")
    if not rounds:
        return None
    ops = spans.inside([o for o in t.ops if o.name == CHOLESKY_OP], rounds)
    by_corr = {}
    for k in t.kernels:
        by_corr.setdefault(k.args.get("correlation"), []).append(k)
    launches = sorted(t.runtime, key=lambda e: e.ts)
    starts = [e.ts for e in launches]
    need = took = 0.0
    for op in ops:
        ks = [k for c in launches[bisect.bisect_left(starts, op.ts):
                                  bisect.bisect_right(starts, op.end)]
              if c.tid == op.tid for k in by_corr.get(c.args.get("correlation"), [])]
        if not ks:
            raise ShortTrace(f"a {CHOLESKY_OP} call of the window GN has no kernel in the trace")
        dims = op.args["Input Dims"][0]
        need += cholesky_bound(int(np.prod(dims[:-2])) if len(dims) > 2 else 1, int(dims[-1]))
        took += sum(k.dur for k in ks) * 1e-6
    return 100.0 * need / took if took > 0 else None
