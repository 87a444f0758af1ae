"""Driver of the improved-mode fleet replay: `fleet_replay`'s fleet pass
(`step`, `end_to_end`, `free`) under `SlamConfig.improved`, judged by the
improved mode's plain reference (`slambench.reference.improved`).

Traced, the readers also get the window GN's counters over the profiled
passes (`frontend/blocked.py`'s `window_gn_rounds` and
`window_gn_firings`), where the program has them: a program without them
gives the readers nothing to read.
"""
from __future__ import annotations

import contextlib
import os
import time

from slambench.drivers import fleet_replay
from slambench.reference import improved

COUNTERS = ("window_gn_rounds", "window_gn_firings")


class Driver(fleet_replay.Driver):

    @contextlib.contextmanager
    def tracing(self):
        from tpuslam_torch.frontend import blocked
        start = {n: getattr(blocked, n, None) for n in COUNTERS}
        with super().tracing() as info:
            try:
                yield info
            finally:
                for n, before in start.items():
                    after = getattr(blocked, n, None)
                    if before is not None and after is not None:
                        info[n] = after - before

    def check(self):
        """(values, notes): the judged numbers over the judged slots, the
        slots judged in parallel processes (one fewer than the CPUs this
        process may use, at most 8)."""
        if len(self.kept) < len(self.judged):
            raise RuntimeError(f"{len(self.kept)} sessions kept for judging, "
                               f"not {len(self.judged)}")
        sem = improved.Semantics.from_config(self.config["slam"], self.config["capacity"],
                                             self.block,
                                             improved.compact_width(self.inputs["valid"]))
        kept = sorted(self.kept.items())
        sessions = []
        for s, (_, _, out) in kept:
            prog = dict(out_pose=out["pose"], az=out["cone_azimuth"], dist=out["cone_distance"],
                        ctype=out["cone_type"], send=out["send"], closed=out["loop_closed"],
                        n_lm=out["n_landmarks"], poses=out["g_poses"], lm=out["g_lm_xy"],
                        lt=out["g_lm_type"], e_pose=out["g_obs_pose"], e_lm=out["g_obs_lm"],
                        e_xy=out["g_obs_xy"], n_p=int(out["g_n_poses"]),
                        n_l=int(out["g_n_landmarks"]), n_e=int(out["g_n_obs"]))
            sessions.append((self.inputs["obs"][s], self.inputs["valid"][s],
                             self.inputs["poses"][s], prog))
        workers = max(1, min(len(sessions), len(os.sched_getaffinity(0)) - 1, 8))
        t0 = time.perf_counter()
        judged = improved.judge_fleet(sem, sessions, self.device, workers)
        ref_s = time.perf_counter() - t0
        tot = improved.replay.Verdict()
        notes = []
        for (s, (_, p, _)), (v, _, _) in zip(kept, judged):
            tot.add(v)
            if v.first_wrong:
                notes.append(f"pass {p} session {s}: {v.first_wrong}")
        notes.append(f"judged {len(kept)} of {self.S} slots, each from one of {self.passes} "
                     f"passes; ties adopted: {tot.adopted}; the reference took {ref_s:.3f} s "
                     f"in {workers} processes")
        notes.append(f"the reference's window GNs over the judged slots: "
                     f"{sum(len(f) for _, f, _ in judged)} firings in "
                     f"{improved.rounds([(f, kc) for _, f, kc in judged], self.block)} batched "
                     f"rounds (a pass's counters when every slot is judged)")
        return tot.readings(), notes
