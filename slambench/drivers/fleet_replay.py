"""Driver of the fleet replay: a team reprocessing its recorded sessions in
one job, one fleet pass after another (a closed loop).

One pass takes the fleet's inputs from host memory to the card, runs every
session through the program's batched blocked pipeline
(`tpuslam_torch.frontend.blocked.run_sequences_blocked_batched`), and
brings every keyframe's outputs and every final map back to host memory.
After the window the plain reference (`slambench.reference.replay`) judges
`judge_sessions` distinct batch slots (all of them in the cells' mixes),
drawn from the seed, each as one pass drawn from the seed left it.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

from slambench import profiling
from slambench.reference import replay
from slambench.traffic import generate

OUT_FIELDS = ("pose", "cone_azimuth", "cone_distance", "cone_type", "send", "loop_closed",
              "n_landmarks")
GRAPH_FIELDS = ("poses", "lm_xy", "lm_type", "obs_pose", "obs_lm", "obs_xy", "n_poses",
                "n_landmarks", "n_obs")


class Driver:
    unit = "pass"

    def __init__(self, config: dict, mix: dict, seed: int, device: str):
        import torch
        from tpuslam_torch.backend.graph import GraphCapacity
        from tpuslam_torch.runtime.config import SlamConfig
        self.torch, self.device, self.seed, self.mix = torch, device, seed, mix
        self.config = config
        self.cap = GraphCapacity(*config["capacity"])
        self.cfg = SlamConfig(capacity=self.cap, **config["slam"])
        self.block = config["block"]
        self.inputs = generate.sessions(mix, seed)
        # the fleet's inputs in host memory, as the job holds them
        self.host = [torch.from_numpy(self.inputs[k]) for k in ("obs", "valid", "poses")]
        self.S, self.T = self.inputs["poses"].shape[:2]
        k = min(mix["judge_sessions"], self.S)
        self.judged = np.sort(np.random.default_rng([seed, 7]).permutation(self.S)[:k])
        self.kept = {}            # slot: (priority, pass, outputs)
        self.passes = 0

    @property
    def work_per_step(self) -> int:
        return self.S * self.T    # session-keyframes per pass

    def step(self, keep: bool = False) -> None:
        from tpuslam_torch.frontend.blocked import run_sequences_blocked_batched
        from tpuslam_torch.parallel.batch import initial_states
        obs, valid, poses = (x.to(self.device) for x in self.host)
        states, outs = run_sequences_blocked_batched(
            initial_states(self.cap, self.S, self.device), obs, valid, poses, self.cfg,
            block=self.block)
        host = {k: getattr(outs, k).cpu().numpy() for k in OUT_FIELDS}
        g = states.graph
        host.update({"g_" + k: getattr(g, k).cpu().numpy() for k in GRAPH_FIELDS})
        if keep:
            self._keep(host)
            self.passes += 1

    def _keep(self, host: dict) -> None:
        """Keep each judged slot's outputs of the pass with the lowest
        priority drawn from the seed so far: one pass per slot, each pass
        of the window as likely as another."""
        pri = np.random.default_rng([self.seed, 7, self.passes]).random(len(self.judged))
        for p, s in zip(pri, self.judged):
            if s not in self.kept or p < self.kept[s][0]:
                self.kept[s] = (float(p), self.passes, {k: v[s].copy() for k, v in host.items()})

    def end_to_end(self, times: list[float], window_s: float) -> dict:
        return {"keyframes_per_s": len(times) * self.work_per_step / window_s,
                "pass_p95_ms": float(np.percentile(np.asarray(times) * 1e3, 95))}

    @contextlib.contextmanager
    def tracing(self):
        with profiling.recorded_kernels() as info:
            info["keyframes_per_step"] = self.work_per_step
            yield info

    def free(self) -> None:
        self.host = None
        if self.device != "cpu":
            self.torch.cuda.empty_cache()

    def check(self):
        """(values, notes): the judged numbers over the judged slots."""
        if len(self.kept) < len(self.judged):
            raise RuntimeError(f"{len(self.kept)} sessions kept for judging, "
                               f"not {len(self.judged)}")
        sem = replay.Semantics.from_config(self.config["slam"], self.config["capacity"])
        tot = replay.Verdict()
        notes = []
        t0 = time.perf_counter()
        for s, (_, p, out) in sorted(self.kept.items()):
            prog = dict(out_pose=out["pose"], az=out["cone_azimuth"], dist=out["cone_distance"],
                        ctype=out["cone_type"], send=out["send"], closed=out["loop_closed"],
                        n_lm=out["n_landmarks"], poses=out["g_poses"], lm=out["g_lm_xy"],
                        lt=out["g_lm_type"], e_pose=out["g_obs_pose"], e_lm=out["g_obs_lm"],
                        e_xy=out["g_obs_xy"], n_p=int(out["g_n_poses"]),
                        n_l=int(out["g_n_landmarks"]), n_e=int(out["g_n_obs"]))
            v = replay.judge_session(sem, self.inputs["obs"][s], self.inputs["valid"][s],
                                     self.inputs["poses"][s], prog, device=self.device)
            tot.add(v)
            if v.first_wrong:
                notes.append(f"pass {p} session {s}: {v.first_wrong}")
        ref_s = time.perf_counter() - t0
        notes.append(f"judged {len(self.kept)} of {self.S} slots, each from one of {self.passes} "
                     f"passes; ties adopted: {tot.adopted}; the reference took {ref_s:.3f} s "
                     f"({ref_s / len(self.kept):.3f} s a session)")
        return tot.readings(), notes
