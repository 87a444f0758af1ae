"""Driver of the map server: a fleet's mapped sessions merged into one map,
one fused map after another (a closed loop), cycling through the mix's
fleets.

Set-up builds each fleet's session graphs with the benchmark's own
generator (`slambench.traffic.generate.session_graphs`) and places them on
the card as one stacked graph. One fused map runs the program's
`tpuslam_torch.parallel.fusion.fuse_sessions` (dedup, merge, joint
Gauss-Newton) from those graphs and brings the fused map's poses,
landmarks and labels back to host memory. After the window every fused map
of the window is judged against the plain reference of its fleet
(`slambench.reference.fusion`), which is given the same graphs: the dedup's
labels and counts exactly, the fused poses (x, y, heading) and landmarks
within the configuration's limits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np

from slambench import profiling
from slambench.reference import fusion as ref_fusion
from slambench.reference import gauss_newton as ref_gn
from slambench.traffic import generate


class Driver:
    unit = "map"

    def __init__(self, config: dict, mix: dict, seed: int, device: str):
        import torch
        from tpuslam_torch.backend import gauss_newton as gn
        from tpuslam_torch.backend.graph import FactorGraph
        self.torch, self.device, self.mix, self.config = torch, device, mix, config
        self.fleets = generate.session_graphs(mix, seed, config["capacity"])
        names = [f.name for f in dataclasses.fields(FactorGraph)]
        ints = ("n_poses", "n_landmarks", "n_obs", "lm_type", "obs_pose", "obs_lm")

        def stacked(graphs):
            return FactorGraph(**{k: torch.as_tensor(np.stack([np.asarray(g[k]) for g in graphs]))
                                  .to(device, torch.int32 if k in ints else torch.float32)
                                  for k in names})

        self.graphs = [stacked(f) for f in self.fleets]
        self.lm_info = [torch.as_tensor(np.stack([g["lm_info"] for g in f])).to(device)
                        for f in self.fleets]
        self.gcfg = gn.GNConfig(**config["fusion_gn"])
        self.fuse_args = dict(gate=mix["gate"], align=mix.get("align", False),
                              robust=mix.get("robust", False))
        self.maps = self.calls = 0
        self.outputs = []          # (fleet, host outputs) of every map of the window

    def step(self, keep: bool = False) -> None:
        from tpuslam_torch.parallel.fusion import fuse_sessions
        f = self.calls % len(self.graphs)
        self.calls += 1
        fused, rep = fuse_sessions(self.graphs[f], cfg=self.gcfg, lm_info=self.lm_info[f],
                                   **self.fuse_args)
        host = dict(poses=fused.poses.cpu().numpy(), lm=fused.lm_xy.cpu().numpy(),
                    lm_type=fused.lm_type.cpu().numpy(), labels=rep["labels"].cpu().numpy(),
                    n=self.torch.stack([fused.n_poses, rep["n_merged_landmarks"],
                                        rep["n_cross_session_merges"]]).cpu().numpy())
        if keep:
            self.outputs.append((f, host))
            self.maps += 1

    def end_to_end(self, times: list[float], window_s: float) -> dict:
        return {"fused_map_s": window_s / len(times)}

    @contextlib.contextmanager
    def tracing(self):
        with profiling.recorded_kernels() as info:
            info["maps_per_step"] = 1
            yield info

    def free(self) -> None:
        self.graphs = self.lm_info = None
        if self.device != "cpu":
            self.torch.cuda.empty_cache()

    def check(self):
        """(values, notes): every map of the window against the reference
        of its fleet."""
        if self.fuse_args["align"]:
            raise NotImplementedError("the fusion reference registers no sessions (align)")
        g = self.config["fusion_gn"]
        prob = ref_gn.Problem(odo_info=g["odo_info"], lm_info=g["lm_info"],
                              iterations=g["iterations"], fix_poses=g["fix_first_poses"],
                              fix_landmarks=g["fix_first_landmarks"],
                              early_exit_tol=g["early_exit_tol"])
        t0 = time.perf_counter()
        v = ref_fusion.Verdict()
        for f, graphs in enumerate(self.fleets):
            mine = [h for ff, h in self.outputs if ff == f]
            if not mine:
                continue
            ref = ref_fusion.Reference(graphs, self.fuse_args["gate"], prob, device=self.device)
            for h in mine:
                n_p, n_m, cross = (int(x) for x in h["n"])
                prog = dict(labels=h["labels"], n_merged=n_m, cross=cross,
                            lm_type=h["lm_type"][:n_m], poses=h["poses"][:n_p], lm=h["lm"][:n_m])
                ref_fusion.judge(ref, prog, v)
        notes = [f"judged {len(self.outputs)} fused maps of {len(self.fleets)} fleets; "
                 f"ties adopted: {v.adopted}; the reference took "
                 f"{time.perf_counter() - t0:.3f} s"]
        if v.first_wrong:
            notes.insert(0, v.first_wrong)
        return v.readings(), notes
