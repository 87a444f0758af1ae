"""Readings that set the limits of a cell's comparison, on the card, in one
process (the benchmark's own runs do not run this):

    python3 slambench/control.py --workload <cell> --seeds 1,2,... [--control-seeds 1,2,3]

For every seed of `--seeds`: one step of the program at the cell's size
(one fleet pass, or one fused map of every fleet), judged by the reference
as a run judges it: the lower readings. For every seed of
`--control-seeds`, two controls in the program's place, judged alike:

- `program_tf32`: the program with its own lower-precision path on
  (`gn_matmul_precision` / `GNConfig.matmul_precision` 'high', TF32);
- `reference_tf32`: the plain reference itself computed in float32 with
  TF32 matmuls (the precision below the configuration's float32 with TF32
  off).

Each reading is one JSON line on standard output.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _program(config, mix, seed, run, device="cuda"):
    """The program's readings: steps that cover every input of the mix once
    (one fleet pass, or one fused map of each fleet), judged."""
    d = run._module(ROOT / "slambench" / "drivers" / f"{config['driver']}.py",
                    f"slambench_driver_{config['driver']}").Driver(config, mix, seed, device)
    for _ in range(mix.get("fleets", 1)):
        d.step(keep=True)
    d.free()
    return d.check()[0]


def tf32(on: bool) -> float:
    """Switch float32 matmuls to TF32 (on) or full FP32 (off); returns the
    relative error of a 1024^3 float32 matmul against float64 on the card,
    about 1e-3 with TF32 and 1e-6 without (0 on the CPU)."""
    import torch
    torch.set_float32_matmul_precision("high" if on else "highest")
    torch.backends.cuda.matmul.allow_tf32 = on
    if not torch.cuda.is_available():
        return 0.0
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(1024, 1024, device="cuda", generator=g)
    b = torch.randn(1024, 1024, device="cuda", generator=g)
    ref = a.double() @ b.double()
    return float((a @ b - ref).abs().max() / ref.abs().max())


def _reference_tf32(config, mix, seed, run, device="cuda"):
    """The reference in float32 with TF32 matmuls, put in the program's
    place and judged by the float64 reference."""
    import numpy as np
    import torch
    from slambench.reference import fusion, gauss_newton, replay
    from slambench.traffic import generate
    tf32(True)
    try:
        if config["driver"] == "fleet_replay":
            sem = replay.Semantics.from_config(config["slam"], config["capacity"])
            d = generate.sessions(mix, seed)
            tot = replay.Verdict()
            for s in range(min(mix["judge_sessions"], len(d["poses"]))):
                prog = replay.run_session(sem, d["obs"][s], d["valid"][s], d["poses"][s],
                                          dtype=np.float32, device=device)
                tf32(False)
                v = replay.judge_session(sem, d["obs"][s], d["valid"][s], d["poses"][s], prog,
                                         device=device)
                tf32(True)
                tot.add(v)
            return tot.readings()
        g = config["fusion_gn"]
        prob = gauss_newton.Problem(g["odo_info"], g["lm_info"], g["iterations"],
                                    g["fix_first_poses"], g["fix_first_landmarks"],
                                    g["early_exit_tol"])
        v = fusion.Verdict()
        for graphs in generate.session_graphs(mix, seed, config["capacity"]):
            f32 = [{k: (x.astype(np.float32) if isinstance(x, np.ndarray) and x.dtype.kind == "f"
                        else x) for k, x in gr.items()} for gr in graphs]
            ctl, poses, lm = fusion.Reference(f32, mix["gate"], prob, dtype=torch.float32,
                                              device=device).map(0.0)
            tf32(False)
            ref = fusion.Reference(graphs, mix["gate"], prob, device=device)
            prog = dict(labels=ctl.labels, n_merged=ctl.n_merged, cross=ctl.cross,
                        lm_type=ctl.lm_type, poses=poses, lm=lm)
            fusion.judge(ref, prog, v)
            tf32(True)
        return v.readings()
    finally:
        tf32(False)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    sys.path[:] = [str(ROOT)] + [q for q in sys.path if q != str(Path(__file__).parent)]
    import torch
    from slambench import run
    if not torch.cuda.is_available():
        print("control readings need a CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"tf32_matmul_rel_err": tf32(True), "fp32_matmul_rel_err": tf32(False)}),
          flush=True)
    _, cell, config, mix = run.lookup(ROOT, args.workload)
    seeds = [int(x) for x in args.seeds.split(",") if x]
    controls = [int(x) for x in args.control_seeds.split(",") if x]
    for seed in seeds:
        print(json.dumps({"cell": cell["name"], "seed": seed, "run": "program",
                          "readings": _program(config, mix, seed, run)}), flush=True)
    for seed in controls:
        lowered = copy.deepcopy(config)
        if "fusion_gn" in lowered:
            lowered["fusion_gn"]["matmul_precision"] = "high"
        else:
            lowered["slam"]["gn_matmul_precision"] = "high"
        print(json.dumps({"cell": cell["name"], "seed": seed, "run": "program_tf32",
                          "readings": _program(lowered, mix, seed, run)}), flush=True)
        print(json.dumps({"cell": cell["name"], "seed": seed, "run": "reference_tf32",
                          "readings": _reference_tf32(config, mix, seed, run)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
