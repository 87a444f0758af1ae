"""Readings that set the limits of the improved-mode replay's comparison
(the cells of the `improved_replay` driver), on the card, in one process:

    python3 slambench/control_improved.py --workload improved_fleet.s64 --seeds 1,2,... \
        [--control-seeds 1,2,3]

As `slambench/control.py`, whose program readings and TF32 switch it uses:
for every seed of `--seeds`, one fleet pass of the program judged as a run
judges it (the lower readings); for every seed of `--control-seeds`, two
controls in the program's place, judged alike:

- `program_tf32`: the program with its TF32 GN (`gn_matmul_precision`
  'high');
- `reference_tf32`: the improved mode's plain reference
  (`slambench.reference.improved`) computed in float32 with TF32 matmuls
  (the precision below the configuration's float32 with TF32 off) and
  judged by the float64 one.

Each reading is one JSON line on standard output.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def reference_tf32(config, mix, seed, device="cuda"):
    """The improved reference in float32 with TF32 matmuls, put in the
    program's place for the judged sessions and judged by the float64
    reference."""
    import numpy as np
    from slambench import control
    from slambench.reference import improved, replay
    from slambench.traffic import generate
    d = generate.sessions(mix, seed)
    sem = improved.Semantics.from_config(config["slam"], config["capacity"], config["block"],
                                         improved.compact_width(d["valid"]))
    tot = replay.Verdict()
    try:
        for s in range(min(mix["judge_sessions"], len(d["poses"]))):
            control.tf32(True)
            prog = improved.run_session(sem, d["obs"][s], d["valid"][s], d["poses"][s],
                                        dtype=np.float32, device=device)
            control.tf32(False)
            v, _ = improved.judge_session(sem, d["obs"][s], d["valid"][s], d["poses"][s], prog,
                                          device=device)
            tot.add(v)
        return tot.readings()
    finally:
        control.tf32(False)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    sys.path[:] = [str(ROOT)] + [q for q in sys.path if q != str(Path(__file__).parent)]
    import torch
    from slambench import control, run
    if not torch.cuda.is_available():
        print("control readings need a CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"tf32_matmul_rel_err": control.tf32(True),
                      "fp32_matmul_rel_err": control.tf32(False)}), flush=True)
    _, cell, config, mix = run.lookup(ROOT, args.workload)
    for seed in (int(x) for x in args.seeds.split(",") if x):
        print(json.dumps({"cell": cell["name"], "seed": seed, "run": "program",
                          "readings": control._program(config, mix, seed, run)}), flush=True)
    for seed in (int(x) for x in args.control_seeds.split(",") if x):
        lowered = copy.deepcopy(config)
        lowered["slam"]["gn_matmul_precision"] = "high"
        print(json.dumps({"cell": cell["name"], "seed": seed, "run": "program_tf32",
                          "readings": control._program(lowered, mix, seed, run)}), flush=True)
        print(json.dumps({"cell": cell["name"], "seed": seed, "run": "reference_tf32",
                          "readings": reference_tf32(config, mix, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
