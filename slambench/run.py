"""The benchmark of the PyTorch/CUDA port (`tpuslam_torch`): one run of one
cell on the card this process finds.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are looked up by name: the cell in `BENCHMARK.json`, the
configuration in `slambench/configs/<config>.json` (its `driver` names
`slambench/drivers/<driver>.py`), the mix in `slambench/traffic/<traffic>.json`,
each per-layer metric's reader in `slambench/metrics/<metric>.py`.

A run makes its inputs from the seed, builds or loads the kernels (in
`tpuslam_torch/build/`, inside the checkout), warms up on the cell's own
shapes, steps the driver for `--seconds` (untraced), and with `--trace 1`
then profiles a few more steps. After the window it frees the program's
state, judges the outputs against the plain reference and prints, as the
last lines of standard error, each compared number beside its limit, and as
the last line of standard output one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` a `breakdown`, and `checks`.
It exits non-zero and prints no result without enough CUDA devices, when
the profiler's trace stays short, or when a module of JAX or of the JAX
package is loaded.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import os  # noqa: E402

# One host thread for NumPy's and torch's CPU pools, set before either loads:
# the host only feeds the card and runs the reference, and one process with
# few threads loads a shared host least.
for _pool in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_pool] = "1"

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuslam")
TRACE_TRIES = 3


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _for_cell(metrics: list[dict], cell: str) -> list[dict]:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (an entry of None is an import that was blocked, not a module)."""
    return sorted(m for m, mod in list(sys.modules.items())
                  if m.split(".")[0] in FORBIDDEN and mod is not None)


def lookup(root: Path, cell_name: str):
    """(benchmark, cell, configuration, mix) by name under `root`."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"unknown workload {cell_name!r}: {sorted(cells)}")
    cell = cells[cell_name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads((root / "slambench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, mix


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out


def readers_for(root: Path, per_layer: list[dict]) -> dict:
    """{metric: its reader module}, each from slambench/metrics/<metric>.py."""
    return {m["name"]: _module(root / "slambench" / "metrics" / f"{m['name']}.py",
                               f"slambench_metric_{i}") for i, m in enumerate(per_layer)}


def traced(driver, per_layer, steps, root: Path):
    """(metrics, device busy_s, window_s, breakdown) from two profiled
    windows of `steps` steps each: the device alone (busy and idle time,
    device operations), then host and device (what the readers correlate,
    and the host op under way in each idle gap). A short trace is profiled
    again, and fails the run after TRACE_TRIES."""
    from slambench import profiling as tr
    readers = readers_for(root, per_layer)
    last = None
    for _ in range(TRACE_TRIES):
        dev = tr.profile(driver.step, steps, host=False)
        with driver.tracing() as info:
            t = tr.profile(driver.step, steps, host=True)
        short = [f"{n} launches have no kernel in the {w} trace"
                 for w, n in (("host", t.missing_launches()), ("device", dev.missing_launches()))
                 if n]
        if short:
            last = "; ".join(short)
            continue
        try:
            values = {name: r.read(t, dict(info, steps=steps, busy_s=dev.busy_s,
                                           window_s=dev.window_s))
                      for name, r in readers.items()}
        except tr.ShortTrace as e:
            last = str(e)
            continue
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in per_layer if values[m["name"]] is not None}
        return metrics, dev.busy_s, dev.window_s, {"device_ops": dev.device_ops(),
                                                   "idle_gaps": t.idle_gaps()}
    raise SystemExit(f"the profiler's trace stayed short after {TRACE_TRIES} tries: {last}")


def main(argv=None, root: Path = ROOT, device: str | None = None) -> int:
    """One run; `device` None takes cuda:0 and refuses to run without enough
    CUDA devices (tests pass "cpu")."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench, cell, config, mix = lookup(root, args.workload)
    # the checkout's root, not this file's folder, is where modules come from
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(root)] + [q for q in sys.path if q not in (here, str(root))]
    import torch
    torch.set_num_threads(1)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"this process sees {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = "cuda"
        # the GN requires full FP32 matmuls (GNConfig.matmul_precision 'highest')
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_inputs = time.monotonic()
    driver = _module(root / "slambench" / "drivers" / f"{config['driver']}.py",
                     f"slambench_driver_{config['driver']}").Driver(config, mix, args.seed, device)
    t_warm = time.monotonic()
    # warm-up: the cell's own shapes, a few steps (the first builds or loads the kernels)
    for _ in range(mix.get("warmup_steps", 1)):
        driver.step()
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.monotonic() - T_START
    set_up = (f"set-up {setup_s:.3f} s: start and imports {t_inputs - T_START:.3f}, inputs "
              f"{t_warm - t_inputs:.3f}, warm-up {T_START + setup_s - t_warm:.3f}")

    times = []
    w0 = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        driver.step(keep=True)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if t1 - w0 >= args.seconds:
            break
    window_s = time.perf_counter() - w0

    result_device = {"platform": "gpu" if device != "cpu" else "cpu",
                     "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
                     "count": cell["chips"],
                     "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))
                     if device != "cpu" else 0}
    breakdown = None
    if args.trace:
        metrics, busy_s, trace_s, breakdown = traced(
            driver, _for_cell(bench["per_layer"], cell["name"]), mix["trace_steps"], root)
        result_device.update(busy_s=busy_s, window_s=trace_s)
    else:
        e2e = dict(driver.end_to_end(times, window_s), setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in _for_cell(bench["end_to_end"], cell["name"])}
    if device != "cpu":
        from slambench.roofline import PEAKS_SOURCE
        print(f"card: {card_line()} (name, power.limit); roofline shares against "
              f"{PEAKS_SOURCE}", file=sys.stderr)

    driver.free()
    values, notes = driver.check()
    limits = config["limits"]
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    result = {"correct": correct, "attempted": len(times), "failed": 0, "metrics": metrics,
              "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for n in notes + [set_up]:
        print(n, file=sys.stderr)
    print(f"{len(times)} x {driver.unit} in {window_s:.3f} s after {setup_s:.3f} s of set-up",
          file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
