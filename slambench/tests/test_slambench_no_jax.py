"""Nothing a run imports has the top-level name of JAX or of the JAX
package, compared whole (`tpuslam_torch` is the program; `tpuslam` is
not), and the reference and the traffic import nothing of the program."""
import subprocess
import sys

from slambench.tests.conftest import REPO

_RUN = """
import sys
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "flax", "tpuslam"):
        del sys.modules[name]
for name in ("jax", "jaxlib", "flax", "tpuslam"):
    sys.modules[name] = None
sys.path.insert(0, {root!r})
import json, pathlib
from slambench import control, profiling, roofline, run
from slambench.tests.conftest import TINY_FUSION, TINY_REPLAY
root = pathlib.Path({root!r})
bench = json.loads((root / "BENCHMARK.json").read_text())
run.readers_for(root, bench["per_layer"])
for cell, mix in (("trackdrive_fleet.s64", TINY_REPLAY), ("fusion.gps8", TINY_FUSION)):
    _, _, config, _ = run.lookup(root, cell)
    drv = run._module(root / "slambench" / "drivers" / f"{{config['driver']}}.py", cell)
    d = drv.Driver(config, dict(mix, sessions=2, judge_sessions=2), 5, "cpu")
    d.step(keep=True)
    d.free()
    assert d.check()[0]
print(json.dumps(run.forbidden_modules()))
"""

_PLAIN = """
import sys
for name in ("jax", "jaxlib", "flax", "tpuslam", "tpuslam_torch"):
    sys.modules[name] = None
sys.path.insert(0, {root!r})
from slambench.reference import replay, fusion, gauss_newton, geometry
from slambench.traffic import generate
mix = dict(generate.load("fleet64"), sessions=2)
d = generate.sessions(mix, 3)
sem = replay.Semantics.from_config({{"association": "nearest", "use_pallas_association": True}},
                                   (384, 256, 4096))
out = replay.run_session(sem, d["obs"][0], d["valid"][0], d["poses"][0])
print(sorted(m for m, v in list(sys.modules.items())
             if m.split(".")[0] == "tpuslam_torch" and v is not None), out["n_l"] > 0)
"""


def test_nothing_a_run_imports_is_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _RUN.format(root=str(REPO))], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_and_traffic_import_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", _PLAIN.format(root=str(REPO))], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"
