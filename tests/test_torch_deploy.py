"""The port's deployment surface on the CPU: the wheel of the tree and an
unpacked copy of it (`pyproject.toml`'s package data), the multi-process
smoke (`tpuslam_torch.deploy.multihost_smoke`: its `build_session` against
bench_scaling.py's, a launcher run of 2 gloo ranks, the death case), the
chain script's `synth` against the JAX script's, and the port's image and
compose file (`deploy/torch/`) against the JAX ones and the port's own
parser. The chain script's `main` runs in the world of 8 gloo ranks of
tests/test_torch_chain.py."""
import dataclasses
import importlib.util
import json
import os
import re
import shlex
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import yaml

REPO = Path(__file__).resolve().parents[1]
SESSION_ATOL = 1e-6


def load_jax_chain_script():
    """scripts/bench_chain_solvers.py of the JAX package, as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_chain_solvers", REPO / "scripts" / "bench_chain_solvers.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_graph(got, want, atol, what):
    """Port graph `got` against JAX graph `want`, field for field: integers
    exact, floats within `atol`."""
    for f in dataclasses.fields(want):
        w = np.asarray(getattr(want, f.name))
        g = getattr(got, f.name).numpy()
        assert g.shape == w.shape, (what, f.name)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{what} {f.name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {f.name}")


def test_wheel_holds_the_port_sources_and_an_unpacked_copy_finds_them(tmp_path):
    """The wheel `pip wheel --no-deps --no-build-isolation` makes of the tree
    holds every file the port compiles or reads (both CUDA sources, the
    native sources and Makefile, the calibration and the message set) and
    the deployment modules; in a fresh process with only an unpacked copy
    on its path, `_build.lib_path` and the native build's output path
    resolve inside that copy."""
    import chip_smoke
    wheel = chip_smoke.tree_wheel(tmp_path)
    names = set(zipfile.ZipFile(wheel).namelist())
    for name in ("csrc/assoc.cu", "csrc/cholesky.cu", "native/od4codec.cpp",
                 "native/od4recv.cpp", "native/od4recv_tsan_test.cpp", "native/Makefile",
                 "perception/data/VLP-16.xml", "io/opendlv_standard_message_set.odvd",
                 "deploy/multihost_smoke.py", "scripts/bench_chain_solvers.py"):
        assert f"tpuslam_torch/{name}" in names, name
    assert not [n for n in names if n.startswith("tpuslam_torch/build/")]
    unpacked = tmp_path / "unpacked"
    zipfile.ZipFile(wheel).extractall(unpacked)
    probe = ("import json; from tpuslam_torch import _build; "
             "from tpuslam_torch.native import _build as nb; "
             "p = _build.lib_path('assoc'); "
             "print(json.dumps([_build.__file__, str(p), str(nb.output_path('libod4codec.so')), "
             "_build.CSRC.joinpath('cholesky.cu').is_file()]))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(unpacked)
    res = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    mod, lib, native, chol = json.loads(res.stdout.strip().splitlines()[-1])
    for p in (mod, lib, native):
        assert p.startswith(str(unpacked)), p
    assert Path(lib).name.startswith("libassoc-") and chol


@pytest.mark.parametrize("seed", range(4))
def test_build_session_equals_bench_scaling(seed):
    """The smoke's `build_session` equals bench_scaling.py's
    `_build_session` field for field (floats within 1e-6) at the smoke's
    capacity."""
    from bench_scaling import _build_session
    from tpuslam.backend.graph import GraphCapacity as JCap
    from tpuslam_torch.backend.graph import GraphCapacity
    from tpuslam_torch.deploy.multihost_smoke import build_session
    got = build_session(GraphCapacity(64, 32, 512), seed, "cpu")
    _same_graph(got, _build_session(JCap(64, 32, 512), seed), SESSION_ATOL, f"seed {seed}")
    assert int(got.n_obs) > 0


@pytest.mark.parametrize("n", [64, 256])
def test_synth_equals_jax_chain_script(n):
    """The chain script's `synth` (also phase `chain`'s graph) equals the JAX
    script's, field for field."""
    from tpuslam_torch.scripts.bench_chain_solvers import synth
    _same_graph(synth(n, n, "cpu"), load_jax_chain_script().synth(n, n), 0.0, f"synth({n})")


def test_launcher_on_cpu_two_ranks():
    """`python -m tpuslam_torch.deploy.multihost_smoke --device cpu --procs
    2`: two OS processes, gloo, every rank's multi-session GN within 1e-4
    of its single-device solve and its fleet within 1e-4 of the unsharded
    core, every frame done, neither `jax` nor `tpuslam` imported; exit 0."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-m", "tpuslam_torch.deploy.multihost_smoke",
                          "--device", "cpu", "--procs", "2"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    (group,) = out["groups"]
    assert group["ok"] and group["return_codes"] == [0, 0] and group["backend"] == ["gloo"]
    assert sorted(w["proc"] for w in group["workers"]) == [0, 1]
    for w in group["workers"]:
        assert w["ok"] and w["fleet_blocked_ok"] and w["imported"] == []
        assert w["devices"] == 2 and w["sessions"] == 4
        assert w["max_abs_err_vs_single_device"] <= 1e-4


def _torchrun(module, *args):
    """`torchrun --standalone --nproc-per-node 2 -m module args` on the CPU:
    (exit code, the JSON lines of its standard output)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2", "-m", module, "--device", "cpu", *args],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    lines = [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith("{")]
    return res.returncode, lines, res.stderr[-3000:]


def test_chain_script_under_torchrun():
    """Under torchrun (RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT in the
    environment, its agent's store) the chain script runs on that world of
    2 (`parallel.mesh.process_group`): one row, from rank 0, whose n_shared
    is the JAX `partition_chain` of the JAX script's `synth` over 2 shards.
    The smoke's launcher hands its workers the same variables."""
    from tpuslam.parallel.chain import partition_chain
    rc, lines, err = _torchrun("tpuslam_torch.scripts.bench_chain_solvers", "--sizes", "64",
                               "--reps", "1")
    assert rc == 0, err
    (row,) = lines
    want = partition_chain(load_jax_chain_script().synth(64, 64), 2).n_shared
    assert row["n_shared"] == want and row["replicated_ms"] > 0 and row["dd_ms"] > 0


def test_death_case_on_cpu_exits_without_hanging():
    """The death case on 2 gloo ranks on the CPU: the last rank is SIGKILLed
    once it is up and both loop in collectives; the survivor, running at
    the kill, exits nonzero well inside its timeout."""
    from tpuslam_torch.deploy.multihost_smoke import run_death_case
    r = run_death_case(2, "cpu", up_timeout_s=60.0, survivor_timeout_s=15.0, pg_timeout_s=10.0)
    assert r["no_hang"] and r["ok"], r
    assert r["running_at_kill"] == [True]
    assert all(isinstance(rc, int) and rc != 0 for rc in r["survivor_rcs"]), r
    assert r["survivors_left_s"] < 15.0


def _instruction(text: str, name: str):
    """The JSON array of a Dockerfile's `name` instruction, lines joined."""
    joined = re.sub(r"\\\n\s*", " ", text)
    (line,) = [ln for ln in joined.splitlines() if ln.startswith(name + " ")]
    return json.loads(line[len(name):])


def _compose_argv(command: str):
    """A compose command with each ${VAR:-default} at its default, split."""
    return shlex.split(re.sub(r"\$\{\w+:-([^}]*)\}", r"\1", command))


def test_image_and_compose_parse_with_the_port_cli():
    """deploy/torch/Dockerfile: entry `slamctl-torch`, the JAX image's `run`
    arguments argument for argument, parsed by the port's `build_parser()`;
    it prebuilds both kernels and both native libraries from the installed
    copy, and no line that is not a comment names JAX. The compose file:
    the JAX file's three services on the port's image, host networking,
    each command the JAX one and parsed by the port's parser; `slam` and
    `replayer` reserve one NVIDIA GPU, `monitor` none."""
    from tpuslam_torch.cli.main import build_parser, cmd_monitor, cmd_replay, cmd_run
    text = (REPO / "deploy/torch/Dockerfile").read_text()
    assert _instruction(text, "ENTRYPOINT") == ["slamctl-torch"]
    cmd = _instruction(text, "CMD")
    assert cmd == _instruction((REPO / "deploy/Dockerfile").read_text(), "CMD")
    args = build_parser().parse_args(cmd)
    assert args.fn is cmd_run and args.device == "cuda" and args.cid == 111
    assert "_build.build_all()" in text and "libod4codec.so" in text and "libod4recv.so" in text
    assert "--target" in text and "AS build" in text
    code = [ln for ln in text.splitlines() if not ln.lstrip().startswith("#")]
    assert not [ln for ln in code if "jax" in ln.lower()]

    port = yaml.safe_load((REPO / "deploy/torch/docker-compose.yml").read_text())["services"]
    jax = yaml.safe_load((REPO / "deploy/docker-compose.yml").read_text())["services"]
    assert set(port) == set(jax) == {"slam", "monitor", "replayer"}
    fns = {"slam": cmd_run, "monitor": cmd_monitor, "replayer": cmd_replay}
    gpu = {"driver": "nvidia", "count": 1, "capabilities": ["gpu"]}
    for name, svc in port.items():
        assert svc["image"] == "tpuslam-torch:latest" and svc["network_mode"] == "host"
        assert svc["command"].split() == jax[name]["command"].split(), name
        assert build_parser().parse_args(_compose_argv(svc["command"])).fn is fns[name]
        devices = svc.get("deploy", {}).get("resources", {}).get("reservations", {}).get(
            "devices", [])
        assert devices == ([] if name == "monitor" else [gpu]), name
    assert port["replayer"]["profiles"] == ["replay"]
    build = port["slam"]["build"]
    here = REPO / "deploy" / "torch"
    assert (here / build["context"]).resolve() == REPO
    assert (REPO / build["dockerfile"]).resolve() == here / "Dockerfile"

