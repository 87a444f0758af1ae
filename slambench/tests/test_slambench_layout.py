"""The benchmark's files: every configuration, traffic mix, driver and
metric reader named in BENCHMARK.json loads by name; the file keeps to the
benchmark's contract; and a cell or a per-layer metric added as files
alone is found and runs."""
import json
import re

from slambench import run
from slambench.tests.conftest import REPO, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
# Each entry's keys, and which of them hold one line of text.
ENTRY_KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, ("source", "why")),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, ("why",)),
    "end_to_end": ({"name", "unit", "better", "bound", "source"}, ()),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"}, ("layer",)),
}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and not set(text) & {"\n", "\r", "\t"}


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_entry_loads_by_name():
    bench = _bench()
    for cell in bench["workloads"]:
        _, c, config, mix = run.lookup(REPO, cell["name"])
        driver = REPO / "slambench" / "drivers" / f"{config['driver']}.py"
        assert hasattr(run._module(driver, "probe_driver"), "Driver")
        assert mix["kind"] in ("sessions", "session_graphs")
        assert set(config["limits"]) and all(v >= 0 for v in config["limits"].values())
    for m in bench["per_layer"]:
        reader = run._module(REPO / "slambench" / "metrics" / f"{m['name']}.py", "probe_m")
        assert callable(reader.read), m["name"]


def test_benchmark_json_keeps_to_the_contract():
    bench = _bench()
    assert set(bench) == KEYS
    assert bench["command"] == ["python3", "slambench/run.py"] and bench["paths"] == ["slambench"]
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for group, (keys, lines) in ENTRY_KEYS.items():
        extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
        for entry in bench[group]:
            assert keys <= set(entry) <= keys | extra, (group, entry["name"])
            assert all(_line(entry[k]) for k in lines), (group, entry["name"])
    assert len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("slambench/")
        config = json.loads((REPO / c["file"]).read_text())
        assert all(k in config for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    layers = {}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if "bound" in m:
            assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
    assert all(len(v) == 1 for v in layers.values()), layers
    for cell in bench["workloads"]:
        assert NAME.match(cell["name"]) and cell["chips"] in (1, 4) and len(cell["why"]) <= 200
        mine = [m["name"] for m in bench["end_to_end"]
                if "workloads" not in m or cell["name"] in m["workloads"]]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(cell["name"] in m["workloads"] for m in bench["per_layer"])
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_cell_added_as_files_runs(checkout, capsys):
    rc, res = run_cell(checkout, "tiny.replay", 2**31 + 11, capsys)
    assert rc == 0 and res["correct"], res
    assert set(res["metrics"]) == {"keyframes_per_s", "pass_p95_ms", "setup_s"}
    assert list(res)[-1] == "checks" and res["checks"]["wrong_keyframes"]["value"] == 0


def test_a_metric_added_as_a_file_is_read(checkout):
    (checkout / "slambench" / "metrics" / "kernels_total.replay.py").write_text(
        "def read(t, run):\n    return float(len(t.kernels))\n")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["per_layer"].append(dict(name="kernels_total.replay", unit="launches", better="lower",
                                   source="device_trace", layer="device (one H100)",
                                   moves="keyframes_per_s", workloads=["tiny.replay"]))
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    bench, cell, _, _ = run.lookup(checkout, "tiny.replay")
    readers = run.readers_for(checkout, run._for_cell(bench["per_layer"], cell["name"]))
    assert list(readers) == ["kernels_total.replay"]

    class T:
        kernels = [object()] * 7
    assert readers["kernels_total.replay"].read(T(), {}) == 7.0


def test_no_card_no_result(capsys):
    rc = run.main(["--workload", "trackdrive_fleet.s64", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
