"""Each per-layer reader on a canned profile, and the guards that fail a
short trace."""
import json

import pytest

from slambench import profiling, roofline, run
from slambench.tests.conftest import REPO

CHOL = "void potrf_kernel<float>(int, float*)"
ASSOC = "void assoc_kernel<false>(float2 const*, void const*)"


def _events(drop_assoc=False):
    """Two steps of 1,000 µs: in each, a cholesky_ex op of [64, 1152, 1152]
    launching one 600 µs kernel, one 3 µs association kernel, one 10 µs
    other kernel, a device-to-host copy and a stream synchronization."""
    ev = []
    corr = 0
    for k in range(2):
        t = 1000.0 * k
        ev.append(dict(ph="X", cat="user_annotation", name=profiling.STEP, ts=t, dur=1000.0,
                       tid=1))
        ev.append(dict(ph="X", cat="cpu_op", name=profiling.CHOLESKY_OP, ts=t + 100, dur=50.0,
                       tid=1, args={"Input Dims": [[64, 1152, 1152]]}))
        for name, at, dur, ts in ((CHOL, t + 110, 600.0, t + 200), (ASSOC, t + 20, 3.0, t + 30),
                                  ("elementwise", t + 900, 10.0, t + 910)):
            corr += 1
            ev.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=at, dur=5.0,
                           tid=1, args={"correlation": corr}))
            if not (drop_assoc and name == ASSOC and k == 1):
                ev.append(dict(ph="X", cat="kernel", name=name, ts=ts, dur=dur, tid=7,
                               args={"correlation": corr}))
        ev.append(dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH (Device -> Pageable)",
                       ts=t + 950, dur=20.0, tid=7, args={}))
        ev.append(dict(ph="X", cat="cuda_runtime", name="cudaStreamSynchronize", ts=t + 940,
                       dur=40.0, tid=1, args={}))
    return ev


def _trace(tmp_path, **kw):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": _events(**kw)}))
    return profiling.load(str(p), 2)


def _read(name, t, info):
    return run._module(REPO / "slambench" / "metrics" / f"{name}.py", f"m_{name}").read(t, info)


INFO = dict(steps=2, keyframes_per_step=100, maps_per_step=1,
            assoc_shapes=[(64, 512, 256, False)] * 2, assoc_launches=2, cholesky_shapes=[])


def test_readers_on_a_canned_profile(tmp_path):
    t = _trace(tmp_path)
    assert t.missing_launches() == 0
    assert t.window_s == pytest.approx(2e-3) and t.busy_s == pytest.approx(2 * 633e-6)
    assert _read("launches_per_keyframe.replay", t, INFO) == pytest.approx(6 / 200)
    assert _read("launches_per_map.fusion", t, INFO) == pytest.approx(3)
    assert _read("syncs_per_pass.replay", t, INFO) == pytest.approx(2)
    dev = dict(INFO, busy_s=t.busy_s, window_s=t.window_s)
    assert _read("device_idle_pct.replay", t, dev) == pytest.approx(100 * (1 - 0.633))
    assert _read("device_idle_pct.fusion", t, dev) == pytest.approx(100 * (1 - 0.633))
    chol = 100 * 2 * roofline.cholesky_bound(64, 1152) / 1.2e-3
    assert _read("closure_factor_roofline.replay", t, INFO) == pytest.approx(chol)
    assert _read("joint_factor_roofline.fusion", t, INFO) == pytest.approx(chol)
    assoc = 100 * 2 * roofline.assoc_bound(64, 512, 256) / 6e-6
    assert _read("assoc_roofline.replay", t, INFO) == pytest.approx(assoc)
    assert 0 < assoc < 100 and 0 < chol < 100
    ops = dict(map(tuple, t.device_ops()))
    assert ops[CHOL] == pytest.approx(1.2e-3)
    gaps = t.idle_gaps()
    assert sum(v for _, v in gaps) == pytest.approx(t.window_s - t.busy_s)


def test_bounds_from_the_shapes():
    # 64 x 1152^3 / 3 FP32 operations at 67 TFLOP/s: 0.487 ms
    assert roofline.cholesky_bound(64, 1152) == pytest.approx(64 * 1152 ** 3 / 3 / 67e12)
    assert roofline.assoc_flop(512, 256, False) == 5 * 512 * 256
    assert roofline.bound(67e12, 0)[1] == "operations"


def test_a_short_trace_fails(tmp_path):
    t = _trace(tmp_path, drop_assoc=True)
    assert t.missing_launches() == 1
    with pytest.raises(profiling.ShortTrace):
        _read("assoc_roofline.replay", t, INFO)
    t = _trace(tmp_path)
    with pytest.raises(profiling.ShortTrace):
        _read("assoc_roofline.replay", t, dict(INFO, assoc_launches=3))


def test_readers_without_their_layer_read_nothing(tmp_path):
    t = _trace(tmp_path)
    t.kernels = [k for k in t.kernels if "assoc" not in k.name]
    assert _read("assoc_roofline.replay", t, dict(INFO, assoc_shapes=[], assoc_launches=0)) \
        is None
    t.ops = []
    assert _read("closure_factor_roofline.replay", t, INFO) is None
