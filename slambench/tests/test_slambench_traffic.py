"""The frozen traffic generator equals the program's simulator at the
cells' seeds, and a seed gives the same inputs every time."""
import numpy as np
import pytest

from slambench.traffic import generate
from slambench.traffic.sim import simulator as frozen_sim
from slambench.traffic.sim import tracks as frozen_tracks
from tpuslam_torch.sim import simulator as port_sim
from tpuslam_torch.sim import tracks as port_tracks

SEEDS = (0, 2**31 + 7, 4_000_000_001)


@pytest.mark.parametrize("name", ["fleet64", "gps8"])
@pytest.mark.parametrize("seed", SEEDS)
def test_frozen_simulator_equals_the_port_at_the_cells_seeds(name, seed):
    mix = generate.load(name)
    a, b = generate.track_of(mix), port_tracks.trackdrive(seed=mix["track_seed"])
    assert np.array_equal(a.cones_xy, b.cones_xy) and np.array_equal(a.cones_type, b.cones_type)
    sim = {k: mix[k] for k in generate.SIM_KEYS if k in mix}
    for s in generate.session_seeds(seed, mix["sessions"], salt=1 if "fleets" in mix else 0)[:3]:
        x = frozen_sim.simulate(a, frozen_sim.SimConfig(**sim, seed=s))
        y = port_sim.simulate(b, port_sim.SimConfig(**sim, seed=s))
        for f in ("times", "gt_poses", "odom_poses", "obs", "obs_valid"):
            assert np.array_equal(getattr(x, f), getattr(y, f)), f


def test_frozen_tracks_equal_the_port():
    for f in ("skidpad", "acceleration"):
        a, b = getattr(frozen_tracks, f)(), getattr(port_tracks, f)()
        assert np.array_equal(a.cones_xy, b.cones_xy)


def test_a_seed_gives_the_same_inputs():
    mix = dict(generate.load("fleet64"), sessions=3)
    a, b = generate.sessions(mix, 2**32 + 3), generate.sessions(mix, 2**32 + 3)
    assert all(np.array_equal(a[k], b[k]) for k in ("obs", "valid", "poses"))
    c = generate.sessions(mix, 5)
    assert a["obs"].shape == c["obs"].shape and not np.array_equal(a["obs"], c["obs"])
    mix = dict(generate.load("gps8"), fleets=1, sessions=2)
    g1, g2 = generate.session_graphs(mix, 9, (384, 256, 4096)), \
        generate.session_graphs(mix, 9, (384, 256, 4096))
    assert all(np.array_equal(g1[0][i][k], g2[0][i][k]) for i in range(2) for k in g1[0][i])
