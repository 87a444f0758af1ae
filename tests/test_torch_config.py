"""The port's configuration dataclasses mirror the JAX package's, field by
field: same names, same order, same defaults."""
import dataclasses

import pytest

from tpuslam.backend import gauss_newton as jgn
from tpuslam.backend.graph import GraphCapacity as JCap
from tpuslam.runtime.config import SlamConfig as JCfg
from tpuslam_torch.backend import gauss_newton as tgn
from tpuslam_torch.backend.graph import GraphCapacity as TCap
from tpuslam_torch.runtime.config import SlamConfig as TCfg


def _as_plain(x):
    """Dataclass -> dict of field values, nested dataclasses included."""
    return {f.name: _as_plain(getattr(x, f.name)) if dataclasses.is_dataclass(getattr(x, f.name))
            else getattr(x, f.name) for f in dataclasses.fields(x)}


@pytest.mark.parametrize("jax_cls,torch_cls", [
    (JCfg, TCfg), (jgn.GNConfig, tgn.GNConfig), (JCap, TCap)],
    ids=["SlamConfig", "GNConfig", "GraphCapacity"])
def test_fields_and_defaults_match(jax_cls, torch_cls):
    assert [f.name for f in dataclasses.fields(torch_cls)] == \
        [f.name for f in dataclasses.fields(jax_cls)]
    assert _as_plain(torch_cls()) == _as_plain(jax_cls())


@pytest.mark.parametrize("kw", [{}, {"periodic_gn_every": 0},
                                {"periodic_gn_every": 0, "mapping_publish_refine": True}])
def test_improved_matches(kw):
    assert _as_plain(TCfg.improved(**kw)) == _as_plain(JCfg.improved(**kw))


def test_cli_args_with_and_gps_reference_match():
    args = {"cid": "112", "id": "121", "sameConeThreshold": "1.5",
            "conesPerPacket": "10", "refLatitude": "57.7", "unknown": "x"}
    t, j = TCfg.from_cli_args(args), JCfg.from_cli_args(args)
    assert _as_plain(t) == _as_plain(j)
    assert t.gps_reference == j.gps_reference
    assert _as_plain(t.with_(association="nearest")) == \
        _as_plain(j.with_(association="nearest"))
