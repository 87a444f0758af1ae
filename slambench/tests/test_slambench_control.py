"""The comparison fails its control: the plain reference put in the
program's place and computed in float32 with TF32 matmuls (the precision
below the configurations' float32 with TF32 off) is not correct, where the
program is. On the card only, at a tiny size; `slambench/control.py` reads
the same at the cells' own sizes."""
import pytest
import torch

from slambench import control, run
from slambench.tests.conftest import REPO, TINY_FUSION, TINY_REPLAY

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("cell,mix", [("trackdrive_fleet.s64", TINY_REPLAY),
                                      ("fusion.gps8", dict(TINY_FUSION, sessions=4))])
def test_the_control_fails_where_the_program_passes(card, cell, mix):
    _, _, config, _ = run.lookup(REPO, cell)
    limits = config["limits"]

    def passes(readings):
        return all(readings[k] <= limits[k] for k in readings if k in limits)

    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        assert passes(control._program(config, mix, seed, run))
        assert not passes(control._reference_tf32(config, mix, seed, run))
