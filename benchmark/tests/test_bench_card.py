"""On the card (``-m cuda``; skipped without one): at a size a test run
holds (the cell's envs, at most 4096), the program's outputs pass the
cell's limits on three seeds, and the control (the reference in TF32 in the
program's place) and each planted fault fail one of them."""
import pytest
from conftest import CELLS

from benchmark import harness

MAX_ENVS = 4096
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def _cell(name):
    c = harness.cell_spec(name)
    n = min(c["traffic_file"]["num_envs"], MAX_ENVS)
    c["traffic_file"] = dict(c["traffic_file"], num_envs=n)
    return c


def _fails(cell, nums):
    return any(v > cell["limits"][k] for k, v in nums.items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_control_and_faults_fail(card, name):
    cell = _cell(name)
    fam = harness.family(cell)
    for seed in SEEDS:
        out = harness.run_cell(cell, seed, 0.0, False, 0.0, card)
        nums = fam.check(cell, seed, out["capture"], card)
        assert not _fails(cell, nums), (seed, nums)
        assert _fails(cell, fam.control(cell, seed, card, tf32=True)), seed
        for fault in ("half", "altered", "unchanged"):
            assert _fails(cell, fam.control(cell, seed, card, tf32=False, fault=fault)), fault
