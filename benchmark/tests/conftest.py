"""Shared helpers of the benchmark's tests: the repository root on the path,
the cells of ``BENCHMARK.json``, and each cell cut to a size the CPU runs in
seconds (the references and the program's plain versions; the card's
numbers come only from the card)."""
import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = tuple(w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"])


def tiny_cell(name: str) -> dict:
    """The cell with a CPU-sized batch: 2 envs a minibatch (16 for 8
    minibatches); the widths and the rest of the traffic are the cell's."""
    from benchmark import harness

    cell = harness.cell_spec(name)
    n_mb = cell["config_file"]["params"].get("num_minibatches", 1)
    cell["traffic_file"] = dict(cell["traffic_file"], num_envs=2 * max(1, n_mb))
    return cell


def run_tiny(cell: dict, seed: int = 2**33 + 5, trace: bool = False) -> dict:
    from benchmark import harness

    return harness.execute(cell, seed, 0.5, trace, time.perf_counter(), "cpu")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
