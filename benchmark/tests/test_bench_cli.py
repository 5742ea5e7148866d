"""The command refuses to measure without a card, and without the program."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import ROOT

ARGS = ["--workload", "mappo_rnn_3m-8192envs", "--seed", str(2**31 + 11), "--seconds", "1",
        "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="" if not torch.cuda.is_available() else
               os.environ.get("CUDA_VISIBLE_DEVICES", ""))
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def _no_result(out: str) -> bool:
    lines = out.strip().splitlines()
    if not lines:
        return True
    try:
        return "correct" not in json.loads(lines[-1])
    except ValueError:
        return True


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = _run(ROOT)
    assert p.returncode != 0 and _no_result(p.stdout)
    assert "CUDA device" in p.stderr


def test_refuses_in_a_checkout_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and _no_result(p.stdout)
