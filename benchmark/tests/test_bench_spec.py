"""BENCHMARK.json against the rules of its format, and every part of a cell
found by name: a cell, a configuration or a metric added as files only."""
import hashlib
import json
import re
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    n = len(SPEC["workloads"])
    # the full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, n // 4)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_keys_names_and_units():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["config"] in names
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    # a per-layer metric moves an end-to-end metric that each of its cells reports
    for m in SPEC["per_layer"]:
        target = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(target.get("workloads", cells)), m["name"]
    all_names = [x["name"] for x in SPEC["configs"] + SPEC["workloads"] + metrics]
    assert len(set(all_names)) == len(all_names)
    for cell in cells:
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_part_of_a_cell_found_by_name(cell):
    spec = harness.cell_spec(cell)
    fam = harness.family(spec)
    for name in ("setup", "check", "control", "shapes"):
        assert callable(getattr(fam, name)), name
    assert isinstance(fam.TRACE_BLOCKS, int) and fam.TRACE_BLOCKS >= 1
    # each number the family compares is held to its limit in test_bench_runs
    assert spec["limits"] and all(v >= 0 for v in spec["limits"].values())
    assert spec["chips"] == 1             # the harness runs one process on one card
    for m in spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def _hashes(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _add_config(root, spec) -> str:
    """A configuration of the MAPPO family with another width, a traffic mix,
    a cell and a per-layer metric → the cell's name."""
    conf = json.loads((ROOT / "benchmark/configs/mappo_rnn_3m.json").read_text())
    conf["params"]["actor_hidden_dim"] = 64
    (root / "benchmark/configs/mappo_rnn_3m_h64.json").write_text(json.dumps(conf))
    (root / "benchmark/traffic/4096envs.json").write_text(
        json.dumps({"num_envs": 4096, "log_interval": 2}))
    (root / "benchmark/limits/mappo_rnn_3m_h64-4096envs.json").write_text(
        (ROOT / "benchmark/limits/mappo_rnn_3m-8192envs.json").read_text())
    (root / "benchmark/metrics/blocks_per_s.py").write_text(
        "def read(ctx):\n    return ctx['steps'] / ctx['wall_s']\n")
    spec["configs"].append(dict(spec["configs"][0], name="mappo_rnn_3m_h64",
                                file="benchmark/configs/mappo_rnn_3m_h64.json"))
    spec["workloads"].append({"name": "mappo_rnn_3m_h64-4096envs", "config": "mappo_rnn_3m_h64",
                              "traffic": "4096envs", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "blocks_per_s", "unit": "1/s", "better": "higher",
                              "source": "host_clock", "layer": "driver",
                              "moves": "peak_mem_gib",
                              "workloads": ["mappo_rnn_3m_h64-4096envs"]})
    return "mappo_rnn_3m_h64-4096envs"


FAMILY = '''"""Recurrent MAPPO judged by a reference of its own."""
from benchmark.families.mappo import (GAINS, TRACE_BLOCKS, Run, check, control,  # noqa: F401
                                      numbers, ref_cfg, setup, shapes)
from benchmark.reference import mappo_27m as reference  # noqa: F401
'''


def _add_family(root, spec) -> str:
    """A family of the MAPPO path with its own reference, and a configuration
    on SMAClite ``27m_vs_30m`` (``mappo_27m30m_paper``'s sizes, with the
    options the MAPPO reference takes), its traffic (the recipe's 512 envs)
    and a cell → the cell's name."""
    (root / "benchmark/families/mappo_27m.py").write_text(FAMILY)
    (root / "benchmark/reference/mappo_27m.py").write_text(
        (ROOT / "benchmark/reference/mappo.py").read_text())
    conf = json.loads((ROOT / "benchmark/configs/mappo_rnn_3m.json").read_text())
    conf["family"] = "mappo_27m"
    conf["about"] = ("Recurrent MAPPO on SMAClite 27m_vs_30m at mappo_27m30m_paper's sizes, "
                     "with the options the MAPPO reference takes")
    conf["params"].update(env_name="27m_vs_30m", learning_rate_actor=5e-4,
                          learning_rate_critic=5e-4, entropy_coef=0.01, epochs=10,
                          num_minibatches=1, ppo_clip=0.05, total_timesteps=15_000_000)
    (root / "benchmark/configs/mappo_rnn_27m30m.json").write_text(json.dumps(conf))
    (root / "benchmark/traffic/512envs.json").write_text(
        json.dumps({"num_envs": 512, "log_interval": 4}))
    (root / "benchmark/limits/mappo_rnn_27m30m-512envs.json").write_text(
        (ROOT / "benchmark/limits/mappo_rnn_3m-8192envs.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="mappo_rnn_27m30m",
                                file="benchmark/configs/mappo_rnn_27m30m.json"))
    spec["workloads"].append({"name": "mappo_rnn_27m30m-512envs", "config": "mappo_rnn_27m30m",
                              "traffic": "512envs", "chips": 1, "why": "a test"})
    for m in spec["per_layer"]:
        m["workloads"].append("mappo_rnn_27m30m-512envs")
    return "mappo_rnn_27m30m-512envs"


REHEARSE = '''
import json, sys, time
sys.path.append({root!r})
from benchmark import harness
cell = harness.cell_spec({name!r})
cell["traffic_file"] = dict(cell["traffic_file"], num_envs={envs})
res = harness.execute(cell, 2**33 + 5, 0.5, False, time.perf_counter(), "cpu")
fam = harness.family(cell)
altered = fam.control(cell, 2**33 + 5, "cpu", tf32=False, fault="altered")
print(json.dumps({{"correct": res["correct"], "checks": res["checks"], "altered": altered,
                  "family": fam.__file__, "reference": fam.reference.__file__}}))
'''


@pytest.mark.parametrize("case", ["config", "family"])
def test_a_cell_a_config_and_a_metric_added_as_files_only(tmp_path, case):
    """A scratch copy of the benchmark takes a new configuration, traffic mix,
    cell and per-layer metric, or a new family with its own reference, from
    new files and one more entry each in BENCHMARK.json: no file of the
    harness is edited. The new family's cell, on SMAClite 27m_vs_30m, is
    rehearsed on the CPU in the copy with one env (1 minibatch), and its
    control with an action altered."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _hashes(tmp_path)
    spec = json.loads(json.dumps(SPEC))
    if case == "config":
        name = _add_config(tmp_path, spec)
    else:
        name = _add_family(tmp_path, spec)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.cell_spec(name, root=tmp_path)
    if case == "config":
        assert cell["config_file"]["params"]["actor_hidden_dim"] == 64
        assert cell["traffic_file"]["num_envs"] == 4096
        assert [m["name"] for m in cell["per_layer"]] == ["blocks_per_s"]
        assert harness.metric_reader("blocks_per_s", tmp_path)({"steps": 6, "wall_s": 2.0}) == 3.0
    else:
        assert cell["config_file"]["family"] == "mappo_27m"
        out = subprocess.run([sys.executable, "-c",
                              REHEARSE.format(root=str(ROOT), name=name, envs=1)],
                             cwd=tmp_path, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-4000:]
        res = json.loads(out.stdout.splitlines()[-1])
        assert res["family"] == str(tmp_path / "benchmark/families/mappo_27m.py")
        assert res["reference"] == str(tmp_path / "benchmark/reference/mappo_27m.py")
        assert res["correct"], res["checks"]
        for key, c in res["checks"].items():
            assert c["value"] < 1e-5, (key, c)
        # the planted fault fails, though env 0's first agent spawns with
        # only "stop" to choose
        assert any(v > cell["limits"][k] for k, v in res["altered"].items()), res["altered"]
    after = _hashes(tmp_path)
    assert {k: after[k] for k in before} == before
