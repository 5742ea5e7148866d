"""BENCHMARK.json against the rules of its format, and every part of a cell
found by name: a cell, a configuration or a metric added as files only."""
import json
import re
import shutil

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
    assert spec["config_file"]["family"] == "mappo"
    assert harness.family(spec).setup and harness.family(spec).check
    assert set(spec["limits"]) >= {"action_gap", "loss_gap", "grad_gap", "change_gap"}
    assert spec["chips"] == 1             # the harness runs one process on one card
    for m in spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_a_cell_a_config_and_a_metric_added_as_files_only(tmp_path):
    """A scratch copy of the benchmark takes a new configuration, traffic mix,
    cell and per-layer metric from new files and one more entry each in
    BENCHMARK.json: no file of the harness is edited."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    conf = json.loads((ROOT / "benchmark/configs/mappo_rnn_3m.json").read_text())
    conf["params"]["actor_hidden_dim"] = 64
    (tmp_path / "benchmark/configs/mappo_rnn_3m_h64.json").write_text(json.dumps(conf))
    (tmp_path / "benchmark/traffic/4096envs.json").write_text(
        json.dumps({"num_envs": 4096, "log_interval": 2}))
    (tmp_path / "benchmark/limits/mappo_rnn_3m_h64-4096envs.json").write_text(
        (ROOT / "benchmark/limits/mappo_rnn_3m-8192envs.json").read_text())
    (tmp_path / "benchmark/metrics/blocks_per_s.py").write_text(
        "def read(ctx):\n    return ctx['steps'] / ctx['wall_s']\n")
    spec["configs"].append(dict(spec["configs"][0], name="mappo_rnn_3m_h64",
                                file="benchmark/configs/mappo_rnn_3m_h64.json"))
    spec["workloads"].append({"name": "mappo_rnn_3m_h64-4096envs", "config": "mappo_rnn_3m_h64",
                              "traffic": "4096envs", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "blocks_per_s", "unit": "1/s", "better": "higher",
                              "source": "host_clock", "layer": "driver",
                              "moves": "peak_mem_gib",
                              "workloads": ["mappo_rnn_3m_h64-4096envs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.cell_spec("mappo_rnn_3m_h64-4096envs", root=tmp_path)
    assert cell["config_file"]["params"]["actor_hidden_dim"] == 64
    assert cell["traffic_file"]["num_envs"] == 4096
    assert [m["name"] for m in cell["per_layer"]] == ["blocks_per_s"]
    assert harness.metric_reader("blocks_per_s", tmp_path)({"steps": 6, "wall_s": 2.0}) == 3.0
