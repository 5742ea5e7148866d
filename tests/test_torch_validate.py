"""The port's validation runner (``cleanmarl_tpu_torch/validate.py``) and
its copy of the recipes (``recipes.py``) against the JAX package's
``scripts/validate_baselines.py``, on the CPU.

- ``recipes.RECIPES`` equals the script's ``CONFIGS`` (the script is
  loaded from its file; it imports JAX only inside ``run_config``);
- every recipe's ``steps_per_block`` from the port's ``meta`` equals the
  one the script's own ``build`` gives;
- the schedule (blocks, the eval cadence, the 5-eval tail) on a tiny
  matrix-game recipe;
- one block of ``mappo_reference`` through the CLI, and of
  ``qmix_spread_memeff`` and ``mappo_5m6m_paper`` (its envs cut from 256
  to 4 for the CPU, every flag kept) through ``run_config``: a ``RESULT``
  line with the script's keys and a curve under the ``--out`` directory,
  nothing under ``validation/``.
"""
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from cleanmarl_tpu_torch import recipes, validate

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "validate_baselines.py")
RESULT_KEYS = {"config", "seed", "tail_mean", "best", "threshold", "passed", "wall_s",
               "env_steps"}


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("validate_baselines", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _validation_listing():
    out = {}
    for root, _, files in os.walk(os.path.join(REPO, "validation")):
        for f in files:
            p = os.path.join(root, f)
            out[p] = os.stat(p).st_mtime_ns
    return out


def test_recipes_equal_the_script_configs(script):
    assert recipes.RECIPES == script.CONFIGS
    assert list(recipes.RECIPES) == list(script.CONFIGS)


@pytest.mark.parametrize("name", sorted(recipes.RECIPES))
def test_steps_per_block_matches_the_script(script, name):
    spec = recipes.RECIPES[name]
    want = script.build(spec["algo"], dict(spec["kwargs"], seed=1, verbose=False,
                                           num_eval_ep=64))[4]
    got = validate.build(spec["algo"], validate.recipe_kwargs(name, 1, "cpu"))[4]
    assert got == want


def test_schedule_matches_the_script(monkeypatch, tmp_path):
    """85 blocks: an eval every 85 // 40 = 2 blocks and after the last,
    43 records; the tail is the mean of the last 5."""
    tiny = dict(algo="mappo", threshold=-1e9, kwargs=dict(
        env_type="matrix", num_envs=2, rollout_len=4, epochs=1, log_interval=1,
        actor_hidden_dim=8, critic_hidden_dim=8, total_timesteps=85 * 8))
    monkeypatch.setitem(validate.RECIPES, "tiny", tiny)
    monkeypatch.delenv("BASELINES_BUDGET", raising=False)
    result, stats = validate.run_config("tiny", seed=3, device="cpu", out_dir=str(tmp_path),
                                        num_eval_ep=2)
    assert (stats["steps_per_block"], stats["num_blocks"], stats["eval_every"]) == (8, 85, 2)
    curve = [json.loads(x) for x in open(tmp_path / "tiny_s3.jsonl")]
    assert [r["env_steps"] for r in curve] == [b * 8 for b in range(2, 85, 2)] + [85 * 8]
    tail = [r["eval_ep_reward"] for r in curve[-5:]]
    assert result["tail_mean"] == round(sum(tail) / 5, 3)
    assert result["best"] == round(max(r["eval_ep_reward"] for r in curve), 3)
    assert result["passed"] and result["env_steps"] == 85 * 8 and result["seed"] == 3


def test_cli_runs_one_block_under_the_budget(tmp_path):
    before = _validation_listing()
    env = dict(os.environ, BASELINES_BUDGET="1", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m", "cleanmarl_tpu_torch.validate", "--config",
                        "mappo_reference", "--device", "cpu", "--out", str(tmp_path)],
                       capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    lines = [x for x in p.stdout.splitlines() if x.startswith("RESULT ")]
    assert len(lines) == 1
    result = json.loads(lines[0][len("RESULT "):])
    assert set(result) == RESULT_KEYS
    assert result["config"] == "mappo_reference" and result["env_steps"] == 64 * 25 * 8
    curve = [json.loads(x) for x in open(tmp_path / "mappo_reference_s1.jsonl")]
    assert len(curve) == 1 and set(curve[0]) == {"env_steps", "wall_s", "eval_ep_reward",
                                                 "rollout_ep_reward"}
    assert _validation_listing() == before


@pytest.mark.parametrize("name,cut", [
    ("qmix_spread_memeff", {}),
    ("mappo_5m6m_paper", {"num_envs": 4}),
])
def test_run_config_one_block(monkeypatch, capsys, tmp_path, name, cut):
    before = _validation_listing()
    spec = recipes.RECIPES[name]
    monkeypatch.setitem(validate.RECIPES, name, dict(spec, kwargs=dict(spec["kwargs"], **cut)))
    monkeypatch.setenv("BASELINES_BUDGET", "1")
    result, stats = validate.run_config(name, seed=1, device="cpu", out_dir=str(tmp_path))
    printed = [x for x in capsys.readouterr().out.splitlines() if x.startswith("RESULT ")]
    assert json.loads(printed[0][len("RESULT "):]) == result
    assert set(result) == RESULT_KEYS and stats["num_blocks"] == 1
    assert result["env_steps"] == stats["steps_per_block"]
    assert result["threshold"] == spec["threshold"]
    curve = [json.loads(x) for x in open(tmp_path / f"{name}_s1.jsonl")]
    assert len(curve) == 1
    metric = spec.get("metric", "eval/ep_reward").replace("/", "_")
    assert metric in curve[0] and result["tail_mean"] == round(curve[0][metric], 3)
    assert all(v == v and abs(v) != float("inf") for v in curve[0].values())
    assert _validation_listing() == before


def test_entry_point_defaults_to_the_card(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.setenv("BASELINES_BUDGET", "1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        validate.run_config("mappo_reference", out_dir=str(tmp_path))


def test_parallel_runs_write_a_summary(monkeypatch, tmp_path):
    """Two recipes, one subprocess each, both at once: a log and a curve
    each, and their RESULT records (with STATS) in ``summary.jsonl``."""
    monkeypatch.setenv("BASELINES_BUDGET", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    names = ["mappo_reference", "qmix_spread_memeff"]
    failures = validate.run_many(names, [2], device="cpu", out_dir=str(tmp_path), parallel=2)
    recs = {r["config"]: r for r in map(json.loads, open(tmp_path / "summary.jsonl"))}
    assert set(recs) == set(names)
    for name in names:
        assert RESULT_KEYS <= set(recs[name]) and recs[name]["seed"] == 2
        assert recs[name]["stats"]["num_blocks"] == 1
        assert (tmp_path / f"{name}_s2.log").exists()
        assert (tmp_path / f"{name}_s2.jsonl").exists()
    assert failures == sum(not r["passed"] for r in recs.values())
