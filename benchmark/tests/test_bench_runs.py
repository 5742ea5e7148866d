"""Each cell rehearsed on the CPU at a tiny size: the program against its
reference, the result line's schema, nothing of the JAX side loaded, and
the output check failing with the timed path broken underneath."""
import json
import math

import pytest
import torch
from conftest import CELLS, run_tiny, tiny_cell

from benchmark import harness
from benchmark.families import mappo


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_its_reference(name):
    res = run_tiny(tiny_cell(name))
    assert res["correct"], res["checks"]
    # the CPU runs the program's plain versions: float32 rounding apart
    for key, c in res["checks"].items():
        assert c["value"] < 1e-5, (key, c)
    assert harness.forbidden_modules() == []


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(name, trace):
    cell = tiny_cell(name)
    res = json.loads(json.dumps(run_tiny(cell, trace=trace)))
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = cell["per_layer"] if trace else cell["end_to_end"]
    units = {m["name"]: m["unit"] for m in want}
    assert set(res["metrics"]) <= set(units)
    for k, v in res["metrics"].items():
        assert v["unit"] == units[k] and math.isfinite(v["value"])
    if trace:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # on the CPU the device readers find nothing to read and stay silent;
        # those of the host's clock read the window
        source = {m["name"]: m["source"] for m in want}
        assert not any(source[k] == "device_trace" for k in res["metrics"])
        assert {k for k, v in source.items() if v == "host_clock"} <= set(res["metrics"])
    else:
        assert set(res["metrics"]) == set(units)
    # the window's blocks; a traced run's profiled block comes after them
    profiled = harness.family(cell).TRACE_BLOCKS if trace else 0
    assert len(res["blocks"]) == res["attempted"] - profiled
    assert all(len(b) == 2 for b in res["blocks"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    assert harness.forbidden_modules() == []


# ---------------------------------------------------------------------------
# the timed path broken underneath: the check has to fail
# ---------------------------------------------------------------------------
def _unchanged(monkeypatch):
    from cleanmarl_tpu_torch.core import optim

    update = optim.Optimizer.update

    def stuck(self, grads, state, params):
        return params, update(self, grads, state, params)[1]
    monkeypatch.setattr(optim.Optimizer, "update", stuck)


def _half_batch(monkeypatch):
    from cleanmarl_tpu_torch.algos import ppo_common

    vag = ppo_common.value_and_grad

    def half(fn, params, mb):
        n = mb["h0"].shape[0] // 2
        return vag(fn, params, {k: (v[:n] if k == "h0" else v[:, :n]) for k, v in mb.items()})
    monkeypatch.setattr(ppo_common, "value_and_grad", half)


def _altered(monkeypatch):
    """The first actions drawn are each agent's worst available one."""
    from cleanmarl_tpu_torch.algos import ppo_common

    orig, calls = ppo_common.categorical, []

    def altered(logits, generator):
        a = orig(logits, generator)
        if not calls:
            a = torch.where(logits > -1e8, logits, float("inf")).argmin(-1)
        calls.append(1)
        return a
    monkeypatch.setattr(ppo_common, "categorical", altered)


def _hidden_state_dropped(monkeypatch):
    """The actor's hidden state is not carried from one rollout to the next:
    each rollout starts from zeros."""
    from cleanmarl_tpu_torch.algos import ppo_common

    replace = ppo_common.PPORunnerState.replace

    def dropped(self, **kw):
        if "actor_h" in kw:
            kw["actor_h"] = torch.zeros_like(kw["actor_h"])
        return replace(self, **kw)
    monkeypatch.setattr(ppo_common.PPORunnerState, "replace", dropped)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered,
          "hidden_state_dropped": _hidden_state_dropped}
# the cells whose family drives the MAPPO path, where these faults are planted
MAPPO_CELLS = [c for c in CELLS
               if issubclass(harness.family(harness.cell_spec(c)).Run, mappo.Run)]


@pytest.mark.parametrize("name", MAPPO_CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_check_fails_when_the_timed_path_is_broken(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    res = run_tiny(tiny_cell(name))
    assert not res["correct"], res["checks"]
