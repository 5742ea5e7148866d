"""``benchmark/spans.py``: device operations to the innermost span of their
launch on any thread, idle gaps to the innermost annotation (the harness's
rule where the program has no spans), one sweep for a large trace, and the
readings absent where the program records nothing."""
import random
import sys
import time
import types

import pytest
from conftest import tiny_cell

from benchmark import spans
from benchmark import trace as tr


class Ev:
    """A profiler event as ``kineto_results.events()`` gives it."""

    def __init__(self, name, start_us, end_us, device=False, annotation=False, corr=0,
                 thread=1):
        self._n, self._s, self._d = name, int(start_us * 1e3), int((end_us - start_us) * 1e3)
        self._dev, self._ann, self._c, self._t = device, annotation, corr, thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return types.SimpleNamespace(name="CUDA" if self._dev else "CPU")

    def is_user_annotation(self):
        return self._ann

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t


def span(name, s, e):
    return Ev(name, s, e, annotation=True)


def op(name, s, e, corr=0):
    return Ev(name, s, e, device=True, corr=corr)


def launch(corr, t, thread=1):
    return Ev("cudaLaunchKernel", t, t + 1, corr=corr, thread=thread)


def fake_prof(evs):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))


PROGRAM = ["ppo.update", "ppo.actor_grad", "optim.update"]
TRACE = [
    span("bench.update", 0, 100), span("ppo.update", 5, 95),
    span("ppo.actor_grad", 10, 50), span("optim.update", 60, 70),
    span("env.step", 70, 72),                     # a span of no recording: not counted
    # the backward, launched by autograd's thread while the main thread
    # waits inside ppo.actor_grad, runs on the device after the span ends
    launch(1, 20, thread=2), op("k_bwd", 200, 210, corr=1),
    launch(2, 65), op("k_adam", 211, 212, corr=2),
    launch(3, 55), op("k_between", 213, 215, corr=3),
    launch(4, 62), op("k_add", 230, 231, corr=4),
    launch(5, 150), op("k_late", 240, 245, corr=5),
    launch(6, 97), op("k_tail", 246, 247, corr=6),
    op("k_lost", 250, 251, corr=404),             # its runtime call was not recorded
]


def test_ops_go_to_the_innermost_span_of_their_launch_on_any_thread():
    out = spans.reduce(*spans.events(TRACE, PROGRAM))
    ops = {k: (v["calls"], v["ops"]) for k, v in out["span_ops"].items()}
    assert ops == {"bench.update": (1, 1), "ppo.update": (1, 1), "ppo.actor_grad": (1, 1),
                   "optim.update": (1, 2), "outside": (0, 1)}
    assert out["span_ops"]["optim.update"]["device_s"] == pytest.approx(2e-6)
    assert out["unmatched"] == 1
    assert out["top_ops_by_span"]["k_bwd"] == {"ppo.actor_grad": pytest.approx(1e-5)}


def test_idle_gaps_go_to_the_innermost_annotation():
    evs = [span("bench.rollout", 0, 100), span("ppo.rollout", 1, 99),
           span("env.step", 10, 20), span("optim.update", 40, 60),
           op("a", 5, 10), op("b", 15, 16), op("c", 30, 41), op("d", 50, 51), op("e", 120, 121)]
    gaps = dict(spans.reduce(*spans.events(evs, ["ppo.rollout", "env.step"]))["breakdown"]
                ["idle_gaps"])
    # 10-15 and 16-30 in env.step (a gap is named where it begins); 41-50
    # in ppo.rollout (optim.update is no span of this recording); 51-120 in
    # ppo.rollout, which closed at 99
    assert gaps == {"env.step": pytest.approx(1.9e-5), "ppo.rollout": pytest.approx(7.8e-5)}


def _random_trace(rng, n_ops, n_spans, program=()):
    """Nested ``bench.*`` spans (and ``program`` ones inside them) over
    device operations with their launches."""
    evs, t = [], 0.0
    for i in range(n_spans):
        s = t
        inner = [(rng.choice(program), s + 1.0, s + 3.0)] if program else []
        evs.append(span(f"bench.{'rollout' if i % 2 else 'update'}", s, s + 5.0))
        evs += [span(n, a, b) for n, a, b in inner]
        t += rng.choice((5.0, 6.0))           # some spans touch, some leave a gap
    horizon = t + 10.0
    for k in range(n_ops):
        a = rng.uniform(0.0, horizon)
        evs.append(launch(k + 1, a))
        start = a + rng.uniform(0.0, 3.0)
        evs.append(op(f"k{k % 7}", start, start + rng.uniform(0.01, 2.0), corr=k + 1))
    rng.shuffle(evs)
    return evs


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_without_program_spans_breakdown_is_the_harness_rule(seed):
    evs = _random_trace(random.Random(seed), 400, 60)
    # an annotation that the recording did not name stays out, as on a
    # program without spans
    evs.append(span("env.step", 3.0, 4.0))
    prof = fake_prof(evs)
    want = tr.breakdown(prof, tr.device_events(prof))
    got = spans.reduce(*spans.events(evs, []))["breakdown"]
    assert got["device_ops"] == want["device_ops"]
    assert [n for n, _ in got["idle_gaps"]] == [n for n, _ in want["idle_gaps"]]
    for (_, a), (_, b) in zip(got["idle_gaps"], want["idle_gaps"]):
        assert a == pytest.approx(b, rel=1e-12)


def test_a_large_trace_reduces_in_one_sweep():
    evs = _random_trace(random.Random(0), 100_000, 500, program=("env.step", "optim.update"))
    t0 = time.perf_counter()
    device, sp = spans.events(evs, ["env.step", "optim.update"])
    out = spans.reduce(device, sp)
    assert time.perf_counter() - t0 < 2.0
    assert len(sp) == 1000 and len(device) == 100_000
    assert sum(v["ops"] for v in out["span_ops"].values()) == 100_000


def test_readings_are_absent_without_the_new_keys():
    assert spans.readings({"wall_s": 1.0, "spans": {}}) == {n: None for n in spans.READINGS}
    ctx = {"program_spans": {
        "env.step": {"calls": 4, "host_s": 0.4, "self_s": 0.2},
        "ppo.rollout_step": {"calls": 4, "host_s": 1.0, "self_s": 0.6},
        "ppo.minibatch": {"calls": 2, "host_s": 1.0, "self_s": 0.1},
        "ppo.actor_grad": {"calls": 2, "host_s": 0.5, "self_s": 0.5},
        "ppo.critic_grad": {"calls": 2, "host_s": 0.1, "self_s": 0.1},
        "optim.update": {"calls": 4, "host_s": 0.2, "self_s": 0.2}},
        "span_ops": {"env.step": {"calls": 4, "ops": 100, "device_s": 0.1},
                     "optim.update": {"calls": 4, "ops": 420, "device_s": 0.1}}}
    assert spans.readings(ctx) == {
        "env_step_ms.smaclite": pytest.approx(50.0), "env_step_ops.smaclite": 25.0,
        "act_ms.mappo": pytest.approx(150.0), "grad_ms.mappo": pytest.approx(300.0),
        "optim_step_ms": pytest.approx(50.0), "optim_step_ops": 105.0}
    assert spans.readings({"program_spans": {}, "span_ops": {}}) == {
        n: None for n in spans.READINGS}


def test_a_program_without_spans_records_nothing(monkeypatch):
    # the rest of the program as the family imports it, before the module goes
    import cleanmarl_tpu_torch.algos.mappo  # noqa: F401
    import cleanmarl_tpu_torch.core.driver  # noqa: F401

    monkeypatch.setitem(sys.modules, spans.TRACING, None)
    assert spans.tracing_module() is None
    out = spans.report(tiny_cell("mappo_rnn_3m-8192envs"), 2**33 + 7, 0.5, "cpu")
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert "program_spans" not in out and "span_ops" not in out
    assert out["readings"] == {n: None for n in spans.READINGS}


def test_report_on_the_cpu():
    cell = tiny_cell("mappo_rnn_3m-8192envs")
    out = spans.report(cell, 2**33 + 5, 0.5, "cpu")
    p = cell["config_file"]["params"]
    t = cell["traffic_file"]
    s = out["program_spans"]
    assert s["env.step"]["calls"] == s["ppo.rollout_step"]["calls"] == (
        p["rollout_len"] * t["log_interval"])
    assert s["optim.update"]["calls"] == 2 * p["epochs"] * p["num_minibatches"] * t["log_interval"]
    assert out["failed"] == 0 and out["traced_block_wall_s"] > 0
    # no device operation on the CPU: the counts have nothing to read
    assert out["span_ops"] == {} and out["breakdown"]["device_ops"] == []
    r = out["readings"]
    assert r["env_step_ops.smaclite"] is None and r["optim_step_ops"] is None
    assert all(r[n] > 0 for n in ("env_step_ms.smaclite", "act_ms.mappo", "grad_ms.mappo",
                                  "optim_step_ms"))
