"""The port's spans (``cleanmarl_tpu_torch/core/tracing.py``): off, a shared
no-op that touches neither the clock nor the profiler; on, exact call
counts and nesting at the layer boundaries of a MAPPO and a recurrent-QMIX
block, and not one number of the run changed by recording."""
import copy

import pytest
import torch

from cleanmarl_tpu_torch.algos import mappo, recurrent_q
from cleanmarl_tpu_torch.algos.ppo_common import PPOConfig
from cleanmarl_tpu_torch.core import tracing
from cleanmarl_tpu_torch.core.checkpoint import to_state
from cleanmarl_tpu_torch.core.params import tree_leaves
from cleanmarl_tpu_torch.distributed import dp

torch.set_num_threads(1)

MAPPO = dict(env_type="smaclite", env_name="3m", recurrent=True, num_envs=4, rollout_len=5,
             actor_hidden_dim=8, critic_hidden_dim=8, epochs=2, num_minibatches=2,
             log_interval=2, seed=0, verbose=False)
# every matrix-game episode ends at step 8: a block of 8 iterations commits 4
# episodes at its last, and the ring then holds a batch
QMIX_RNN = dict(env_type="matrix", mixing="qmix", num_envs=4, buffer_size=16, batch_size=4,
                log_interval=8, hidden_dim=8, hyper_dim=8, embed_dim=4, num_eval_ep=2,
                target_network_update_freq=1, seed=0, verbose=False)


def _mappo():
    init, train_block, _, _ = mappo.make_train(PPOConfig(**MAPPO, device="cpu"))
    return init(torch.Generator().manual_seed(0)), train_block


def _qmix_rnn():
    init, train_block, _, _ = recurrent_q.make_train(
        recurrent_q.RecurrentQConfig(**QMIX_RNN, device="cpu"))
    return init(torch.Generator().manual_seed(0)), train_block


def test_spans_off_are_one_shared_no_op(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span off touched the clock or the profiler")

    monkeypatch.setattr(tracing.time, "perf_counter_ns", refuse)
    monkeypatch.setattr(tracing._profiler, "record_function", refuse)
    s = tracing.span("env.step")
    assert s is tracing.span("optim.update") is tracing._OFF
    with s:
        pass
    runner, train_block = _mappo()
    train_block(runner)                  # every span of a block, off
    assert tracing._record is None


def test_recording_is_one_at_a_time_and_closes():
    with tracing.recording() as rec:
        with pytest.raises(RuntimeError, match="already open"):
            with tracing.recording():
                pass
        with tracing.span("a"):
            with tracing.span("b"):
                pass
    assert tracing.span("a") is tracing._OFF
    assert rec.spans["a"]["calls"] == rec.spans["b"]["calls"] == 1
    assert rec.spans["a"]["self_s"] == pytest.approx(
        rec.spans["a"]["host_s"] - rec.spans["b"]["host_s"], abs=1e-9)
    assert rec.spans["b"]["self_s"] == rec.spans["b"]["host_s"]


def test_mappo_block_counts_and_nesting():
    runner, train_block = _mappo()
    with tracing.recording() as rec:
        train_block(runner)
    s = rec.spans
    steps = MAPPO["rollout_len"] * MAPPO["log_interval"]
    minibatches = MAPPO["epochs"] * MAPPO["num_minibatches"] * MAPPO["log_interval"]
    calls = {k: v["calls"] for k, v in s.items()}
    assert calls == {
        "ppo.rollout": 2, "ppo.rollout_step": steps, "env.step": steps,
        "ppo.update": 2, "ppo.returns": 2, "ppo.epoch": MAPPO["epochs"] * 2,
        "ppo.minibatch": minibatches, "ppo.actor_grad": minibatches,
        "ppo.critic_grad": minibatches, "optim.update": 2 * minibatches}
    # a span's time less its self time is the host time of its direct
    # children, so each parent's children are exactly these
    children = {
        "ppo.rollout": ["ppo.rollout_step"], "ppo.rollout_step": ["env.step"],
        "ppo.update": ["ppo.returns", "ppo.epoch"], "ppo.epoch": ["ppo.minibatch"],
        "ppo.minibatch": ["ppo.actor_grad", "ppo.critic_grad", "optim.update"]}
    for name, v in s.items():
        assert 0 <= v["self_s"] <= v["host_s"], name
        kids = sum(s[k]["host_s"] for k in children.get(name, []))
        assert v["host_s"] - v["self_s"] == pytest.approx(kids, abs=1e-9), name
        assert kids > 0 or name not in children, name


def test_recurrent_qmix_block_counts_the_off_policy_spans():
    runner, train_block = _qmix_rnn()
    with tracing.recording() as rec:
        runner, _ = train_block(runner)
    calls = {k: v["calls"] for k, v in rec.spans.items()}
    n = runner.num_updates
    assert n > 0
    iters = QMIX_RNN["log_interval"]
    # the mixer runs twice an update: the target's and the online Q_tot
    assert calls == {"env.step": iters, "ring.commit": iters, "rq.act": iters,
                     "ring.sample": n, "rq.update": n, "rq.target": n, "rq.td_grad": n,
                     "net.mixer": 2 * n, "optim.update": n, "net.polyak": 1}
    t_max = runner.ring.t_max
    counters = rec.counter_values()
    assert counters["rq.padded_steps"] == n * QMIX_RNN["batch_size"] * t_max
    # every sampled matrix-game episode is whole: 8 steps of t_max
    assert counters["rq.valid_steps"] == n * QMIX_RNN["batch_size"] * 8


@pytest.mark.parametrize("family", ["mappo", "qmix_rnn"])
def test_tracing_changes_no_number(family):
    runner, train_block = {"mappo": _mappo, "qmix_rnn": _qmix_rnn}[family]()
    twin = copy.deepcopy(runner)
    plain, m_plain = train_block(runner)
    with tracing.recording() as rec:
        traced, m_traced = train_block(twin)
    assert rec.spans
    a, b = tree_leaves(to_state(plain)), tree_leaves(to_state(traced))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y
    assert m_plain.keys() == m_traced.keys()
    assert all(torch.equal(m_plain[k], m_traced[k]) for k in m_plain)


def test_collectives_are_spanned_by_their_name():
    calls = dp.COMM.calls
    payload = torch.zeros(4)
    with tracing.recording() as rec:
        dp._collective("dp.all_reduce", lambda: None, payload, payload.device)
        dp._collective("dp.broadcast", lambda: None, payload, payload.device)
    assert {k: v["calls"] for k, v in rec.spans.items()} == {"dp.all_reduce": 1, "dp.broadcast": 1}
    assert dp.COMM.calls == calls + 2
