"""Recurrent QMIX in the port (``algos/recurrent_q.py``) against the
benchmark's plain reference of it (``benchmark/reference/qmix.py``), the
planted faults the check must catch, the split of ``train_iter`` into
``act_iter`` and ``update_iter``, and the spans and counters of the
off-policy loop (``core/tracing.py``).

The program runs through the benchmark's own family
(``benchmark/families/qmix.py``: its weights, first env state and
generator, the recorder) at a CPU size: 4 envs, a ring of 8 episodes,
batches of 4, widths of 8, at most 2 updates an iteration, and an
exploration schedule over 200 env steps, so that greedy actions come in
the recorded iterations."""
import copy
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.families import qmix as fam
from benchmark.reference import qmix as reference
from cleanmarl_tpu_torch.algos import recurrent_q
from cleanmarl_tpu_torch.buffers.episode import EpisodeBuffer
from cleanmarl_tpu_torch.core import tracing
from cleanmarl_tpu_torch.core.checkpoint import to_state
from cleanmarl_tpu_torch.core.params import tree_leaves

torch.set_num_threads(1)

SEED = 2**33 + 7
SMALL = dict(buffer_size=8, batch_size=4, hidden_dim=8, hyper_dim=8, embed_dim=8,
             max_updates_per_iter=2, total_timesteps=4000)
# float32 on the CPU on both sides: rounding apart, the numbers read under 1e-6
TOL = {"action_gap": 0.0, "loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-5,
       "target_gap": 1e-5}
FAULTS = ("half", "altered", "unchanged", "frozen_target")


def _cell() -> dict:
    """The benchmark's ``qmix_rnn_3m-64envs`` cell at the CPU size."""
    cell = harness.cell_spec("qmix_rnn_3m-64envs")
    cell["config_file"] = dict(cell["config_file"],
                               params=dict(cell["config_file"]["params"], **SMALL))
    cell["traffic_file"] = {"num_envs": 4, "log_interval": 10}
    return cell


_RUNS = {}


def _run():
    """The family's set-up at the CPU size (once)."""
    if "run" not in _RUNS:
        _RUNS["run"] = fam.setup(_cell(), SEED, "cpu")
    return _RUNS["run"]


def _config():
    params = _cell()["config_file"]["params"]
    return recurrent_q.RecurrentQConfig(**params, num_envs=4, log_interval=10, device="cpu",
                                        seed=3, verbose=False)


def _runner():
    """A runner of the CPU-sized configuration after 50 iterations: its
    ring holds a batch, so every later block runs updates."""
    init, train_block, _, meta = recurrent_q.make_train(_config())
    runner = init(torch.Generator().manual_seed(3))
    for _ in range(5):
        runner, _ = train_block(runner)
    assert runner.ring.size >= SMALL["batch_size"]
    return runner, train_block, meta


def _same(a, b):
    a, b = tree_leaves(to_state(a)), tree_leaves(to_state(b))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


# ---------------------------------------------------------------------------
# the program against the reference, and the faults
# ---------------------------------------------------------------------------
def test_program_agrees_with_the_reference():
    cell, capture = _cell(), _run().capture
    nums = fam.check(cell, SEED, capture, "cpu")
    assert set(nums) == set(TOL)
    for key, value in nums.items():
        assert value <= TOL[key], (key, nums)
    # both stages, and greedy actions among the recorded ones
    assert len(capture["losses"]) == 2 * reference.STEPS
    assert len(capture["late"]["updates"]) == reference.STEPS
    assert "target3" in capture and len(capture["actions"]) > 1


@pytest.mark.parametrize("fault", FAULTS)
def test_each_planted_fault_fails_the_check(fault):
    nums = fam.control(_cell(), SEED, "cpu", tf32=False, fault=fault)
    assert any(v > TOL[k] for k, v in nums.items()), (fault, nums)


def test_the_recorder_puts_back_what_it_wrapped():
    from cleanmarl_tpu_torch.core import networks, optim

    _run()
    assert recurrent_q.eps_greedy.__module__ == "cleanmarl_tpu_torch.core.acting"
    assert recurrent_q.value_and_grad.__module__ == "cleanmarl_tpu_torch.core.params"
    assert optim.Optimizer.update.__qualname__ == "Optimizer.update"
    assert networks.soft_update.__qualname__ == "soft_update"
    assert EpisodeBuffer.sample.__qualname__ == "EpisodeBuffer.sample"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.qmix; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'cleanmarl_tpu_torch', 'cleanmarl_tpu', 'jax'}))" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["[]"]


# ---------------------------------------------------------------------------
# train_iter's two halves
# ---------------------------------------------------------------------------
def test_act_then_update_is_train_iter_bitwise():
    runner, _, meta = _runner()
    twin = copy.deepcopy(runner)
    epsilons = []
    before = runner.num_updates
    for _ in range(30):
        runner, eps = meta["train_iter"](runner)
        twin, n_ended, eps2 = meta["act_iter"](twin)
        twin = meta["update_iter"](twin, n_ended)
        epsilons.append((eps, eps2))
    assert runner.num_updates > before
    assert all(a == b for a, b in epsilons)
    _same(runner, twin)


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------
def _recorded_blocks(k: int = 3):
    """``k`` blocks of the CPU-sized configuration under a recording, with
    each sampled batch's step mask kept → (record, runner, masks)."""
    runner, train_block, _ = _runner()
    sample, masks = EpisodeBuffer.sample, []

    def kept(ring, generator, batch_size):
        batch, mask = sample(ring, generator, batch_size)
        masks.append(mask)
        return batch, mask
    EpisodeBuffer.sample = kept
    try:
        with tracing.recording() as rec:
            for _ in range(k):
                runner, _ = train_block(runner)
    finally:
        EpisodeBuffer.sample = sample
    return rec, runner, masks


def test_off_policy_spans_fire_under_a_recording():
    rec, _, masks = _recorded_blocks()
    n, iters = len(masks), 3 * 10
    assert n > 0
    calls = {k: v["calls"] for k, v in rec.spans.items()}
    assert {k: calls[k] for k in ("rq.act", "ring.commit", "rq.update", "rq.target",
                                  "rq.td_grad", "ring.sample", "net.mixer")} == {
        "rq.act": iters, "ring.commit": iters, "rq.update": n, "rq.target": n,
        "rq.td_grad": n, "ring.sample": n, "net.mixer": 2 * n}
    # the target's mixer runs inside rq.target, the online one inside rq.td_grad
    for name in ("rq.target", "rq.td_grad"):
        assert rec.spans[name]["self_s"] < rec.spans[name]["host_s"], name


def test_counters_are_the_sampled_masks():
    rec, runner, masks = _recorded_blocks()
    c = rec.counter_values()
    assert masks
    assert c["rq.valid_steps"] == float(sum(m.sum() for m in masks))
    assert c["rq.padded_steps"] == len(masks) * SMALL["batch_size"] * runner.ring.t_max
    assert 0 < c["rq.valid_steps"] < c["rq.padded_steps"]


def test_a_recorded_block_changes_no_number():
    runner, train_block, _ = _runner()
    twin = copy.deepcopy(runner)
    plain = traced = None
    for _ in range(3):
        plain, m_plain = train_block(plain or runner)
    with tracing.recording() as rec:
        for _ in range(3):
            traced, m_traced = train_block(traced or twin)
    assert rec.spans and rec.counters
    assert plain.num_updates > runner.num_updates
    _same(plain, traced)
    assert all(torch.equal(m_plain[k], m_traced[k]) for k in m_plain)
