"""The MAPPO paper's practices in the port (death masking, value
normalization, advantage normalization; ``algos/ppo_common.py``) against
the benchmark's plain reference of them (``benchmark/reference/
mappo_paper.py``), and the spans and counters that measure them
(``core/tracing.py``).

The program's first two iterations run through the benchmark's own
family (``benchmark/families/mappo_paper.py``: its weights, first env
state and generator, the recorder) at a CPU size: 4 envs, rollouts of 16
steps, 3 epochs of 2 minibatches, widths of 16."""
import pytest
import torch

from benchmark import harness
from benchmark.families import common
from benchmark.families import mappo_paper as fam
from benchmark.reference import mappo_paper as reference
from cleanmarl_tpu_torch.algos import mappo
from cleanmarl_tpu_torch.algos.ppo_common import PPOConfig
from cleanmarl_tpu_torch.core import tracing

torch.set_num_threads(1)

SEED = 2**33 + 7
MAPS = ("27m_vs_30m", "3m")
OPTIONS = ("death_masking", "normalize_values", "normalize_advantage")
NEW_SPANS = ("ppo.death_mask", "ppo.value_norm", "ppo.adv_norm")
# float32 on the CPU on both sides: rounding apart, the numbers read under 1e-6
TOL = {"action_gap": 0.0, "loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-5}
SMALL = dict(rollout_len=16, actor_hidden_dim=16, critic_hidden_dim=16, epochs=3,
             num_minibatches=2)


def _cell(env_name: str) -> dict:
    """The benchmark's ``mappo_27m30m_paper`` cell at the CPU size, on
    ``env_name``."""
    cell = harness.cell_spec("mappo_27m30m_paper-512envs")
    params = dict(cell["config_file"]["params"], env_name=env_name, **SMALL)
    cell["config_file"] = dict(cell["config_file"], params=params)
    cell["traffic_file"] = {"num_envs": 4, "log_interval": 1}
    return cell


_CAPTURES = {}


def _capture(env_name: str):
    """The program's record of its first two iterations (once a map)."""
    if env_name not in _CAPTURES:
        cell = _cell(env_name)
        run = fam.setup(cell, SEED, "cpu")
        _CAPTURES[env_name] = (cell, run.capture)
        run.free()
    return _CAPTURES[env_name]


def _judge(env_name: str, **ref_options):
    """The program's record against the reference's (with ``ref_options``
    set in the reference alone) → (the check's numbers, the reference's
    record)."""
    cell, capture = _capture(env_name)
    ins = common.inputs(SEED, "cpu", fam.shapes(cell, "cpu"), fam.GAINS)
    ref = reference.run(dict(fam.ref_cfg(cell), **ref_options), ins, "cpu", given=capture)
    return fam.numbers(capture, ref, ins["params"]), ref


@pytest.mark.parametrize("env_name", MAPS)
def test_program_agrees_with_the_reference(env_name):
    nums, _ = _judge(env_name)
    assert set(nums) == set(TOL)
    for key, value in nums.items():
        assert value <= TOL[key], (key, nums)


@pytest.mark.parametrize("env_name", MAPS)
def test_the_alive_mask_has_zeros_in_the_batch(env_name):
    _, ref = _judge(env_name)
    assert len(ref["alive"]) == 2
    for alive, total in ref["alive"]:
        assert 0 < alive < total, ref["alive"]


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("env_name", MAPS)
def test_each_mechanism_is_seen(env_name, option):
    """With one option off in the reference alone, the check fails."""
    nums, _ = _judge(env_name, **{option: False})
    assert any(v > TOL[k] for k, v in nums.items()), (option, nums)


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------
def _refuse(*args, **kwargs):
    raise AssertionError("count read or touched its value")


class _Untouchable:
    __getattribute__ = _refuse


def test_count_without_a_recording_does_nothing():
    assert tracing._record is None
    tracing.count("x", _Untouchable())
    with tracing.recording() as rec:
        pass
    assert rec.counters == {} and rec.counter_values() == {}


def test_count_sums_numbers_and_tensors_across_calls():
    with tracing.recording() as rec:
        tracing.count("a", 2)
        tracing.count("a", 3.5)
        tracing.count("b", torch.tensor([1.0, 2.0]))
        tracing.count("b", torch.ones((2, 2), dtype=torch.bool))
        tracing.count("a", torch.tensor(1.0))
    assert rec.counter_values() == {"a": 6.5, "b": 7.0}
    assert tracing._record is None


def test_count_keeps_a_tensor_on_its_device(monkeypatch):
    """A tensor's counter is summed where it lies and never read back
    while counting: on the meta device, where nothing can be read, it
    stays a meta tensor."""
    for name in ("item", "tolist", "__float__", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, _refuse)
    with tracing.recording() as rec:
        tracing.count("c", torch.ones((3, 4), device="meta"))
        tracing.count("c", torch.ones((5,), device="meta"))
        tracing.count("n", 12)
    c = rec.counters["c"]
    assert torch.is_tensor(c) and c.device.type == "meta" and c.shape == ()
    assert rec.counters["n"] == 12


# ---------------------------------------------------------------------------
# the program's new spans and counters
# ---------------------------------------------------------------------------
def _update_recorded(**options):
    """One rollout of the CPU-sized 3m configuration, then its update
    under a recording → (record, the rollout's alive mask)."""
    params = dict(_cell("3m")["config_file"]["params"], **options)
    cfg = PPOConfig(**params, num_envs=4, log_interval=1, device="cpu", seed=3, verbose=False)
    init, _, _, meta = mappo.make_train(cfg)
    runner = init(torch.Generator().manual_seed(3))
    runner, traj, h0 = meta["collect_rollout"](runner)
    with tracing.recording() as rec:
        meta["ppo_update"](runner, traj, h0)
    return rec, reference.alive_mask(traj["avail"])


def test_paper_options_span_and_count_an_update():
    rec, alive = _update_recorded()
    calls = {k: rec.spans[k]["calls"] for k in NEW_SPANS}
    # the mask and the minibatch counts; the values' denormalization and
    # the targets' normalization; the advantages
    assert calls == {"ppo.death_mask": 2, "ppo.value_norm": 2, "ppo.adv_norm": 1}
    assert rec.counter_values() == {"ppo.agent_steps": float(alive.numel()),
                                    "ppo.alive_agent_steps": float(alive.sum())}


def test_options_off_enter_no_new_span_and_no_counter():
    """As in the 3m cell: with the three options off an update opens none
    of their spans and counts nothing."""
    rec, _ = _update_recorded(**{k: False for k in OPTIONS})
    assert "ppo.update" in rec.spans
    assert not set(NEW_SPANS) & set(rec.spans)
    assert rec.counters == {}
