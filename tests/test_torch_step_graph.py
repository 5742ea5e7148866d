"""``VecEnv.step`` replayed from CUDA graphs (``envs/step_graph.py``).

On the CPU: a CPU ``VecEnv`` and a ``HostVecEnv`` never capture (no
``env.step.capture`` or ``env.step.replay`` span) and give the eager step's
outputs; with the capture replaced by a stand-in that runs the recorded
body at each replay, the graph's buffers, copies and binding to a generator
give the eager step's outputs bitwise. On the card (``cuda`` marker): the
graphed step against the eager one, bitwise, 60 steps with auto-resets, on
SMAClite 3m at 8192 envs, LBF and the other device envs.

The successor equality, on the eager route, on the graph's data flow and
on the card: an env whose episode goes on returns as its next ``obs`` and
``state`` bitwise the step's ``final`` ones, which the episode ring's
paired layout stores once (``buffers/episode.py``).

The reference is the eager step as it stood before the graph
(``_eager_step``). This file imports neither JAX nor the JAX package, so
the card tests run on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_step_graph.py -m cuda
"""
import numpy as np
import pytest
import torch

from cleanmarl_tpu_torch.core import tracing
from cleanmarl_tpu_torch.envs import registry, step_graph
from cleanmarl_tpu_torch.envs.base import VecEnv, state_where
from cleanmarl_tpu_torch.envs.external import HostEnvFamily

torch.set_num_threads(1)

GRAPH_SPANS = ("env.step.capture", "env.step.replay")

# (env_type, env_name, constructor options): short episodes, so that a run
# of steps crosses auto-resets
ENVS = {
    "smaclite_3m": ("smaclite", "3m", dict(agent_ids=True, time_limit=6)),
    "smaclite_MMM": ("smaclite", "MMM", dict(time_limit=6)),
    "smaclite_3m_collisions": ("smaclite", "3m", dict(unit_collisions=True, time_limit=6)),
    "lbf": ("lbf", "Foraging-8x8-2p-3f-v3", dict(time_limit=6)),
    "mpe_spread": ("mpe", "simple_spread_v3", dict(max_cycles=6)),
    "mpe_speaker_listener": ("mpe", "simple_speaker_listener_v4", dict(max_cycles=6)),
    "pursuit": ("pursuit", "pursuit_v4", dict(time_limit=6)),
    "matrix": ("matrix", "", dict(episode_limit=4)),
}


def _eager_step(vec, state, actions, generator):
    """``VecEnv.step`` as it was before the graph."""
    state2, ts = vec.env.step(state, actions, generator)
    if not vec.auto_reset:
        return state2, ts, ts
    reset_state, reset_ts = vec.env.reset(vec.num_envs, generator)
    ended = torch.logical_or(ts.done, ts.truncated)

    def pick(a, b):
        return torch.where(ended.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    new_state = state_where(ended, reset_state, state2)
    out = ts.replace(obs=pick(reset_ts.obs, ts.obs), state=pick(reset_ts.state, ts.state),
                     avail=pick(reset_ts.avail, ts.avail))
    return new_state, out, ts


def _vec(name, num_envs, device, auto_reset=True):
    env_type, env_name, kw = ENVS[name]
    return VecEnv(registry.make(env_type, env_name, device=device, **kw), num_envs,
                  auto_reset=auto_reset)


def _tensors(out):
    """Every tensor of a step's (state, ts, final), by name."""
    state, ts, final = out
    d = {f"state.{k}": v for k, v in vars(state).items()}
    for tag, t in (("ts", ts), ("final", final)):
        for k in ("obs", "state", "avail", "reward", "done", "truncated"):
            d[f"{tag}.{k}"] = getattr(t, k)
        d.update({f"{tag}.info.{k}": v for k, v in t.info.items()})
    return d


def _bits(x):
    return x.detach().contiguous().view(torch.uint8).cpu()


def _assert_same(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}: {k}"
        assert torch.equal(_bits(a), _bits(b)), f"{what}: {k} differs"


def _run(vec, seed, steps, step_fn, start=None, gen=None):
    """``steps`` steps from a reset (or ``start``: (state, ts)) with actions
    drawn from the step's own generator, as a rollout does → [(inputs,
    outputs, generator state after)] and the generator."""
    gen = gen or torch.Generator(vec.device).manual_seed(seed)
    state, ts = start or vec.reset(gen)
    log = []
    for _ in range(steps):
        actions = vec.sample(gen, ts.avail)
        out = step_fn(vec, state, actions, gen)
        log.append(((state, actions), out, gen.get_state()))
        state, ts = out[0], out[1]
    return log, gen


def _graphed(vec, state, actions, gen):
    return vec.step(state, actions, gen)


def _hold_contract(vec, seed, steps, rerun_from):
    """The graphed step against the eager one, bitwise, step by step; inputs
    and earlier outputs unwritten; then ``set_state`` back to the generator
    of step ``rerun_from`` and the rest replayed again → the spans' calls."""
    want, _ = _run(vec, seed, steps, _eager_step)
    with tracing.recording() as rec:
        gen = torch.Generator(vec.device).manual_seed(seed)
        state, ts = vec.reset(gen)
        held, outs = [], []
        for t in range(steps):
            actions = vec.sample(gen, ts.avail)
            ins = {**{f"state.{k}": v for k, v in vars(state).items()}, "actions": actions}
            ins_before = {k: v.clone() for k, v in ins.items()}
            out = vec.step(state, actions, gen)
            _assert_same(ins, ins_before, f"step {t}: an input was written")
            _assert_same(_tensors(out), _tensors(want[t][1]), f"step {t}")
            assert torch.equal(gen.get_state(), want[t][2]), f"step {t}: generator"
            held.append((_tensors(out), {k: v.clone() for k, v in _tensors(out).items()}))
            outs.append(out)
            state, ts = out[0], out[1]
        for t, (got, copy) in enumerate(held):
            _assert_same(got, copy, f"step {t}: an output was written by a later call")
        # phase_timer's pattern: the generator put back, the steps run again
        gen.set_state(want[rerun_from - 1][2])
        start = outs[rerun_from - 1][0], outs[rerun_from - 1][1]
        again, _ = _run(vec, seed, steps - rerun_from, _graphed, start=start, gen=gen)
        for t, (_, out, g) in enumerate(again, start=rerun_from):
            _assert_same(_tensors(out), _tensors(want[t][1]), f"step {t} after set_state")
            assert torch.equal(g, want[t][2])
    return {k: v["calls"] for k, v in rec.spans.items()}


# ---------------------------------------------------------------------------
# CPU: no capture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("auto_reset", [True, False])
@pytest.mark.parametrize("name", sorted(ENVS))
def test_cpu_vec_env_never_captures_and_steps_as_before(name, auto_reset):
    vec = _vec(name, 6, "cpu", auto_reset)
    want, _ = _run(vec, 3, 10, _eager_step)
    with tracing.recording() as rec:
        got, _ = _run(vec, 3, 10, _graphed)
    assert vec._graph is None
    assert {k: v["calls"] for k, v in rec.spans.items()} == {"env.step": 10}
    for t, ((_, out, g), (_, ref, g_ref)) in enumerate(zip(got, want)):
        _assert_same(_tensors(out), _tensors(ref), f"step {t}")
        assert torch.equal(g, g_ref)


class ScriptedHostEnv:
    """Episodes of 3 steps; the obs and state carry the step count."""

    n_agents, obs_dim, state_dim, n_actions, episode_limit = 2, 3, 4, 3, 3

    def __init__(self):
        self.t = 0

    def close(self):
        pass

    def reset(self, seed=None):
        self.t = 0
        return np.full((self.n_agents, self.obs_dim), float(self.t), np.float32)

    def get_state(self):
        return np.full((self.state_dim,), float(self.t), np.float32)

    def get_avail_actions(self):
        return np.ones((self.n_agents, self.n_actions), bool)

    def step(self, actions):
        self.t += 1
        obs = np.full((self.n_agents, self.obs_dim), float(self.t), np.float32)
        return obs, float(np.sum(actions)), self.t >= self.episode_limit, False, {}


@pytest.mark.parametrize("auto_reset", [True, False])
def test_host_vec_env_never_captures(auto_reset):
    vec = HostEnvFamily(ScriptedHostEnv, device="cpu").make_vec(3, auto_reset=auto_reset)
    gen = torch.Generator().manual_seed(0)
    state, ts = vec.reset(gen)
    with tracing.recording() as rec:
        for t in range(5):
            state, ts, final = vec.step(state, vec.sample(gen, ts.avail), gen)
            assert float(final.obs[0, 0, 0]) == (t % 3 if auto_reset else t) + 1
    assert {k: v["calls"] for k, v in rec.spans.items()} == {"env.step": 5}


# ---------------------------------------------------------------------------
# CPU: the graph's data flow, the capture replaced by a stand-in
# ---------------------------------------------------------------------------

@pytest.fixture
def stand_in_capture(monkeypatch):
    """Every env capturable, and a capture that records nothing: its replay
    runs the body again, so the buffers, copies and selection are the
    graph's own and only the launches are eager."""
    captured = []

    def capture(fn, generator, device, pool=None):
        captured.append(generator)
        return fn, None

    monkeypatch.setattr(step_graph, "capturable", lambda env: True)
    monkeypatch.setattr(step_graph, "capture", capture)
    return captured


@pytest.mark.parametrize("auto_reset", [True, False])
@pytest.mark.parametrize("name", sorted(ENVS))
def test_graph_data_flow_matches_eager_bitwise(stand_in_capture, name, auto_reset):
    vec = _vec(name, 5, "cpu", auto_reset)
    calls = _hold_contract(vec, seed=11, steps=14, rerun_from=6)
    assert calls == {"env.step": 14 + 8, "env.step.capture": 1,
                     "env.step.replay": 14 - 1 + 8}
    assert len(stand_in_capture) == (2 if auto_reset else 1)


def test_graph_binds_to_the_latest_generator(stand_in_capture):
    """The first call with a generator warms up eagerly, the next captures
    and replays, a call with another generator drops the graph; None, and
    inputs laid out otherwise, run eagerly."""
    vec = _vec("smaclite_3m", 4, "cpu")
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    state, ts = vec.reset(g1)

    def step(gen, state=None, ts=None, actions=None):
        with tracing.recording() as rec:
            out = vec.step(state, vec.sample(g1, ts.avail) if actions is None else actions,
                           gen)
        return out, sorted(k for k in rec.spans if k in GRAPH_SPANS)

    seen = []
    for gen in (g1, g1, g1, g2, g1, None, g1, g1):
        out, spans = step(gen, state, ts)
        seen.append(spans)
        state, ts = out[0], out[1]
    assert seen == [[], list(GRAPH_SPANS), ["env.step.replay"], [], [],
                    [], list(GRAPH_SPANS), ["env.step.replay"]]
    graph = vec._graph
    _, spans = step(g1, state, ts, actions=vec.sample(g1, ts.avail).int())
    assert spans == [] and vec._graph is graph


# ---------------------------------------------------------------------------
# the successor equality that the episode ring stores once
# ---------------------------------------------------------------------------

# the envs behind the paired episode ring, as the algorithms build them
# (agent ids on): recurrent QMIX on SMAClite 3m, QMIX on MPE spread; with
# short episodes, so that a run of steps crosses auto-resets
SUCCESSOR_ENVS = {
    "smaclite_3m": ("smaclite", "3m", dict(agent_ids=True, time_limit=6)),
    "mpe_spread": ("mpe", "simple_spread_v3", dict(agent_ids=True, max_cycles=6)),
}


def _hold_successor(vec, seed, steps):
    """Every step, each env whose episode goes on returns as its next
    ``obs`` and ``state`` bitwise the step's ``final`` ones: the episode
    ring stores ``next_obs[t]`` as ``obs[t + 1]`` (``buffers/episode.py``).
    → the (env, step) pairs held and the episodes that ended."""
    gen = torch.Generator(vec.device).manual_seed(seed)
    state, ts = vec.reset(gen)
    held = ended = 0
    for t in range(steps):
        state, ts, final = vec.step(state, vec.sample(gen, ts.avail), gen)
        on = ~torch.logical_or(ts.done, ts.truncated)
        for k in ("obs", "state"):
            assert torch.equal(_bits(getattr(ts, k)[on]), _bits(getattr(final, k)[on])), \
                f"step {t}: {k}"
        held += int(on.sum())
        ended += int((~on).sum())
    return held, ended


def _successor_vec(name, num_envs, device):
    env_type, env_name, kw = SUCCESSOR_ENVS[name]
    return VecEnv(registry.make(env_type, env_name, device=device, **kw), num_envs)


@pytest.mark.parametrize("name", sorted(SUCCESSOR_ENVS))
def test_eager_step_successor_is_the_next_observation(name):
    held, ended = _hold_successor(_successor_vec(name, 5, "cpu"), seed=3, steps=14)
    assert held > 0 and ended > 0


@pytest.mark.parametrize("name", sorted(SUCCESSOR_ENVS))
def test_graph_step_successor_is_the_next_observation(stand_in_capture, name):
    with tracing.recording() as rec:
        held, ended = _hold_successor(_successor_vec(name, 5, "cpu"), seed=3, steps=14)
    assert held > 0 and ended > 0
    assert rec.spans["env.step.replay"]["calls"] == 13


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


CARD_CASES = {
    # the benchmark cell's env (agent ids, 150-step episodes) and the same
    # map with 25-step episodes, so that 60 steps cross two auto-resets
    "smaclite_3m_cell-8192": (("smaclite", "3m", dict(agent_ids=True)), 8192),
    "smaclite_3m-8192": (("smaclite", "3m", dict(agent_ids=True, time_limit=25)), 8192),
    "lbf-8192": (("lbf", "Foraging-8x8-2p-3f-v3", dict(time_limit=25)), 8192),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_graphed_step_bitwise_on_card(case):
    _card()
    (env_type, env_name, kw), n = CARD_CASES[case]
    vec = VecEnv(registry.make(env_type, env_name, device="cuda", **kw), n)
    calls = _hold_contract(vec, seed=2**33 + 7, steps=60, rerun_from=30)
    assert calls == {"env.step": 90, "env.step.capture": 1, "env.step.replay": 89}


@pytest.mark.cuda
@pytest.mark.parametrize("auto_reset", [True, False])
@pytest.mark.parametrize("name", sorted(ENVS))
def test_every_device_env_graphed_bitwise_on_card(name, auto_reset):
    _card()
    vec = _vec(name, 256, "cuda", auto_reset)
    calls = _hold_contract(vec, seed=5, steps=20, rerun_from=8)
    assert calls == {"env.step": 32, "env.step.capture": 1, "env.step.replay": 31}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SUCCESSOR_ENVS))
def test_graphed_step_successor_is_the_next_observation_on_card(name):
    _card()
    with tracing.recording() as rec:
        held, ended = _hold_successor(_successor_vec(name, 256, "cuda"), seed=2**33 + 5,
                                      steps=20)
    assert held > 0 and ended > 0
    assert rec.spans["env.step.replay"]["calls"] == 19
