"""The frozen copy of SMAClite (``reference/smaclite.py``), built by the
reference's ``make_env``, held to the program's env: one map of each
pattern the program names, with unit collisions off and on, stepped with
the same seeded legal actions from generators of the same seed; every
timestep (obs, state, avail, reward, done, truncated, before and after the
auto-reset) and env state bitwise equal."""
import dataclasses

import pytest
import torch
from conftest import ROOT  # noqa: F401  (the repository on the path)

from benchmark.reference import common as C

N_ENVS, STEPS, SEED = 64, 150, 2**33 + 19
CASES = [(m, c, True) for m in ("3m", "27m_vs_30m", "2s3z", "MMM", "MMM2")
         for c in (False, True)] + [("3m", False, False)]


def _same(ref, prog, what):
    for k in ("obs", "state", "avail", "reward", "done", "truncated"):
        a, b = getattr(ref, k), getattr(prog, k)
        assert a.dtype == b.dtype and torch.equal(a, b), (what, k)


def _same_state(ref, prog, what):
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(prog, f.name)), (what, f.name)


@pytest.mark.parametrize("env_name,collisions,ids", CASES)
def test_frozen_env_steps_as_the_program_does(env_name, collisions, ids):
    from cleanmarl_tpu_torch.envs import registry

    cfg = {"env_type": "smaclite", "env_name": env_name, "agent_ids": ids,
           "unit_collisions": collisions}
    ref = C.make_env(cfg, N_ENVS, "cpu")
    prog = registry.make_vec("smaclite", env_name, N_ENVS, agent_ids=ids, device="cpu",
                             unit_collisions=collisions)
    assert ((ref.n_agents, ref.n_actions, ref.obs_dim, ref.state_dim)
            == (prog.n_agents, prog.n_actions, prog.obs_dim, prog.state_dim))
    g_ref, g_prog = torch.Generator().manual_seed(SEED), torch.Generator().manual_seed(SEED)
    pick = torch.Generator().manual_seed(SEED + 1)
    s_ref, ts_ref = ref.reset(g_ref)
    s_prog, ts_prog = prog.reset(g_prog)
    _same(ts_ref, ts_prog, "reset")
    ended = 0
    for t in range(STEPS):
        scores = torch.rand(ts_ref.avail.shape, generator=pick)
        actions = torch.where(ts_ref.avail.bool(), scores, -1.0).argmax(-1)
        s_ref, ts_ref, final_ref = ref.step(s_ref, actions, g_ref)
        s_prog, ts_prog, final_prog = prog.step(s_prog, actions, g_prog)
        _same(ts_ref, ts_prog, t)
        _same(final_ref, final_prog, t)
        _same_state(s_ref, s_prog, t)
        ended += int((ts_ref.done | ts_ref.truncated).sum())
    assert ended > 0          # the auto-reset was taken


def test_unknown_maps_and_options_refused_by_name():
    cfg = {"env_type": "smaclite", "env_name": "3m", "agent_ids": True,
           "unit_collisions": False}
    with pytest.raises(ValueError, match="5z3s"):
        C.make_env(dict(cfg, env_name="5z3s"), 1, "cpu")
    with pytest.raises(ValueError, match="unit_collisions"):
        C.make_env(dict(cfg, unit_collisions="yes"), 1, "cpu")
    with pytest.raises(ValueError, match="mpe"):
        C.make_env(dict(cfg, env_type="mpe"), 1, "cpu")
