"""Data parallelism of the port's off-policy families (QMIX, VDN, recurrent
Q with episode and sequence replay, MADDPG, FACMAC) over
``torch.distributed`` (gloo on the CPU), mirroring
``tests/test_distributed.py:55-72, 98-146, 193-288, 313-343`` and
``tests/test_multihost.py:137-178``.

- **Commit.** Two ranks take the same steps (records and end flags from a
  numpy seed), each its envs ``rank::2`` (global env ``j`` on rank ``j %
  2``). The union of their ring rows, by global index (row ``i`` on rank
  ``i % 2`` at ``i // 2``), equals the JAX package's own
  ``EpisodeAccumulator.add_step``, ``SequenceAccumulator.add_step`` and
  ``TransitionBuffer.add_batch`` on the full batch after every step,
  exactly, scratch row aside, at capacities 2 divides and does not; the
  host counters are the global ones; a sample gives each rank rows
  ``rank::2`` of the single-process sample from the same generator.
- **One update per family** from the JAX package's params and Adam state
  (warmed by one earlier JAX update), the sampled batch (and noise) split
  over 2 ranks, against the JAX package's single-device update at 1e-5;
  both ranks end with the same params.

The driven path (one rank, two ranks' blocks, the CLI cluster) is in
``tests/test_torch_distributed_offpolicy_runs.py``. Each spawned rank imports torch and the port only (``tests/_dp_ranks.py``);
the JAX references run in this process.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dp_ranks
import test_torch_facmac as tfacmac
import test_torch_maddpg as tmaddpg
import test_torch_qmix as tqmix
import test_torch_recurrent_q as trq
import test_torch_vdn as tvdn
from cleanmarl_tpu.algos import facmac as jfacmac
from cleanmarl_tpu.algos import maddpg as jmaddpg
from cleanmarl_tpu.algos import qmix as jqmix
from cleanmarl_tpu.algos import recurrent_q as jrq
from cleanmarl_tpu.algos import vdn as jvdn
from cleanmarl_tpu.buffers.episode import EpisodeAccumulator as JEpisodeAcc
from cleanmarl_tpu.buffers.episode import EpisodeBuffer as JEpisodeRing
from cleanmarl_tpu.buffers.sequence import SequenceAccumulator as JSequenceAcc
from cleanmarl_tpu.buffers.sequence import SequenceBuffer as JSequenceRing
from cleanmarl_tpu.buffers.transition import TransitionBuffer as JTransitionRing
from cleanmarl_tpu.core import networks as jnets
from cleanmarl_tpu.core.optim import make_optimizer as jmake_optimizer
from cleanmarl_tpu_torch.distributed import dp
from cleanmarl_tpu_torch.envs import registry
from test_torch_distributed import np_tree, port_opt

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
WORLD = 2


def same_trees(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b), strict=True):
        np.testing.assert_array_equal(x, y)


def close_trees(got, want, what):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL, err_msg=what)


# ---------------------------------------------------------------------------
# the commit: every ring kind, capacities 2 divides and does not
# ---------------------------------------------------------------------------

NUM_ENVS, STEPS = 6, 30
# name → (kind, capacity, T_max or chunk length); the transition ring at 8
# takes the aligned path (every row a rank writes is its own), at 7 the
# exchange
RING_CASES = {
    "episode_cap6": ("episode", 6, 5), "episode_cap7": ("episode", 7, 5),
    "sequence_cap8": ("sequence", 8, 4), "sequence_cap7": ("sequence", 7, 4),
    "transition_cap8": ("transition", 8, None), "transition_cap7": ("transition", 7, None),
}


def ring_steps(kind, seed):
    rng = np.random.RandomState(seed)
    p_end = {"episode": 0.35, "sequence": 0.2, "transition": 0.0}[kind]
    return [({"obs": rng.randn(NUM_ENVS, 2, 3).astype(np.float32),
              "action": rng.randint(0, 5, (NUM_ENVS, 2)).astype(np.int64),
              "done": rng.rand(NUM_ENVS) < 0.5},
             rng.rand(NUM_ENVS) < p_end) for _ in range(STEPS)]


def jax_rings(kind, cap, length, steps):
    """The JAX package's ring after each step, on the full batch."""
    jex = {"obs": jnp.zeros((2, 3)), "action": jnp.zeros((2,), jnp.int32),
           "done": jnp.zeros((), jnp.bool_)}
    if kind == "transition":
        ring, acc = JTransitionRing.create(cap, jex), None
    elif kind == "episode":
        ring, acc = JEpisodeRing.create(cap, length, jex), JEpisodeAcc.create(
            NUM_ENVS, length, jex)
    else:
        ring, acc = JSequenceRing.create(cap, length, jex), JSequenceAcc.create(
            NUM_ENVS, length, jex)
    out = []
    for rec, ended in steps:
        rec = {k: jnp.asarray(v) for k, v in rec.items()}
        if acc is None:
            ring = ring.add_batch(rec)
        else:
            acc, ring = acc.add_step(ring, rec, jnp.asarray(ended))
        out.append(ring)
    return out


@pytest.fixture(scope="module")
def commit_results():
    cases = {name: (kind, cap, length, ring_steps(kind, i))
             for i, (name, (kind, cap, length)) in enumerate(sorted(RING_CASES.items()))}
    got = _dp_ranks.run_ranks(_dp_ranks.commit_rings, WORLD, cases)
    single = {name: _dp_ranks.feed_ring(*args) for name, args in cases.items()}
    return cases, got, single


@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_two_rank_commit_equals_jax(name, commit_results):
    cases, got, single = commit_results
    kind, cap, length, steps = cases[name]
    ranks = [g[name] for g in got]
    rows = [dp.owned_rows(cap, r, WORLD) for r in range(WORLD)]
    wrapped = False
    for t, want in enumerate(jax_rings(kind, cap, length, steps)):
        snaps = [r["snaps"][t] for r in ranks]
        for k in ("obs", "action", "done"):
            local = [s["data"][k] for s in snaps]
            # every rank: its rows, and a scratch row on the episode and
            # sequence rings
            assert [len(x) for x in local] == [n + (kind != "transition") for n in rows]
            union = np.stack([local[i % WORLD][i // WORLD] for i in range(cap)])
            np.testing.assert_array_equal(union, np.asarray(want.data[k])[:cap],
                                          err_msg=f"{k} after step {t}")
        if kind == "episode":
            union = [snaps[i % WORLD]["length"][i // WORLD] for i in range(cap)]
            np.testing.assert_array_equal(union, np.asarray(want.length)[:cap])
        for s in snaps:       # global host counters, equal on both ranks
            assert (s["cursor"], s["size"]) == (int(want.cursor), int(want.size))
            assert s["counts"] == single[name]["snaps"][t]["counts"]
        wrapped |= snaps[0]["size"] == cap and snaps[0]["cursor"] > 0
    assert wrapped
    # each rank's rows of the sample are the single-process sample's
    for r, rank in enumerate(ranks):
        for a, b in zip(jax.tree.leaves(rank["sample"]),
                        jax.tree.leaves(single[name]["sample"])):
            np.testing.assert_array_equal(a, b[r::WORLD])


# ---------------------------------------------------------------------------
# one update per family against the JAX package's single-device update
# ---------------------------------------------------------------------------

H = 16


def perturbed(tree, key):
    leaves, tdef = jax.tree.flatten(tree)
    keys = jax.random.split(key, len(leaves))
    return jax.tree.unflatten(tdef, [p + 0.05 * jax.random.normal(k, p.shape)
                                     for p, k in zip(leaves, keys)])


def twice(make):
    """A batch of twice the rows of the ``make()`` of a port test file."""
    (b0, m0), (b1, m1) = make(), make()
    return ({k: np.concatenate([b0[k], b1[k]]) for k in b0},
            None if m0 is None else np.concatenate([m0, m1]))


def jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def qmix_job(seed=1):
    kw = dict(env_type="mpe", env_name="simple_spread_v3", hidden_dim=H, hyper_dim=H,
              embed_dim=8, learning_rate=3e-3, normalize_reward=True)
    env = registry.make("mpe", "simple_spread_v3", agent_ids=True, device="cpu")
    jcfg = jqmix.QMIXConfig(**kw)
    k = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = {"q": jnets.mlp_init(k[0], env.obs_dim, H, env.n_actions),
              "mixer": jnets.mixer_init(k[1], env.n_agents, env.state_dim, 8, H)}
    target = perturbed(params, k[2])
    opt = jmake_optimizer("adam", jcfg.learning_rate, jcfg.clip_gradients).init(params)
    update = jax.jit(functools.partial(tqmix.jax_update, jcfg))
    rng = np.random.RandomState(seed)
    b0, m0 = tqmix.make_batch(rng, env, False)
    params, opt, _, _ = update(params, target, opt, jb(b0), jnp.asarray(m0))
    b1, m1 = tqmix.make_batch(rng, env, False)
    p, _, loss, gnorm = update(params, target, opt, jb(b1), jnp.asarray(m1))
    start = dict(params=np_tree(params), target_params=np_tree(target), opt_state=port_opt(opt))
    return ("qmix", kw, start, b1, m1, None), (np_tree(p), [loss, gnorm])


def vdn_job(seed=2):
    kw = dict(env_type="mpe", env_name="simple_spread_v3", hidden_dim=H, learning_rate=3e-3,
              batch_size=4, num_envs=8, clip_gradients=2.0, normalize_reward=True)
    env = registry.make("mpe", "simple_spread_v3", agent_ids=True, device="cpu")
    jcfg = jvdn.VDNConfig(**kw)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = jnets.mlp_init(k1, env.obs_dim, H, env.n_actions)
    target = perturbed(params, k2)
    opt = jmake_optimizer("adam", jcfg.learning_rate, jcfg.clip_gradients).init(params)
    update = jax.jit(functools.partial(tvdn.jax_update, jcfg))
    rng = np.random.RandomState(seed)

    def rows():
        rec = tvdn.make_transitions(rng, 32)
        rec["next_avail"][..., 1] = True          # as tvdn.to_port and to_jax
        return rec
    params, opt, _, _ = update(params, target, opt, tvdn.to_jax(rows()))
    rec = rows()
    p, _, loss, gnorm = update(params, target, opt, tvdn.to_jax(rec))
    start = dict(params=np_tree(params), target_params=np_tree(target), opt_state=port_opt(opt))
    return ("vdn", kw, start, rec, None, None), (np_tree(p), [loss, gnorm])


def recq_job(seq, seed):
    kw = dict(env_type="smaclite", env_name="3m", hidden_dim=H, hyper_dim=H, embed_dim=8,
              learning_rate=3e-3, seq_length=trq.L, normalize_reward=True,
              **(dict(mixing="vdn", replay="sequence", burn_in=3) if seq else
                 dict(mixing="qmix")))
    env = registry.make("smaclite", "3m", agent_ids=True, device="cpu")
    jcfg = jrq.RecurrentQConfig(**kw)
    params, target, opt = trq.start(jcfg, env, seed)
    rng = np.random.RandomState(seed)
    steps = trq.L if seq else trq.T

    def batch():
        mask = (np.arange(trq.T)[None] < rng.randint(1, trq.T + 1, (trq.B, 1)))
        return trq.make_batch(rng, env, steps), mask.astype(np.float32)
    if seq:
        update = jax.jit(functools.partial(trq.jax_update_seq, jcfg))
        params, opt, _, _ = update(params, target, opt, jb(twice(batch)[0]))
        b1, m1 = twice(batch)[0], None
        p, _, loss, gnorm = update(params, target, opt, jb(b1))
    else:
        update = jax.jit(functools.partial(trq.jax_update, jcfg))
        b0, m0 = twice(batch)
        params, opt, _, _ = update(params, target, opt, jb(b0), jnp.asarray(m0))
        b1, m1 = twice(batch)
        p, _, loss, gnorm = update(params, target, opt, jb(b1), jnp.asarray(m1))
    start = dict(params=np_tree(params), target_params=np_tree(target), opt_state=port_opt(opt))
    return ("recq", kw, start, b1, m1, None), (np_tree(p), [loss, gnorm])


def actor_critic_job(family, seed):
    """MADDPG with a GRU actor, or FACMAC, on speaker-listener."""
    test, jmod = {"maddpg": (tmaddpg, jmaddpg), "facmac": (tfacmac, jfacmac)}[family]
    kw = dict(env_type="mpe", env_name="simple_speaker_listener_v4", actor_hidden_dim=H,
              critic_hidden_dim=H, learning_rate_actor=3e-3, learning_rate_critic=3e-3,
              normalize_reward=True)
    kw.update(dict(recurrent=True, gumbel_tau=0.8) if family == "maddpg" else
              dict(hyper_dim=H, embed_dim=8))
    env = registry.make("mpe", "simple_speaker_listener_v4", agent_ids=True, device="cpu")
    jcfg = (jmod.MADDPGConfig if family == "maddpg" else jmod.FACMACConfig)(**kw)
    state = test.start(jcfg, env, seed)
    rng = np.random.RandomState(seed)
    args = (jcfg, env) if family == "maddpg" else (jcfg,)
    update = jax.jit(functools.partial(test.jax_update, *args))
    keys = jax.random.split(jax.random.PRNGKey(seed + 10), 4)
    T = env.episode_limit
    b0, m0 = twice(lambda: test.make_batch(rng, env, T))
    state, _ = update(state, jb(b0), jnp.asarray(m0), (keys[0], keys[1]))
    b1, m1 = twice(lambda: test.make_batch(rng, env, T))
    want_state, want = update(state, jb(b1), jnp.asarray(m1), (keys[2], keys[3]))
    noise = tuple(np.array(jax.random.gumbel(k, b1["action"].shape)) for k in keys[2:])
    actor, critic, tgt_actor, tgt_critic, a_opt, c_opt = state
    start = dict(actor_params=np_tree(actor), critic_params=np_tree(critic),
                 target_actor=np_tree(tgt_actor), target_critic=np_tree(tgt_critic),
                 actor_opt=port_opt(a_opt), critic_opt=port_opt(c_opt))
    return (family, kw, start, b1, m1, noise), (
        (np_tree(want_state[0]), np_tree(want_state[1])), list(want))


UPDATE_JOBS = {
    "qmix_normalize": qmix_job,
    "vdn_normalize_clip": vdn_job,
    "recurrent_qmix_episode": functools.partial(recq_job, False, 3),
    "recurrent_vdn_sequence": functools.partial(recq_job, True, 4),
    "maddpg_gru_actor": functools.partial(actor_critic_job, "maddpg", 5),
    "facmac": functools.partial(actor_critic_job, "facmac", 6),
}


@pytest.fixture(scope="module")
def update_results():
    jobs, want = {}, {}
    for name, make in UPDATE_JOBS.items():
        jobs[name], want[name] = make()
    got = _dp_ranks.run_ranks(_dp_ranks.offpolicy_updates, WORLD, jobs)
    return want, got


@pytest.mark.parametrize("name", sorted(UPDATE_JOBS))
def test_two_rank_update_matches_jax(name, update_results):
    want, got = update_results
    params, metrics = want[name]
    ranks = [g[name] for g in got]
    np.testing.assert_allclose(ranks[0]["metrics"], [float(m) for m in metrics], **TOL)
    if "actor" in ranks[0]:
        close_trees(ranks[0]["actor"], params[0], "actor")
        close_trees(ranks[0]["critic"], params[1], "critic")
    else:
        close_trees(ranks[0]["params"], params, "params")
        assert ranks[0]["count"] == 2
    for r in ranks[1:]:                 # one step on every rank: identical params
        same_trees({k: v for k, v in r.items() if k != "collectives"},
                   {k: v for k, v in ranks[0].items() if k != "collectives"})
    assert ranks[0]["collectives"] > 0
