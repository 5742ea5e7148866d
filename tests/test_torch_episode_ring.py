"""The episode ring's successor pairs (``buffers/episode.py``): a ring and
an accumulator created with ``pairs={"next_obs": "obs", "next_state":
"state"}`` store each pair once, as a ``(rows, T_max + 1, ...)`` leaf.

- Fed records that obey the pairs' equality (``next_obs[t]`` is ``obs[t +
  1]`` unless the env's episode ended), with episodes that reach ``T_max``
  and a ring that wraps: every valid step of every field of ``data`` and
  ``store``, the lengths, ``cursor``, ``size``, the counts and a sample's
  valid steps and mask are bitwise an unpaired ring's; the fields' names,
  shapes and dtypes are the unpaired ring's. An episode that runs past
  ``T_max`` (the envs truncate at it, so none on the port's routes)
  differs in one step of each successor, which the layout cannot hold.
- The stored bytes follow the layout's formula, at the ``qmix_rnn_3m``
  cell's sizes too (built on the meta device: nothing is allocated); a
  ring without pairs keeps one ``(rows, T_max, ...)`` leaf a field.
- Pairs of another shape or dtype, of a field the record lacks, or with a
  field in two pairs, raise.
- ``shard``/``unshard`` and a checkpoint's ``to_state``/``from_state``
  (through ``torch.save``/``torch.load``) give the paired ring back
  bitwise; a ring of the unpaired layout's file is refused, naming the
  layouts' attributes; two gloo ranks' commit through ``dp.move_rows``
  is the single-process ring's.
- Recurrent QMIX on SMAClite 3m and QMIX on MPE spread, driven on a paired
  ring and on an unpaired one from the same generator: the same losses,
  parameters, targets and host counters, bitwise.

Imports neither JAX nor the JAX package.
"""
import io

import numpy as np
import pytest
import torch

import _dp_ranks
from cleanmarl_tpu_torch.algos import qmix, recurrent_q
from cleanmarl_tpu_torch.buffers.episode import EpisodeAccumulator, EpisodeBuffer
from cleanmarl_tpu_torch.core.checkpoint import from_state, to_state
from cleanmarl_tpu_torch.core.driver import to_host
from cleanmarl_tpu_torch.core.params import tree_leaves
from cleanmarl_tpu_torch.envs import registry

torch.set_num_threads(1)

PAIRS = _dp_ranks.SUCCESSOR_PAIRS
NUM_ENVS, T_MAX, CAP = 5, 6, 7


def example():
    z = torch.zeros
    return {"obs": z(2, 3), "state": z(4), "action": z(2, dtype=torch.int64), "reward": z(()),
            "done": z((), dtype=torch.bool), "next_obs": z(2, 3), "next_state": z(4),
            "next_avail": z(2, 5, dtype=torch.bool)}


def steps(seed, n=40, num_envs=NUM_ENVS, past=False):
    """``n`` (record, ended) steps of numpy arrays (leading axis num_envs)
    that obey the pairs' equality: an env's next ``obs`` and ``state`` are
    its record's ``next_obs`` and ``next_state`` unless it ended. An episode
    ends at random or, as the envs truncate, at its ``T_MAX``-th step; env
    0's only there, or with ``past`` never, so that it runs past ``T_MAX``."""
    rng = np.random.RandomState(seed)

    def draw(*shape):
        return rng.randn(num_envs, *shape).astype(np.float32)
    obs, state, out = draw(2, 3), draw(4), []
    t = np.zeros(num_envs, np.int64)
    for _ in range(n):
        t += 1
        ended = (rng.rand(num_envs) < 0.3) | (t >= T_MAX)
        ended[0] = not past and t[0] >= T_MAX
        t[ended] = 0
        rec = {"obs": obs, "state": state,
               "action": rng.randint(0, 5, (num_envs, 2)).astype(np.int64),
               "reward": draw(), "done": rng.rand(num_envs) < 0.5,
               "next_obs": draw(2, 3), "next_state": draw(4),
               "next_avail": rng.rand(num_envs, 2, 5) < 0.7}
        out.append((rec, ended))
        reset_obs, reset_state = draw(2, 3), draw(4)
        obs = np.where(ended[:, None, None], reset_obs, rec["next_obs"])
        state = np.where(ended[:, None], reset_state, rec["next_state"])
    return out


def tensors(rec):
    return {k: torch.as_tensor(v) for k, v in rec.items()}


def valid(x, length):
    """The steps ``t < length`` of (rows, T_max, ...) ``x``, one row after
    another."""
    steps_ = torch.arange(x.shape[1])
    return x[steps_[None, :] < length[:, None]]


def assert_valid_same(got, want, length, what):
    assert got.keys() == want.keys(), what
    for k in want:
        a, b = got[k], want[k]
        assert (a.shape, a.dtype) == (b.shape, b.dtype), f"{what}: {k}"
        assert torch.equal(valid(a, length), valid(b, length)), f"{what}: {k}"


def stored_bytes(x):
    return sum(t.numel() * t.element_size() for t in tree_leaves(x.stored))


# ---------------------------------------------------------------------------
# the layout against the unpaired ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paired_ring_reads_as_the_unpaired_ring(seed):
    plain = EpisodeBuffer.create(CAP, T_MAX, example())
    plain_acc = EpisodeAccumulator.create(NUM_ENVS, T_MAX, example())
    ring = EpisodeBuffer.create(CAP, T_MAX, example(), pairs=PAIRS)
    acc = EpisodeAccumulator.create(NUM_ENVS, T_MAX, example(), pairs=PAIRS)
    assert set(ring.stored) == set(example()) - set(PAIRS)
    wrapped = full = False
    for t, (rec, ended) in enumerate(steps(seed)):
        ended = torch.as_tensor(ended)
        want = plain_acc.add_step(plain, tensors(rec), ended)
        assert acc.add_step(ring, tensors(rec), ended) == want, f"step {t}"
        assert (ring.cursor, ring.size, ring.t_max) == (plain.cursor, plain.size, T_MAX)
        assert torch.equal(ring.length, plain.length) and torch.equal(acc.t, plain_acc.t)
        assert_valid_same(ring.data, plain.data, ring.length, f"ring after step {t}")
        assert_valid_same(acc.store, plain_acc.store, acc.t, f"acc after step {t}")
        wrapped |= ring.size == CAP and ring.cursor > 0
        full |= bool((ring.length[:CAP] == T_MAX).any())
    assert wrapped and full
    for n in (3, 16):
        batch, mask = ring.sample(torch.Generator().manual_seed(seed), n)
        want_batch, want_mask = plain.sample(torch.Generator().manual_seed(seed), n)
        assert torch.equal(mask, want_mask)
        assert_valid_same(batch, want_batch, mask.sum(1).long(), f"sample of {n}")


def test_an_episode_past_t_max_differs_in_one_successor():
    """Past ``T_max`` (no env of the port's runs there: each truncates at
    its ``episode_limit``, the ring's ``T_max``) both layouts keep writing
    the last step; the paired leaf's step ``T_max - 1`` is then also
    ``next_obs[T_max - 2]``, which reads the latest ``obs``."""
    plain = EpisodeBuffer.create(CAP, T_MAX, example())
    plain_acc = EpisodeAccumulator.create(NUM_ENVS, T_MAX, example())
    ring = EpisodeBuffer.create(CAP, T_MAX, example(), pairs=PAIRS)
    acc = EpisodeAccumulator.create(NUM_ENVS, T_MAX, example(), pairs=PAIRS)
    recs = steps(4, 3 * T_MAX, past=True)
    for rec, ended in recs:
        for a, r in ((plain_acc, plain), (acc, ring)):
            a.add_step(r, tensors(rec), torch.as_tensor(ended))
    assert int(acc.t[0]) == T_MAX
    got, want = acc.store, plain_acc.store
    for k in example():
        cut = T_MAX - 2 if k in PAIRS else None
        a, b = got[k][0], want[k][0]
        keep = [i for i in range(T_MAX) if i != cut]
        assert torch.equal(a[keep], b[keep]), k
        if cut is not None:
            assert torch.equal(a[cut], torch.as_tensor(recs[-1][0][PAIRS[k]][0])), k
    assert_valid_same({k: v[1:] for k, v in got.items()},
                      {k: v[1:] for k, v in want.items()}, acc.t[1:], "the other envs")


def test_fields_names_shapes_and_dtypes_are_the_unpaired_rings():
    plain = EpisodeBuffer.create(CAP, T_MAX, example())
    ring = EpisodeBuffer.create(CAP, T_MAX, example(), pairs=PAIRS)
    acc = EpisodeAccumulator.create(NUM_ENVS, T_MAX, example(), pairs=PAIRS)
    want = {k: ((CAP + 1, T_MAX) + tuple(x.shape), x.dtype) for k, x in example().items()}
    assert {k: (tuple(x.shape), x.dtype) for k, x in ring.data.items()} == want
    assert {k: (tuple(x.shape), x.dtype) for k, x in plain.data.items()} == want
    assert {k: (tuple(x.shape[1:]), x.dtype) for k, x in acc.store.items()} == {
        k: (s[1:], d) for k, (s, d) in want.items()}
    batch, mask = ring.sample(torch.Generator().manual_seed(0), 4)
    assert {k: (tuple(x.shape), x.dtype) for k, x in batch.items()} == {
        k: ((4,) + s[1:], d) for k, (s, d) in want.items()}
    assert mask.shape == (4, T_MAX)
    # a pair's fields are the leaf's first and last T_max steps
    leaf = ring.stored["obs"]
    assert ring.data["obs"].data_ptr() == leaf.data_ptr()
    assert ring.data["next_obs"].data_ptr() == leaf[:, 1:].data_ptr()


def test_unpaired_ring_keeps_a_leaf_per_field():
    ring = EpisodeBuffer.create(CAP, T_MAX, example())
    acc = EpisodeAccumulator.create(NUM_ENVS, T_MAX, example())
    assert ring.pairs == {} and acc.pairs == {}
    assert ring.data is ring.stored and acc.store is acc.stored
    assert {k: tuple(x.shape[:2]) for k, x in ring.stored.items()} == {
        k: (CAP + 1, T_MAX) for k in example()}


def _layout_bytes(rows, t_max, ex, pairs):
    per = {k: x.numel() * x.element_size() for k, x in ex.items()}
    heads = set(pairs.values())
    return rows * sum(per[k] * (t_max + (k in heads)) for k in per if k not in pairs)


def test_stored_bytes_follow_the_layout():
    ring = EpisodeBuffer.create(CAP, T_MAX, example(), pairs=PAIRS)
    acc = EpisodeAccumulator.create(NUM_ENVS, T_MAX, example(), pairs=PAIRS)
    assert stored_bytes(ring) == _layout_bytes(CAP + 1, T_MAX, example(), PAIRS)
    assert stored_bytes(acc) == _layout_bytes(NUM_ENVS, T_MAX, example(), PAIRS)
    plain = EpisodeBuffer.create(CAP, T_MAX, example())
    assert stored_bytes(plain) == _layout_bytes(CAP + 1, T_MAX, example(), {})


def test_stored_bytes_at_the_qmix_cell():
    """``qmix_rnn_3m``'s record (3 agents, obs 30 + 3 ids, state 48, 9
    actions), 5,000 episodes of 150 steps and 64 envs, on the meta device."""
    env = registry.make("smaclite", "3m", agent_ids=True, device="cpu")
    n, A = env.n_agents, env.n_actions

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")
    rec = {"obs": z(n, env.obs_dim), "state": z(env.state_dim),
           "action": z(n, dtype=torch.int64), "reward": z(), "done": z(dtype=torch.bool),
           "next_obs": z(n, env.obs_dim), "next_state": z(env.state_dim),
           "next_avail": z(n, A, dtype=torch.bool)}
    T = env.episode_limit
    assert (T, n, env.obs_dim, env.state_dim, A) == (150, 3, 33, 48, 9)
    assert stored_bytes(EpisodeBuffer.create(5000, T, rec)) == 924_184_800
    assert stored_bytes(EpisodeBuffer.create(5000, T, rec, pairs=PAIRS)) == 486_037_188
    assert stored_bytes(EpisodeAccumulator.create(64, T, rec)) == 11_827_200
    assert stored_bytes(EpisodeAccumulator.create(64, T, rec, pairs=PAIRS)) == 6_220_032


@pytest.mark.parametrize("pairs, match", [
    ({"next_obs": "state"}, "next_obs.*is \\(2, 3\\).*'state' is \\(4,\\)"),
    ({"next_avail": "obs"}, "torch.bool"),
    ({"next_obs": "prev_obs"}, "no field 'prev_obs'"),
    ({"next_obs": "obs", "other_obs": "obs"}, "in two pairs"),
    ({"next_obs": "obs", "obs": "other_obs"}, "in two pairs"),
])
def test_pairs_that_do_not_fit_raise(pairs, match):
    ex = dict(example(), other_obs=torch.zeros(2, 3))
    if "next_avail" in pairs:
        ex["next_avail"] = torch.zeros(2, 3, dtype=torch.bool)
    for make in (lambda: EpisodeBuffer.create(CAP, T_MAX, ex, pairs=pairs),
                 lambda: EpisodeAccumulator.create(NUM_ENVS, T_MAX, ex, pairs=pairs)):
        with pytest.raises(ValueError, match=match):
            make()


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------

def fed(seed=0, n=40):
    ring = EpisodeBuffer.create(CAP, T_MAX, example(), pairs=PAIRS)
    acc = EpisodeAccumulator.create(NUM_ENVS - 1, T_MAX, example(), pairs=PAIRS)
    for rec, ended in steps(seed, n, NUM_ENVS - 1):
        acc.add_step(ring, tensors(rec), torch.as_tensor(ended))
    assert ring.size == CAP
    return ring, acc


def same_leaves(a, b):
    """Tensors of one dtype and shape, bit for bit; other leaves equal."""
    def same(x, y):
        if isinstance(x, torch.Tensor):
            return x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        return type(x) is type(y) and x == y
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(same(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("world", [2, 3])
def test_shard_and_unshard_of_a_paired_ring(world):
    ring, acc = fed()
    parts = [ring.shard(k, world) for k in range(world)]
    assert all(p.pairs == PAIRS and p.t_max == T_MAX for p in parts)
    back = EpisodeBuffer.unshard(parts)
    ring.stored = {k: torch.cat([x[:-1], torch.zeros_like(x[-1:])])
                   for k, x in ring.stored.items()}          # the scratch row comes back zero
    ring.length[-1] = 0
    assert back.pairs == PAIRS and same_leaves(back.stored, ring.stored)
    assert torch.equal(back.length, ring.length)
    assert (back.cursor, back.size, back.capacity) == (ring.cursor, ring.size, ring.capacity)
    acc_back = EpisodeAccumulator.unshard(
        [acc.shard(k, 2) for k in range(2)])
    assert acc_back.pairs == PAIRS and same_leaves(acc_back.stored, acc.stored)
    assert torch.equal(acc_back.t, acc.t)


def test_checkpoint_round_trip_of_a_paired_ring():
    ring, acc = fed(1)
    buf = io.BytesIO()
    torch.save(to_state({"ring": ring, "acc": acc}), buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    assert set(saved["ring"]) == {"stored", "pairs", "length", "cursor", "size", "capacity"}
    template = {"ring": EpisodeBuffer.create(CAP, T_MAX, example(), pairs=PAIRS),
                "acc": EpisodeAccumulator.create(NUM_ENVS - 1, T_MAX, example(), pairs=PAIRS)}
    got = from_state(template, saved)
    assert got["ring"].pairs == PAIRS and same_leaves(got["ring"].stored, ring.stored)
    assert same_leaves(got["ring"].data, ring.data)
    assert torch.equal(got["ring"].length, ring.length)
    assert (got["ring"].cursor, got["ring"].size) == (ring.cursor, ring.size)
    assert same_leaves(got["acc"].stored, acc.stored) and torch.equal(got["acc"].t, acc.t)
    # the restored views read the restored leaves
    got["ring"].stored["obs"][0, 1] = 7.0
    assert bool((got["ring"].data["next_obs"][0, 0] == 7.0).all())


def test_a_checkpoint_of_the_other_layout_is_refused():
    ring, _ = fed(2)
    # the unpaired layout's file: a ``data`` leaf for every field
    old = {"data": {k: v.clone() for k, v in ring.data.items()}, "length": ring.length,
           "cursor": ring.cursor, "size": ring.size, "capacity": ring.capacity}
    template = EpisodeBuffer.create(CAP, T_MAX, example(), pairs=PAIRS)
    with pytest.raises(ValueError, match=r"at runner: the file's EpisodeBuffer has the "
                                         r"attributes \['capacity', 'cursor', 'data', "
                                         r"'length', 'size'\], this one .*'pairs'.*'stored'"):
        from_state(template, old)
    # a paired file into a ring without pairs, and the other way round
    with pytest.raises(ValueError, match=r"runner\.stored: keys"):
        from_state(EpisodeBuffer.create(CAP, T_MAX, example()), to_state(ring))
    with pytest.raises(ValueError, match=r"runner\.stored: keys"):
        from_state(template, to_state(EpisodeBuffer.create(CAP, T_MAX, example())))


def test_two_rank_commit_of_a_paired_ring_is_the_single_process_ring():
    world, cap = 2, 7
    recs = steps(3, 30, 6)
    cases = {"paired": ("episode_paired", cap, T_MAX, recs)}
    got = _dp_ranks.run_ranks(_dp_ranks.commit_rings, world, cases)
    single = _dp_ranks.feed_ring(*cases["paired"])
    ranks = [g["paired"] for g in got]
    for t, want in enumerate(single["snaps"]):
        snaps = [r["snaps"][t] for r in ranks]
        for k in example():
            union = np.stack([snaps[i % world]["data"][k][i // world] for i in range(cap)])
            np.testing.assert_array_equal(union, want["data"][k][:cap], err_msg=f"{k}, {t}")
        union = [snaps[i % world]["length"][i // world] for i in range(cap)]
        np.testing.assert_array_equal(union, want["length"][:cap])
        for s in snaps:
            assert (s["cursor"], s["size"], s["counts"]) == (
                want["cursor"], want["size"], want["counts"])
    assert want["size"] == cap
    for r, rank in enumerate(ranks):
        for k in example():
            np.testing.assert_array_equal(rank["sample"][0][k], single["sample"][0][k][r::world])
        np.testing.assert_array_equal(rank["sample"][1], single["sample"][1][r::world])


# ---------------------------------------------------------------------------
# the whole loop on both layouts
# ---------------------------------------------------------------------------

_RQ = dict(env_type="smaclite", env_name="3m", mixing="qmix", num_envs=4, buffer_size=6,
           batch_size=4, log_interval=40, hidden_dim=8, hyper_dim=8, embed_dim=4,
           max_updates_per_iter=2, start_e=0.5, num_eval_ep=1, seed=0, verbose=False)
_QMIX = dict(env_type="mpe", env_name="simple_spread_v3", num_envs=4, buffer_size=6,
             batch_size=4, log_interval=25, hidden_dim=8, hyper_dim=8, embed_dim=4,
             max_updates_per_iter=2, num_eval_ep=1, seed=0, verbose=False)
LOOPS = {"qmix_rnn_3m": (recurrent_q, recurrent_q.RecurrentQConfig, _RQ, 3),
         "qmix_spread": (qmix, qmix.QMIXConfig, _QMIX, 3)}


def drive(name, paired, monkeypatch):
    """``blocks`` train blocks of ``name`` on a paired ring (as the
    algorithm builds it) or with the pairs dropped → (runner, [(loss,
    params, target)] after each block, [the blocks' host metrics])."""
    mod, cls, kw, blocks = LOOPS[name]
    with monkeypatch.context() as m:
        if not paired:
            for c in (EpisodeBuffer, EpisodeAccumulator):
                make = c.create
                m.setattr(c, "create", staticmethod(
                    lambda *a, _make=make, pairs=None, **k: _make(*a, **k)))
        init, train_block, _, _ = mod.make_train(cls(**kw, device="cpu"))
        runner = init(torch.Generator().manual_seed(5))
    assert runner.ring.pairs == (PAIRS if paired else {})
    out, metrics = [], []
    for _ in range(blocks):
        runner, mx = train_block(runner)
        metrics.append(to_host(mx))
        out.append((runner.last_loss.clone(), to_state(runner.params),
                    to_state(runner.target_params)))
    return runner, out, metrics


@pytest.mark.parametrize("name", sorted(LOOPS))
def test_training_on_a_paired_ring_is_bitwise_the_unpaired(name, monkeypatch):
    a, out_a, m_a = drive(name, True, monkeypatch)
    b, out_b, m_b = drive(name, False, monkeypatch)
    assert a.num_updates > 4 and a.ring.size == a.ring.capacity
    assert m_a == m_b
    for (la, pa, ta), (lb, pb, tb) in zip(out_a, out_b):
        assert torch.equal(la, lb)
        assert same_leaves(pa, pb) and same_leaves(ta, tb)
    assert same_leaves(to_state(a.opt_state), to_state(b.opt_state))
    assert (a.step, a.episodes, a.num_updates, a.update_debt) == (
        b.step, b.episodes, b.num_updates, b.update_debt)
    assert torch.equal(a.ring.length, b.ring.length)
    assert_valid_same(a.ring.data, b.ring.data, a.ring.length, f"{name}: the ring")
    # the padded steps differ (a paired row's obs[length] is the final
    # observation), and the masked update does not see them
    assert not torch.equal(a.ring.data["obs"], b.ring.data["obs"])
    assert_valid_same(a.acc.store, b.acc.store, a.acc.t, f"{name}: the accumulator")
