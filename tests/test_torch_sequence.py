"""Port parity: the sequence-chunk replay of ``cleanmarl_tpu_torch``
(``buffers/sequence.py``) against the JAX package, on the CPU.

- the storage cases of ``tests/test_sequence_buffer.py`` on the port:
  full chunks, the back-fill patch, an episode that ends on a chunk
  boundary, a short first episode back-filled with zeros, the next
  episode after a patch, and several envs committing at once;
- a randomized stream of several envs with random episode ends, at two
  chunk lengths, through the JAX ``SequenceAccumulator`` and the port's
  until the ring wraps: rows ``[0, capacity)`` (row ``capacity`` is the
  scratch row, which nothing reads), ``cursor``, ``size``, ``t``, ``prev``
  and the counts ``add_step`` returns, all exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleanmarl_tpu.buffers.sequence import SequenceAccumulator as JAcc
from cleanmarl_tpu.buffers.sequence import SequenceBuffer as JRing
from cleanmarl_tpu_torch.buffers.sequence import SequenceAccumulator, SequenceBuffer

torch.set_num_threads(1)


def make_pair(num_envs=1, L=10, cap=64):
    example = {"x": torch.zeros(())}
    return (SequenceBuffer.create(cap, L, example),
            SequenceAccumulator.create(num_envs, L, example))


def feed(ring, acc, values, ended_at):
    """Stream scalar records for one env; its episode ends at the indices
    in ``ended_at`` (0-based)."""
    for i, v in enumerate(values):
        acc.add_step(ring, {"x": torch.tensor([float(v)])}, torch.tensor([i in ended_at]))


def rows(ring):
    return ring.data["x"][:ring.size].numpy()


def test_full_chunks_and_overlap_patch():
    # 25 steps, L = 10: [1..10], [11..20], then the patch back-fills from
    # the previous chunk → [16..25]
    ring, acc = make_pair()
    feed(ring, acc, range(1, 26), ended_at={24})
    got = rows(ring)
    assert got.shape == (3, 10)
    np.testing.assert_array_equal(got[0], np.arange(1, 11))
    np.testing.assert_array_equal(got[1], np.arange(11, 21))
    np.testing.assert_array_equal(got[2], np.arange(16, 26))


def test_exact_boundary_episode_stores_no_patch():
    ring, acc = make_pair()
    feed(ring, acc, range(1, 21), ended_at={19})
    got = rows(ring)
    assert got.shape == (2, 10)
    np.testing.assert_array_equal(got[1], np.arange(11, 21))
    assert int(acc.t[0]) == 0


def test_short_first_episode_backfills_zeros():
    ring, acc = make_pair()
    feed(ring, acc, [1, 2, 3], ended_at={2})
    got = rows(ring)
    assert got.shape == (1, 10)
    np.testing.assert_array_equal(got[0], [0, 0, 0, 0, 0, 0, 0, 1, 2, 3])


def test_next_episode_starts_fresh_after_patch():
    ring, acc = make_pair()
    feed(ring, acc, range(1, 26), ended_at={24})
    # a second episode of 12 steps: one full chunk [100..109], then the
    # patch back-fills from it: its tail [102..109] and [110, 111]
    feed(ring, acc, range(100, 112), ended_at={11})
    got = rows(ring)
    assert got.shape == (5, 10)
    np.testing.assert_array_equal(got[3], np.arange(100, 110))
    np.testing.assert_array_equal(got[4], list(range(102, 110)) + [110, 111])


def test_multi_env_commits_land_in_distinct_rows():
    ring, acc = make_pair(num_envs=3, L=4)
    for i in range(4):                       # all three envs fill a chunk at once
        n_new, n_ended = acc.add_step(
            ring, {"x": torch.tensor([10.0 + i, 20.0 + i, 30.0 + i])},
            torch.zeros(3, dtype=torch.bool))
    assert (n_new, n_ended) == (3, 0)
    got = rows(ring)
    assert got.shape == (3, 4)
    assert sorted(got[:, 0].tolist()) == [10.0, 20.0, 30.0]
    batch = ring.sample(torch.Generator().manual_seed(0), 64)
    assert batch["x"].shape == (64, 4)
    assert set(batch["x"][:, 0].tolist()) == {10.0, 20.0, 30.0}


@pytest.mark.parametrize("L", [4, 10])
def test_random_stream_matches_jax(L):
    num_envs, cap = 5, 7
    jex = {"obs": jnp.zeros((2, 3)), "action": jnp.zeros((2,), jnp.int32),
           "done": jnp.zeros((), jnp.bool_)}
    tex = {"obs": torch.zeros(2, 3), "action": torch.zeros(2, dtype=torch.int64),
           "done": torch.zeros((), dtype=torch.bool)}
    jring, jacc = JRing.create(cap, L, jex), JAcc.create(num_envs, L, jex)
    ring, acc = SequenceBuffer.create(cap, L, tex), SequenceAccumulator.create(
        num_envs, L, tex)
    rng = np.random.RandomState(L)
    wrapped = patched = False
    for step in range(6 * L):
        rec = {"obs": rng.randn(num_envs, 2, 3).astype(np.float32),
               "action": rng.randint(0, 5, (num_envs, 2)),
               "done": rng.rand(num_envs) < 0.5}
        ended = rng.rand(num_envs) < 0.2
        t_before = jacc.t
        jacc, jring = jacc.add_step(jring, {k: jnp.asarray(v) for k, v in rec.items()},
                                    jnp.asarray(ended))
        n_new, n_ended = acc.add_step(ring, {k: torch.as_tensor(v) for k, v in rec.items()},
                                      torch.as_tensor(ended))
        assert n_ended == int(ended.sum())
        assert n_new == int(((np.asarray(t_before) + 1 == L) | ended).sum())
        for k in rec:
            np.testing.assert_array_equal(ring.data[k][:cap].numpy(),
                                          np.asarray(jring.data[k][:cap]), err_msg=k)
            np.testing.assert_array_equal(acc.prev[k].numpy(), np.asarray(jacc.prev[k]),
                                          err_msg=k)
        np.testing.assert_array_equal(acc.t.numpy(), np.asarray(jacc.t))
        assert (ring.cursor, ring.size) == (int(jring.cursor), int(jring.size))
        wrapped |= ring.size == cap and ring.cursor > 0
        patched |= bool((ended & (np.asarray(t_before) + 1 < L)).any())
    assert wrapped and patched
