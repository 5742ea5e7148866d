"""Port parity: ``cleanmarl_tpu_torch.core.optim`` against optax (through
the JAX package's ``make_optimizer``), on the same gradients, params to
atol=1e-6 (float32 arithmetic in both; the bias corrections are computed
the same way).

- ``adam``: 5 updates, with and without clip and anneal, on the small
  tree; its update is also held bitwise against a frozen copy of the
  port's Adam from before the optimizers became transform chains;
- every other name: 5 updates on the tree with one 128 x 128 leaf (the
  one Adafactor factors), ``plain`` and ``clip_anneal`` (clip only for the
  names optax refuses under a schedule), and RAdam's rectified steps over
  12 updates;
- each name's optax state converted after 2 updates, then 3 more in both;
- ``noisy_sgd`` by its distribution: (noisy − sgd) / −lr has the variance
  eta / (1 + count)^gamma in both packages, over a 128 x 128 leaf; the same
  count draws the same noise;
- the refusals, each also a failure of the JAX package.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cleanmarl_tpu.core.optim import make_optimizer as jax_make_optimizer
from cleanmarl_tpu_torch.core.networks import global_norm
from cleanmarl_tpu_torch.core.optim import NO_SCHEDULE, SUPPORTED, make_optimizer
from cleanmarl_tpu_torch.core.params import (
    from_numpy_tree, opt_state_from_numpy, tree_leaves, tree_map,
)

torch.set_num_threads(1)
ATOL = 1e-6
OTHERS = sorted(set(SUPPORTED) - {"adam", "noisy_sgd"})


def _params(rng):
    return {"layers": [{"w": rng.randn(5, 4), "b": rng.randn(4)}],
            "head": {"w": rng.randn(4, 3), "b": np.zeros(3)}}


def _wide_params(rng):
    """The small tree and one 128 x 128 leaf, which Adafactor factors."""
    return dict(_params(rng), wide=0.1 * rng.randn(128, 128))


def _grads(rng, params, scale):
    return jax.tree.map(lambda p: (rng.randn(*p.shape) * scale).astype(np.float32),
                        params)


def _jax_optimizer(name, lr, clip, anneal):
    with warnings.catch_warnings():      # optimistic_adam and noisy_sgd warn
        warnings.simplefilter("ignore")
        return jax_make_optimizer(name, lr, clip, anneal)


def _np_state(state):
    """An optax state as numpy (a PRNG key as its key data)."""
    def leaf(x):
        if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
            return np.asarray(jax.random.key_data(x))
        return np.asarray(x)
    return jax.tree.map(leaf, state)


def _run_both(name, clip, anneal, steps, params_fn, seed=0, lr=3e-3):
    """``steps`` updates in both packages from the same params and
    gradients → per step, (port params, JAX params) as numpy."""
    rng = np.random.RandomState(seed)
    p_np = jax.tree.map(lambda x: x.astype(np.float32), params_fn(rng))
    jopt = _jax_optimizer(name, lr, clip, anneal)
    topt = make_optimizer(name, lr, clip, anneal)
    jp = jax.tree.map(jnp.asarray, p_np)
    js = jopt.init(jp)
    tp = from_numpy_tree(p_np, "cpu")
    ts = topt.init(tp)
    out = []
    for step in range(steps):
        g = _grads(rng, p_np, scale=1.0 if step % 2 else 0.05)
        upd, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = topt.update(from_numpy_tree(g, "cpu"), ts, tp)
        out.append(([a.numpy() for a in tree_leaves(tp)],
                    [np.asarray(b) for b in jax.tree.leaves(jp)]))
    assert ts["count"] == steps
    return out


@pytest.mark.parametrize("clip,anneal", [(0.0, 0), (0.5, 0), (0.0, 4), (0.5, 4)],
                         ids=["adam", "clip", "anneal", "clip_anneal"])
def test_adam_matches_optax(clip, anneal):
    rng = np.random.RandomState(0)
    p_np = jax.tree.map(lambda x: x.astype(np.float32), _params(rng))
    jopt = jax_make_optimizer("adam", 3e-3, clip, anneal)
    topt = make_optimizer("adam", 3e-3, clip, anneal)
    jp = jax.tree.map(jnp.asarray, p_np)
    js = jopt.init(jp)
    tp = from_numpy_tree(p_np, "cpu")
    ts = topt.init(tp)
    for step in range(5):
        g = _grads(rng, p_np, scale=1.0 if step % 2 else 0.05)
        upd, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = topt.update(from_numpy_tree(g, "cpu"), ts, tp)
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                       err_msg=f"step {step}")
    assert ts["count"] == 5


def _frozen_adam_update(grads, state, params, learning_rate, clip, anneal_steps,
                        b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    """The port's ``Adam.update`` as it stood before the optimizers became
    transform chains, frozen here: Adam's numbers must not move."""
    if clip:
        norm = global_norm(grads)
        grads = tree_map(lambda g: torch.where(norm < clip, g, (g / norm) * clip), grads)
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
    nu = tree_map(lambda g, v: (1 - b2) * (g ** 2) + b2 * v, grads, state["nu"])
    count = state["count"] + 1
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
    lr = np.float32(learning_rate)
    if anneal_steps:
        c = np.float32(min(max(state["count"], 0), anneal_steps))
        lr = lr * (np.float32(1.0) - c / np.float32(anneal_steps))
    lr = float(lr)
    new_params = tree_map(
        lambda p, m, v: p + (-lr) * ((m / bc1) / (torch.sqrt(v / bc2 + eps_root) + eps)),
        params, mu, nu)
    return new_params, {"count": count, "mu": mu, "nu": nu}


@pytest.mark.parametrize("clip,anneal", [(0.0, 0), (0.5, 4)], ids=["plain", "clip_anneal"])
def test_adam_bitwise_as_before(clip, anneal):
    rng = np.random.RandomState(3)
    p = from_numpy_tree(jax.tree.map(lambda x: x.astype(np.float32), _wide_params(rng)), "cpu")
    opt = make_optimizer("adam", 3e-3, clip, anneal)
    s = opt.init(p)
    assert sorted(s) == ["count", "mu", "nu"]
    fp, fs = p, s
    for step in range(5):
        g = from_numpy_tree(_grads(rng, p, 1.0 if step % 2 else 0.05), "cpu")
        p, s = opt.update(g, s, p)
        fp, fs = _frozen_adam_update(g, fs, fp, 3e-3, clip, anneal)
        for a, b in zip(tree_leaves((p, s)), tree_leaves((fp, fs))):
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


@pytest.mark.parametrize("case", ["plain", "clip_anneal"])
@pytest.mark.parametrize("name", OTHERS)
def test_optimizer_matches_optax(name, case):
    clip, anneal = (0.0, 0) if case == "plain" else (0.5, 0 if name in NO_SCHEDULE else 4)
    for step, (got, want) in enumerate(_run_both(name, clip, anneal, 5, _wide_params)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=ATOL, err_msg=f"step {step}")


def test_radam_rectified_steps_match_optax():
    """ρ_t reaches RAdam's threshold 5 at the 6th update. From there optax
    computes ρ_t = ρ_∞ − 2t·b2^t / (1 − b2^t) as a difference of two
    numbers near 2000, so one float32 ulp of b2^t (XLA's ``pow`` is not
    correctly rounded; the port's host ``np.float32`` power is) moves the
    rectifier r by up to 0.6 %. Held: the same updates are rectified, and
    every step p_t − p_{t−1} agrees with optax's within 1 % of its size."""
    runs = _run_both("radam", 0.0, 0, 12, _wide_params)
    prev_got, prev_want = runs[0]
    for step, (got, want) in enumerate(runs[1:], start=1):
        for a, b, pa, pb in zip(got, want, prev_got, prev_want):
            da, db = a - pa, b - pb
            np.testing.assert_allclose(da, db, rtol=0.0, atol=0.01 * np.abs(db).max() + 1e-9,
                                       err_msg=f"step {step}")
        prev_got, prev_want = got, want


@pytest.mark.parametrize("name", SUPPORTED)
def test_optax_state_carries_across(name):
    """Two optax steps, convert the state, three more in both."""
    clip, anneal = (1.0, 0) if name in NO_SCHEDULE else (1.0, 10)
    rng = np.random.RandomState(1)
    p_np = jax.tree.map(lambda x: x.astype(np.float32), _wide_params(rng))
    jopt = _jax_optimizer(name, 1e-3, clip, anneal)
    jp = jax.tree.map(jnp.asarray, p_np)
    js = jopt.init(jp)
    for _ in range(2):
        upd, js = jopt.update(jax.tree.map(jnp.asarray, _grads(rng, p_np, 1.0)), js, jp)
        jp = optax.apply_updates(jp, upd)
    topt = make_optimizer(name, 1e-3, clip, anneal)
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    # count= is what optax keeps no count for without a schedule (rmsprop,
    # sgd, ...); where it keeps one, the conversion holds the two equal
    ts = opt_state_from_numpy(_np_state(js), "cpu", name, count=2)
    assert ts["count"] == 2
    assert sorted(ts) == sorted(topt.init(tp))
    if name == "noisy_sgd":
        # JAX's noise stream is not the port's: the count carried across
        # draws the port's own noise of update 3
        g = from_numpy_tree(_grads(rng, p_np, 2.0), "cpu")
        fresh = dict(topt.init(tp), count=2)
        a, _ = topt.update(g, ts, tp)
        b, _ = topt.update(g, fresh, tp)
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
        return
    for _ in range(3):
        g = _grads(rng, p_np, 2.0)
        upd, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = topt.update(from_numpy_tree(g, "cpu"), ts, tp)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_optax_state_count_rules():
    """Without a schedule rmsprop's optax state keeps no count: the caller
    passes it. A count that contradicts optax's is refused."""
    p = {"w": jnp.ones((3, 2))}
    rms = _jax_optimizer("rmsprop", 1e-3, 0.0, 0)
    with pytest.raises(ValueError, match="count="):
        opt_state_from_numpy(jax.tree.map(np.asarray, rms.init(p)), "cpu", "rmsprop")
    adam = _jax_optimizer("adam", 1e-3, 0.0, 0)
    with pytest.raises(ValueError, match="counts 0 updates"):
        opt_state_from_numpy(jax.tree.map(np.asarray, adam.init(p)), "cpu", "adam", count=3)


def test_noisy_sgd_by_distribution():
    """(noisy_sgd − sgd) / −lr, from the same params and gradients at
    count c, has the variance eta / (1 + c)^gamma (eta 0.01, gamma 0.55) in
    both packages: within 5 % over 16,384 entries (the sample variance's
    standard error is 1.1 %). The port draws the same noise for the same
    count, and other noise for another."""
    lr, eta, gamma = 1e-2, 0.01, 0.55
    rng = np.random.RandomState(2)
    p_np = {"w": rng.randn(128, 128).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = from_numpy_tree(p_np, "cpu")
    jn, js_ = _jax_optimizer("noisy_sgd", lr, 0.0, 0), _jax_optimizer("sgd", lr, 0.0, 0)
    tn, ts_ = make_optimizer("noisy_sgd", lr), make_optimizer("sgd", lr)
    jn_state, tn_state = jn.init(jp), tn.init(tp)
    js_state, ts_state = js_.init(jp), ts_.init(tp)
    draws = []
    for c in range(3):
        g = _grads(rng, p_np, 1.0)
        want = eta / (1 + c) ** gamma
        u_noisy, jn_state = jn.update(jax.tree.map(jnp.asarray, g), jn_state, jp)
        u_plain, js_state = js_.update(jax.tree.map(jnp.asarray, g), js_state, jp)
        jax_noise = (np.asarray(u_noisy["w"]) - np.asarray(u_plain["w"])) / -lr
        again = dict(tn_state)
        new_noisy, tn_state = tn.update(from_numpy_tree(g, "cpu"), tn_state, tp)
        new_plain, ts_state = ts_.update(from_numpy_tree(g, "cpu"), ts_state, tp)
        port_noise = ((new_noisy["w"] - new_plain["w"]) / -lr).numpy()
        for noise in (jax_noise, port_noise):
            assert abs(noise.var() / want - 1.0) < 0.05, (c, noise.var(), want)
            assert abs(noise.mean()) < 5 * np.sqrt(want / noise.size)
        repeat, _ = tn.update(from_numpy_tree(g, "cpu"), again, tp)
        assert torch.equal(repeat["w"], new_noisy["w"])
        draws.append(port_noise)
    assert abs(np.corrcoef(draws[0].ravel(), draws[1].ravel())[0, 1]) < 0.05


def _jax_refuses(name, anneal):
    """True if the JAX package fails to build, init or take one update."""
    p = {"w": jnp.ones((3, 2))}
    try:
        opt = _jax_optimizer(name, 1e-3, 0.0, anneal)
        s = opt.init(p)
        opt.update({"w": jnp.ones((3, 2))}, s, p)
    except Exception:               # ValueError, TypeError: whatever optax raises
        return True
    return False


@pytest.mark.parametrize("name,anneal", [("adamz", 0), ("lbfgs", 0), ("polyak_sgd", 0),
                                         ("optimistic_adam", 10), ("rprop", 10),
                                         ("sm3", 10)])
def test_refusals_match_the_jax_package(name, anneal):
    match = {"adamz": "supported: adam", "lbfgs": "loss value",
             "polyak_sgd": "loss value"}.get(name, "constant learning rate")
    with pytest.raises(ValueError, match=match):
        make_optimizer(name, 1e-3, 0.0, anneal)
    assert _jax_refuses(name, anneal)
    if anneal:                      # the same name trains without the schedule
        assert not _jax_refuses(name, 0)
        make_optimizer(name, 1e-3, 0.0, 0)
