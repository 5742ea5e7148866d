"""Port parity: λ-returns, advantages and n-step returns of
``cleanmarl_tpu_torch.ops`` against the JAX package (its scan form and
its Pallas kernel, run in interpret mode on the CPU).

Tolerance rtol=2e-5, atol=1e-5: the recursion is float32 in both
packages and only the rounding of the fused products differs (the same
tolerance the JAX package holds its own kernel to).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleanmarl_tpu.ops import returns as jret
from cleanmarl_tpu.ops.pallas_returns import lambda_returns_pallas
from cleanmarl_tpu_torch.ops import returns as tret

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=1e-5)

CASES = {
    # (shape, ended probability, gamma, lam, per-env inputs) — the JAX
    # kernel's own cases, then the MAPPO update's layouts: "team" draws the
    # reward and ended flag one per env and broadcasts them over the trailing
    # agent axis as algos/ppo_common.py:ppo_update does
    # (x[..., None].expand(values.shape)); "central" also the centralized
    # critic's value and bootstrap (ppo_common.py:critic_values)
    "small_7x5x3": ((7, 5, 3), 0.2, 0.97, 0.9, ()),
    "padded_25x130": ((25, 130), 0.0, 0.99, 0.95, ()),
    "ends_12x33": ((12, 33), 0.3, 0.99, 0.95, ()),
    "team_12x33x3": ((12, 33, 3), 0.2, 0.99, 0.95, ("r", "e")),
    "central_12x33x3": ((12, 33, 3), 0.2, 0.99, 0.95, ("r", "e", "v", "b")),
}


def _inputs(shape, p_end, seed, per_env=()):
    """numpy r, e, V (shape) and bootstrap (shape[1:]); an input named in
    ``per_env`` lacks the trailing agent axis."""
    rng = np.random.RandomState(seed)

    def cut(name, s):
        return s[:-1] if name in per_env else s
    r = rng.randn(*cut("r", shape)).astype(np.float32)
    e = rng.rand(*cut("e", shape)) < p_end
    v = rng.randn(*cut("v", shape)).astype(np.float32)
    b = rng.randn(*cut("b", shape[1:])).astype(np.float32)
    return r, e, v, b


def _j(shape, *xs):
    """JAX inputs: each broadcast to its full shape."""
    full = (shape, shape, shape, shape[1:])
    return [jnp.asarray(np.broadcast_to(x if x.shape == s else x[..., None], s))
            for x, s in zip(xs, full)]


def _t(*xs, shape=None):
    """Port inputs; with ``shape``, a per-env input is broadcast over the
    agents as a view (``x[..., None].expand``), as the MAPPO update does."""
    ts = [torch.as_tensor(x) for x in xs]
    if shape is None:
        return ts
    full = (shape, shape, shape, shape[1:])
    return [x if tuple(x.shape) == s else x[..., None].expand(s) for x, s in zip(ts, full)]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("ref", ["scan", "pallas"])
def test_lambda_returns_matches_jax(case, ref):
    shape, p_end, gamma, lam, per_env = CASES[case]
    xs = _inputs(shape, p_end, seed=len(case), per_env=per_env)
    if ref == "scan":
        want = jret.lambda_returns(*_j(shape, *xs), gamma, lam, use_pallas=False)
    else:
        want = lambda_returns_pallas(*_j(shape, *xs), gamma, lam)
    got = tret.lambda_returns(*_t(*xs, shape=shape), gamma, lam)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lambda_advantages_matches_jax(case):
    shape, p_end, gamma, lam, per_env = CASES[case]
    xs = _inputs(shape, p_end, seed=7, per_env=per_env)
    g_want, a_want = jret.lambda_advantages(*_j(shape, *xs), gamma, lam)
    g, a = tret.lambda_advantages(*_t(*xs, shape=shape), gamma, lam)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_want), **TOL)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_want), **TOL)


@pytest.mark.parametrize("n", [1, 3])
def test_nstep_returns_matches_jax(n):
    r, e, v, b = _inputs((9, 4, 3), 0.25, seed=n)
    want = jret.nstep_returns(jnp.asarray(r), jnp.asarray(e), jnp.asarray(v),
                              jnp.asarray(b), 0.99, n)
    got = tret.nstep_returns(*_t(r, e, v, b), 0.99, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_nstep_rejects_zero():
    r, e, v, b = _t(*_inputs((3, 2), 0.0, seed=0))
    with pytest.raises(ValueError):
        tret.nstep_returns(r, e, v, b, 0.99, 0)
