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
    # (shape, ended probability, gamma, lam) — the JAX kernel's own cases
    "small_7x5x3": ((7, 5, 3), 0.2, 0.97, 0.9),
    "padded_25x130": ((25, 130), 0.0, 0.99, 0.95),
    "ends_12x33": ((12, 33), 0.3, 0.99, 0.95),
}


def _inputs(shape, p_end, seed):
    rng = np.random.RandomState(seed)
    r = rng.randn(*shape).astype(np.float32)
    e = rng.rand(*shape) < p_end
    v = rng.randn(*shape).astype(np.float32)
    b = rng.randn(*shape[1:]).astype(np.float32)
    return r, e, v, b


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("ref", ["scan", "pallas"])
def test_lambda_returns_matches_jax(case, ref):
    shape, p_end, gamma, lam = CASES[case]
    r, e, v, b = _inputs(shape, p_end, seed=len(case))
    if ref == "scan":
        want = jret.lambda_returns(jnp.asarray(r), jnp.asarray(e), jnp.asarray(v),
                                   jnp.asarray(b), gamma, lam, use_pallas=False)
    else:
        want = lambda_returns_pallas(jnp.asarray(r), jnp.asarray(e), jnp.asarray(v),
                                     jnp.asarray(b), gamma, lam)
    got = tret.lambda_returns(*_t(r, e, v, b), gamma, lam)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lambda_advantages_matches_jax(case):
    shape, p_end, gamma, lam = CASES[case]
    r, e, v, b = _inputs(shape, p_end, seed=7)
    g_want, a_want = jret.lambda_advantages(
        jnp.asarray(r), jnp.asarray(e), jnp.asarray(v), jnp.asarray(b), gamma, lam)
    g, a = tret.lambda_advantages(*_t(r, e, v, b), gamma, lam)
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
