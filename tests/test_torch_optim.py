"""Port parity: ``cleanmarl_tpu_torch.core.optim`` against optax (through
the JAX package's ``make_optimizer``), 5 updates on the same gradients,
params to atol=1e-6 (float32 arithmetic in both; the bias corrections
are computed the same way)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cleanmarl_tpu.core.optim import make_optimizer as jax_make_optimizer
from cleanmarl_tpu_torch.core.optim import make_optimizer
from cleanmarl_tpu_torch.core.params import (
    from_numpy_tree, opt_state_from_numpy, tree_leaves,
)

torch.set_num_threads(1)
ATOL = 1e-6


def _params(rng):
    return {"layers": [{"w": rng.randn(5, 4), "b": rng.randn(4)}],
            "head": {"w": rng.randn(4, 3), "b": np.zeros(3)}}


def _grads(rng, params, scale):
    return jax.tree.map(lambda p: (rng.randn(*p.shape) * scale).astype(np.float32),
                        params)


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


def test_optax_state_carries_across():
    """Two optax steps, convert the state, three more in both."""
    rng = np.random.RandomState(1)
    p_np = jax.tree.map(lambda x: x.astype(np.float32), _params(rng))
    jopt = jax_make_optimizer("adam", 1e-3, 1.0, 10)
    jp = jax.tree.map(jnp.asarray, p_np)
    js = jopt.init(jp)
    for _ in range(2):
        upd, js = jopt.update(jax.tree.map(jnp.asarray, _grads(rng, p_np, 1.0)), js, jp)
        jp = optax.apply_updates(jp, upd)
    topt = make_optimizer("adam", 1e-3, 1.0, 10)
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert ts["count"] == 2
    for _ in range(3):
        g = _grads(rng, p_np, 2.0)
        upd, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = topt.update(from_numpy_tree(g, "cpu"), ts, tp)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_only_adam_is_ported():
    with pytest.raises(ValueError, match="not ported"):
        make_optimizer("sgd", 1e-3)
