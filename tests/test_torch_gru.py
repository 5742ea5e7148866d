"""Port parity: the recurrent core (``rnn_seq_apply`` on the scan route
and on the kernel route, whose CPU path runs the kernels' plain versions
through the hand-written backward) against the JAX package's
``rnn_seq_apply`` on its ``xla`` scan and its Pallas kernel (interpret
mode on the CPU), with JAX params copied across.

Tolerances are the JAX package's own kernel tests': values 1e-5, grads
2e-4 (float32 recurrences summed in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleanmarl_tpu.core import networks as jnets
from cleanmarl_tpu_torch.core import networks as tnets
from cleanmarl_tpu_torch.core.params import from_numpy_tree, tree_leaves
from cleanmarl_tpu_torch.ops import gru_kernel

torch.set_num_threads(1)
VAL_TOL = 1e-5
GRAD_TOL = 2e-4


def _setup(T=7, B=4, n=3, in_dim=11, H=16, A=5, seed=0):
    params = jnets.rnn_init(jax.random.PRNGKey(seed), in_dim, H, A)
    rng = np.random.RandomState(seed)
    x = rng.randn(T, B, n, in_dim).astype(np.float32)
    h0 = (rng.randn(B, n, H) * 0.3).astype(np.float32)
    reset = rng.rand(T, B) < 0.3
    return params, x, h0, reset


def _jax_run(params, h0, x, reset, impl, tbptt=0):
    def f(p, h0_, x_):
        hf, out = jnets.rnn_seq_apply(p, h0_, x_, reset_seq=reset, tbptt=tbptt,
                                      impl=impl)
        return jnp.sum(out * out) + jnp.sum(hf), (hf, out)

    (val, (hf, out)), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(h0), jnp.asarray(x))
    return float(val), np.asarray(hf), np.asarray(out), jax.tree.map(np.asarray, grads)


def _torch_run(params, h0, x, reset, impl, tbptt=0):
    p = from_numpy_tree(jax.tree.map(np.asarray, params), "cpu")
    leaves = tree_leaves(p)
    for leaf in leaves:
        leaf.requires_grad_(True)
    h0_t = torch.tensor(h0, requires_grad=True)
    x_t = torch.tensor(x, requires_grad=True)
    reset_t = None if reset is None else torch.as_tensor(reset)
    hf, out = tnets.rnn_seq_apply(p, h0_t, x_t, reset_seq=reset_t, tbptt=tbptt,
                                  impl=impl)
    loss = torch.sum(out * out) + torch.sum(hf)
    grads = torch.autograd.grad(loss, leaves + [h0_t, x_t], allow_unused=True)
    grads = [np.zeros(t.shape, np.float32) if g is None else g.numpy()
             for g, t in zip(grads, leaves + [h0_t, x_t])]
    return float(loss.detach()), hf.detach().numpy(), out.detach().numpy(), grads


def _compare(jres, tres):
    jval, jhf, jout, jgrads = jres
    tval, thf, tout, tgrads = tres
    np.testing.assert_allclose(tout, jout, atol=VAL_TOL)
    np.testing.assert_allclose(thf, jhf, atol=VAL_TOL)
    np.testing.assert_allclose(tval, jval, rtol=VAL_TOL)
    jp, jh0, jx = jgrads
    # JAX leaves are in sorted-key order; the port keeps the same tree
    want = jax.tree.leaves(jp) + [jh0, jx]
    order = jax.tree_util.tree_flatten_with_path(jp)[0]
    names = [jax.tree_util.keystr(k) for k, _ in order] + ["h0", "x"]
    for name, a, b in zip(names, tgrads, want):
        np.testing.assert_allclose(a, b, atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("impl", ["scan", "kernel"])
@pytest.mark.parametrize("with_reset", [True, False], ids=["reset", "no_reset"])
def test_rnn_seq_apply_matches_jax(impl, jax_impl, with_reset):
    params, x, h0, reset = _setup()
    reset = reset if with_reset else None
    _compare(_jax_run(params, h0, x, reset, jax_impl),
             _torch_run(params, h0, x, reset, impl))


@pytest.mark.parametrize("impl", ["scan", "kernel"])
def test_padding_case_m3(impl):
    """M = 3 rows: the JAX kernel pads to 8; the port's kernels mask."""
    params, x, h0, _ = _setup(T=5, B=1, n=3, in_dim=9, H=8, A=4)
    h0 = np.zeros_like(h0)
    _compare(_jax_run(params, h0, x, None, "pallas"),
             _torch_run(params, h0, x, None, impl))


def test_tbptt_scan_matches_jax():
    params, x, h0, reset = _setup()
    _compare(_jax_run(params, h0, x, reset, "xla", tbptt=2),
             _torch_run(params, h0, x, reset, "scan", tbptt=2))


@pytest.mark.parametrize("kw", [dict(tbptt=2), dict(dtype=torch.bfloat16)],
                         ids=["tbptt", "bf16"])
def test_kernel_route_rejects_unsupported_modes(kw):
    p = tnets.rnn_init(torch.Generator().manual_seed(0), 4, 8, 3)
    x = torch.zeros(4, 8, 2, 4)
    h0 = torch.zeros(8, 2, 8)
    with pytest.raises(ValueError):
        tnets.rnn_seq_apply(p, h0, x, impl="kernel", **kw)
    with pytest.raises(ValueError):
        tnets.rnn_seq_apply(p, h0, x, impl="pallas", **kw)


def test_resolve_gru_impl_rule():
    r = tnets.resolve_gru_impl
    assert r("auto", 128, device="cuda") == "kernel"
    assert r("auto", 512, device="cuda") == "kernel"
    assert r("auto", 128, device="cpu") == "scan"
    assert r("auto", 128, tbptt=4, device="cuda") == "scan"
    assert r("auto", 128, bf16=True, device="cuda") == "scan"
    assert r("xla", 128, device="cuda") == "scan"
    assert r("pallas", 128, device="cpu") == "kernel"
    # widths the CUDA kernels refuse (hidden % 4 != 0, hidden > 512) take
    # the scan under auto on cuda; an explicit kernel still raises
    for h in (102, 1024, 6):
        assert r("auto", h, device="cuda") == "scan"
        assert r("kernel", h, device="cuda") == "kernel"
        with pytest.raises(ValueError):                     # ... and raises at launch
            gru_kernel._dims(h, torch.zeros(2, 3, 3 * h))
    for h in (8, 64, 96, 100, 256, 512):
        assert r("auto", h, device="cuda") == "kernel"
    with pytest.raises(ValueError):
        r("fast", 128)
