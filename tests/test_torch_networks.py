"""The networks layer's writes over its own fresh temporaries
(``core/networks.py``): ``_affine`` adds the bias in place over the matmul
product, and ``_dense_relu`` writes the relu over that sum. At each site
that routes through them they give bitwise the outputs and every gradient
of ``matmul(x, w, dtype) + b`` and ``torch.relu``.

This file imports neither JAX nor the JAX package."""
import pytest
import torch

from cleanmarl_tpu_torch.core import networks as nets
from cleanmarl_tpu_torch.core.params import tree_leaves, tree_unflatten

torch.set_num_threads(1)

T, B, N, IN, H, A = 6, 4, 3, 11, 8, 5


def _out_of_place(x, w, b, dtype=None):
    return nets.matmul(x, w, dtype) + b


def _relu_out_of_place(params, x, dtype=None):
    return torch.relu(nets.dense(params, x, dtype))


def _site(name, dtype):
    """→ (params, inputs, f(params, *inputs) → a tuple of outputs)."""
    g = torch.Generator().manual_seed(len(name))
    x = torch.randn(T, B, N, IN, generator=g)
    if name == "dense":
        return (nets.dense_init(g, IN, H), [x],
                lambda p, x: (nets.dense(p, x, dtype),))
    if name == "mlp_apply":                # the critics: two hidden layers, a head
        params = nets.mlp_init(g, IN, H, 1, num_layers=1)
        for p in tree_leaves(params):
            p.add_(0.1 * torch.randn(p.shape, generator=g))
        return params, [x], lambda p, x: (nets.mlp_apply(p, x, dtype=dtype),)
    params = nets.rnn_init(g, IN, H, A, final_gain=0.5)
    for p in tree_leaves(params):          # zeros would hide a bias add gone wrong
        p.add_(0.1 * torch.randn(p.shape, generator=g))
    if name == "gru_input_proj":
        return params, [x], lambda p, x: (nets.gru_input_proj(p, x, dtype),)
    if name == "rnn_seq_apply":
        h0 = 0.5 * torch.randn(B, N, H, generator=g)
        reset = torch.rand(T, B, generator=g) < 0.3
        return params, [h0, x], lambda p, h0, x: nets.rnn_seq_apply(
            p, h0, x, reset_seq=reset, dtype=dtype, impl="scan")
    if name == "rnn_apply":                # acting: gru_apply and the dense layers
        h = 0.5 * torch.randn(B, N, H, generator=g)
        return params, [h, x[0]], lambda p, h, x: nets.rnn_apply(p, h, x)
    raise ValueError(name)


def _run(name, dtype, grad, in_place):
    """The site's outputs, and with ``grad`` the gradients of a weighted
    sum of them in every parameter and input."""
    params, inputs, f = _site(name, dtype)
    leaves = [p.detach().requires_grad_(grad) for p in tree_leaves(params)]
    inputs = [x.requires_grad_(grad) for x in inputs]
    with pytest.MonkeyPatch.context() as mp:
        if not in_place:
            mp.setattr(nets, "_affine", _out_of_place)
            mp.setattr(nets, "_dense_relu", _relu_out_of_place)
        with torch.set_grad_enabled(grad):
            outs = f(tree_unflatten(params, leaves), *inputs)
        if not grad:
            return list(outs)
        g = torch.Generator().manual_seed(7)
        loss = sum((o * torch.randn(o.shape, generator=g)).sum() for o in outs)
        grads = torch.autograd.grad(loss, leaves + inputs, materialize_grads=True)
    return [o.detach() for o in outs] + list(grads)


@pytest.mark.parametrize("grad", [True, False], ids=["grad", "no_grad"])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["dense", "mlp_apply", "gru_input_proj", "rnn_seq_apply"])
def test_bias_in_place_is_bitwise_the_out_of_place_sum(name, dtype, grad):
    got = _run(name, dtype, grad, in_place=True)
    want = _run(name, dtype, grad, in_place=False)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("grad", [True, False], ids=["grad", "no_grad"])
def test_acting_step_adds_its_biases_in_place_bitwise(grad):
    """``rnn_apply``: fc1, ``gru_apply``'s two projections and the head,
    four bias adds a step."""
    got = _run("rnn_apply", None, grad, in_place=True)
    want = _run("rnn_apply", None, grad, in_place=False)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_bias_that_would_broadcast_the_product_raises():
    """The bias is written into the product, so one that would make the
    sum larger than the product is refused, not added to a copy."""
    g = torch.Generator().manual_seed(3)
    x, w = torch.randn(5, IN, generator=g), torch.randn(IN, H, generator=g)
    with pytest.raises(RuntimeError):
        nets._affine(x, w, torch.randn(2, 5, H, generator=g))
