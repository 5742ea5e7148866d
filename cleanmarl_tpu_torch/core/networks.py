"""Functional network core (port of ``cleanmarl_tpu/core/networks.py``,
the parts MAPPO, QMIX, VDN and their recurrent forms need): params are
nested dicts of tensors in the JAX layout, every forward is a plain
function.

- dense ``w`` is ``(in, out)``; ``mlp`` is ``num_layers + 1`` hidden
  Linear+ReLU layers and a Linear head;
- the GRU keeps fused ``wi (in, 3H)``, ``wh (H, 3H)``, ``bi``, ``bh`` in
  gate order r, z, n (torch ``nn.GRUCell`` semantics: the reset gate
  multiplies the projected hidden contribution);
- ``rnn`` is fc1 → ReLU → GRU → head; ``rnn_seq_apply`` and
  ``rnn_seq_eval_next`` run it over a time-major sequence, on the CUDA
  kernels or as a scan (``resolve_gru_impl``);
- ``mixer`` is the QMIX hypernetwork mixer, ``soft_update`` Polyak
  averaging of a target tree;
- every bias is added, and every hidden ReLU applied, in place over the
  layer's own fresh product (``_affine``, ``_dense_relu``): one buffer a
  layer where the out-of-place forms held two, with the same bits and
  gradients.

Initialization is orthogonal (QR of a Gaussian, per gate block for the
GRU) for kernels and zeros for biases, drawn from a ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from cleanmarl_tpu_torch.core.params import tree_leaves, tree_map
from cleanmarl_tpu_torch.core.tracing import span

MASK_NEG = -1e9


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def orthogonal(generator, shape, gain: float = 1.0, device="cpu"):
    """Orthogonal init with the semantics of
    ``jax.nn.initializers.orthogonal`` (column axis last)."""
    n_rows, n_cols = math.prod(shape[:-1]), shape[-1]
    mshape = (n_cols, n_rows) if n_rows < n_cols else (n_rows, n_cols)
    a = torch.randn(mshape, generator=generator, device=device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if n_rows < n_cols:
        q = q.t()
    return (gain * q).reshape(shape).contiguous()


def dense_init(generator, in_dim: int, out_dim: int, gain: float = math.sqrt(2.0),
               device="cpu"):
    return {"w": orthogonal(generator, (in_dim, out_dim), gain, device),
            "b": torch.zeros((out_dim,), device=device)}


def matmul(x, w, dtype=None):
    """x @ w; ``dtype=torch.bfloat16`` rounds both operands to bf16 and
    multiplies in float32 (products of bf16 values are exact in float32,
    so this is bf16 operands with float32 accumulation, with no
    autocast)."""
    if dtype is None:
        return x @ w
    return x.to(dtype).float() @ w.to(dtype).float()


def _affine(x, w, b, dtype=None):
    """matmul(x, w, dtype) + b, the bias added in place over the fresh
    float32 product, so that the product and the sum are never live at
    once. The bits and the gradients are those of ``p + b``: matmul's
    backward saves its operands, not its output, and add's saves nothing.
    Every bias here is (out,); one that would broadcast the product to a
    larger shape raises."""
    return matmul(x, w, dtype).add_(b)


def dense(params, x, dtype=None):
    return _affine(x, params["w"], params["b"], dtype)


def _dense_relu(params, x, dtype=None):
    """relu(dense(x)), the relu written over dense's own fresh sum: the
    bits and the gradients are those of ``torch.relu``, whose backward
    reads its output, and the layer holds one buffer where it held two."""
    return torch.relu_(dense(params, x, dtype))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_init(generator, in_dim: int, hidden_dim: int, out_dim: int,
             num_layers: int = 1, final_gain: float = 1.0, device="cpu"):
    layers = []
    d = in_dim
    for _ in range(num_layers + 1):
        layers.append(dense_init(generator, d, hidden_dim, device=device))
        d = hidden_dim
    head = dense_init(generator, d, out_dim, gain=final_gain, device=device)
    return {"layers": layers, "head": head}


def mlp_apply(params, x, dtype=None):
    for layer in params["layers"]:
        x = _dense_relu(layer, x, dtype)
    return dense(params["head"], x, dtype)


def masked_q(q: torch.Tensor, avail: Optional[torch.Tensor]) -> torch.Tensor:
    """Mask unavailable actions to a large finite negative."""
    if avail is None:
        return q
    return torch.where(avail.bool(), q, MASK_NEG)


# ---------------------------------------------------------------------------
# GRU cell
# ---------------------------------------------------------------------------

def gru_init(generator, in_dim: int, hidden_dim: int, device="cpu"):
    def mat(d_in):
        return orthogonal(generator, (d_in, hidden_dim), 1.0, device)
    return {
        "wi": torch.cat([mat(in_dim), mat(in_dim), mat(in_dim)], dim=-1),
        "wh": torch.cat([mat(hidden_dim), mat(hidden_dim), mat(hidden_dim)], dim=-1),
        "bi": torch.zeros((3 * hidden_dim,), device=device),
        "bh": torch.zeros((3 * hidden_dim,), device=device),
    }


def gru_apply_pre(params, h, gi, dtype=None):
    """GRU step from a precomputed input projection gi = x @ wi + bi."""
    gh = _affine(h, params["wh"], params["bh"], dtype)
    ir, iz, in_ = torch.chunk(gi, 3, dim=-1)
    hr, hz, hn = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(in_ + r * hn)
    return (1.0 - z) * n + z * h


def gru_apply(params, h, x):
    return gru_apply_pre(params, h, _affine(x, params["wi"], params["bi"]))


# ---------------------------------------------------------------------------
# fc1 → GRU → head
# ---------------------------------------------------------------------------

def rnn_init(generator, in_dim: int, hidden_dim: int, out_dim: int,
             final_gain: float = 1.0, device="cpu"):
    return {
        "fc1": dense_init(generator, in_dim, hidden_dim, device=device),
        "gru": gru_init(generator, hidden_dim, hidden_dim, device=device),
        "head": dense_init(generator, hidden_dim, out_dim, gain=final_gain,
                           device=device),
    }


def rnn_apply(params, h, x):
    """Returns (h', out). x (..., in_dim), h (..., hidden_dim)."""
    z = _dense_relu(params["fc1"], x)
    h2 = gru_apply(params["gru"], h, z)
    return h2, dense(params["head"], h2)


def gru_input_proj(params, x, dtype=None):
    """relu(fc1(x)) @ wi + bi over any leading dims → (..., 3H)."""
    z = _dense_relu(params["fc1"], x, dtype)
    return _affine(z, params["gru"]["wi"], params["gru"]["bi"], dtype)


def _gru_seq_kernel(params, h0, x_seq, reset_seq):
    """The GRU of fc1→GRU over a time-major ``x_seq`` on the kernels
    (ops/gru_kernel.py): the whole time loop runs in one launch per
    direction → (h_final, h_seq (T, ..., H)), before the head. The batch
    dims flatten to M rows; the JAX path pads M to a multiple of 8 for the
    TPU's sublanes, while the CUDA kernels mask a ragged last row tile
    themselves, so no padding is needed."""
    from cleanmarl_tpu_torch.ops.gru_kernel import gru_seq

    gi = gru_input_proj(params, x_seq)                       # (T, ..., 3H)
    T = gi.shape[0]
    batch_shape = gi.shape[1:-1]
    H = gi.shape[-1] // 3
    m0 = math.prod(batch_shape)
    if reset_seq is None:
        keep = torch.ones((T, m0), device=gi.device)
    else:
        r = reset_seq.reshape(reset_seq.shape
                              + (1,) * (1 + len(batch_shape) - reset_seq.dim()))
        keep = (1.0 - r.float()).expand((T,) + tuple(batch_shape)).reshape(T, m0)
    # gi is this function's own temporary: the backward writes its
    # gradient over it (consume_gi) rather than into a second buffer
    h_final, h_seq = gru_seq(params["gru"]["wh"], params["gru"]["bh"],
                             h0.reshape(m0, H), gi.reshape(T, m0, 3 * H),
                             keep.contiguous(), consume_gi=True)
    return (h_final.reshape(tuple(batch_shape) + (H,)),
            h_seq.reshape((T,) + tuple(batch_shape) + (H,)))


def _rnn_seq_apply_kernel(params, h0, x_seq, reset_seq):
    """Kernel path of ``rnn_seq_apply``."""
    h_final, h_seq = _gru_seq_kernel(params, h0, x_seq, reset_seq)
    return h_final, dense(params["head"], h_seq)


_IMPL_ALIASES = {"xla": "scan", "pallas": "kernel"}


def resolve_gru_impl(impl: str, hidden_dim: int, tbptt: int = 0,
                     bf16: bool = False, device="cpu") -> str:
    """Resolve a GRU sequence route → "kernel" | "scan".

    ``xla``/``pallas`` are accepted as aliases of ``scan``/``kernel`` so
    JAX command lines run unchanged. ``auto`` takes the CUDA kernels on a
    CUDA device at every width they take
    (``ops/gru_kernel.py:kernel_supports``), and the scan at any other
    width, with ``tbptt > 0`` or with bf16 operands, which the kernels do
    not take (as in the JAX package); on the CPU it takes the scan.

    The kernel route was faster at every shape timed on an NVIDIA H100
    80GB HBM3 at its 700 W limit (``chip_smoke.py``, PERF.md §6), so the
    rule has no crossover in T or M: MAPPO's actor (T=60, M=3072, H=128)
    and the recurrent-Q recomputes at M=96, H=64, where forward + backward
    took 2.32 ms against the scan's 106.9 at T=150 and 2.42 against 3.28
    at T=2 (the scan's host launches cost more than the kernels' device
    time even at two steps).
    An explicit ``kernel`` still raises for a width the kernels refuse.
    """
    from cleanmarl_tpu_torch.ops.gru_kernel import kernel_supports

    impl = _IMPL_ALIASES.get(impl, impl)
    if impl not in ("auto", "scan", "kernel"):
        raise ValueError(f"gru_impl must be auto|scan|kernel (or xla|pallas), "
                         f"got {impl!r}")
    if impl != "auto":
        return impl
    if tbptt or bf16 or not kernel_supports(hidden_dim):
        return "scan"
    return "kernel" if torch.device(device).type == "cuda" else "scan"


def rnn_seq_apply(params, h0, x_seq, reset_seq=None, tbptt: int = 0,
                  dtype=None, impl: str = "scan"):
    """fc1→GRU→head over a time-major sequence ``x_seq (T, ..., in_dim)``
    with the input side and the head hoisted out of the time loop.

    ``reset_seq (T, ...)`` (bool): the carry is zeroed after emitting
    step t's output wherever it is set. ``tbptt=k`` stops gradients
    through the carry every k steps (including t = 0).
    Returns ``(h_final, out_seq (T, ..., out_dim))``.
    """
    impl = _IMPL_ALIASES.get(impl, impl)
    if impl == "kernel":
        if tbptt:
            raise ValueError("impl='kernel' does not support tbptt>0 "
                             "(use the scan path)")
        if dtype is not None:
            raise ValueError("impl='kernel' does not support a reduced compute "
                             "dtype (use the scan path for bfloat16 matmuls)")
        return _rnn_seq_apply_kernel(params, h0, x_seq, reset_seq)
    if impl != "scan":
        raise ValueError(f"impl must be scan|kernel, got {impl!r}")
    gi = gru_input_proj(params, x_seq, dtype)
    if reset_seq is not None:
        reset_seq = reset_seq.reshape(
            reset_seq.shape + (1,) * (h0.dim() + 1 - reset_seq.dim()))
    h = h0
    outs = []
    for t in range(gi.shape[0]):
        if tbptt and t % tbptt == 0:
            h = h.detach()
        h2 = gru_apply_pre(params["gru"], h, gi[t], dtype)
        outs.append(h2)
        h = h2 if reset_seq is None else torch.where(reset_seq[t], 0.0, h2)
    h_seq = torch.stack(outs)
    return h, dense(params["head"], h_seq, dtype)


def rnn_seq_eval_next(params, h0, obs_seq, next_obs_seq, dtype=None, impl: str = "scan"):
    """Target evaluation of the off-policy recurrent algorithms: advance
    the hidden stream on ``obs_t`` and evaluate the head one GRU step
    ahead on ``next_obs_t`` (within an episode next_obs_t == obs_{t+1};
    at a terminal step it is the stored final observation). Returns
    ``out_seq (T, ..., out_dim)``.

    The one-step-ahead state is never carried, so the kernel route is one
    K2 forward over ``obs_seq`` (no reset) and then one GRU step from
    every ``h_t`` at once on the projected ``next_obs_seq``: two launches
    where the scan takes two cells per step. The arithmetic is the scan's;
    only the order of the float32 sums differs. The scan route also takes
    ``dtype=torch.bfloat16``, which the kernel route refuses.
    """
    impl = _IMPL_ALIASES.get(impl, impl)
    if impl not in ("scan", "kernel"):
        raise ValueError(f"impl must be scan|kernel, got {impl!r}")
    if impl == "kernel" and dtype is not None:
        raise ValueError("impl='kernel' does not support a reduced compute dtype "
                         "(use the scan path for bfloat16 matmuls)")
    gi_next = gru_input_proj(params, next_obs_seq, dtype)
    if impl == "kernel":
        _, h_seq = _gru_seq_kernel(params, h0, obs_seq, None)
        h_eval = gru_apply_pre(params["gru"], h_seq, gi_next)
    else:
        gi_obs = gru_input_proj(params, obs_seq, dtype)
        h, evals = h0, []
        for t in range(gi_obs.shape[0]):
            h = gru_apply_pre(params["gru"], h, gi_obs[t], dtype)
            evals.append(gru_apply_pre(params["gru"], h, gi_next[t], dtype))
        h_eval = torch.stack(evals)
    return dense(params["head"], h_eval, dtype)


def rnn_initial_state(batch_shape, hidden_dim: int, device="cpu") -> torch.Tensor:
    return torch.zeros(tuple(batch_shape) + (hidden_dim,), device=device)


# ---------------------------------------------------------------------------
# QMIX monotonic mixing hypernetwork
# ---------------------------------------------------------------------------

def mixer_init(generator, n_agents: int, state_dim: int, embed_dim: int,
               hyper_dim: int, device="cpu"):
    """Hypernetworks from the global state give the mixing weights |W1|
    (n_agents x embed), b1, |W2| (embed x 1) and b2; ``abs`` keeps Q_tot
    monotonic in every agent's utility. ``num_layers=0`` still has one
    hidden layer (state → hyper → out)."""
    def hyper(out_dim):
        return mlp_init(generator, state_dim, hyper_dim, out_dim, num_layers=0,
                        device=device)
    return {
        "hw1": hyper(n_agents * embed_dim),
        "hb1": dense_init(generator, state_dim, embed_dim, gain=1.0, device=device),
        "hw2": hyper(embed_dim),
        "hb2": hyper(1),
    }


def mixer_apply(params, agent_qs: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """agent_qs (..., n_agents), state (..., state_dim) → Q_tot (...). The
    dims come from the weight shapes."""
    with span("net.mixer"):
        embed_dim = params["hb1"]["b"].shape[0]
        n_agents = params["hw1"]["head"]["b"].shape[0] // embed_dim
        w1 = torch.abs(mlp_apply(params["hw1"], state))
        w1 = w1.reshape(state.shape[:-1] + (n_agents, embed_dim))
        b1 = dense(params["hb1"], state)
        w2 = torch.abs(mlp_apply(params["hw2"], state))
        b2 = mlp_apply(params["hb2"], state)
        hidden = torch.nn.functional.elu(torch.einsum("...a,...ae->...e", agent_qs, w1) + b1)
        return torch.einsum("...e,...e->...", hidden, w2) + b2[..., 0]


def soft_update(target_params, online_params, polyak: float):
    """Polyak averaging θ' ← (1 − τ)·θ' + τ·θ over the whole tree."""
    with span("net.polyak"):
        return tree_map(lambda t, o: (1.0 - polyak) * t + polyak * o,
                        target_params, online_params)


def global_norm(tree) -> torch.Tensor:
    """L2 norm over a tree of tensors."""
    return torch.sqrt(sum(torch.sum(torch.square(x)) for x in tree_leaves(tree)))
