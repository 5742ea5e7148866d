"""Functional network core (port of ``cleanmarl_tpu/core/networks.py``,
the parts MAPPO needs): params are nested dicts of tensors in the JAX
layout, every forward is a plain function.

- dense ``w`` is ``(in, out)``; ``mlp`` is ``num_layers + 1`` hidden
  Linear+ReLU layers and a Linear head;
- the GRU keeps fused ``wi (in, 3H)``, ``wh (H, 3H)``, ``bi``, ``bh`` in
  gate order r, z, n (torch ``nn.GRUCell`` semantics: the reset gate
  multiplies the projected hidden contribution);
- ``rnn`` is fc1 → ReLU → GRU → head.

Initialization is orthogonal (QR of a Gaussian, per gate block for the
GRU) for kernels and zeros for biases, drawn from a ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from cleanmarl_tpu_torch.core.params import tree_leaves

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


def dense(params, x, dtype=None):
    return matmul(x, params["w"], dtype) + params["b"]


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


def mlp_apply(params, x, activation: Callable = torch.relu, dtype=None):
    for layer in params["layers"]:
        x = activation(dense(layer, x, dtype))
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
    gh = matmul(h, params["wh"], dtype) + params["bh"]
    ir, iz, in_ = torch.chunk(gi, 3, dim=-1)
    hr, hz, hn = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(in_ + r * hn)
    return (1.0 - z) * n + z * h


def gru_apply(params, h, x):
    return gru_apply_pre(params, h, x @ params["wi"] + params["bi"])


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
    z = torch.relu(dense(params["fc1"], x))
    h2 = gru_apply(params["gru"], h, z)
    return h2, dense(params["head"], h2)


def gru_input_proj(params, x, dtype=None):
    """relu(fc1(x)) @ wi + bi over any leading dims → (..., 3H)."""
    z = torch.relu(dense(params["fc1"], x, dtype))
    return matmul(z, params["gru"]["wi"], dtype) + params["gru"]["bi"]


def _rnn_seq_apply_kernel(params, h0, x_seq, reset_seq):
    """Kernel path of ``rnn_seq_apply`` (ops/gru_kernel.py): the whole
    time loop runs in one launch per direction. The batch dims flatten
    to M rows; the JAX path pads M to a multiple of 8 for the TPU's
    sublanes, while the CUDA kernels mask a ragged last row tile
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
    h_final, h_seq = gru_seq(params["gru"]["wh"], params["gru"]["bh"],
                             h0.reshape(m0, H), gi.reshape(T, m0, 3 * H),
                             keep.contiguous())
    h_final = h_final.reshape(tuple(batch_shape) + (H,))
    h_seq = h_seq.reshape((T,) + tuple(batch_shape) + (H,))
    return h_final, dense(params["head"], h_seq)


_IMPL_ALIASES = {"xla": "scan", "pallas": "kernel"}


def resolve_gru_impl(impl: str, hidden_dim: int, tbptt: int = 0,
                     bf16: bool = False, device="cpu") -> str:
    """Resolve a GRU sequence route → "kernel" | "scan".

    ``xla``/``pallas`` are accepted as aliases of ``scan``/``kernel`` so
    JAX command lines run unchanged. ``auto`` takes the CUDA kernel on a
    CUDA device at every width, except with ``tbptt > 0`` or bf16
    operands, which the kernel does not take (as in the JAX package);
    on the CPU it takes the scan. No H100 crossover has been measured
    yet, so the rule does not depend on ``hidden_dim``.
    """
    impl = _IMPL_ALIASES.get(impl, impl)
    if impl not in ("auto", "scan", "kernel"):
        raise ValueError(f"gru_impl must be auto|scan|kernel (or xla|pallas), "
                         f"got {impl!r}")
    if impl != "auto":
        return impl
    if tbptt or bf16:
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


def global_norm(tree) -> torch.Tensor:
    """L2 norm over a tree of tensors."""
    return torch.sqrt(sum(torch.sum(torch.square(x)) for x in tree_leaves(tree)))
