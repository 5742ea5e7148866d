"""Masked λ-returns as one CUDA kernel (``csrc/lambda_returns.cu``),
with its plain PyTorch version beside it.

Port of ``cleanmarl_tpu/ops/pallas_returns.py`` (the TPU kernel
``_kernel``, launched by ``_lambda_returns_2d``). The kernel runs one
thread per column of the flattened (T, B) block with the reverse loop
over T inside the thread, loads the column's inputs into registers in
chunks of time steps, three chunks in flight, and writes the advantage
``A = G − V`` in the same pass.

Inputs that are an expand over trailing axes (stride 0), such as a team
reward broadcast over the agents, reach the kernel as their base and a
repeat factor (``repeat_base``), without a copy; any other layout is made
contiguous.

``lambda_returns_kernel`` launches the kernel for CUDA tensors and runs
the plain reverse loop for CPU tensors; it never falls back from one to
the other. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from cleanmarl_tpu_torch.ops import _build

LAUNCHES = {"lambda_returns": 0}


def lambda_returns_plain(rewards, ended, values, bootstrap, gamma: float,
                         lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reverse loop over T: (G, A) for (T, ...) inputs, bootstrap (...)."""
    ended_f = ended.to(values.dtype)
    g = bootstrap
    v_next = bootstrap
    out = torch.empty_like(values)
    for t in range(values.shape[0] - 1, -1, -1):
        g = rewards[t] + gamma * (1.0 - ended_f[t]) * (lam * g + (1.0 - lam) * v_next)
        out[t] = g
        v_next = values[t]
    return out, out - values


def repeat_base(x: torch.Tensor) -> Optional[Tuple[torch.Tensor, int]]:
    """(base, R) when ``x`` (T, d1, ..., dn) is an expand over its trailing
    axes of a contiguous (T, d1, ..., dk): every axis after k has stride 0
    (or size 1). ``base`` is that tensor as (T, B / R), with B = d1 ⋯ dn and
    R = d(k+1) ⋯ dn, sharing ``x``'s storage; a contiguous ``x`` gives R = 1.
    None for any other layout (and for an empty ``x``)."""
    shape, stride = tuple(x.shape), x.stride()
    if not shape or x.numel() == 0:
        return None
    k = len(shape)
    while k > 1 and (stride[k - 1] == 0 or shape[k - 1] == 1):
        k -= 1
    n = 1                                  # elements of shape[i + 1:k]
    for i in range(k - 1, -1, -1):
        if shape[i] != 1 and stride[i] != n:
            return None
        n *= shape[i]
    cols = n // shape[0]
    return x.as_strided((shape[0], cols), (cols, 1)), x.numel() // n


def _rows(pair, ts):
    """The kernel's view of two tensors that share a repeat factor (r and e,
    or V and the bootstrap, the latter with a leading axis of ts[1] = 1):
    their bases and R, or both made contiguous with R = 1 where either
    layout is not an expand or their factors differ."""
    got = [repeat_base(x) for x in pair]
    if None in got or got[0][1] != got[1][1]:
        return [x.contiguous().view(t, -1) for x, t in zip(pair, ts)], 1
    return [b for b, _ in got], got[0][1]


def kernel_args(rewards, ended, values, bootstrap):
    """The tensors the kernel reads and its repeat factors:
    ((r, e, v, boot), Rr, Rv), with r, e (T, B / Rr), v (T, B / Rv) and
    boot (1, B / Rv), each a view of the caller's tensor where its layout
    allows (``repeat_base``)."""
    T = values.shape[0]
    (r, e), Rr = _rows((rewards, ended), (T, T))
    (v, b), Rv = _rows((values, bootstrap[None]), (T, 1))
    return (r, e, v, b), Rr, Rv


@functools.cache
def _launcher():
    """The kernel's launch function, its ctypes signature set once, when
    the library is first loaded."""
    lib = _build.load("lambda_returns")
    fn = lib.lambda_returns_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _launch(rewards, ended, values, bootstrap, gamma, lam):
    for k, x in dict(rewards=rewards, values=values, bootstrap=bootstrap).items():
        if x.dtype != torch.float32:
            raise TypeError(f"lambda_returns kernel: {k} must be float32, got {x.dtype}")
    if ended.dtype != torch.bool:
        raise TypeError(f"lambda_returns kernel: ended must be bool, got {ended.dtype}")
    if rewards.shape != values.shape or ended.shape != values.shape:
        raise ValueError("lambda_returns kernel: rewards/ended/values shapes differ: "
                         f"{tuple(rewards.shape)} {tuple(ended.shape)} {tuple(values.shape)}")
    if values.dim() == 0 or tuple(bootstrap.shape) != tuple(values.shape[1:]):
        raise ValueError("lambda_returns kernel: bootstrap must have shape "
                         f"{tuple(values.shape[1:])}, got {tuple(bootstrap.shape)}")
    for k, x in dict(rewards=rewards, ended=ended, bootstrap=bootstrap).items():
        if x.device != values.device:
            raise ValueError(f"lambda_returns kernel: {k} is on {x.device}, "
                             f"values on {values.device}")
    T = values.shape[0]
    if values.numel() >= 2**31:
        raise ValueError("lambda_returns kernel: T * B must be below 2^31 (32-bit "
                         f"offsets), got {tuple(values.shape)}")
    g = torch.empty_like(values, memory_format=torch.contiguous_format)
    a = torch.empty_like(values, memory_format=torch.contiguous_format)
    if values.numel() == 0:
        return g, a
    (r, e, v, b), Rr, Rv = kernel_args(rewards, ended, values, bootstrap)
    lib, fn = _launcher()
    p = _build.ptr
    rc = fn(p(r), p(e), p(v), p(b), p(g), p(a), T, values.numel() // T, Rr, Rv,
            float(gamma), float(lam), _build.stream_ptr(values.device))
    _build.check(lib, "lambda_returns", rc)
    LAUNCHES["lambda_returns"] += 1
    return g, a


def lambda_returns_kernel(rewards, ended, values, bootstrap, gamma: float,
                          lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G, A) for rewards/ended/values (T, ...) and bootstrap (...), in any
    layout. CUDA tensors go to the kernel, CPU tensors to the plain loop."""
    if values.is_cuda:
        return _launch(rewards, ended, values, bootstrap, gamma, lam)
    if values.device.type != "cpu":
        raise ValueError(f"lambda_returns: unsupported device {values.device}")
    return lambda_returns_plain(rewards, ended, values, bootstrap, gamma, lam)
