"""Masked λ-returns as one CUDA kernel (``csrc/lambda_returns.cu``),
with its plain PyTorch version beside it.

Port of ``cleanmarl_tpu/ops/pallas_returns.py`` (the TPU kernel
``_kernel``, launched by ``_lambda_returns_2d``). The kernel runs one
thread per column of the flattened (T, B) block with the reverse loop
over T inside the thread, and writes the advantage ``A = G − V`` in the
same pass.

``lambda_returns_kernel`` launches the kernel for CUDA tensors and runs
the plain reverse loop for CPU tensors; it never falls back from one to
the other. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

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


def _launch(rewards, ended, values, bootstrap, gamma, lam):
    T = values.shape[0]
    tensors = dict(rewards=rewards, values=values, bootstrap=bootstrap)
    for k, x in tensors.items():
        if x.dtype != torch.float32:
            raise TypeError(f"lambda_returns kernel: {k} must be float32, got {x.dtype}")
    if ended.dtype != torch.bool:
        raise TypeError(f"lambda_returns kernel: ended must be bool, got {ended.dtype}")
    if rewards.shape != values.shape or ended.shape != values.shape:
        raise ValueError("lambda_returns kernel: rewards/ended/values shapes differ: "
                         f"{tuple(rewards.shape)} {tuple(ended.shape)} {tuple(values.shape)}")
    if tuple(bootstrap.shape) != tuple(values.shape[1:]):
        raise ValueError("lambda_returns kernel: bootstrap must have shape "
                         f"{tuple(values.shape[1:])}, got {tuple(bootstrap.shape)}")
    for k, x in dict(tensors, ended=ended).items():
        if x.device != values.device:
            raise ValueError(f"lambda_returns kernel: {k} is on {x.device}, "
                             f"values on {values.device}")
        if not x.is_contiguous():
            raise ValueError(f"lambda_returns kernel: {k} must be contiguous")
    B = values.numel() // max(T, 1)
    g = torch.empty_like(values)
    a = torch.empty_like(values)
    lib = _build.load("lambda_returns")
    fn = lib.lambda_returns_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_float, ctypes.c_float,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    p = _build.ptr
    rc = fn(p(rewards), p(ended), p(values), p(bootstrap), p(g), p(a), T, B,
            float(gamma), float(lam), _build.stream_ptr(values.device))
    _build.check(lib, "lambda_returns", rc)
    LAUNCHES["lambda_returns"] += 1
    return g, a


def lambda_returns_kernel(rewards, ended, values, bootstrap, gamma: float,
                          lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G, A) for rewards/ended/values (T, ...) and bootstrap (...).
    CUDA tensors go to the kernel, CPU tensors to the plain loop."""
    if values.is_cuda:
        return _launch(rewards, ended, values, bootstrap, gamma, lam)
    if values.device.type != "cpu":
        raise ValueError(f"lambda_returns: unsupported device {values.device}")
    return lambda_returns_plain(rewards, ended, values, bootstrap, gamma, lam)
