"""Fused GRU sequence kernels with a hand-written backward, and their
plain PyTorch versions.

Port of ``cleanmarl_tpu/ops/pallas_gru.py``: ``gru_seq(wh, bh, h0, gi,
keep)`` runs the whole T-step recurrence (gi (T, M, 3H) is the
precomputed input projection, h0 (M, H), keep (T, M) float in {0, 1})
and returns ``(h_final (M, H), h_seq (T, M, H))``. ``h_seq[t]`` is the
pre-mask output; the carry into t+1 is ``keep[t]·h_seq[t]``:

    gh = h @ wh + bh
    r = σ(gi_r + gh_r); z = σ(gi_z + gh_z); n = tanh(gi_n + r·gh_n)
    h2 = (1−z)·n + z·h

Three kernels (``csrc/gru_seq_fwd.cu``, ``csrc/gru_seq_bwd.cu``):

- ``gru_seq_fwd``: the forward recurrence (replaces ``_fwd_kernel``);
- ``gru_seq_bwd``: the reverse-time recurrence of the backward, emitting
  dgi, dh0 and the n block of dgh (replaces the recurrence part of
  ``_make_bwd_kernel``);
- ``gru_seq_dw``: dwh = Σ h_prevᵀ·dgh and dbh = Σ dgh over all (t, m),
  per-block partials reduced in a fixed order (replaces the ``dwh +=``
  accumulation of ``_make_bwd_kernel``, a race on the GPU).

``GruSeq`` ties them together as a ``torch.autograd.Function`` saving the
same residuals as ``_gru_seq_fwd``. Each wrapper launches its kernel for
CUDA tensors and runs its plain version for CPU tensors; it never falls
back from one to the other. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from cleanmarl_tpu_torch.ops import _build

LAUNCHES = {"gru_seq_fwd": 0, "gru_seq_bwd": 0, "gru_seq_dw": 0}
MAX_HIDDEN = 512      # bwd block = H threads, TM*4H floats of shared memory
DW_ROWS_PER_SPLIT = 4096


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def _gates(gi_t, gh, H):
    r = torch.sigmoid(gi_t[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi_t[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gi_t[:, 2 * H:] + r * gh[:, 2 * H:])
    return r, z, n


def gru_seq_fwd_plain(wh, bh, h0, gi, keep):
    T, H = gi.shape[0], h0.shape[-1]
    h = h0
    h_seq = []
    for t in range(T):
        r, z, n = _gates(gi[t], h @ wh + bh, H)
        h2 = (1.0 - z) * n + z * h
        h_seq.append(h2)
        h = keep[t][:, None] * h2
    hs = torch.stack(h_seq) if T else gi.new_zeros((0,) + h0.shape)
    return h, hs


def _h_prev(h0, h_seq, keep):
    """h entering each step: h0 at t = 0, keep[t-1]·h_seq[t-1] after."""
    return torch.cat([h0[None], keep[:-1, :, None] * h_seq[:-1]], dim=0)


def gru_seq_bwd_plain(wh, bh, h0, h_seq, gi, keep, g_hseq, g_hfinal):
    """→ (dgi (T, M, 3H), dghn (T, M, H), dh0 (M, H))."""
    T, H = gi.shape[0], h0.shape[-1]
    h_prev = _h_prev(h0, h_seq, keep)
    dgi = torch.empty_like(gi)
    dghn = torch.empty_like(h_seq)
    dh = g_hfinal
    for t in range(T - 1, -1, -1):
        hp = h_prev[t]
        gh = hp @ wh + bh
        r, z, n = _gates(gi[t], gh, H)
        dh2 = g_hseq[t] + keep[t][:, None] * dh
        dz = dh2 * (hp - n)
        dn = dh2 * (1.0 - z)
        da_n = dn * (1.0 - n * n)
        da_r = da_n * gh[:, 2 * H:] * r * (1.0 - r)
        da_z = dz * z * (1.0 - z)
        dgi[t] = torch.cat([da_r, da_z, da_n], dim=-1)
        dghn[t] = da_n * r
        dh = dh2 * z + torch.cat([da_r, da_z, da_n * r], dim=-1) @ wh.t()
    return dgi, dghn, dh


def gru_seq_dw_plain(h0, h_seq, keep, dgi, dghn):
    """→ (dwh (H, 3H), dbh (3H,))."""
    H = h0.shape[-1]
    h_prev = _h_prev(h0, h_seq, keep).reshape(-1, H)
    dgh = torch.cat([dgi[..., :2 * H], dghn], dim=-1).reshape(-1, 3 * H)
    return h_prev.t() @ dgh, dgh.sum(0)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check(name, shapes: dict, ref: torch.Tensor):
    for k, (x, shape) in shapes.items():
        if x.device != ref.device:
            raise ValueError(f"{name}: {k} is on {x.device}, expected {ref.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {k} must be float32, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: {k} must have shape {tuple(shape)}, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")


def _on_cpu(name, x) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA tensor
    (kernel); any other device raises."""
    if x.device.type == "cpu":
        return True
    if x.is_cuda:
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


def _dims(H, gi):
    """(T, M, H) for the kernels, which take hidden % 4 == 0 up to
    MAX_HIDDEN and gi (T, M, 3H)."""
    if H % 4 or not 0 < H <= MAX_HIDDEN:
        raise ValueError(f"GRU kernels need hidden % 4 == 0 and hidden <= "
                         f"{MAX_HIDDEN}, got {H}")
    if gi.dim() != 3:
        raise ValueError(f"gi must be (T, M, 3H), got {tuple(gi.shape)}")
    return gi.shape[0], gi.shape[1], H


def _fn(lib, name, n_ptr, n_int, extra=()):
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + list(extra) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def gru_seq_fwd(wh, bh, h0, gi, keep) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (h_final (M, H), h_seq (T, M, H))."""
    if _on_cpu("gru_seq_fwd", gi):
        return gru_seq_fwd_plain(wh, bh, h0, gi, keep)
    T, M, H = _dims(wh.shape[0], gi)
    _check("gru_seq_fwd", dict(wh=(wh, (H, 3 * H)), bh=(bh, (3 * H,)),
                               h0=(h0, (M, H)), gi=(gi, (T, M, 3 * H)),
                               keep=(keep, (T, M))), gi)
    h_seq = torch.empty((T, M, H), device=gi.device)
    h_final = torch.empty((M, H), device=gi.device)
    lib = _build.load("gru_seq_fwd")
    p = _build.ptr
    rc = _fn(lib, "gru_seq_fwd", 7, 3)(
        p(wh), p(bh), p(h0), p(gi), p(keep), p(h_seq), p(h_final), T, M, H,
        _build.stream_ptr(gi.device))
    _build.check(lib, "gru_seq_fwd", rc)
    LAUNCHES["gru_seq_fwd"] += 1
    return h_final, h_seq


def gru_seq_bwd(wh, bh, h0, h_seq, gi, keep, g_hseq, g_hfinal):
    """→ (dgi (T, M, 3H), dghn (T, M, H), dh0 (M, H))."""
    if _on_cpu("gru_seq_bwd", gi):
        return gru_seq_bwd_plain(wh, bh, h0, h_seq, gi, keep, g_hseq, g_hfinal)
    T, M, H = _dims(wh.shape[0], gi)
    _check("gru_seq_bwd", dict(
        wh=(wh, (H, 3 * H)), bh=(bh, (3 * H,)), h0=(h0, (M, H)),
        h_seq=(h_seq, (T, M, H)), gi=(gi, (T, M, 3 * H)), keep=(keep, (T, M)),
        g_hseq=(g_hseq, (T, M, H)), g_hfinal=(g_hfinal, (M, H))), gi)
    whT = wh.t().contiguous()        # (3H, H): coalesced reads for dgh @ wh^T
    dgi = torch.empty_like(gi)
    dghn = torch.empty_like(h_seq)
    dh0 = torch.empty_like(h0)
    lib = _build.load("gru_seq_bwd")
    p = _build.ptr
    rc = _fn(lib, "gru_seq_bwd", 12, 3)(
        p(wh), p(whT), p(bh), p(h0), p(h_seq), p(gi), p(keep), p(g_hseq),
        p(g_hfinal), p(dgi), p(dghn), p(dh0), T, M, H,
        _build.stream_ptr(gi.device))
    _build.check(lib, "gru_seq_bwd", rc)
    LAUNCHES["gru_seq_bwd"] += 1
    return dgi, dghn, dh0


def gru_seq_dw(h0, h_seq, keep, dgi, dghn) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (dwh (H, 3H), dbh (3H,)), summed in a fixed order."""
    if _on_cpu("gru_seq_dw", dgi):
        return gru_seq_dw_plain(h0, h_seq, keep, dgi, dghn)
    T, M, H = _dims(h0.shape[-1], dgi)
    _check("gru_seq_dw", dict(
        h0=(h0, (M, H)), h_seq=(h_seq, (T, M, H)), keep=(keep, (T, M)),
        dgi=(dgi, (T, M, 3 * H)), dghn=(dghn, (T, M, H))), dgi)
    R = T * M
    S = max(1, -(-R // DW_ROWS_PER_SPLIT))
    rows = -(-R // S) if R else 1
    part_w = torch.empty((S, H, 3 * H), device=dgi.device)
    part_b = torch.empty((S, 3 * H), device=dgi.device)
    dwh = torch.empty((H, 3 * H), device=dgi.device)
    dbh = torch.empty((3 * H,), device=dgi.device)
    lib = _build.load("gru_seq_bwd")
    p = _build.ptr
    rc = _fn(lib, "gru_seq_dw", 9, 4, extra=(ctypes.c_longlong,))(
        p(h0), p(h_seq), p(keep), p(dgi), p(dghn), p(part_w), p(part_b),
        p(dwh), p(dbh), T, M, H, S, rows, _build.stream_ptr(dgi.device))
    _build.check(lib, "gru_seq_bwd", rc)
    LAUNCHES["gru_seq_dw"] += 1
    return dwh, dbh


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class GruSeq(torch.autograd.Function):
    """Fused GRU over time with the hand-written backward. Saves the
    residuals of ``_gru_seq_fwd`` (wh, bh, h0, gi, keep, h_seq), returns a
    zero gradient for ``keep`` and treats a missing cotangent as zeros."""

    @staticmethod
    def forward(ctx, wh, bh, h0, gi, keep):
        wh, bh, h0, gi, keep = (x.contiguous() for x in (wh, bh, h0, gi, keep))
        h_final, h_seq = gru_seq_fwd(wh, bh, h0, gi, keep)
        ctx.save_for_backward(wh, bh, h0, gi, keep, h_seq)
        return h_final, h_seq

    @staticmethod
    def backward(ctx, g_hfinal, g_hseq):
        wh, bh, h0, gi, keep, h_seq = ctx.saved_tensors
        g_hfinal = (torch.zeros_like(h0) if g_hfinal is None
                    else g_hfinal.contiguous())
        g_hseq = (torch.zeros_like(h_seq) if g_hseq is None
                  else g_hseq.contiguous())
        dgi, dghn, dh0 = gru_seq_bwd(wh, bh, h0, h_seq, gi, keep, g_hseq, g_hfinal)
        dwh, dbh = gru_seq_dw(h0, h_seq, keep, dgi, dghn)
        return dwh, dbh, dh0, dgi, torch.zeros_like(keep)


def gru_seq(wh, bh, h0, gi, keep):
    """→ (h_final (M, H), h_seq (T, M, H)), differentiable."""
    return GruSeq.apply(wh, bh, h0, gi, keep)
