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

Kernels (``csrc/gru_seq_fwd.cu``, ``csrc/gru_seq_bwd.cu``):

- ``gru_seq_fwd``: the forward recurrence (replaces ``_fwd_kernel``), by
  width (``fwd_route``): on the tensor cores with ``wh`` held in shared
  memory for ``TC_WIDTHS``, and as the float32 kernel that streams ``wh``
  from L2 (``LAUNCHES["gru_seq_fwd_l2"]``) at every other width the
  kernels take;
- ``gru_seq_bwd``: the reverse-time recurrence of the backward, emitting
  dgi, dh0 and the n block of dgh (replaces the recurrence part of
  ``_make_bwd_kernel``), by width (``bwd_route``), with the same two
  routes (``LAUNCHES["gru_seq_bwd_l2"]`` off ``TC_WIDTHS``);
- ``gru_seq_dw``: dwh = Σ h_prevᵀ·dgh and dbh = Σ dgh over all (t, m), a
  split-K GEMM on the tensor cores whose per-block partials are reduced in
  a fixed order (replaces the ``dwh +=`` accumulation of
  ``_make_bwd_kernel``, a race on the GPU).

The tensor-core kernels (both recurrences at ``TC_WIDTHS`` and the
weight gradient) compute in 3xTF32 (float32 accuracy, whatever
``torch.backends.cuda.matmul.allow_tf32`` says); the L2 routes in float32
FMA. Every kernel sums in a fixed order and gives the same bits on every
run.

``GruSeq`` ties them together as a ``torch.autograd.Function`` saving the
same residuals as ``_gru_seq_fwd``. Each wrapper launches its kernel for
CUDA tensors and runs its plain version for CPU tensors; it never falls
back from one to the other. ``LAUNCHES`` counts kernel launches.

``gru_seq_bwd`` (and its plain version) may write dgi over gi, which the
recurrence has read by then. ``gru_seq(..., consume_gi=True)`` has the
backward do so, for a caller whose gi is its own temporary: the backward
then holds one (T, M, 3H) buffer where it held two, and gi's version is
bumped, so that a second backward through a retained graph raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from cleanmarl_tpu_torch.core import tracing
from cleanmarl_tpu_torch.ops import _build

LAUNCHES = {"gru_seq_fwd": 0, "gru_seq_fwd_l2": 0, "gru_seq_bwd": 0, "gru_seq_bwd_l2": 0,
            "gru_seq_dw": 0}
MAX_HIDDEN = 512      # L2-route blocks: H threads, TM*4H floats of shared memory
TC_WIDTHS = (32, 64, 96, 128)   # multiples of 32 whose wh (H x 3H) fits a block's shared memory
DW_MIN_ROWS = 512     # fewest rows per split of the dw kernel


def kernel_supports(hidden: int) -> bool:
    """True for the widths the CUDA kernels take: hidden % 4 == 0, up to
    MAX_HIDDEN."""
    return hidden % 4 == 0 and 0 < hidden <= MAX_HIDDEN


def fwd_route(hidden: int) -> str:
    """The ``LAUNCHES`` key of the forward kernel for a width:
    ``gru_seq_fwd`` (tensor cores, wh in shared memory) for TC_WIDTHS,
    ``gru_seq_fwd_l2`` (float32, wh streamed from L2) otherwise."""
    return "gru_seq_fwd" if hidden in TC_WIDTHS else "gru_seq_fwd_l2"


def bwd_route(hidden: int) -> str:
    """The ``LAUNCHES`` key of the backward recurrence kernel for a width:
    ``gru_seq_bwd`` (tensor cores, wh in shared memory) for TC_WIDTHS,
    ``gru_seq_bwd_l2`` (float32, wh streamed from L2) otherwise."""
    return "gru_seq_bwd" if hidden in TC_WIDTHS else "gru_seq_bwd_l2"


def dw_splits(R: int, tiles: int, slab: int, n_sm: int) -> Tuple[int, int]:
    """(S, rows per split) of the dw kernel over R rows: S contiguous row
    ranges, each a whole number of ``slab``-row slabs, with S x ``tiles``
    output tiles at most one block per SM. The kernel states its tiles and
    slab (``gru_seq_dw_tiles``, ``gru_seq_dw_slab_rows``)."""
    S = max(1, min(n_sm // tiles, -(-R // DW_MIN_ROWS)))
    per_split = -(-R // S)
    rows = max(slab, -(-per_split // slab) * slab)
    return max(1, -(-R // rows)), rows


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


def gru_seq_bwd_plain(wh, bh, h0, h_seq, gi, keep, g_hseq, g_hfinal, dgi=None):
    """→ (dgi (T, M, 3H), dghn (T, M, H), dh0 (M, H)); dgi is written into
    the given buffer, which may be gi (step t reads gi[t] before it writes
    dgi[t]), or a fresh one."""
    T, H = gi.shape[0], h0.shape[-1]
    h_prev = _h_prev(h0, h_seq, keep)
    dgi = torch.empty_like(gi) if dgi is None else dgi
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
    """Device, dtype, shape and layout of each kernel argument. The kernels
    copy and read every tensor but ``keep`` in 8- or 16-byte vectors, so
    those must start on a 16-byte boundary (a fresh tensor does; a view
    at an odd offset does not)."""
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
        if k != "keep" and x.data_ptr() % 16:
            raise ValueError(f"{name}: {k} must start on a 16-byte boundary")


def _on_cpu(name, x) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA tensor
    (kernel); any other device raises."""
    if x.device.type == "cpu":
        return True
    if x.is_cuda:
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


def _dims(H, gi):
    """(T, M, H) for the kernels, which take the widths of
    ``kernel_supports`` and gi (T, M, 3H)."""
    if not kernel_supports(H):
        raise ValueError(f"GRU kernels need hidden % 4 == 0 and hidden <= "
                         f"{MAX_HIDDEN}, got {H}")
    if gi.dim() != 3:
        raise ValueError(f"gi must be (T, M, 3H), got {tuple(gi.shape)}")
    if gi.shape[0] == 0 or gi.shape[1] == 0:
        # a rank with no rows of a minibatch must not launch an empty grid
        raise ValueError(f"GRU kernels refuse an empty input: gi {tuple(gi.shape)}")
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
    route = fwd_route(H)
    rc = _fn(lib, route, 7, 3)(
        p(wh), p(bh), p(h0), p(gi), p(keep), p(h_seq), p(h_final), T, M, H,
        _build.stream_ptr(gi.device))
    _build.check(lib, "gru_seq_fwd", rc)
    LAUNCHES[route] += 1
    return h_final, h_seq


def gru_seq_bwd(wh, bh, h0, h_seq, gi, keep, g_hseq, g_hfinal, dgi=None):
    """→ (dgi (T, M, 3H), dghn (T, M, H), dh0 (M, H)); dgi is written into
    the given buffer, which may be gi itself, or a fresh one."""
    if _on_cpu("gru_seq_bwd", gi):
        return gru_seq_bwd_plain(wh, bh, h0, h_seq, gi, keep, g_hseq, g_hfinal, dgi)
    T, M, H = _dims(wh.shape[0], gi)
    dgi = torch.empty_like(gi) if dgi is None else dgi
    _check("gru_seq_bwd", dict(
        wh=(wh, (H, 3 * H)), bh=(bh, (3 * H,)), h0=(h0, (M, H)),
        h_seq=(h_seq, (T, M, H)), gi=(gi, (T, M, 3 * H)), keep=(keep, (T, M)),
        g_hseq=(g_hseq, (T, M, H)), g_hfinal=(g_hfinal, (M, H)),
        dgi=(dgi, (T, M, 3 * H))), gi)
    dghn = torch.empty_like(h_seq)
    dh0 = torch.empty_like(h0)
    lib = _build.load("gru_seq_bwd")
    p = _build.ptr
    route = bwd_route(H)
    if route == "gru_seq_bwd":
        rc = _fn(lib, "gru_seq_bwd", 11, 3)(
            p(wh), p(bh), p(h0), p(h_seq), p(gi), p(keep), p(g_hseq),
            p(g_hfinal), p(dgi), p(dghn), p(dh0), T, M, H,
            _build.stream_ptr(gi.device))
    else:
        whT = wh.t().contiguous()    # (3H, H): coalesced reads for dgh @ wh^T
        rc = _fn(lib, "gru_seq_bwd_l2", 12, 3)(
            p(wh), p(whT), p(bh), p(h0), p(h_seq), p(gi), p(keep), p(g_hseq),
            p(g_hfinal), p(dgi), p(dghn), p(dh0), T, M, H,
            _build.stream_ptr(gi.device))
    _build.check(lib, "gru_seq_bwd", rc)
    LAUNCHES[route] += 1
    return dgi, dghn, dh0


def gru_seq_dw(h0, h_seq, keep, dgi, dghn) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (dwh (H, 3H), dbh (3H,)), summed in a fixed order."""
    if _on_cpu("gru_seq_dw", dgi):
        return gru_seq_dw_plain(h0, h_seq, keep, dgi, dghn)
    T, M, H = _dims(h0.shape[-1], dgi)
    _check("gru_seq_dw", dict(
        h0=(h0, (M, H)), h_seq=(h_seq, (T, M, H)), keep=(keep, (T, M)),
        dgi=(dgi, (T, M, 3 * H)), dghn=(dghn, (T, M, H))), dgi)
    lib = _build.load("gru_seq_bwd")
    S, rows = dw_splits(T * M, lib.gru_seq_dw_tiles(H), lib.gru_seq_dw_slab_rows(),
                        torch.cuda.get_device_properties(dgi.device).multi_processor_count)
    part_w = torch.empty((S, H, 3 * H), device=dgi.device)
    part_b = torch.empty((S, 3 * H), device=dgi.device)
    dwh = torch.empty((H, 3 * H), device=dgi.device)
    dbh = torch.empty((3 * H,), device=dgi.device)
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
    zero gradient for ``keep`` and treats a missing cotangent as zeros.
    With ``consume_gi`` the backward writes dgi over the saved gi and
    bumps gi's version. Counters ``gru.bwd_calls`` and
    ``gru.bwd_in_place`` (``core/tracing.py``) count the backward's calls
    and those that wrote over gi."""

    @staticmethod
    def forward(ctx, wh, bh, h0, gi, keep, consume_gi):
        wh, bh, h0, gi, keep = (x.contiguous() for x in (wh, bh, h0, gi, keep))
        h_final, h_seq = gru_seq_fwd(wh, bh, h0, gi, keep)
        ctx.save_for_backward(wh, bh, h0, gi, keep, h_seq)
        ctx.consume_gi = consume_gi
        return h_final, h_seq

    @staticmethod
    def backward(ctx, g_hfinal, g_hseq):
        wh, bh, h0, gi, keep, h_seq = ctx.saved_tensors
        g_hfinal = (torch.zeros_like(h0) if g_hfinal is None
                    else g_hfinal.contiguous())
        g_hseq = (torch.zeros_like(h_seq) if g_hseq is None
                  else g_hseq.contiguous())
        dgi, dghn, dh0 = gru_seq_bwd(wh, bh, h0, h_seq, gi, keep, g_hseq, g_hfinal,
                                     dgi=gi if ctx.consume_gi else None)
        if ctx.consume_gi:
            torch.autograd.graph.increment_version(gi)
        tracing.count("gru.bwd_calls", 1)
        tracing.count("gru.bwd_in_place", int(ctx.consume_gi))
        dwh, dbh = gru_seq_dw(h0, h_seq, keep, dgi, dghn)
        return dwh, dbh, dh0, dgi, torch.zeros_like(keep), None


def gru_seq(wh, bh, h0, gi, keep, consume_gi: bool = False):
    """→ (h_final (M, H), h_seq (T, M, H)), differentiable. ``consume_gi``:
    the backward writes gi's gradient over gi, which only a caller that
    owns gi and reads it no more may ask for; gi is left intact otherwise."""
    return GruSeq.apply(wh, bh, h0, gi, keep, consume_gi)
