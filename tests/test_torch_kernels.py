"""The port's kernel wrappers: the CPU path (plain versions, no launch,
hand-written GRU backward against autograd) and, on the card, each CUDA
kernel against its plain version.

This file imports neither JAX nor the JAX package, so the card tests run
on a machine without JAX (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

Tolerances: λ-returns rtol=2e-5/atol=1e-5 (float32 in both, the kernel's
FMAs round differently); GRU values 1e-5 and
gradients 2e-4 (3xTF32 on the tensor cores at the widths of
``TC_WIDTHS``, float32 FMA on the L2 routes, summed in another order than
the plain version's matmuls; TF32 off for the plain versions).
``test_3xtf32_split_meets_grad_tol`` and
``test_3xtf32_fwd_recurrence_meets_val_tol`` record why 3xTF32 meets the
gradient and value tolerances and one TF32 pass does not.
"""
import shutil

import numpy as np
import pytest
import torch

from cleanmarl_tpu_torch.ops import _build, gru_kernel, returns_kernel

torch.set_num_threads(1)
RET_TOL = dict(rtol=2e-5, atol=1e-5)
VAL_TOL = 1e-5
GRAD_TOL = 2e-4


def _returns_inputs(shape, p_end, seed, device="cpu", per_env=()):
    """r, e, V (shape) and bootstrap (shape[1:]); an input named in
    ``per_env`` is drawn without the trailing agent axis and broadcast over
    it as a view, as the MAPPO update passes the team reward, the end flag
    and the centralized critic's value (``x[..., None].expand``)."""
    rng = np.random.RandomState(seed)
    full = dict(r=shape, e=shape, v=shape, b=shape[1:])
    draw = dict(r=lambda s: rng.randn(*s).astype(np.float32), e=lambda s: rng.rand(*s) < p_end,
                v=lambda s: rng.randn(*s).astype(np.float32),
                b=lambda s: rng.randn(*s).astype(np.float32))
    out = []
    for k, s in full.items():
        if k in per_env:
            out.append(torch.as_tensor(draw[k](s[:-1]), device=device)[..., None].expand(s))
        else:
            out.append(torch.as_tensor(draw[k](s), device=device))
    return out


def _gru_inputs(T, M, H, seed, device="cpu"):
    rng = np.random.RandomState(seed)
    xs = (rng.randn(H, 3 * H) / np.sqrt(H), rng.randn(3 * H) * 0.1,
          rng.randn(M, H), rng.randn(T, M, 3 * H), rng.rand(T, M) > 0.2)
    return [torch.as_tensor(x.astype(np.float32), device=device) for x in xs]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# CPU path
# ---------------------------------------------------------------------------

def test_returns_cpu_tensor_takes_plain_version_without_launch():
    r, e, v, b = _returns_inputs((5, 6), 0.2, seed=3)
    before = dict(returns_kernel.LAUNCHES)
    g, a = returns_kernel.lambda_returns_kernel(r, e, v, b, 0.99, 0.95)
    g2, a2 = returns_kernel.lambda_returns_plain(r, e, v, b, 0.99, 0.95)
    assert returns_kernel.LAUNCHES == before
    torch.testing.assert_close(g, g2, rtol=0, atol=0)
    torch.testing.assert_close(a, a2 + 0.0, rtol=0, atol=0)
    torch.testing.assert_close(a, g - v, rtol=0, atol=0)


@pytest.mark.parametrize("layout,R", [
    ("contiguous", 1), ("agents_expanded", 3), ("two_axes_expanded", 6),
    ("offset_view", 1), ("size1_trailing", 1),
    ("transposed", None), ("middle_axis_expanded", None), ("strided_rows", None)])
def test_repeat_base_shares_storage_or_declines(layout, R):
    """An expand over trailing axes reaches the kernel as its base (the same
    storage, no copy) and the repeat factor; a layout the kernel cannot
    read is declined (the wrapper then copies it)."""
    base = torch.arange(6 * 5, dtype=torch.float32).view(6, 5)
    x = {"contiguous": base,
         "agents_expanded": base[..., None].expand(6, 5, 3),
         "two_axes_expanded": base[:, :, None, None].expand(6, 5, 2, 3),
         "offset_view": torch.arange(8 * 5, dtype=torch.float32).view(8, 5)[2:],
         "size1_trailing": base[..., None],
         "transposed": base.t(),
         "middle_axis_expanded": base[:, None, :].expand(6, 3, 5),
         "strided_rows": base[:, :4]}[layout]
    got = returns_kernel.repeat_base(x)
    if R is None:
        assert got is None
        return
    b, r = got
    assert r == R and b.data_ptr() == x.data_ptr() and b.is_contiguous()
    assert tuple(b.shape) == (x.shape[0], x[0].numel() // R)
    torch.testing.assert_close(b[..., None].expand(b.shape + (R,)).reshape(x.shape), x,
                               rtol=0, atol=0)


@pytest.mark.parametrize("per_env,want_R", [
    (("r", "e", "v", "b"), (3, 3)),     # MAPPO, centralized critic (the main path)
    (("r", "e"), (3, 1)),               # per-agent values (IPPO)
    ((), (1, 1)),
    (("r",), (1, 1))])                  # r and e differ: both read at R = 1
def test_kernel_args_read_broadcast_inputs_without_copies(per_env, want_R):
    """What the wrapper hands the kernel for each layout of the MAPPO update:
    per-env inputs as their (T, E) bases, sharing storage with the caller's
    tensors (through ``ops/returns.py`` too, which no longer copies); a
    pair whose factors differ is made contiguous."""
    from cleanmarl_tpu_torch.ops import returns as tret

    ins = _returns_inputs((7, 5, 3), 0.3, seed=2, per_env=per_env)
    flat = tret._flat_args(*ins)
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(flat, ins))
    (r, e, v, b), Rr, Rv = returns_kernel.kernel_args(*flat)
    assert (Rr, Rv) == want_R
    assert tuple(r.shape) == tuple(e.shape) == (7, 15 // Rr)
    assert tuple(v.shape) == (7, 15 // Rv) and tuple(b.shape) == (1, 15 // Rv)
    for k, got, x in zip("revb", (r, e, v, b), ins):
        if (k in "re" and Rr > 1) or (k in "vb" and Rv > 1):
            assert got.data_ptr() == x.data_ptr()
    rep = ((r, Rr), (e, Rr), (v, Rv), (b, Rv))
    for (got, R), x in zip(rep, ins):
        full = got[..., None].expand(got.shape + (R,)).reshape(got.shape[0], -1)
        torch.testing.assert_close(full, x.reshape(got.shape[0], -1), rtol=0, atol=0)


def test_gru_cpu_tensors_take_plain_versions_without_launch():
    wh, bh, h0, gi, keep = (x.requires_grad_(True) for x in _gru_inputs(4, 3, 8, 0))
    before = dict(gru_kernel.LAUNCHES)
    hf, hs = gru_kernel.gru_seq(wh, bh, h0, gi, keep)
    (hs.sum() + hf.sum()).backward()
    assert gru_kernel.LAUNCHES == before


@pytest.mark.parametrize("T,M,H", [(6, 5, 8), (1, 3, 4), (9, 17, 16)])
def test_gru_backward_matches_autograd_of_plain_forward(T, M, H):
    """The hand-written backward (dgi/dh0 recurrence + dwh/dbh reduction)
    equals autograd through the plain forward; keep gets a zero gradient
    and a missing cotangent counts as zeros."""
    ins = [x.requires_grad_(True) for x in _gru_inputs(T, M, H, seed=T + M)]
    w = torch.randn(T, M, H, generator=torch.Generator().manual_seed(1))
    _, hs = gru_kernel.gru_seq(*ins)
    got = torch.autograd.grad((hs * w).sum(), ins)
    _, hs_ref = gru_kernel.gru_seq_fwd_plain(*ins)
    want = torch.autograd.grad((hs_ref * w).sum(), ins[:4])
    for a, b in zip(got[:4], want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert torch.count_nonzero(got[4]) == 0


def _rnn_seq_grads(T, B, n, H, p_end, seed, consume, remat=False):
    """Every parameter's and h0's gradient of fc1→GRU→head through
    ``rnn_seq_apply(impl="kernel")`` (the plain versions on the CPU), the
    GRU's backward writing dgi over gi as the network asks (``consume``)
    or into a buffer of its own; with ``remat`` under the non-reentrant
    checkpoint that ``remat_actor`` puts around the actor. → (grads, the
    counters of the one backward)."""
    from cleanmarl_tpu_torch.core import networks as nets
    from cleanmarl_tpu_torch.core import tracing
    from cleanmarl_tpu_torch.core.params import tree_leaves, tree_unflatten

    g = torch.Generator().manual_seed(seed)
    params = nets.rnn_init(g, 11, H, 5, final_gain=0.01)
    obs = torch.randn(T, B, n, 11, generator=g)
    h0 = 0.5 * torch.randn(B, n, H, generator=g)
    ended = torch.rand(T, B, generator=g) < p_end
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    hx = h0.clone().requires_grad_(True)

    def apply(hx, *leaves):
        return nets.rnn_seq_apply(tree_unflatten(params, list(leaves)), hx, obs,
                                  reset_seq=ended, impl="kernel")

    gru_seq = gru_kernel.gru_seq

    def owned_elsewhere(*args, consume_gi=False):
        return gru_seq(*args, consume_gi=False)

    with pytest.MonkeyPatch.context() as mp:
        if not consume:
            mp.setattr(gru_kernel, "gru_seq", owned_elsewhere)
        with tracing.recording() as rec:
            if remat:
                hf, out = torch.utils.checkpoint.checkpoint(apply, hx, *leaves,
                                                            use_reentrant=False)
            else:
                hf, out = apply(hx, *leaves)
            grads = torch.autograd.grad((out * out).sum() + hf.sum(), leaves + [hx])
    return grads, rec.counter_values()


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("T,B,n,H,p_end", [(6, 4, 3, 8, 0.3), (9, 5, 3, 16, 0.2),
                                           (1, 3, 1, 8, 0.0), (7, 7, 5, 16, 0.5)])
def test_consuming_gi_gives_the_same_gradients_bitwise(T, B, n, H, p_end, remat):
    """The network's GRU backward writes dgi over its own gi: every
    parameter's and h0's gradient is bitwise that of the route that keeps
    gi, with resets, at ragged row counts (M = 15, 35) and at H = 8 and 16,
    with and without the actor's checkpoint, and the one backward read
    as in place."""
    got, counts = _rnn_seq_grads(T, B, n, H, p_end, seed=T * B + H, consume=True,
                                 remat=remat)
    want, counts_kept = _rnn_seq_grads(T, B, n, H, p_end, seed=T * B + H,
                                       consume=False, remat=remat)
    assert counts == {"gru.bwd_calls": 1, "gru.bwd_in_place": 1}
    assert counts_kept == {"gru.bwd_calls": 1, "gru.bwd_in_place": 0}
    assert len(got) == len(want) == 9
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_gru_backward_counters_read_engagement():
    """In one recording, a direct ``gru_seq`` backward counts one call and
    none in place (the network's counts one and one, above); nothing is
    counted with no recording open."""
    from cleanmarl_tpu_torch.core import tracing

    ins = [x.requires_grad_(True) for x in _gru_inputs(5, 6, 8, seed=2)]
    with tracing.recording() as rec:
        _, hs = gru_kernel.gru_seq(*ins)
        hs.sum().backward()
    assert rec.counter_values() == {"gru.bwd_calls": 1, "gru.bwd_in_place": 0}
    _, hs = gru_kernel.gru_seq(*ins)
    hs.sum().backward()
    assert rec.counter_values() == {"gru.bwd_calls": 1, "gru.bwd_in_place": 0}


@pytest.mark.parametrize("which", ["gru_seq_leaf_gi", "gru_seq_bwd"])
def test_public_gru_calls_leave_gi_intact(which):
    """The public ``gru_seq`` (with a leaf gi that needs its gradient) and
    ``gru_seq_bwd`` without an output buffer leave every input bitwise as
    it was."""
    ins = [x.requires_grad_(True) for x in _gru_inputs(6, 5, 8, seed=3)]
    before = [x.detach().clone() for x in ins]
    _, hs = gru_kernel.gru_seq(*ins)
    g = torch.randn_like(hs)
    if which == "gru_seq_leaf_gi":
        (hs * g).sum().backward()
        assert not torch.equal(ins[3].grad, ins[3].detach())
    else:
        args = [x.detach() for x in ins[:3]] + [hs.detach()] + [x.detach() for x in ins[3:]]
        before += [hs.detach().clone()]
        dgi, _, _ = gru_kernel.gru_seq_bwd(*args, g, torch.zeros_like(ins[2]))
        assert dgi.data_ptr() != ins[3].data_ptr()
        ins = ins + [hs]
    for a, b in zip(ins, before):
        assert torch.equal(a.detach(), b)


def _written_as_the_kernel_writes(wh, bh, h0, h_seq, gi, keep, g_hseq, g_hfinal, dgi=None):
    """The plain backward, its dgi stored into the buffer behind autograd's
    back, as the CUDA kernel stores it: the buffer's version stays."""
    got = gru_kernel.gru_seq_bwd_plain(wh, bh, h0, h_seq, gi, keep, g_hseq, g_hfinal)
    if dgi is None:
        return got
    dgi.data.copy_(got[0])
    return (dgi,) + got[1:]


@pytest.mark.parametrize("write", ["plain", "as_the_kernel"])
def test_second_backward_through_consumed_gi_raises(write, monkeypatch):
    """After the backward wrote over gi, a second backward through a
    retained graph refuses with autograd's in-place error instead of
    reading the gradient as gi, also where the write itself bumped no
    version (the kernel's)."""
    if write == "as_the_kernel":
        monkeypatch.setattr(gru_kernel, "gru_seq_bwd", _written_as_the_kernel_writes)
    from cleanmarl_tpu_torch.core import networks as nets

    g = torch.Generator().manual_seed(0)
    params = nets.rnn_init(g, 7, 8, 3, device="cpu")
    for p in (params["fc1"]["w"], params["gru"]["wh"]):
        p.requires_grad_(True)
    obs = torch.randn(4, 3, 2, 7, generator=g)
    hf, out = nets.rnn_seq_apply(params, torch.zeros(3, 2, 8), obs, impl="kernel")
    loss = (out * out).sum() + hf.sum()
    torch.autograd.grad(loss, [params["fc1"]["w"], params["gru"]["wh"]], retain_graph=True)
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        torch.autograd.grad(loss, [params["fc1"]["w"], params["gru"]["wh"]])


def test_kernel_supports_and_backward_route_by_width():
    for h in (4, 8, 100, 128, 256, 512):
        assert gru_kernel.kernel_supports(h)
    for h in (0, 6, 101, 516, 1024):
        assert not gru_kernel.kernel_supports(h)
    for h in (32, 64, 96, 128):
        assert gru_kernel.fwd_route(h) == "gru_seq_fwd"
        assert gru_kernel.bwd_route(h) == "gru_seq_bwd"
    for h in (8, 16, 100, 160, 256, 512):
        assert gru_kernel.fwd_route(h) == "gru_seq_fwd_l2"
        assert gru_kernel.bwd_route(h) == "gru_seq_bwd_l2"
    assert set(gru_kernel.LAUNCHES) == {"gru_seq_fwd", "gru_seq_fwd_l2", "gru_seq_bwd",
                                        "gru_seq_bwd_l2", "gru_seq_dw"}


def test_library_path_hashes_the_shared_header(tmp_path, monkeypatch):
    """An edited csrc/*.cuh renames every library (a stale build is never
    reused); an unchanged tree keeps its names."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    assert {n: _build.library_path(n) for n in _build.SOURCES} == before
    header = src / "tf32_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
    assert all(after[n].parent == _build.BUILD_DIR for n in _build.SOURCES)


@pytest.mark.parametrize("R,H", [(60 * 3072, 128), (60 * 3077, 128), (84, 16),
                                 (0, 8), (60 * 3072, 256), (4 * 40, 512)])
def test_dw_splits_cover_rows_in_whole_slabs(R, H):
    n_sm, tile, slab = 132, 128, 64      # csrc/gru_seq_bwd.cu: DW_BM = DW_BN, DW_BK
    tiles = -(-3 * H // tile) * -(-H // tile)
    S, rows = gru_kernel.dw_splits(R, tiles, slab, n_sm)
    assert rows % slab == 0
    assert S * rows >= R and (S - 1) * rows < max(R, 1)
    assert S == 1 or S * tiles <= n_sm
    if (R, H) == (60 * 3072, 128):
        assert (S, rows) == (44, 4224)     # 3 tiles x 44 splits = 132 blocks


def _tf32(x, nearest=True):
    """float32 → TF32 (10 mantissa bits): to nearest, ties away from zero,
    as cvt.rna.tf32.f32 rounds, or truncated, as the mma reads an operand."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (0x1000 if nearest else 0)) & ~0x1FFF).view(torch.float32)


def _split(x):
    """The kernels' split: big rounded to nearest, small = x - big as the
    mma reads it."""
    big = _tf32(x)
    return big, _tf32(x - big, nearest=False)


@pytest.mark.parametrize("case", ["dw_rows_184320", "dh_k_384"])
def test_3xtf32_split_meets_grad_tol(case):
    """The backward kernels' precision scheme, emulated on the CPU: a
    product as big*big + big*small + small*big of TF32 halves stays within
    the card tests' gradient tolerance of float64, while one TF32 product
    (big*big) does not. The sums are taken in float64 (each product of two
    TF32 values is exact there), so the test isolates the split's own
    error; float32 accumulation adds what any float32 matmul adds. Cases: a
    32 x 32 block of h_prevᵀ·dgh over the main path's 184,320 rows (T=60,
    M=3072), and dgh @ whᵀ with K = 3H = 384."""
    rng = np.random.RandomState(5)
    if case == "dw_rows_184320":
        a = np.tanh(rng.randn(32, 60 * 3072))            # h_prevᵀ: k x rows
        b = rng.randn(60 * 3072, 32)                     # dgh: rows x c
    else:
        a = rng.randn(512, 384)                          # dgh: rows x 3H
        b = rng.randn(384, 128) / np.sqrt(128)           # whᵀ: 3H x H
    want = torch.as_tensor(a @ b)
    a32, b32 = (torch.as_tensor(x.astype(np.float32)) for x in (a, b))
    (ab, as_), (bb, bs) = (tuple(x.double() for x in _split(y)) for y in (a32, b32))
    three = as_ @ bb + ab @ bs + ab @ bb
    one = ab @ bb

    def within(got):
        err = (got.double() - want).abs()
        return bool((err <= GRAD_TOL + 1e-4 * want.abs()).all())
    assert within(three)
    assert not within(one)


def _trunc32(x):
    """float64 → float32 rounded toward zero, as the tensor core adds into
    its float32 accumulator."""
    f = x.float()
    over = f.double().abs() > x.abs()
    f[over] = torch.nextafter(f[over], torch.zeros_like(f[over]))
    return f


def _mma_rounds(a_halves, b_halves, kc=4):
    """a @ b as csrc/gru_seq_fwd.cu sums it: per 8-deep k-step three passes
    (small·big, big·small, big·big), each an exact 8-term sum truncated into
    a float32 accumulator; fresh accumulators every ``kc`` k-steps, added
    into the total with rounded float32 adds."""
    (ab, as_), (bb, bs) = a_halves, b_halves
    tot = torch.zeros(ab.shape[0], bb.shape[1])
    acc = torch.zeros_like(tot)
    for ks in range(ab.shape[1] // 8):
        k = slice(8 * ks, 8 * ks + 8)
        for a, b in ((as_, bb), (ab, bs), (ab, bb)):
            acc = _trunc32(acc.double() + a[:, k].double() @ b[k].double())
        if (ks + 1) % kc == 0:
            tot, acc = tot + acc, torch.zeros_like(acc)
    return tot


@pytest.mark.parametrize("accumulate", ["exact", "mma_rounds"])
def test_3xtf32_fwd_recurrence_meets_val_tol(accumulate):
    """The forward kernel's precision scheme, emulated on the CPU: 60 steps
    of the GRU recurrence at H = 128 over 64 rows, with gh = h @ wh taken
    as big·big + big·small + small·big of TF32 halves and the carry kept in
    float32, stays within VAL_TOL of a float64 recurrence; one TF32 product
    (big·big) does not. "exact" sums each step's products in float64;
    "mma_rounds" sums them as the kernel does (``_mma_rounds``)."""
    ins = _gru_inputs(60, 64, 128, seed=11)
    wh, bh, h0, gi, keep = ins
    H, w_halves = 128, _split(wh)

    def three(h):
        if accumulate == "mma_rounds":
            return _mma_rounds(_split(h), w_halves)
        (ab, as_), (bb, bs) = (tuple(x.double() for x in y) for y in (_split(h), w_halves))
        return (as_ @ bb + ab @ bs + ab @ bb).float()

    def one(h):
        return (_split(h)[0].double() @ w_halves[0].double()).float()

    def recurrence(product):
        h, out = h0, []
        for t in range(gi.shape[0]):
            r, z, n = gru_kernel._gates(gi[t], product(h) + bh, H)
            h2 = (1.0 - z) * n + z * h
            out.append(h2)
            h = keep[t][:, None] * h2
        return torch.stack(out)

    want = gru_kernel.gru_seq_fwd_plain(*(x.double() for x in ins))[1]
    err_three = float((recurrence(three).double() - want).abs().max())
    err_one = float((recurrence(one).double() - want).abs().max())
    assert err_three <= VAL_TOL
    assert err_one > VAL_TOL


def test_gru_kernel_wrappers_reject_bad_inputs_before_launch():
    wh, bh, h0, gi, keep = _gru_inputs(3, 4, 6, seed=0)
    with pytest.raises(ValueError):
        gru_kernel._dims(wh.shape[0], gi)              # H = 6 is not % 4
    wh, bh, h0, gi, keep = _gru_inputs(3, 4, 8, seed=0)
    with pytest.raises(ValueError):
        gru_kernel._check("gru_seq_fwd", dict(keep=(keep[:, :2], (3, 4))), gi)
    with pytest.raises(TypeError):
        gru_kernel._check("gru_seq_fwd", dict(gi=(gi.double(), gi.shape)), gi)


def test_gru_kernel_wrappers_reject_misaligned_views():
    """The kernels read in 16-byte vectors: a contiguous view that starts
    off a 16-byte boundary is refused, except keep (read by element)."""
    flat = torch.zeros(4 + 4 * 8)
    h0 = flat[1:33].view(4, 8)
    assert h0.is_contiguous() and h0.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        gru_kernel._check("gru_seq_bwd", dict(h0=(h0, (4, 8))), h0)
    gru_kernel._check("gru_seq_bwd", dict(keep=(h0, (4, 8))), h0)
    gru_kernel._check("gru_seq_bwd", dict(h0=(flat[4:].view(4, 8), (4, 8))), h0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CENTRAL = ("r", "e", "v", "b")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,p_end,per_env", [
    ((7, 5, 3), 0.2, ()), ((25, 130), 0.0, ()), ((60, 8192, 3), 0.02, ()),
    ((60, 8192, 3), 0.02, CENTRAL),          # the main path, R = 3
    ((60, 8191, 3), 0.02, CENTRAL),          # ragged last block
    ((1, 77, 3), 0.2, CENTRAL), ((1, 77), 0.2, ()),          # T = 1
    ((21, 50, 3), 0.1, ("r", "e")),          # one step over a 20-step chunk
    ((257, 1000, 3), 0.02, CENTRAL),         # T over three chunks in flight
    ((257, 130), 0.05, ()), ((60, 1000, 3), 0.05, ("r", "e")),
    ((150, 64, 3), 0.03, ("r", "e")),        # COMA on 3m: team reward and flag, R = (3, 1)
    ((100, 64, 8), 0.01, ("r", "e")),        # IPPO on pursuit: R = (8, 1)
    ((150, 64, 2), 0.03, ("r", "e")),        # IPPO on LBF: R = (2, 1)
    ((150, 64, 2), 0.03, ("e",))])           # COMA on LBF, per-agent rewards: R = 1
def test_returns_kernel_matches_plain_on_card(shape, p_end, per_env):
    """The kernel against the plain loop at R = 1 and 3, a ragged B, T = 1,
    T = 60, T over several chunks, COMA's update (T=150, 64 envs x 3
    agents), IPPO's on pursuit (T=100, 64 envs x 8 agents) and on LBF
    (T=150, 64 x 2) and COMA's with per-agent LBF rewards (only the flag
    broadcast, so both are read materialised); each call counts one
    launch."""
    _card()
    r, e, v, b = _returns_inputs(shape, p_end, seed=1, device="cuda", per_env=per_env)
    n0 = returns_kernel.LAUNCHES["lambda_returns"]
    g, a = returns_kernel.lambda_returns_kernel(r, e, v, b, 0.99, 0.95)
    assert returns_kernel.LAUNCHES["lambda_returns"] == n0 + 1
    g2, a2 = returns_kernel.lambda_returns_plain(r, e, v, b, 0.99, 0.95)
    torch.testing.assert_close(g, g2, **RET_TOL)
    torch.testing.assert_close(a, a2, **RET_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,per_env", [((60, 8192, 3), CENTRAL), ((257, 130), ())])
def test_returns_kernel_is_bitwise_deterministic_on_card(shape, per_env):
    _card()
    ins = _returns_inputs(shape, 0.05, seed=6, device="cuda", per_env=per_env)
    first = returns_kernel.lambda_returns_kernel(*ins, 0.99, 0.95)
    second = returns_kernel.lambda_returns_kernel(*ins, 0.99, 0.95)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("T,M,H", [(7, 12, 16), (5, 3, 8), (9, 37, 128),
                                   (60, 3072, 128), (8, 100, 256),
                                   (4, 40, 512), (60, 3077, 128),
                                   (7, 33, 32), (6, 50, 64), (5, 45, 96),
                                   (5, 20, 100), (150, 96, 64), (2, 96, 64),
                                   (25, 64, 64), (150, 192, 64), (150, 128, 64)])
def test_gru_kernels_match_plain_on_card(T, M, H):
    """Each kernel against its plain version, at the test shapes, the main
    path's (T=60, M=3072, H=128), a ragged one that cuts the row tiles and
    the dw slabs (M=3077, R=184,620), every tensor-core width, widths of
    the L2 routes (8, 16, 100, 256, 512), the recurrent-Q update's (32
    episodes x 3 agents at H=64: whole episodes of T=150, chunks after
    burn-in of T=2), recurrent MADDPG's (32 speaker-listener episodes x 2
    agents, T=25), recurrent COMA's (a 3m rollout of 64 envs x 3
    agents, T=150) and recurrent IPPO's and COMA's on LBF (64 envs x 2
    agents, T=150); each recurrence goes through the route of its width."""
    _card()
    wh, bh, h0, gi, keep = _gru_inputs(T, M, H, seed=H, device="cuda")
    fwd = gru_kernel.fwd_route(H)
    n0 = gru_kernel.LAUNCHES[fwd]
    hf, hs = gru_kernel.gru_seq_fwd(wh, bh, h0, gi, keep)
    assert gru_kernel.LAUNCHES[fwd] == n0 + 1
    hf2, hs2 = gru_kernel.gru_seq_fwd_plain(wh, bh, h0, gi, keep)
    torch.testing.assert_close(hs, hs2, atol=VAL_TOL, rtol=0)
    torch.testing.assert_close(hf, hf2, atol=VAL_TOL, rtol=0)
    g = torch.randn_like(hs)
    gf = torch.randn_like(hf)
    route = gru_kernel.bwd_route(H)
    n0 = gru_kernel.LAUNCHES[route]
    got = gru_kernel.gru_seq_bwd(wh, bh, h0, hs, gi, keep, g, gf)
    assert gru_kernel.LAUNCHES[route] == n0 + 1
    want = gru_kernel.gru_seq_bwd_plain(wh, bh, h0, hs, gi, keep, g, gf)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=GRAD_TOL, rtol=1e-4)
    dw = gru_kernel.gru_seq_dw(h0, hs, keep, got[0], got[1])
    dw2 = gru_kernel.gru_seq_dw_plain(h0, hs, keep, got[0], got[1])
    for a, b in zip(dw, dw2):
        torch.testing.assert_close(a, b, atol=GRAD_TOL, rtol=1e-4)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("T,M,H", [(60, 3072, 128), (60, 13824, 128), (9, 37, 32),
                                   (13, 77, 256)])
def test_gru_seq_bwd_writing_dgi_over_gi_is_bitwise_on_card(T, M, H):
    """K3 (and at H = 256 its L2 route) launched with dgi on gi's storage
    gives bitwise the out-of-place dgi, dghn and dh0, and dw over them
    bitwise the same dwh and dbh: at the 3m and 27m_vs_30m updates'
    shapes, a ragged tensor-core one and an L2 one."""
    _card()
    wh, bh, h0, gi, keep = _gru_inputs(T, M, H, seed=T + H, device="cuda")
    _, hs = gru_kernel.gru_seq_fwd(wh, bh, h0, gi, keep)
    g, gf = torch.randn_like(hs), torch.randn_like(h0)
    want = gru_kernel.gru_seq_bwd(wh, bh, h0, hs, gi, keep, g, gf)
    want += gru_kernel.gru_seq_dw(h0, hs, keep, want[0], want[1])
    buf = gi.clone()
    got = gru_kernel.gru_seq_bwd(wh, bh, h0, hs, buf, keep, g, gf, dgi=buf)
    assert got[0].data_ptr() == buf.data_ptr()
    got += gru_kernel.gru_seq_dw(h0, hs, keep, got[0], got[1])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_consuming_gi_cuts_the_backward_peak_by_gi_on_card():
    """One ``rnn_seq_apply(impl="kernel")`` at the 27m_vs_30m update's
    shape (T=60, 512 envs x 27 agents, H=128, obs 312): the backward's own
    peak (stats reset after the forward) falls by gi's bytes,
    1,274,019,840, against the route that keeps gi, up to the caching
    allocator's rounding of a block that large to 2 MiB (1,275,068,416).
    One backward runs first: the first on autograd's thread allocates
    that thread's cuBLAS workspace (32 MiB on this card)."""
    _card()
    from cleanmarl_tpu_torch.core import networks as nets
    from cleanmarl_tpu_torch.core.params import tree_leaves, tree_unflatten

    T, B, n, H = 60, 512, 27, 128
    g = torch.Generator("cuda").manual_seed(0)
    params = nets.rnn_init(g, 312, H, 36, final_gain=0.01, device="cuda")
    obs = torch.randn(T, B, n, 312, generator=g, device="cuda")
    h0 = torch.zeros(B, n, H, device="cuda")
    gru_seq = gru_kernel.gru_seq

    def backward_peak(consume):
        torch.cuda.empty_cache()
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with pytest.MonkeyPatch.context() as mp:
            if not consume:
                mp.setattr(gru_kernel, "gru_seq",
                           lambda *a, consume_gi=False: gru_seq(*a, consume_gi=False))
            hf, out = nets.rnn_seq_apply(tree_unflatten(params, leaves), h0, obs,
                                         impl="kernel")
            loss = out.square().sum() + hf.sum()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
        del hf, out, loss, grads, leaves
        return peak

    gi_bytes = T * B * n * 3 * H * 4
    assert gi_bytes == 1_274_019_840
    backward_peak(True)
    kept, consumed = backward_peak(False), backward_peak(True)
    assert gi_bytes <= kept - consumed <= -(-gi_bytes // 2**21) * 2**21, (kept, consumed)


@pytest.mark.cuda
def test_bias_in_place_cuts_the_forward_peak_by_the_product_on_card():
    """``_gru_seq_kernel`` at the 3m update's shape (T=60, 1024 envs x 3
    agents, H=128, obs 33), wi's bias added in place over its product
    (and fc1's relu over fc1's sum) against the out-of-place forms: the
    input projection's peak (stats reset
    before each forward) falls by the product's bytes, 283,115,520 (135
    whole 2 MiB blocks); the whole forward's, whose peak then moves to
    the GRU launch, by that less what the launch allocates beside gi
    (h_seq, h_final; keep just before it). The outputs and every gradient
    are bitwise equal, and the backward still writes dgi over gi. One
    forward and backward run first: the first builds and loads the
    kernels and takes autograd's thread's cuBLAS workspace."""
    _card()
    from cleanmarl_tpu_torch.core import networks as nets
    from cleanmarl_tpu_torch.core import tracing
    from cleanmarl_tpu_torch.core.params import tree_leaves, tree_unflatten

    T, B, n, H, n_in = 60, 1024, 3, 128, 33
    M = B * n
    g = torch.Generator("cuda").manual_seed(0)
    params = nets.rnn_init(g, n_in, H, 9, final_gain=0.01, device="cuda")
    params = {"fc1": params["fc1"], "gru": params["gru"]}
    for p in tree_leaves(params):
        p.add_(0.1 * torch.randn(p.shape, generator=g, device="cuda"))
    x = torch.randn(T, B, n, n_in, generator=g, device="cuda")
    h0 = 0.5 * torch.randn(B, n, H, generator=g, device="cuda")
    reset = torch.rand(T, B, generator=g, device="cuda") < 0.05

    def out_of_place(x, w, b, dtype=None):
        return nets.matmul(x, w, dtype) + b

    def relu_out_of_place(p, x, dtype=None):
        return torch.relu(nets.dense(p, x, dtype))

    def peak_of(f):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = f()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    def run(in_place):
        torch.cuda.empty_cache()
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        hx = h0.clone().requires_grad_(True)
        ps = tree_unflatten(params, leaves)
        with pytest.MonkeyPatch.context() as mp:
            if not in_place:
                mp.setattr(nets, "_affine", out_of_place)
                mp.setattr(nets, "_dense_relu", relu_out_of_place)
            gi, proj = peak_of(lambda: nets.gru_input_proj(ps, x))
            del gi
            (hf, hs), fwd = peak_of(lambda: nets._gru_seq_kernel(ps, hx, x, reset))
            with tracing.recording() as rec:
                grads = torch.autograd.grad((hs * hs).sum() + hf.sum(), leaves + [hx])
        return [hf.detach(), hs.detach(), *grads], proj, fwd, rec.counter_values()

    run(True)
    got, proj_in, fwd_in, counts = run(True)
    want, proj_out, fwd_out, counts_out = run(False)
    product = T * M * 3 * H * 4
    launch = (T * M * H + M * H + T * M) * 4
    assert product == 283_115_520 and product % 2**21 == 0
    assert proj_out - proj_in == product, (proj_out, proj_in)
    assert fwd_out - fwd_in >= product - launch, (fwd_out, fwd_in)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert counts == counts_out == {"gru.bwd_calls": 1, "gru.bwd_in_place": 1}


@pytest.mark.cuda
def test_relu_in_place_cuts_the_critics_peak_by_a_layer_on_card():
    """The 3m update's critic values over the whole rollout (``ppo.returns``,
    no grad: T=60, 8192 envs, state 48, two hidden layers of 128): with
    each relu written over its layer's fresh sum, two (T, E, 128) buffers
    are live at once where three were (the layer's input, its sum and the
    relu's output), so the peak falls by one, 251,658,240 bytes (120 whole
    2 MiB blocks); the values are bitwise equal. With grad, on a minibatch
    (1024 envs), the values and every gradient are bitwise equal."""
    _card()
    from cleanmarl_tpu_torch.core import networks as nets
    from cleanmarl_tpu_torch.core.params import tree_leaves, tree_unflatten

    T, E, S, H = 60, 8192, 48, 128
    g = torch.Generator("cuda").manual_seed(1)
    params = nets.mlp_init(g, S, H, 1, num_layers=1, device="cuda")
    for p in tree_leaves(params):
        p.add_(0.1 * torch.randn(p.shape, generator=g, device="cuda"))
    state = torch.randn(T, E, S, generator=g, device="cuda")

    def run(in_place):
        torch.cuda.empty_cache()
        with pytest.MonkeyPatch.context() as mp:
            if not in_place:
                mp.setattr(nets, "_dense_relu",
                           lambda p, x, dtype=None: torch.relu(nets.dense(p, x, dtype)))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with torch.no_grad():
                v = nets.mlp_apply(params, state)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
            vg = nets.mlp_apply(tree_unflatten(params, leaves), state[:, :1024])
            grads = torch.autograd.grad(vg.square().sum(), leaves)
        return [v, vg.detach(), *grads], peak

    run(True)
    got, peak_in = run(True)
    want, peak_out = run(False)
    layer = T * E * H * 4
    assert layer == 251_658_240 and layer % 2**21 == 0
    assert peak_out - peak_in == layer, (peak_out, peak_in)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("T,M,H", [(60, 3072, 128), (13, 77, 256)])
def test_gru_seq_dw_is_bitwise_deterministic_on_card(T, M, H):
    _card()
    wh, bh, h0, gi, keep = _gru_inputs(T, M, H, seed=3, device="cuda")
    _, hs = gru_kernel.gru_seq_fwd(wh, bh, h0, gi, keep)
    dgi, dghn, _ = gru_kernel.gru_seq_bwd(wh, bh, h0, hs, gi, keep,
                                          torch.randn_like(hs), torch.randn_like(h0))
    first = gru_kernel.gru_seq_dw(h0, hs, keep, dgi, dghn)
    second = gru_kernel.gru_seq_dw(h0, hs, keep, dgi, dghn)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("T,M,H", [(60, 3072, 128), (9, 37, 32), (13, 77, 256)])
def test_gru_seq_fwd_is_bitwise_deterministic_on_card(T, M, H):
    _card()
    ins = _gru_inputs(T, M, H, seed=4, device="cuda")
    first = gru_kernel.gru_seq_fwd(*ins)
    second = gru_kernel.gru_seq_fwd(*ins)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [150, 2, 8])
def test_rnn_seq_eval_next_kernel_route_matches_scan_on_card(T):
    """The recurrent-Q target stream at the update's shape (32 episodes x 3
    agents, obs 33, H=64, 9 actions): one K2 forward and one batched GRU
    step against the scan of two cells per step; values at 1e-5."""
    _card()
    from cleanmarl_tpu_torch.core import networks as nets

    g = torch.Generator("cuda").manual_seed(T)
    params = nets.rnn_init(g, 33, 64, 9, device="cuda")
    obs = torch.randn(T, 32, 3, 33, generator=g, device="cuda")
    next_obs = torch.randn(T, 32, 3, 33, generator=g, device="cuda")
    h0 = nets.rnn_initial_state((32, 3), 64, device="cuda")
    n0 = gru_kernel.LAUNCHES["gru_seq_fwd"]
    with torch.no_grad():
        got = nets.rnn_seq_eval_next(params, h0, obs, next_obs, impl="kernel")
        want = nets.rnn_seq_eval_next(params, h0, obs, next_obs, impl="scan")
    assert gru_kernel.LAUNCHES["gru_seq_fwd"] == n0 + 1
    torch.testing.assert_close(got, want, atol=VAL_TOL, rtol=0)


def _rnn_seq_apply_kernel_vs_scan(T, B, n, n_obs, n_actions, p_end, seed):
    """The kernel route of ``rnn_seq_apply`` at H=64 (one K2, then K3 and
    dw) against the scan, from a non-zero carry with resets at per-env
    episode ends: values at 1e-5, every gradient at 2e-4 of its largest
    entry."""
    from cleanmarl_tpu_torch.core import networks as nets
    from cleanmarl_tpu_torch.core.params import tree_leaves, tree_unflatten

    g = torch.Generator("cuda").manual_seed(seed)
    params = nets.rnn_init(g, n_obs, 64, n_actions, final_gain=0.01, device="cuda")
    obs = torch.randn(T, B, n, n_obs, generator=g, device="cuda")
    h0 = 0.5 * torch.randn(B, n, 64, generator=g, device="cuda")
    ended = torch.rand(T, B, generator=g, device="cuda") < p_end

    def run(impl):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        hx = h0.clone().requires_grad_(True)
        hf, out = nets.rnn_seq_apply(tree_unflatten(params, leaves), hx, obs,
                                     reset_seq=ended, impl=impl)
        return out.detach(), torch.autograd.grad((out * out).sum() + hf.sum(), leaves + [hx])
    n0 = {k: gru_kernel.LAUNCHES[k] for k in ("gru_seq_fwd", "gru_seq_bwd", "gru_seq_dw")}
    out_k, grads_k = run("kernel")
    assert {k: gru_kernel.LAUNCHES[k] - v for k, v in n0.items()} == {
        "gru_seq_fwd": 1, "gru_seq_bwd": 1, "gru_seq_dw": 1}
    out_s, grads_s = run("scan")
    torch.testing.assert_close(out_k, out_s, atol=VAL_TOL, rtol=0)
    for a, b in zip(grads_k, grads_s):
        torch.testing.assert_close(a, b, atol=GRAD_TOL * max(1.0, float(b.abs().max())), rtol=0)


@pytest.mark.cuda
def test_rnn_seq_apply_with_resets_kernel_route_matches_scan_on_card():
    """Recurrent COMA's actor recompute at its update's shape on 3m (T=150,
    64 envs x 3 agents, obs 33, 9 actions)."""
    _card()
    _rnn_seq_apply_kernel_vs_scan(150, 64, 3, 33, 9, 0.03, seed=5)


@pytest.mark.cuda
def test_rnn_seq_apply_at_lbf_shape_kernel_route_matches_scan_on_card():
    """Recurrent IPPO's and COMA's actor recompute on LBF 8x8-2p-3f (T=150,
    64 envs x 2 agents, obs 15 + 2 agent ids, 6 actions: M=128)."""
    _card()
    _rnn_seq_apply_kernel_vs_scan(150, 64, 2, 17, 6, 0.02, seed=6)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["lambda_returns_T0", "lambda_returns_B0", "gru_seq_fwd",
                                   "gru_seq_bwd", "gru_seq_dw"])
def test_wrappers_refuse_empty_inputs_on_card(which):
    """A data-parallel rank with no rows (M = 0) or no columns must not
    launch a kernel with an empty grid: each wrapper raises, and no launch
    is counted."""
    _card()
    before = {**returns_kernel.LAUNCHES, **gru_kernel.LAUNCHES}
    if which.startswith("lambda_returns"):
        shape = (0, 12) if which.endswith("T0") else (8, 0)
        r, e, v = (torch.zeros(shape, device="cuda") for _ in range(3))
        with pytest.raises(ValueError, match="empty"):
            returns_kernel.lambda_returns_kernel(r, e.bool(), v, v[0] if shape[0] else
                                                 torch.zeros(shape[1:], device="cuda"),
                                                 0.99, 0.95)
    else:
        wh, bh, h0, gi, keep = _gru_inputs(6, 0, 64, seed=0, device="cuda")
        hs = torch.zeros((6, 0, 64), device="cuda")
        with pytest.raises(ValueError, match="empty"):
            if which == "gru_seq_fwd":
                gru_kernel.gru_seq_fwd(wh, bh, h0, gi, keep)
            elif which == "gru_seq_bwd":
                gru_kernel.gru_seq_bwd(wh, bh, h0, hs, gi, keep, hs, h0)
            else:
                gru_kernel.gru_seq_dw(h0, hs, keep, gi, hs)
    assert {**returns_kernel.LAUNCHES, **gru_kernel.LAUNCHES} == before


@pytest.mark.cuda
def test_gru_kernels_on_an_interleaved_half_equal_the_full_rows_on_card():
    """The main path's minibatch (T=60, 1024 envs x 3 agents, H=128) split
    over 2 ranks by env (rank r takes envs r, r + 2, ...): K2 and K3 on one
    rank's rows give bitwise the same rows as the full call, since every row
    runs its own recurrence."""
    _card()
    T, envs, n, H = 60, 1024, 3, 128
    wh, bh, h0, gi, keep = _gru_inputs(T, envs * n, H, seed=9, device="cuda")
    g = torch.randn(T, envs * n, H, device="cuda")
    gf = torch.randn(envs * n, H, device="cuda")
    hf, hs = gru_kernel.gru_seq_fwd(wh, bh, h0, gi, keep)
    full_bwd = gru_kernel.gru_seq_bwd(wh, bh, h0, hs, gi, keep, g, gf)
    for rank in range(2):
        rows = (torch.arange(rank, envs, 2, device="cuda")[:, None] * n
                + torch.arange(n, device="cuda")).reshape(-1)

        def part(x, axis):
            return x.index_select(axis, rows).contiguous()
        hf_r, hs_r = gru_kernel.gru_seq_fwd(wh, bh, part(h0, 0), part(gi, 1), part(keep, 1))
        assert torch.equal(hf_r, part(hf, 0)) and torch.equal(hs_r, part(hs, 1))
        got = gru_kernel.gru_seq_bwd(wh, bh, part(h0, 0), hs_r, part(gi, 1), part(keep, 1),
                                     part(g, 1), part(gf, 0))
        for a, b, axis in zip(got, full_bwd, (1, 1, 0)):
            assert torch.equal(a, part(b, axis))
    torch.cuda.synchronize()
