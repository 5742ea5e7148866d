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
    ((257, 130), 0.05, ()), ((60, 1000, 3), 0.05, ("r", "e"))])
def test_returns_kernel_matches_plain_on_card(shape, p_end, per_env):
    """The kernel against the plain loop at R = 1 and 3, a ragged B, T = 1,
    T = 60 and T over several chunks; each call counts one launch."""
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
                                   (5, 20, 100)])
def test_gru_kernels_match_plain_on_card(T, M, H):
    """Each kernel against its plain version, at the test shapes, the main
    path's (T=60, M=3072, H=128), a ragged one that cuts the row tiles and
    the dw slabs (M=3077, R=184,620), every tensor-core width, and widths of
    the L2 routes (8, 16, 100, 256, 512); each recurrence goes through the
    route of its width."""
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
