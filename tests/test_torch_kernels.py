"""The port's kernel wrappers: the CPU path (plain versions, no launch,
hand-written GRU backward against autograd) and, on the card, each CUDA
kernel against its plain version.

This file imports neither JAX nor the JAX package, so the card tests run
on a machine without JAX (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

Tolerances: λ-returns rtol=2e-5/atol=1e-5; GRU values 1e-5 and
gradients 2e-4 (float32 FMA on the card, summed in another order than
the plain version's matmuls; TF32 off).
"""
import numpy as np
import pytest
import torch

from cleanmarl_tpu_torch.ops import gru_kernel, returns_kernel

torch.set_num_threads(1)
RET_TOL = dict(rtol=2e-5, atol=1e-5)
VAL_TOL = 1e-5
GRAD_TOL = 2e-4


def _returns_inputs(shape, p_end, seed, device="cpu"):
    rng = np.random.RandomState(seed)
    xs = (rng.randn(*shape).astype(np.float32), rng.rand(*shape) < p_end,
          rng.randn(*shape).astype(np.float32),
          rng.randn(*shape[1:]).astype(np.float32))
    return [torch.as_tensor(x, device=device) for x in xs]


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


def test_gru_kernel_wrappers_reject_bad_inputs_before_launch():
    wh, bh, h0, gi, keep = _gru_inputs(3, 4, 6, seed=0)
    with pytest.raises(ValueError):
        gru_kernel._dims(wh.shape[0], gi)              # H = 6 is not % 4
    wh, bh, h0, gi, keep = _gru_inputs(3, 4, 8, seed=0)
    with pytest.raises(ValueError):
        gru_kernel._check("gru_seq_fwd", dict(keep=(keep[:, :2], (3, 4))), gi)
    with pytest.raises(TypeError):
        gru_kernel._check("gru_seq_fwd", dict(gi=(gi.double(), gi.shape)), gi)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape,p_end", [((7, 5, 3), 0.2), ((25, 130), 0.0),
                                         ((60, 8192, 3), 0.02)])
def test_returns_kernel_matches_plain_on_card(shape, p_end):
    _card()
    r, e, v, b = _returns_inputs(shape, p_end, seed=1, device="cuda")
    n0 = returns_kernel.LAUNCHES["lambda_returns"]
    g, a = returns_kernel.lambda_returns_kernel(r, e, v, b, 0.99, 0.95)
    assert returns_kernel.LAUNCHES["lambda_returns"] == n0 + 1
    g2, a2 = returns_kernel.lambda_returns_plain(r, e, v, b, 0.99, 0.95)
    torch.testing.assert_close(g, g2, **RET_TOL)
    torch.testing.assert_close(a, a2, **RET_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("T,M,H", [(7, 12, 16), (5, 3, 8), (9, 37, 128),
                                   (60, 3072, 128), (8, 100, 256),
                                   (4, 40, 512)])
def test_gru_kernels_match_plain_on_card(T, M, H):
    _card()
    wh, bh, h0, gi, keep = _gru_inputs(T, M, H, seed=H, device="cuda")
    hf, hs = gru_kernel.gru_seq_fwd(wh, bh, h0, gi, keep)
    hf2, hs2 = gru_kernel.gru_seq_fwd_plain(wh, bh, h0, gi, keep)
    torch.testing.assert_close(hs, hs2, atol=VAL_TOL, rtol=0)
    torch.testing.assert_close(hf, hf2, atol=VAL_TOL, rtol=0)
    g = torch.randn_like(hs)
    gf = torch.randn_like(hf)
    got = gru_kernel.gru_seq_bwd(wh, bh, h0, hs, gi, keep, g, gf)
    want = gru_kernel.gru_seq_bwd_plain(wh, bh, h0, hs, gi, keep, g, gf)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=GRAD_TOL, rtol=1e-4)
    dw = gru_kernel.gru_seq_dw(h0, hs, keep, got[0], got[1])
    dw2 = gru_kernel.gru_seq_dw_plain(h0, hs, keep, got[0], got[1])
    for a, b in zip(dw, dw2):
        torch.testing.assert_close(a, b, atol=GRAD_TOL, rtol=1e-4)
    torch.cuda.synchronize()
