#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``cleanmarl_tpu_torch``) on one
NVIDIA GPU, from the sources in this checkout.

    python3 chip_smoke.py [--out results.json]

Phases, each of which must pass:

1. print the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and build every CUDA kernel from ``csrc/`` (one
   ``nvcc`` per source, all at once);
2. hold each kernel against its plain PyTorch version on the card (TF32
   off for the plain versions; the GRU tensor-core kernels compute in
   3xTF32 whatever that flag says), at the test shapes, the ragged-edge
   shapes (rows that cut the kernels' tiles and slabs), every width of
   both routes of the forward and the backward, and the main path's
   shapes; check that the forward and the weight gradient are bitwise the
   same on two launches, and report both against float64; time kernel,
   plain version and, where one PyTorch call computes the same function,
   that call (a yardstick only: the port never calls it); time the card's
   TF32 ``mma.sync`` peak (``csrc/mma_rate.cu``), the tensor-core kernels'
   ceiling. The λ-return kernel is also held at inputs broadcast over the
   agents (read without a copy), T = 1 and T = 257, and timed by its device
   time alone: CUDA graphs of its launches replayed between CUDA events,
   cold (each launch after an L2 flush, the flushes' own time subtracted)
   and warm (back to back), beside the kernel it replaced, one copy of as
   many bytes, and the wrapper's host time per call;
3. check one PPO update of the port on the card against the same update
   on the CPU (plain versions) on a small input, then drive the main
   path: recurrent MAPPO on SMAClite 3m at the bench settings (GRU
   actor and critic of width 128, 8192 envs, rollouts of 60 steps, 8
   epochs x 8 minibatches), one warm-up ``train_block``, two timed ones
   and one ``eval_fn``, with every kernel's launch count set to 0 just
   before and read just after; then time the rollout and the update
   alone, and read the update's device busy share (one update timed
   without the profiler, one profiled for its kernels' device time, the
   λ-return kernel's among them);
4. run the CLI (``python -m cleanmarl_tpu_torch.algos.mappo``) for one
   short block as a subprocess.

The line before last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA, or without
the package beside this file, it exits non-zero and prints no result.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data-sheet peaks (dense), at the full 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12          # float32 FMA outside the tensor cores
PEAK_TF32_FLOPS = 495e12        # tensor cores; float32 accuracy takes 3 TF32 products
L2_FLUSH_BYTES = 128 * 2**20    # written between cold launches: 2.5x the 50 MB L2

# main path: the bench configuration of the JAX package
# (scripts/check_bench_memory.py:bench_config), copied, not imported
BENCH = dict(env_type="smaclite", env_name="3m", agent_ids=True, recurrent=True,
             num_envs=8192, rollout_len=60, actor_hidden_dim=128,
             critic_hidden_dim=128, epochs=8, num_minibatches=8,
             total_timesteps=1_000_000_000, log_interval=2, seed=0, verbose=False)

RET_TOL = dict(rtol=2e-5, atol=1e-5)      # as tests/test_torch_returns.py
VAL_TOL = dict(rtol=0.0, atol=1e-5)       # GRU values, as tests/test_torch_gru.py
# GRU gradients: 2e-4 of the tensor's largest entry (at least 2e-4). dwh
# and dbh are float32 sums over T*M rows (184,320 at the bench shape),
# taken in another order than the plain version's matmul
GRAD_TOL = 2e-4
PPO_TOL = dict(rtol=1e-4, atol=1e-4)      # one PPO update, card vs CPU


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph(body, n: int):
    """A CUDA graph of ``n`` calls of ``body`` (one call first, outside the
    graph, on the capture's side stream: module load and allocator)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            body()
    torch.cuda.synchronize()
    return graph


def _replay_ms(graph) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def device_ms(launch, n_warm: int = 200, n_cold: int = 50, reps: int = 5):
    """(cold, warm) device ms of one ``launch()``, from CUDA graphs replayed
    between CUDA events, so the host's per-call cost is out of the loop.
    Warm: ``n_warm`` launches back to back (inputs that fit the 50 MB L2
    stay there). Cold: ``n_cold`` launches, each after a write of
    ``L2_FLUSH_BYTES``, minus a graph of the writes alone. Each is the
    median of ``reps`` replays (cold: of the replay-by-replay differences)."""
    import statistics
    import torch

    flush_buf = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")

    def flushed():
        flush_buf.zero_()
        launch()
    warm, cold, flush = (_graph(launch, n_warm), _graph(flushed, n_cold),
                         _graph(flush_buf.zero_, n_cold))
    for g in (warm, cold, flush):
        _replay_ms(g)
    warm_ms = statistics.median(_replay_ms(warm) for _ in range(reps)) / n_warm
    cold_ms = statistics.median(_replay_ms(cold) - _replay_ms(flush)
                                for _ in range(reps)) / n_cold
    del warm, cold, flush, flush_buf
    torch.cuda.empty_cache()
    return cold_ms, warm_ms


def host_ms(fn, iters: int = 200) -> float:
    """Host ms per call of ``fn`` (the wrapper's own cost: checks, output
    allocation, the ctypes call), timed before the device catches up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e3


def bound_ms(n_bytes: float, n_flops: float, flops_per_s: float = PEAK_F32_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> float:
    return max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
               for a, b in zip(got, want))


def close(got, want, tol) -> bool:
    import torch

    return all(torch.allclose(a, b, **tol) for a, b in zip(got, want))


def close_scaled(got, want, tol: float) -> bool:
    """|got - want| <= tol * max(1, max |want|), tensor by tensor."""
    return all(float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))
               for a, b in zip(got, want) if b.numel())


def ptxas_usage(log_text: str):
    """[(kernel, "N registers, ...")] from ``nvcc -Xptxas -v`` output:
    registers, barriers, stack and spills of each compiled kernel."""
    out, kernel, spill = [], None, ""
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            kernel, spill = line.split("'")[1], ""
        elif kernel and "spill stores" in line:      # printed before "Used"
            spill = "; " + line.strip()
        elif kernel and "Used" in line and "registers" in line:
            out.append((kernel, line.split(":", 1)[1].strip() + spill))
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# (T, E, agents or None, P(ended), reward and flag per env, value per env):
# "per env" inputs are (T, E) broadcast over the agents as the MAPPO update
# builds them (algos/ppo_common.py: x[..., None].expand(values.shape))
RETURNS_CASES = (
    (7, 5, 3, 0.2, False, False), (25, 130, None, 0.0, False, False),
    (60, 8192, 3, 0.02, False, False),
    (60, 8192, 3, 0.02, True, True),        # the main path
    (60, 8191, 3, 0.02, True, True),        # ragged last block
    (1, 77, 3, 0.2, True, True),            # T = 1
    (21, 50, 3, 0.1, True, False),          # one step over the kernel's 20-step chunk
    (257, 1000, 3, 0.02, True, True),       # T over three chunks in flight
    (257, 130, None, 0.05, False, False),
    (60, 1000, 3, 0.05, True, False))       # per-agent values (IPPO)
RETURNS_MAIN = (60, 8192, 3, 0.02, True, True)


def _returns_inputs(T, E, n, p_end, shared_r, shared_v, seed):
    """r, e, V (T, E[, n]) and bootstrap (E[, n]) on the card; a shared
    input is drawn per env and broadcast over the agents."""
    import torch

    gen = torch.Generator("cuda").manual_seed(seed)
    full = (T, E) if n is None else (T, E, n)

    def draw(fn, shape, shared):
        if not shared:
            return fn(shape)
        return fn(shape[:-1])[..., None].expand(shape)
    r = draw(lambda s: torch.randn(s, generator=gen, device="cuda"), full, shared_r)
    e = draw(lambda s: torch.rand(s, generator=gen, device="cuda") < p_end, full, shared_r)
    v = draw(lambda s: torch.randn(s, generator=gen, device="cuda"), full, shared_v)
    b = draw(lambda s: torch.randn(s, generator=gen, device="cuda"), full[1:], shared_v)
    return r, e, v, b


def returns_bytes(T, B, Rr, Rv) -> int:
    """Bytes the λ-return function needs: G and A written (T, B), V read
    at (T, B / Rv), r (4 B) and e (1 B) at (T, B / Rr), the bootstrap (B / Rv)."""
    return T * B * 8 + T * (B // Rv) * 4 + T * (B // Rr) * 5 + (B // Rv) * 4


def _column_launch(r, e, v, b):
    """A launch of the yardstick kernel of csrc/lambda_returns.cu (one
    thread per column, the loop over T in the thread, full (T, B) inputs:
    the design the port's kernel replaced; the port never calls it)."""
    import ctypes
    import torch
    from cleanmarl_tpu_torch.ops import _build

    lib = _build.load("lambda_returns")
    fn = lib.lambda_returns_column_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                                           ctypes.c_float, ctypes.c_void_p]
    r, e, v, b = (x.contiguous() for x in (r, e, v, b))
    g, a = torch.empty_like(v), torch.empty_like(v)
    T, p = v.shape[0], _build.ptr

    def launch():
        _build.check(lib, "lambda_returns", fn(
            p(r), p(e), p(v), p(b), p(g), p(a), T, v.numel() // T, 0.99, 0.95,
            _build.stream_ptr(v.device)))
    return launch, (g, a)


def check_returns(results):
    """K1 against its plain version at every case of RETURNS_CASES (shared
    inputs must reach the kernel without a copy), two launches bitwise
    equal, then its device time at the main path's inputs: cold (L2
    flushed) and warm, from CUDA graphs, beside the column kernel it
    replaced, the same kernel on materialised (R = 1) inputs, one copy of
    as many bytes, the wrapper's host time and the plain version."""
    import torch
    from cleanmarl_tpu_torch.ops import returns_kernel as rk

    errs = []
    for i, case in enumerate(RETURNS_CASES):
        r, e, v, b = _returns_inputs(*case, seed=i)
        (kr, ke, kv, kb), Rr, Rv = rk.kernel_args(r, e, v, b)
        want_r = case[2] if case[4] else 1
        want_v = case[2] if case[5] else 1
        shared = ([(kr, r), (ke, e)] if case[4] else []) + ([(kv, v), (kb, b)] if case[5] else [])
        if (Rr, Rv) != (want_r, want_v) or any(k.data_ptr() != x.data_ptr() for k, x in shared):
            fail(f"lambda_returns at {case}: the kernel would read R=({Rr}, {Rv}), "
                 f"expected ({want_r}, {want_v}) without a copy")
        n0 = rk.LAUNCHES["lambda_returns"]
        got = rk.lambda_returns_kernel(r, e, v, b, 0.99, 0.95)
        if rk.LAUNCHES["lambda_returns"] != n0 + 1:
            fail("lambda_returns_kernel did not count its launch")
        want = rk.lambda_returns_plain(r, e, v, b, 0.99, 0.95)
        err = max_err(got, want)
        log(f"[kernels] lambda_returns T={case[0]} E={case[1]} agents={case[2]} "
            f"R=({Rr}, {Rv}): max_abs_err={err:.3e}")
        if not close(got, want, RET_TOL):
            fail(f"lambda_returns disagrees with its plain version at {case}")
        errs.append(err)
    r, e, v, b = _returns_inputs(*RETURNS_MAIN, seed=0)
    first = rk.lambda_returns_kernel(r, e, v, b, 0.99, 0.95)
    second = rk.lambda_returns_kernel(r, e, v, b, 0.99, 0.95)
    if not all(torch.equal(x, y) for x, y in zip(first, second)):
        fail("lambda_returns differs between two launches on the same inputs")

    T, B = v.shape[0], v[0].numel()
    n_bytes = returns_bytes(T, B, RETURNS_MAIN[2], RETURNS_MAIN[2])
    bnd, by = bound_ms(n_bytes, 8 * T * B)
    ms, warm = device_ms(lambda: rk.lambda_returns_kernel(r, e, v, b, 0.99, 0.95))
    full = [x.contiguous() for x in (r, e, v, b)]
    r1_ms, r1_warm = device_ms(lambda: rk.lambda_returns_kernel(*full, 0.99, 0.95))
    col_launch, col_out = _column_launch(r, e, v, b)
    col_launch()
    col_err = max_err(col_out, first)
    col_ms, col_warm = device_ms(col_launch)
    host = host_ms(lambda: rk.lambda_returns_kernel(r, e, v, b, 0.99, 0.95))
    plain = time_ms(lambda: rk.lambda_returns_plain(r, e, v, b, 0.99, 0.95), 10)
    src = torch.empty(n_bytes // 8, device="cuda")
    dst = torch.empty_like(src)
    copy_ms, copy_warm = device_ms(lambda: dst.copy_(src))
    log("[kernels] lambda_returns: two launches bitwise equal; at the main path's inputs "
        f"(T={T}, B={B}, reward, flag and value per env, R=3): {n_bytes} B, bound "
        f"{bnd:.5f} ms ({by}); device ms cold/warm: kernel {ms:.5f}/{warm:.5f} "
        f"({bnd / ms:.1%} of the bound cold), kernel on materialised inputs (R=1) "
        f"{r1_ms:.5f}/{r1_warm:.5f}, column kernel it replaced (R=1) {col_ms:.5f}/"
        f"{col_warm:.5f} (max |diff| {col_err:.1e}), one copy of {n_bytes} B "
        f"{copy_ms:.5f}/{copy_warm:.5f}; wrapper host {host:.5f} ms per call; "
        f"plain {plain:.4f} ms")
    results["lambda_returns"] = dict(
        source="cleanmarl_tpu_torch/csrc/lambda_returns.cu",
        replaces="cleanmarl_tpu/ops/pallas_returns.py:35",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
        library_ms=None, warm_ms=warm, host_ms=host, copy_ms=copy_ms,
        copy_warm_ms=copy_warm, materialised_ms=r1_ms, materialised_warm_ms=r1_warm,
        column_kernel_ms=col_ms, column_kernel_warm_ms=col_warm, bytes=n_bytes)


def _gru_inputs(T, M, H, seed):
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    wh = torch.randn(H, 3 * H, generator=g, device="cuda") / math.sqrt(H)
    bh = torch.randn(3 * H, generator=g, device="cuda") * 0.1
    h0 = torch.randn(M, H, generator=g, device="cuda") * 0.3
    gi = torch.randn(T, M, 3 * H, generator=g, device="cuda")
    keep = (torch.rand(T, M, generator=g, device="cuda") > 0.05).float()
    return wh, bh, h0, gi, keep


def check_gru_shape(T, M, H, seed):
    """Values and all gradients of the fused GRU (K2 + K3 through the
    autograd.Function) against autograd through the plain scan, and each
    backward kernel against its plain version; each recurrence must go
    through the route its width takes."""
    import torch
    from cleanmarl_tpu_torch.ops import gru_kernel as gk

    ins = _gru_inputs(T, M, H, seed)
    g = torch.Generator("cuda").manual_seed(seed + 1)
    w_seq = torch.randn(T, M, H, generator=g, device="cuda")
    w_fin = torch.randn(M, H, generator=g, device="cuda")

    def run(fn):
        xs = [x.clone().requires_grad_(True) for x in ins]
        hf, hs = fn(*xs)
        grads = torch.autograd.grad((hs * w_seq).sum() + (hf * w_fin).sum(), xs[:4])
        return [hs.detach(), hf.detach()], list(grads)

    fwd = gk.fwd_route(H)
    n0 = gk.LAUNCHES[fwd]
    (vals_k, grads_k) = run(gk.gru_seq)
    if gk.LAUNCHES[fwd] != n0 + 1:
        fail(f"gru_seq_fwd at H={H} did not go through {fwd}")
    (vals_p, grads_p) = run(gk.gru_seq_fwd_plain)
    errs = {"fwd": max_err(vals_k, vals_p), "grads": max_err(grads_k, grads_p)}
    ok = close(vals_k, vals_p, VAL_TOL) and close_scaled(grads_k, grads_p, GRAD_TOL)
    hs = vals_k[0]
    route = gk.bwd_route(H)
    n0 = gk.LAUNCHES[route]
    rec_k = gk.gru_seq_bwd(*ins[:3], hs, ins[3], ins[4], w_seq, w_fin)
    if gk.LAUNCHES[route] != n0 + 1:
        fail(f"gru_seq_bwd at H={H} did not go through {route}")
    rec_p = gk.gru_seq_bwd_plain(*ins[:3], hs, ins[3], ins[4], w_seq, w_fin)
    dw_k = gk.gru_seq_dw(ins[2], hs, ins[4], rec_k[0], rec_k[1])
    dw_p = gk.gru_seq_dw_plain(ins[2], hs, ins[4], rec_k[0], rec_k[1])
    errs["bwd"] = max_err(rec_k, rec_p)
    errs["dw"] = max_err(dw_k, dw_p)
    ok = (ok and close_scaled(rec_k, rec_p, GRAD_TOL)
          and close_scaled(dw_k, dw_p, GRAD_TOL))
    scale = max(float(x.abs().max()) for x in grads_p + list(dw_p))
    log(f"[kernels] gru T={T} M={M} H={H} ({fwd}, {route}): " + " ".join(
        f"{k}_err={v:.3e}" for k, v in errs.items()) + f" (largest grad {scale:.3e})")
    if not ok:
        fail(f"GRU kernels disagree with the plain versions at T={T} M={M} H={H}")
    return errs, ins, hs, rec_k


def time_gru(T, M, H, ins, hs, rec):
    """Kernel, plain and library times of K2, K3-recurrence and K3-dw at
    one shape, plus whole fwd+bwd (kernel route vs scan with autograd)."""
    import torch
    from cleanmarl_tpu_torch.ops import gru_kernel as gk

    wh, bh, h0, gi, keep = ins
    g_hs, g_hf = torch.ones_like(hs), torch.ones_like(h0)
    out = {}
    out["fwd_ms"] = time_ms(lambda: gk.gru_seq_fwd(wh, bh, h0, gi, keep), 10)
    out["fwd_plain_ms"] = time_ms(lambda: gk.gru_seq_fwd_plain(wh, bh, h0, gi, keep), 3, 1)
    out["bwd_ms"] = time_ms(
        lambda: gk.gru_seq_bwd(wh, bh, h0, hs, gi, keep, g_hs, g_hf), 10)
    out["bwd_plain_ms"] = time_ms(
        lambda: gk.gru_seq_bwd_plain(wh, bh, h0, hs, gi, keep, g_hs, g_hf), 3, 1)
    out["dw_ms"] = time_ms(lambda: gk.gru_seq_dw(h0, hs, keep, rec[0], rec[1]), 10)
    out["dw_plain_ms"] = time_ms(
        lambda: gk.gru_seq_dw_plain(h0, hs, keep, rec[0], rec[1]), 10)

    # yardsticks: cuDNN's GRU on the same gi (identity input weights,
    # keep = 1) and one matmul for dwh
    cudnn = torch.nn.GRU(3 * H, H).cuda()
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(torch.eye(3 * H, device="cuda"))
        cudnn.bias_ih_l0.zero_()
        cudnn.weight_hh_l0.copy_(wh.t())
        cudnn.bias_hh_l0.copy_(bh)
        out["fwd_library_ms"] = time_ms(lambda: cudnn(gi, h0[None]), 10)
        h_prev = torch.cat([h0[None], keep[:-1, :, None] * hs[:-1]]).reshape(-1, H)
        dgh = torch.cat([rec[0][..., :2 * H], rec[1]], -1).reshape(-1, 3 * H)
        out["dw_library_ms"] = time_ms(lambda: torch.matmul(h_prev.t(), dgh), 10)

    # yardstick of the whole backward (recurrence + weight gradient): cuDNN's
    # GRU on the same gi with identity input weights and keep = 1, autograd
    # fwd+bwd minus fwd (cuDNN also forms the input-weight gradient)
    gi_l = gi.clone().requires_grad_(True)
    h0_l = h0[None].clone().requires_grad_(True)

    def cudnn_fwd():
        return cudnn(gi_l, h0_l)

    def cudnn_fwd_bwd():
        out_, hn_ = cudnn(gi_l, h0_l)
        torch.autograd.grad(out_.sum() + hn_.sum(),
                            [gi_l, h0_l, cudnn.weight_hh_l0, cudnn.bias_hh_l0])
    out["bwd_library_ms"] = time_ms(cudnn_fwd_bwd, 10) - time_ms(cudnn_fwd, 10)

    def route(fn):
        xs = [x.clone().requires_grad_(True) for x in ins[:4]]

        def step():
            hf, hs_ = fn(*xs, keep)
            torch.autograd.grad(hs_.sum() + hf.sum(), xs)
        return step
    out["kernel_fwd_bwd_ms"] = time_ms(route(gk.gru_seq), 5)
    out["scan_fwd_bwd_ms"] = time_ms(route(gk.gru_seq_fwd_plain), 3, 1)
    log(f"[kernels] gru T={T} M={M} H={H} times (ms): " + " ".join(
        f"{k[:-3]}={v:.4f}" for k, v in out.items()))
    return out


def gru_bounds(T, M, H):
    """{kernel: {"f32": (ms, by), "tc": (ms, by)}}: the least time at the
    data-sheet peaks, with the operations on the float32 units or, where
    the kernel runs them there, as 3xTF32 on the tensor cores (three TF32
    products per float32 product), against the same bytes. Bytes are what
    the function needs: each input it reads once (the backward reads
    h_seq[:T-1] and keep[:T-1] as h_prev, and dgi's first 2H columns), each
    output written once."""
    f = 4
    flops = 2.0 * T * M * H * 3 * H
    fwd_bytes = f * (H * 3 * H + 3 * H + M * H + T * M * 3 * H + T * M + T * M * H + M * H)
    bwd_bytes = f * (H * 3 * H + 3 * H + M * H + (T - 1) * M * H + T * M * H
                     + T * M * 3 * H + T * M + M * H + T * M * 3 * H + T * M * H + M * H)
    dw_bytes = f * (M * H + (T - 1) * M * H + (T - 1) * M + T * M * 2 * H + T * M * H
                    + H * 3 * H + 3 * H)
    work = {"fwd": (fwd_bytes, flops, 10.0 * T * M * H),
            "bwd": (bwd_bytes, 2 * flops, 20.0 * T * M * H),
            "dw": (dw_bytes, flops, T * M * 3 * H)}
    return {k: {"f32": bound_ms(b, mm + ew),
                "tc": bound_ms(b, 3 * mm / PEAK_TF32_FLOPS * PEAK_F32_FLOPS + ew)}
            for k, (b, mm, ew) in work.items()}


def check_rnn_seq_apply():
    """The actor's sequence recompute at the bench minibatch (T=60, 1024
    envs x 3 agents, in=33, H=128, 9 actions): the kernel route of
    rnn_seq_apply against the scan route, values and all gradients."""
    import torch
    from cleanmarl_tpu_torch.core import networks as nets
    from cleanmarl_tpu_torch.core.params import tree_leaves

    g = torch.Generator("cuda").manual_seed(7)
    params = nets.rnn_init(g, 33, 128, 9, final_gain=0.01, device="cuda")
    x = torch.randn(60, 1024, 3, 33, generator=g, device="cuda")
    h0 = 0.3 * torch.randn(1024, 3, 128, generator=g, device="cuda")
    reset = torch.rand(60, 1024, generator=g, device="cuda") < 0.05

    def run(impl):
        leaves = [p.clone().requires_grad_(True) for p in tree_leaves(params)]
        it = iter(leaves)
        live = {k: {kk: next(it) for kk in v} for k, v in params.items()}
        xs = [h0.clone().requires_grad_(True), x.clone().requires_grad_(True)]
        hf, out = nets.rnn_seq_apply(live, xs[0], xs[1], reset_seq=reset, impl=impl)
        loss = (out * out).sum() + hf.sum()
        return [out.detach(), hf.detach()], list(torch.autograd.grad(loss, leaves + xs))

    vals_k, grads_k = run("kernel")
    vals_s, grads_s = run("scan")
    err_v, err_g = max_err(vals_k, vals_s), max_err(grads_k, grads_s)
    scale = max(float(g.abs().max()) for g in grads_s)
    log(f"[kernels] rnn_seq_apply bench minibatch, kernel vs scan route: "
        f"values_err={err_v:.3e} grads_err={err_g:.3e} (largest grad {scale:.3e})")
    if not (close(vals_k, vals_s, VAL_TOL) and close_scaled(grads_k, grads_s, GRAD_TOL)):
        fail("rnn_seq_apply kernel route disagrees with the scan route")


def mma_ceiling():
    """TFLOP/s of TF32 mma.sync m16n8k8 on 132 blocks of 8 and 16 warps
    (csrc/mma_rate.cu): the ceiling of the tensor-core GRU kernels, which
    issue mma.sync (the data-sheet 495 TFLOP/s takes wgmma)."""
    import ctypes
    import torch
    from cleanmarl_tpu_torch.ops import _build

    lib = _build.load("mma_rate")
    fn = lib.mma_rate_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_void_p]
    blocks, iters = 132, 4000
    out = torch.empty(blocks * 512, device="cuda")
    rates = {}
    for warps in (8, 16):
        def launch():
            _build.check(lib, "mma_rate", fn(blocks, 32 * warps, iters, _build.ptr(out),
                                             _build.stream_ptr(out.device)))
        ms = time_ms(launch, 3, 1)
        rates[warps] = blocks * warps * iters * 8 * (2 * 16 * 8 * 8) / (ms * 1e-3) / 1e12
    log("[kernels] TF32 mma.sync m16n8k8 peak: " + ", ".join(
        f"{r:.1f} TFLOP/s at {w} warps per block" for w, r in rates.items()))
    return rates


def check_dw_deterministic(ins, hs, rec):
    """Two launches of the weight-gradient kernel on the same inputs give
    the same bits; report its dwh and the plain version's (cuBLAS float32)
    against a float64 product on the card."""
    import torch
    from cleanmarl_tpu_torch.ops import gru_kernel as gk

    first = gk.gru_seq_dw(ins[2], hs, ins[4], rec[0], rec[1])
    second = gk.gru_seq_dw(ins[2], hs, ins[4], rec[0], rec[1])
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail("gru_seq_dw differs between two launches on the same inputs")
    H = hs.shape[-1]
    h_prev = torch.cat([ins[2][None], ins[4][:-1, :, None] * hs[:-1]]).reshape(-1, H)
    dgh = torch.cat([rec[0][..., :2 * H], rec[1]], -1).reshape(-1, 3 * H)
    exact = h_prev.double().t() @ dgh.double()
    plain = gk.gru_seq_dw_plain(ins[2], hs, ins[4], rec[0], rec[1])[0]
    log(f"[kernels] gru_seq_dw: two launches bitwise equal; dwh max err against float64: "
        f"kernel {float((first[0].double() - exact).abs().max()):.3e}, "
        f"plain (cuBLAS float32) {float((plain.double() - exact).abs().max()):.3e}")


def check_fwd_deterministic(ins):
    """Two launches of the forward on the same inputs give the same bits;
    report its h_seq and the plain float32 scan's against a float64
    recurrence on the card."""
    import torch
    from cleanmarl_tpu_torch.ops import gru_kernel as gk

    first = gk.gru_seq_fwd(*ins)
    second = gk.gru_seq_fwd(*ins)
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail("gru_seq_fwd differs between two launches on the same inputs")
    exact = gk.gru_seq_fwd_plain(*(x.double() for x in ins))[1]
    plain = gk.gru_seq_fwd_plain(*ins)[1]
    err_k = float((first[1].double() - exact).abs().max())
    err_p = float((plain.double() - exact).abs().max())
    log(f"[kernels] gru_seq_fwd: two launches bitwise equal; h_seq max err against "
        f"float64: kernel {err_k:.3e}, plain (float32 scan) {err_p:.3e}")
    return dict(kernel=err_k, plain=err_p)


def check_gru(results):
    errs = {"fwd": 0.0, "fwd_l2": 0.0, "bwd": 0.0, "bwd_l2": 0.0, "dw": 0.0, "grads": 0.0}
    from cleanmarl_tpu_torch.ops import gru_kernel as gk

    def keep_max(e, H):
        for k, v in e.items():
            if k == "fwd" and gk.fwd_route(H) == "gru_seq_fwd_l2":
                k = "fwd_l2"
            elif k == "bwd" and gk.bwd_route(H) == "gru_seq_bwd_l2":
                k = "bwd_l2"
            errs[k] = max(errs[k], v)

    # test shapes; ragged rows (M=3077: the 32-row tiles and the 64-row dw
    # slabs do not divide it); every tensor-core width; the L2 route
    for T, M, H in ((7, 12, 16), (5, 3, 8), (9, 37, 128), (60, 3077, 128),
                    (7, 33, 32), (6, 50, 64), (5, 45, 96), (5, 20, 100)):
        keep_max(check_gru_shape(T, M, H, seed=H)[0], H)
    timings = {}
    for H in (128, 256):
        e, ins, hs, rec = check_gru_shape(60, 3072, H, seed=H + 1)
        keep_max(e, H)
        if H == 128:
            vs_f64 = check_fwd_deterministic(ins)
            check_dw_deterministic(ins, hs, rec)
        timings[H] = time_gru(60, 3072, H, ins, hs, rec)
    src = "cleanmarl_tpu_torch/csrc/"
    rows = {"gru_seq_fwd": ("fwd", 128, "tc", "gru_seq_fwd.cu", "pallas_gru.py:67",
                            "fwd_library_ms", errs["fwd"]),
            "gru_seq_fwd_l2": ("fwd", 256, "f32", "gru_seq_fwd.cu", "pallas_gru.py:67",
                               "fwd_library_ms", errs["fwd_l2"]),
            "gru_seq_bwd": ("bwd", 128, "tc", "gru_seq_bwd.cu", "pallas_gru.py:130",
                            None, max(errs["bwd"], errs["grads"])),
            "gru_seq_bwd_l2": ("bwd", 256, "f32", "gru_seq_bwd.cu", "pallas_gru.py:130",
                               None, errs["bwd_l2"]),
            "gru_seq_dw": ("dw", 128, "tc", "gru_seq_bwd.cu", "pallas_gru.py:173",
                           "dw_library_ms", errs["dw"])}
    for name, (k, H, unit, f, rep, lib, err) in rows.items():
        t, b = timings[H], gru_bounds(60, 3072, H)[k]
        results[name] = dict(
            source=src + f, replaces="cleanmarl_tpu/ops/" + rep, max_abs_err=err,
            ms=t[f"{k}_ms"], plain_ms=t[f"{k}_plain_ms"], bound_ms=b[unit][0],
            bound_by=b[unit][1], library_ms=t[lib] if lib else None,
            bound_f32_ms=b["f32"][0], bound_tc_ms=b["tc"][0], hidden=H)
        if k == "bwd":
            # no one call computes the recurrence alone; cuDNN's GRU backward
            # (fwd+bwd - fwd) is the yardstick of recurrence + weight gradient
            results[name].update(whole_bwd_library_ms=t["bwd_library_ms"],
                                 whole_bwd_ms=t["bwd_ms"] + t["dw_ms"])
    results["gru_seq_fwd"].update(h_seq_err_vs_f64=vs_f64["kernel"],
                                  plain_h_seq_err_vs_f64=vs_f64["plain"])
    return timings


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def check_update_against_cpu():
    """One PPO update on the card (kernels) equals the same update on the
    CPU (plain versions), from the same params and trajectory."""
    import torch
    from cleanmarl_tpu_torch.algos.mappo import make_train
    from cleanmarl_tpu_torch.algos.ppo_common import PPOConfig
    from cleanmarl_tpu_torch.core.params import tree_leaves, tree_map

    small = dict(BENCH, num_envs=16, rollout_len=12, actor_hidden_dim=32,
                 critic_hidden_dim=32, epochs=2, num_minibatches=2,
                 normalize_advantage=True)
    init_c, _, _, meta_c = make_train(PPOConfig(**small, device="cpu"))
    _, _, _, meta_g = make_train(PPOConfig(**small, device="cuda"))
    runner = init_c(torch.Generator().manual_seed(0))
    runner, traj, h0 = meta_c["collect_rollout"](runner)

    def to_cuda(x):
        return x.cuda() if isinstance(x, torch.Tensor) else x
    runner_g = runner.replace(
        actor_params=tree_map(to_cuda, runner.actor_params),
        critic_params=tree_map(to_cuda, runner.critic_params),
        actor_opt=tree_map(to_cuda, runner.actor_opt),
        critic_opt=tree_map(to_cuda, runner.critic_opt),
        obs=runner.obs.cuda(), state=runner.state.cuda(), avail=runner.avail.cuda(),
        vnorm=tree_map(to_cuda, runner.vnorm))
    out_c, m_c = meta_c["ppo_update"](runner, traj, h0)
    out_g, m_g = meta_g["ppo_update"](runner_g, tree_map(to_cuda, traj), h0.cuda())
    worst = 0.0
    for k in m_c:
        a, b = m_g[k].cpu(), m_c[k]
        worst = max(worst, abs(float(a) - float(b)))
        if not torch.allclose(a, b, **PPO_TOL):
            fail(f"PPO update on the card disagrees with the CPU: {k} "
                 f"{float(a)} vs {float(b)}")
    for a, b in zip(tree_leaves(out_g.actor_params) + tree_leaves(out_g.critic_params),
                    tree_leaves(out_c.actor_params) + tree_leaves(out_c.critic_params)):
        if not torch.allclose(a.cpu(), b, **PPO_TOL):
            fail("PPO update on the card disagrees with the CPU on the params")
    log(f"[main] one PPO update, card vs CPU: metrics agree (max |diff| {worst:.3e})")


def main_path_kernels(counters):
    """Every counted kernel except the forward and backward routes that the
    main path's GRU (the actor's; the critic is an MLP) does not take."""
    from cleanmarl_tpu_torch.ops import gru_kernel as gk

    H = BENCH["actor_hidden_dim"]
    routes = {"gru_seq_fwd", "gru_seq_fwd_l2", "gru_seq_bwd", "gru_seq_bwd_l2"}
    skipped = routes - {gk.fwd_route(H), gk.bwd_route(H)}
    return [k for table in counters for k in table if k not in skipped]


def profile_update(meta, runner):
    """The update layer's device busy share: one PPO update of the main path
    timed without the profiler, then the same update under
    ``torch.profiler`` (CUDA activity only) for the device time of every
    kernel in it. Busy share = device time over wall time (one stream, so
    the kernels do not overlap), against both wall times; the profiler
    slows the host, so the unprofiled share is the one that counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    r2, traj, h0 = meta["collect_rollout"](runner)
    meta["ppo_update"](r2, traj, h0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meta["ppo_update"](r2, traj, h0)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        meta["ppo_update"](r2, traj, h0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            kernels[e.key] = (us / 1e6, e.count)
    busy = sum(sec for sec, _ in kernels.values())
    n_ops = sum(c for _, c in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    k1 = [(k, v) for k, v in kernels.items() if "lambda_returns" in k]
    if not k1:
        fail("the profiled update ran no lambda_returns kernel")
    log(f"[main] one PPO update: device busy {busy:.4f} s, {n_ops} device ops; wall "
        f"{wall_plain:.4f} s unprofiled ({100 * busy / wall_plain:.1f} % busy), "
        f"{wall:.4f} s under the profiler ({100 * busy / wall:.1f} % busy)")
    for name, (sec, n) in top + k1:
        log(f"[main]   {sec * 1e3:9.4f} ms {n:6d}x {name[:90]}")
    return dict(wall_s=wall_plain, wall_profiled_s=wall, device_busy_s=busy,
                device_ops=n_ops, busy_share=busy / wall_plain,
                busy_share_profiled=busy / wall,
                top=[dict(name=k, s=v[0], count=v[1]) for k, v in top],
                lambda_returns=[dict(name=k, s=v[0], count=v[1]) for k, v in k1])


def drive_main_path(counters):
    import torch
    from cleanmarl_tpu_torch.algos.mappo import make_train
    from cleanmarl_tpu_torch.algos.ppo_common import PPOConfig
    from cleanmarl_tpu_torch.core.driver import to_host

    cfg = PPOConfig(**BENCH, device="cuda")
    init, train_block, eval_fn, meta = make_train(cfg)
    log(f"[main] MAPPO smaclite 3m, GRU route {meta['gru_impl']!r}, "
        f"{meta['steps_per_block']} env steps per train_block")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for table in counters:
        for k in table:
            table[k] = 0
    t0 = time.perf_counter()
    runner = init(torch.Generator("cuda").manual_seed(cfg.seed))
    runner, metrics = train_block(runner)
    warm = to_host(metrics)
    t1 = time.perf_counter()
    timed = []
    for _ in range(2):
        runner, metrics = train_block(runner)
        metrics = to_host(metrics)
        timed.append(time.perf_counter())
    evals = to_host(eval_fn(runner.actor_params, torch.Generator("cuda").manual_seed(1)))
    torch.cuda.synchronize()
    launches = {k: v for table in counters for k, v in table.items()}
    peak = torch.cuda.max_memory_allocated()
    block_s = (timed[-1] - t1) / len(timed)
    sps = meta["steps_per_block"] / block_s
    log(f"[main] warm-up block (incl. init) {t1 - t0:.3f} s; timed blocks "
        f"{timed[0] - t1:.3f} s, {timed[1] - timed[0]:.3f} s; env-steps/s {sps:.1f}")
    log(f"[main] launches {launches}; peak device memory {peak / 2**30:.3f} GiB")
    log(f"[main] last block metrics {json.dumps(metrics, sort_keys=True)}")
    log(f"[main] eval {json.dumps(evals, sort_keys=True)}")
    for k, v in {**warm, **metrics, **evals}.items():
        if not math.isfinite(v):
            fail(f"non-finite metric {k}={v}")
    for k in main_path_kernels(counters):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the main path")
    phases = meta["phase_timer"](runner, iters=1)
    log(f"[main] phase_timer {json.dumps(phases, sort_keys=True)}")
    return dict(launches=launches, env_steps_per_s=sps, block_s=block_s,
                peak_gib=peak / 2**30, metrics=metrics, eval=evals, phases=phases,
                update_profile=profile_update(meta, runner),
                model_flops_per_step=meta["model_flops_per_step"])


def run_cli():
    cmd = [sys.executable, "-m", "cleanmarl_tpu_torch.algos.mappo", "--recurrent",
           "true", "--env_type", "smaclite", "--env_name", "3m", "--device", "cuda",
           "--num_envs", "16", "--total_timesteps", "19200", "--eval_steps", "19200",
           "--seed", "0"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    log(f"[cli] {' '.join(cmd[1:])}: rc {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in proc.stdout.strip().splitlines()[-3:]:
        log(f"[cli] {line}")
    if proc.returncode != 0:
        fail(f"CLI exited {proc.returncode}: {proc.stderr[-2000:]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write all results to this JSON file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(ROOT, "cleanmarl_tpu_torch")):
        fail("cleanmarl_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, ROOT)
    from cleanmarl_tpu_torch.ops import _build, gru_kernel, returns_kernel

    # phase 1: the card and the build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[build] {len(built)} sources in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(k + (' cached' if v['cached'] else '') for k, v in built.items())})")
    for name, info in built.items():
        for kernel, usage in ptxas_usage(info["ptxas"]):
            log(f"[build] {name}: {kernel}: {usage}")

    # phase 2: kernels vs plain versions, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[kernels] TF32 off (matmul and cuDNN) for the plain versions; the GRU tensor-core "
        "kernels run 3xTF32; tolerances: returns "
        f"{RET_TOL}, GRU values {VAL_TOL}, GRU grads {GRAD_TOL} x max(1, max|grad|)")
    results = {}
    check_returns(results)
    gru_times = check_gru(results)
    mma_tflops = mma_ceiling()
    check_rnn_seq_apply()

    # phase 3: the main path
    check_update_against_cpu()
    counters = (returns_kernel.LAUNCHES, gru_kernel.LAUNCHES)
    main_path = drive_main_path(counters)

    # phase 4: the CLI
    run_cli()

    kernels = [dict(name=name, route="cuda", launches=main_path["launches"][name], **r)
               for name, r in results.items()]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                           kernels=kernels, gru_times=gru_times, main_path=main_path,
                           mma_tf32_tflops=mma_tflops),
                      f, indent=1, sort_keys=True)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
