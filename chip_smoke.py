#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``cleanmarl_tpu_torch``) on one
NVIDIA GPU, from the sources in this checkout.

    python3 chip_smoke.py [--out results.json]

Phases, each of which must pass. The script checks; it does not
measure the program: block rates, phase times, device busy shares and
peak memory come from the benchmark (``python3 benchmark/run.py``;
``PERF_LEDGER.jsonl``). Phase 2 alone times each kernel by itself at the
shapes the paths launch, beside its plain version and bound.

1. print the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and build every CUDA kernel from ``csrc/`` (one
   ``nvcc`` per source, all at once);
2. hold each kernel against its plain PyTorch version on the card (TF32
   off for the plain versions; the GRU tensor-core kernels compute in
   3xTF32 whatever that flag says), at the test shapes, the ragged-edge
   shapes (rows that cut the kernels' tiles and slabs), every width of
   both routes of the forward and the backward, and the main path's
   shapes; check that the forward and the weight gradient are bitwise the
   same on two launches, and report both against float64; at the shapes
   the paths launch, time kernel, plain version and, where one PyTorch
   call computes the same function, that call (a yardstick only: the port
   never calls it), beside the least time of ``benchmark/yardstick.py``.
   The λ-return kernel is also held at inputs broadcast over the agents
   (read without a copy), T = 1 and T = 257, and timed by its device time
   alone: CUDA graphs of its launches replayed between CUDA events, cold
   (each launch after an L2 flush, the flushes' own time subtracted) and
   warm (back to back), beside one copy of as many bytes and the
   wrapper's host time per call;
3. check one PPO update of the port on the card against the same update
   on the CPU (plain versions) on a small input, then drive the main
   path: recurrent MAPPO on SMAClite 3m at the bench settings (GRU
   actor and critic of width 128, 8192 envs, rollouts of 60 steps, 8
   epochs x 8 minibatches), one warm-up ``train_block``, two more and one
   ``eval_fn``, with every kernel's launch count set to 0 just before and
   read just after: finite metrics, every kernel of the path launched;
4. run the CLIs (``python -m cleanmarl_tpu_torch.algos.mappo``,
   ``...algos.qmix`` on MPE simple_spread and ``...algos.qmix_rnn`` on
   SMAClite 3m) for one short block each, as subprocesses;
5. the off-policy slice, which launches no kernel: one QMIX and one VDN
   update on the card against the same update on the CPU, then QMIX and
   VDN on MPE simple_spread at the JAX package's validated recipes
   (qmix_spread, vdn_spread: 32 envs, hidden 64), warm-up and driven
   ``train_block``s and one ``eval_fn`` each, with the kernel counts set
   to 0 before and read after: finite metrics, updates in the driven
   blocks, and the update count equal to the episode (QMIX) or iteration
   (VDN) clock;
6. recurrent QMIX and VDN on SMAClite 3m, whose update runs K2, K3 and dw
   at new shapes (phase 2 also holds and times them there: 32 episodes x
   3 agents at H=64 over T=150, and T=2 after a burn-in of 8, against the
   scan route and cuDNN's GRU): one update of each of ``qmix_rnn_3m``,
   ``vdn_rnn_3m`` and ``vdn_rnn_seq_3m`` on the card against the CPU, then
   ``qmix_rnn_3m`` (episode replay) and ``vdn_rnn_seq_3m`` (sequence
   replay) driven at the JAX package's recipes, with the checks of phase
   5, the update count against the episode or iteration clock, and the
   kernel counts (K2, K3 and dw launched; the L2 routes and K1 not);
7. MADDPG, FACMAC and COMA, whose updates run K1 at COMA's shape and K2,
   K3 and dw on the recurrent actors (phase 2 also holds and times K1
   over one ``coma_3m`` rollout's reward and end flags broadcast over 3
   agents, and K2/K3/dw at T=25, M=64 and at T=150, M=192 with that
   rollout's resets, beside cuDNN's GRU; phase 4 also runs the recurrent
   ``maddpg`` and ``coma`` CLIs): one update of each of ``maddpg_sl``,
   ``maddpg_rnn_sl``, ``facmac_sl``, ``coma_3m`` and a recurrent
   ``coma_3m`` on the card against the CPU, then each driven at its
   recipe's widths (COMA two rollouts a block) with the checks of phase
   5, the update clock (one update per completed episode, or per
   rollout), and every kernel's launches equal to its launches per update
   times the updates;
8. IPPO, pursuit and LBF, the host-env route and SMAClite collisions
   (phase 2 also holds and times K1 at IPPO's update shapes on pursuit,
   T=100 over 64 envs x 8 pursuers, and LBF, T=150 over 64 x 2, with the
   team reward and flag broadcast, and at COMA's on LBF with per-agent
   rewards, and K2/K3/dw at T=150, M=128 with resets and a carried h0;
   phase 4 also runs the recurrent ``ippo`` CLI on LBF): one update of
   each of ``ippo_pursuit``, ``ippo_lbf``, ``ippo_rnn_lbf``,
   ``coma_lbf``, ``coma_rnn_lbf`` and ``vdn_pursuit`` on the card against
   the CPU; ``ippo_pursuit``, ``ippo_rnn_lbf`` and ``coma_rnn_lbf`` driven
   as in phase 7 (launches per update call, IPPO's per rollout) and
   ``vdn_pursuit`` as in phase 5; the host route (a numpy host env written
   here behind ``HostEnvFamily``: its live and pre-reset views against the
   host env's own arrays, one IPPO block and one QMIX episode-ring block on
   it); SMAClite 3m with ``unit_collisions``, one step on the card against
   the CPU and one MAPPO block at the bench widths;
9. checkpoint and resume, data parallelism and the new CLI options
   (``core/checkpoint.py``, ``distributed/``; phase 2 also holds and
   times K1 at one rank's shape, T=60 over 4096 envs x 3 agents, and
   K2/K3/dw at one rank's rows of a minibatch, T=60, M=1536, H=128, with
   per-env resets): recurrent MAPPO at the
   main path's widths trains one block, saves, restores into an init of
   another seed, and one more block from both must give the same bits in
   every param, optimizer moment, env state, generator state and counter;
   two gloo ranks on the one card, 4096 envs each, hold one Adam step over
   a fixed trajectory (split by the interleave) against the
   single-process step on the scan and the kernel route (params and
   metrics to ``PPO_TOL``, gradients to ``DP_GRAD_TOL``) and the main
   path's 64-step update's metrics, then drive three blocks each: params
   bitwise identical across ranks, finite metrics, K1, K2, K3 and dw
   launched on every rank (``mappo_dp`` in ``launches_by_path``); a
   2-process MAPPO CLI cluster saves and a resumed one prints ``resumed
   from step N`` on rank 0 only and ends at its total; a ``--profile_dir``
   run leaves a trace.
10. Data-parallel QMIX, VDN, recurrent Q, MADDPG and FACMAC over two
   gloo ranks on the one card (``distributed/dp.py``: rings sharded by
   capacity; phase 2 also holds and times K2, K3 and dw at a rank's
   shapes, T=150, M=48 and T=25, M=32): the commit of every ring kind
   (injected steps, at capacities the ranks divide and do not) equal to
   the single-process ring, scratch row aside; one ``qmix_rnn_3m`` and
   one ``maddpg_rnn_sl`` update split over the ranks against the
   single-process one (phase 9's one-step tolerances); ``qmix_rnn_3m``
   driven at full width on 2 ranks (three blocks: updates, K2/K3/dw
   launches on each rank, params bitwise identical); one 2-rank block of
   ``qmix_spread``, ``vdn_spread``, ``vdn_rnn_seq_3m``, ``maddpg_rnn_sl``
   and ``facmac_3m``; a 2-process QMIX CLI cluster that saves and
   resumes; and a ``qmix_rnn_3m`` resume in one process, bitwise but for
   the ring's scratch row.
11. The validation runner (``cleanmarl_tpu_torch/validate.py``; phase 2
   also holds and times K1 at ``mappo_27m30m_paper``'s update, T=60 over
   512 envs x 27 agents, and K2, K3 and dw at its one minibatch, T=60,
   M=13824, H=128, and at ``qmix_rnn_5m6m``'s, T=150, M=160, H=64): one
   block of each of the ten recipes new to the port (``PATHS11``: five
   SMAClite maps up to 27m_vs_30m, the MAPPO-paper flags together, QMIX-RNN
   on 5m_vs_6m, MPE's referential game, the store-once QMIX ring) through
   ``validate.run_config`` at full width, its budget one block's steps:
   finite results, the recipe's eval metric and each kernel of the
   recipe's path launched (``validate`` in ``launches_by_path``: the ten
   runs' sum).
12. Restore at another world size (``core/checkpoint.py``,
   ``dp.unshard_runners``): the main path's MAPPO (8192 envs, GRU 128)
   and ``qmix_rnn_3m`` (ring cut to 500 episodes, after updates have
   started) saved by two gloo ranks and restored in this process at 1
   (each rank's file bitwise its share of the restored runner, their
   partial sums adding up to its own), one driven block from it (K1, K2,
   K3 and dw at T=60, M=3072; K2, K3 and dw at T=150, M=96), saved and
   restored by two ranks (each rank's restored runner bitwise its share
   of the runner saved, rank 1's generator the rule's new stream, the two
   streams different; shares cut by this script's own index arithmetic,
   not by the ``dp`` code under test), one block on each (M=1536; M=48),
   params bitwise identical across the ranks (``*_resume_2to1`` and
   ``*_resume_1to2`` in ``launches_by_path``).
13. Every optax optimizer the JAX package trains with
   (``core/optim.py``, ``core/optim_transforms.py``; no kernel of its
   own): (a) each name's 3 updates, clip and LR anneal on where optax
   allows them, on the card against the CPU (params and state) on a tree
   with a 128 x 384 leaf that Adafactor factors, ``noisy_sgd`` by its
   noise's variance and the same noise for the same count; (b) each
   name's MAPPO update at the main path's width: finite metrics and 64
   optimizer steps; (c) the main path and ``qmix_rnn_3m`` driven with
   ``rmsprop`` and then with Adam (one update each card vs CPU, a warm-up
   and a driven block, K1/K2/K3/dw counts equal to their launches per
   update: ``mappo_rmsprop`` and ``qmix_rnn_3m_rmsprop`` in
   ``launches_by_path``); (d) a bitwise ``rmsprop`` resume of the main
   path.

``--dp_ranks N`` (N cards) builds the kernels and runs only phase 10's
rank checks over N ranks (nccl with a card each) and recurrent QMIX and
FACMAC through the CLI with ``--use_mesh``; it prints no result line.

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
import re
import subprocess
import sys
import time

from benchmark.yardstick import PEAK_BYTES_PER_S, gru_least_s, returns_bytes, returns_least_s

ROOT = os.path.dirname(os.path.abspath(__file__))

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


def check_returns(results):
    """K1 against its plain version at every case of RETURNS_CASES (shared
    inputs must reach the kernel without a copy), two launches bitwise
    equal, then its device time at the main path's inputs: cold (L2
    flushed) and warm, from CUDA graphs, beside the yardstick's least time
    (bytes), one copy of as many bytes, the wrapper's host time and the
    plain version."""
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

    T, B, R = v.shape[0], v[0].numel(), RETURNS_MAIN[2]
    n_bytes = returns_bytes(T, B, R, R)
    bnd = returns_least_s(T, B, R, R) * 1e3
    ms, warm = device_ms(lambda: rk.lambda_returns_kernel(r, e, v, b, 0.99, 0.95))
    host = host_ms(lambda: rk.lambda_returns_kernel(r, e, v, b, 0.99, 0.95))
    plain = time_ms(lambda: rk.lambda_returns_plain(r, e, v, b, 0.99, 0.95), 10)
    src = torch.empty(n_bytes // 8, device="cuda")
    dst = torch.empty_like(src)
    copy_ms, copy_warm = device_ms(lambda: dst.copy_(src))
    log("[kernels] lambda_returns: two launches bitwise equal; at the main path's inputs "
        f"(T={T}, B={B}, reward, flag and value per env, R={R}): {n_bytes} B, bound "
        f"{bnd:.5f} ms (bytes); device ms cold/warm: kernel {ms:.5f}/{warm:.5f} "
        f"({bnd / ms:.1%} of the bound cold), one copy of {n_bytes} B "
        f"{copy_ms:.5f}/{copy_warm:.5f}; wrapper host {host:.5f} ms per call; "
        f"plain {plain:.4f} ms")
    results["lambda_returns"] = dict(
        source="cleanmarl_tpu_torch/csrc/lambda_returns.cu",
        replaces="cleanmarl_tpu/ops/pallas_returns.py:35",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=bnd,
        library_ms=None, warm_ms=warm, host_ms=host, copy_ms=copy_ms,
        copy_warm_ms=copy_warm, bytes=n_bytes)


def _gru_inputs(T, M, H, seed, keep=None):
    """Random wh, bh, h0 and gi; ``keep`` (T, M) if given, else random
    with 5 % resets."""
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    wh = torch.randn(H, 3 * H, generator=g, device="cuda") / math.sqrt(H)
    bh = torch.randn(3 * H, generator=g, device="cuda") * 0.1
    h0 = torch.randn(M, H, generator=g, device="cuda") * 0.3
    gi = torch.randn(T, M, 3 * H, generator=g, device="cuda")
    if keep is None:
        keep = (torch.rand(T, M, generator=g, device="cuda") > 0.05).float()
    return wh, bh, h0, gi, keep


def check_gru_shape(T, M, H, seed, keep=None):
    """Values and all gradients of the fused GRU (K2 + K3 through the
    autograd.Function) against autograd through the plain scan, and each
    backward kernel against its plain version; each recurrence must go
    through the route its width takes."""
    import torch
    from cleanmarl_tpu_torch.ops import gru_kernel as gk

    ins = _gru_inputs(T, M, H, seed, keep)
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


# the recurrent-Q update's GRU (32 sampled episodes or chunks x 3 agents at
# H=64): whole episodes of T=150 (SMAClite's time limit), chunks of 10
# steps after a burn-in of 8 (T=2), and that burn-in (T=8, checked only)
RQ_SHAPES = ((150, 96, 64), (2, 96, 64))
RQ_BURN_IN_SHAPE = (8, 96, 64)
RQ_OBS, RQ_ACTIONS = 33, 9          # SMAClite 3m with agent ids


def time_rq_routes(T):
    """The recurrent-Q sequence recomputes at (T, 32 episodes, 3 agents,
    obs 33, H=64, 9 actions) on the kernel route against the scan route:
    ``rnn_seq_eval_next`` (values), ``rnn_seq_apply`` (values and every
    gradient) held at VAL_TOL / GRAD_TOL, then both timed: the target
    stream and the online forward without gradient, and the online
    forward + backward. → {name: ms}."""
    import torch
    from cleanmarl_tpu_torch.core import networks as nets
    from cleanmarl_tpu_torch.core.params import tree_leaves, tree_unflatten

    g = torch.Generator("cuda").manual_seed(T)
    params = nets.rnn_init(g, RQ_OBS, 64, RQ_ACTIONS, device="cuda")
    obs = torch.randn(T, 32, 3, RQ_OBS, generator=g, device="cuda")
    next_obs = torch.randn(T, 32, 3, RQ_OBS, generator=g, device="cuda")
    h0 = nets.rnn_initial_state((32, 3), 64, device="cuda")

    def eval_next(impl):
        with torch.no_grad():
            return nets.rnn_seq_eval_next(params, h0, obs, next_obs, impl=impl)

    def fwd(impl):
        with torch.no_grad():
            return nets.rnn_seq_apply(params, h0, obs, impl=impl)[1]

    def fwd_bwd(impl):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        _, q = nets.rnn_seq_apply(tree_unflatten(params, leaves), h0, obs, impl=impl)
        return [q.detach()], list(torch.autograd.grad((q * q).sum(), leaves))

    ek, es = [eval_next("kernel")], [eval_next("scan")]
    err_e = max_err(ek, es)
    (vk, gk_), (vs, gs) = fwd_bwd("kernel"), fwd_bwd("scan")
    err_v, err_g = max_err(vk, vs), max_err(gk_, gs)
    log(f"[kernels] recurrent-Q recompute T={T} (32 x 3 agents, H=64), kernel vs scan route: "
        f"rnn_seq_eval_next err {err_e:.3e}, rnn_seq_apply values err {err_v:.3e} "
        f"grads err {err_g:.3e} (largest grad {max(float(x.abs().max()) for x in gs):.3e})")
    if not (close(ek, es, VAL_TOL) and close(vk, vs, VAL_TOL) and close_scaled(gk_, gs, GRAD_TOL)):
        fail(f"the kernel route of the recurrent-Q recompute disagrees with the scan at T={T}")
    iters = {"kernel": 10, "scan": 3} if T > 10 else {"kernel": 50, "scan": 20}
    out = {}
    for impl, n in iters.items():
        out[f"eval_next_{impl}_ms"] = time_ms(lambda: eval_next(impl), n)
        out[f"fwd_{impl}_ms"] = time_ms(lambda: fwd(impl), n)
        out[f"fwd_bwd_{impl}_ms"] = time_ms(lambda: fwd_bwd(impl), n)
    log(f"[kernels] recurrent-Q recompute T={T} times (ms, host clock to device end): " + " ".join(
        f"{k[:-3]}={v:.4f}" for k, v in out.items()))
    return dict(out, eval_next_err=err_e, values_err=err_v, grads_err=err_g)


def check_recurrent_q_shapes(results):
    """K2, K3 and dw against their plain versions at the recurrent-Q
    update's shapes (and the burn-in's), their times, bounds and cuDNN's
    GRU at the same shapes, and the kernel route against the scan route of
    the sequence recomputes. Adds a ``recurrent_q_shapes`` entry to each
    tensor-core GRU row of ``results``."""
    e = check_gru_shape(*RQ_BURN_IN_SHAPE, seed=8)[0]
    routes = {}
    for T, M, H in RQ_SHAPES:
        e2, ins, hs, rec = check_gru_shape(T, M, H, seed=T)
        e = {k: max(e[k], e2[k]) for k in e}
        add_shape_rows(results, "recurrent_q_shapes", T, M, H,
                       time_gru(T, M, H, ins, hs, rec))
        routes[T] = time_rq_routes(T)
    keep_max_err(results, e)
    return routes


def add_shape_rows(results, group, T, M, H, t):
    """Add the times ``t`` of K2, K3 and dw at one shape, with their least
    times (``gru_least_s``), µs a step and yardsticks, to
    ``results[name][group]``."""
    rows = {"gru_seq_fwd": ("fwd", "fwd_library_ms"), "gru_seq_bwd": ("bwd", None),
            "gru_seq_dw": ("dw", "dw_library_ms")}
    least = gru_least_s(T, M, H)
    for name, (k, lib) in rows.items():
        entry = dict(ms=t[f"{k}_ms"], plain_ms=t[f"{k}_plain_ms"], bound_ms=least[k] * 1e3,
                     library_ms=t[lib] if lib else None, us_per_step=t[f"{k}_ms"] * 1e3 / T)
        if k == "bwd":
            entry.update(whole_bwd_library_ms=t["bwd_library_ms"],
                         whole_bwd_ms=t["bwd_ms"] + t["dw_ms"])
        results[name].setdefault(group, {})[f"T{T}_M{M}_H{H}"] = entry


def keep_max_err(results, e):
    """Raise each tensor-core GRU row's max_abs_err to the errors ``e`` of
    ``check_gru_shape`` where they are larger."""
    for name, key in (("gru_seq_fwd", "fwd"), ("gru_seq_bwd", "bwd"), ("gru_seq_dw", "dw")):
        worst = max(e[key], e["grads"]) if key == "bwd" else e[key]
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], worst)


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
    # the L2 route at the main path's T and M: held, not timed (no path launches it)
    keep_max(check_gru_shape(60, 3072, 256, seed=257)[0], 256)
    e, ins, hs, rec = check_gru_shape(60, 3072, 128, seed=129)
    keep_max(e, 128)
    vs_f64 = check_fwd_deterministic(ins)
    check_dw_deterministic(ins, hs, rec)
    t = time_gru(60, 3072, 128, ins, hs, rec)
    least = gru_least_s(60, 3072, 128)
    src = "cleanmarl_tpu_torch/csrc/"
    rows = {"gru_seq_fwd": ("fwd", "gru_seq_fwd.cu", "pallas_gru.py:67", "fwd_library_ms",
                            errs["fwd"]),
            "gru_seq_fwd_l2": (None, "gru_seq_fwd.cu", "pallas_gru.py:67", None,
                               errs["fwd_l2"]),
            "gru_seq_bwd": ("bwd", "gru_seq_bwd.cu", "pallas_gru.py:130", None,
                            max(errs["bwd"], errs["grads"])),
            "gru_seq_bwd_l2": (None, "gru_seq_bwd.cu", "pallas_gru.py:130", None,
                               errs["bwd_l2"]),
            "gru_seq_dw": ("dw", "gru_seq_bwd.cu", "pallas_gru.py:173", "dw_library_ms",
                           errs["dw"])}
    for name, (k, f, rep, lib, err) in rows.items():
        results[name] = dict(source=src + f, replaces="cleanmarl_tpu/ops/" + rep,
                             max_abs_err=err, hidden=256 if k is None else 128)
        if k is None:
            continue
        results[name].update(ms=t[f"{k}_ms"], plain_ms=t[f"{k}_plain_ms"],
                             bound_ms=least[k] * 1e3, library_ms=t[lib] if lib else None)
        if k == "bwd":
            # no one call computes the recurrence alone; cuDNN's GRU backward
            # (fwd+bwd - fwd) is the yardstick of recurrence + weight gradient
            results[name].update(whole_bwd_library_ms=t["bwd_library_ms"],
                                 whole_bwd_ms=t["bwd_ms"] + t["dw_ms"])
    results["gru_seq_fwd"].update(h_seq_err_vs_f64=vs_f64["kernel"],
                                  plain_h_seq_err_vs_f64=vs_f64["plain"])
    return {128: t}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def check_update_against_cpu(optimizer: str = "adam", tag: str = "main"):
    """One PPO update on the card (kernels) equals the same update on the
    CPU (plain versions), from the same params and trajectory, with the
    optimizer ``optimizer``."""
    import torch
    from cleanmarl_tpu_torch.algos.mappo import make_train
    from cleanmarl_tpu_torch.algos.ppo_common import PPOConfig
    from cleanmarl_tpu_torch.core.params import tree_leaves, tree_map

    small = dict(BENCH, num_envs=16, rollout_len=12, actor_hidden_dim=32,
                 critic_hidden_dim=32, epochs=2, num_minibatches=2,
                 normalize_advantage=True, optimizer=optimizer)
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
    log(f"[{tag}] one PPO update ({optimizer}), card vs CPU: metrics agree (max |diff| "
        f"{worst:.3e})")
    return worst


def main_path_kernels(counters):
    """Every counted kernel except the forward and backward routes that the
    main path's GRU (the actor's; the critic is an MLP) does not take."""
    from cleanmarl_tpu_torch.ops import gru_kernel as gk

    H = BENCH["actor_hidden_dim"]
    routes = {"gru_seq_fwd", "gru_seq_fwd_l2", "gru_seq_bwd", "gru_seq_bwd_l2"}
    skipped = routes - {gk.fwd_route(H), gk.bwd_route(H)}
    return [k for table in counters for k in table if k not in skipped]


def drive_main_path(counters):
    """The main path at the bench settings: one warm-up ``train_block``
    (with init), two more and one ``eval_fn``, every kernel count set to 0
    before and read after: finite metrics, every kernel of the path
    launched."""
    import torch
    from cleanmarl_tpu_torch.algos.mappo import make_train
    from cleanmarl_tpu_torch.algos.ppo_common import PPOConfig
    from cleanmarl_tpu_torch.core.driver import to_host

    cfg = PPOConfig(**BENCH, device="cuda")
    init, train_block, eval_fn, meta = make_train(cfg)
    log(f"[main] MAPPO smaclite 3m, GRU route {meta['gru_impl']!r}, "
        f"{meta['steps_per_block']} env steps per train_block")
    for table in counters:
        for k in table:
            table[k] = 0
    runner = init(torch.Generator("cuda").manual_seed(cfg.seed))
    runner, metrics = train_block(runner)
    warm = to_host(metrics)
    for _ in range(2):
        runner, metrics = train_block(runner)
        metrics = to_host(metrics)
    evals = to_host(eval_fn(runner.actor_params, torch.Generator("cuda").manual_seed(1)))
    torch.cuda.synchronize()
    launches = {k: v for table in counters for k, v in table.items()}
    log(f"[main] launches {launches}")
    log(f"[main] last block metrics {json.dumps(metrics, sort_keys=True)}")
    log(f"[main] eval {json.dumps(evals, sort_keys=True)}")
    for k, v in {**warm, **metrics, **evals}.items():
        if not math.isfinite(v):
            fail(f"non-finite metric {k}={v}")
    for k in main_path_kernels(counters):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the main path")
    return dict(launches=launches, metrics=metrics, eval=evals,
                model_flops_per_step=meta["model_flops_per_step"])


MAPPO_CLI = ["--recurrent", "true", "--env_type", "smaclite", "--env_name", "3m",
             "--device", "cuda", "--num_envs", "16", "--total_timesteps", "19200",
             "--eval_steps", "19200", "--seed", "0"]
# one train_block of the qmix_spread recipe's width (40 iterations of 32 envs)
QMIX_CLI = ["--env_type", "mpe", "--env_name", "simple_spread_v3", "--device", "cuda",
            "--num_envs", "32", "--log_interval", "40", "--total_timesteps", "1280",
            "--eval_steps", "1280", "--seed", "0"]


def run_cli(algo: str, args):
    cmd = [sys.executable, "-m", f"cleanmarl_tpu_torch.algos.{algo}"] + args
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    log(f"[cli] {' '.join(cmd[1:])}: rc {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in proc.stdout.strip().splitlines()[-3:]:
        log(f"[cli] {line}")
    if proc.returncode != 0:
        fail(f"CLI exited {proc.returncode}: {proc.stderr[-2000:]}")


# ---------------------------------------------------------------------------
# phase 5: the off-policy slice, QMIX and VDN on MPE simple_spread
# ---------------------------------------------------------------------------

# the JAX package's validated recipes (scripts/validate_baselines.py:37-59,
# qmix_spread and vdn_spread), copied, not imported; random weights, seed 0
OFFPOLICY = {
    "qmix": dict(env_type="mpe", env_name="simple_spread_v3", num_envs=32,
                 total_timesteps=2_000_000, buffer_size=5_000, batch_size=32,
                 exploration_fraction=0.1, hidden_dim=64, log_interval=40,
                 seed=0, verbose=False),
    "vdn": dict(env_type="mpe", env_name="simple_spread_v3", num_envs=32,
                total_timesteps=2_000_000, buffer_size=100_000, batch_size=4,
                learning_starts=10_000, train_freq=1, exploration_fraction=0.1,
                hidden_dim=64, log_interval=200, seed=0, verbose=False),
}
# (warm-up blocks, driven blocks): VDN's updates start after 10,000
# transitions, inside its second block (vdn_pursuit: its fourth of 100
# iterations, DRIVE_LOG_INTERVAL)
OFFPOLICY_BLOCKS = {"qmix": (1, 3), "vdn": (2, 3), "vdn_pursuit": (4, 2)}
MPE_CYCLES = 25     # every simple_spread env truncates at step 25, none terminates


def _offpolicy(name, device):
    """(module, config) of one off-policy recipe on ``device``."""
    from cleanmarl_tpu_torch.algos import qmix, vdn

    if name in PATHS8:
        return _recipe(name, device, DRIVE_LOG_INTERVAL.get(name))
    mod, cls = {"qmix": (qmix, qmix.QMIXConfig), "vdn": (vdn, vdn.VDNConfig)}[name]
    return mod, cls(**OFFPOLICY[name], device=device)


def _sample(name, cfg, runner, generator):
    """The arguments ``meta["update"]`` takes after the params: a sampled
    batch (and QMIX's step mask)."""
    if name == "qmix":
        return runner.ring.sample(generator, cfg.batch_size)
    return (runner.buffer.sample(generator, cfg.batch_size * cfg.num_envs),)


def check_offpolicy_updates_against_cpu():
    """One QMIX and one VDN update on the card (float32, TF32 off) equal the
    same update on the CPU, from the same params, Adam state and batch:
    the recipe's replay after 25 iterations on the CPU (one episode per
    env; QMIX has run its first 32 updates)."""
    import torch
    from cleanmarl_tpu_torch.core.params import tree_leaves, tree_map

    def to_cuda(x):
        return x.cuda() if isinstance(x, torch.Tensor) else x
    for name in OFFPOLICY:
        mod, cfg_c = _offpolicy(name, "cpu")
        init_c, _, _, meta_c = mod.make_train(cfg_c)
        _, _, _, meta_g = mod.make_train(_offpolicy(name, "cuda")[1])
        runner = init_c(torch.Generator().manual_seed(0))
        for _ in range(MPE_CYCLES):
            runner, _ = meta_c["train_iter"](runner)
        args = _sample(name, cfg_c, runner, torch.Generator().manual_seed(1))
        state = (runner.params, runner.target_params, runner.opt_state)
        p_c, _, loss_c, gn_c = meta_c["update"](*state, *args)
        p_g, _, loss_g, gn_g = meta_g["update"](*tree_map(to_cuda, state),
                                                *tree_map(to_cuda, args))
        pairs = [(loss_g, loss_c), (gn_g, gn_c)] + list(zip(tree_leaves(p_g),
                                                            tree_leaves(p_c)))
        worst = max(float((a.cpu() - b).abs().max()) for a, b in pairs)
        if not all(torch.allclose(a.cpu(), b, **PPO_TOL) for a, b in pairs):
            fail(f"{name} update on the card disagrees with the CPU (max |diff| {worst})")
        log(f"[offpolicy] one {name} update, card vs CPU: loss {float(loss_g):.6f} vs "
            f"{float(loss_c):.6f}, grad norm {float(gn_g):.6f} vs {float(gn_c):.6f}, "
            f"max |diff| over loss, norm and params {worst:.3e}")


def offpolicy_clock(name, cfg, step: int) -> int:
    """Updates the recipe owes after ``step`` iterations. QMIX: one per
    completed episode (train_freq 1), from the first commit on (its 32
    episodes fill the batch of 32). VDN: one every ``train_freq``
    iterations once more than ``learning_starts`` transitions are stored."""
    if name == "qmix":
        return cfg.num_envs * (step // MPE_CYCLES) // cfg.train_freq
    first = cfg.learning_starts // cfg.num_envs + 1
    return max(0, step // cfg.train_freq - (first - 1) // cfg.train_freq)


def drive_offpolicy(name, counters):
    """One recipe at full width on the card: warm-up blocks (incl. init),
    driven blocks, one eval, finite metrics, updates in the driven blocks,
    the episode- or iteration-clock update count. Every kernel count is
    set to 0 before and read after: this path launches no kernel."""
    import torch
    from cleanmarl_tpu_torch.core.driver import to_host

    mod, cfg = _offpolicy(name, "cuda")
    init, train_block, eval_fn, meta = mod.make_train(cfg)
    n_warm, n_driven = OFFPOLICY_BLOCKS[name]
    for table in counters:
        for k in table:
            table[k] = 0
    seen = []
    runner = init(torch.Generator("cuda").manual_seed(cfg.seed))
    for _ in range(n_warm):
        runner, metrics = train_block(runner)
        seen.append(to_host(metrics))
    updates = []
    for _ in range(n_driven):
        n0 = runner.num_updates
        runner, metrics = train_block(runner)
        seen.append(to_host(metrics))
        updates.append(runner.num_updates - n0)
    evals = to_host(eval_fn(runner.params, torch.Generator("cuda").manual_seed(1)))
    torch.cuda.synchronize()
    launches = {k: v for table in counters for k, v in table.items()}
    for k, v in [kv for m in seen for kv in m.items()] + list(evals.items()):
        if not math.isfinite(v):
            fail(f"{name}: non-finite metric {k}={v}")
    want = offpolicy_clock(name, cfg, runner.step)
    if runner.num_updates != want or seen[-1]["train/num_updates"] != want:
        fail(f"{name}: {runner.num_updates} updates after {runner.step} iterations, "
             f"the clock says {want}")
    if sum(updates) == 0:
        fail(f"{name}: the driven blocks ran no update")
    log(f"[{name}] {cfg.env_type} {cfg.env_name}, {cfg.num_envs} envs, "
        f"{meta['steps_per_block']} env steps per train_block; {n_warm} warm-up block(s) "
        f"(incl. init), driven blocks with {updates} updates; kernel launches on this path "
        f"{launches}")
    log(f"[{name}] {runner.num_updates} updates after {runner.step} iterations = the clock's "
        f"{want}; last block {json.dumps(seen[-1], sort_keys=True)}")
    log(f"[{name}] eval {json.dumps(evals, sort_keys=True)}")
    return dict(updates_per_block=updates, launches=launches, num_updates=runner.num_updates,
                step=runner.step, metrics=seen[-1], eval=evals)


# ---------------------------------------------------------------------------
# phase 6: recurrent QMIX and VDN on SMAClite 3m (K2, K3 and dw on the path)
# ---------------------------------------------------------------------------

# the JAX package's validated recipes (scripts/validate_baselines.py:127-153
# qmix_rnn_3m and vdn_rnn_3m, :195-207 vdn_rnn_seq_3m), copied, not
# imported; random weights, seed 0
_RQ_BASE = dict(env_type="smaclite", env_name="3m", num_envs=64, total_timesteps=2_000_000,
                batch_size=32, train_freq=1, learning_rate=5e-4, polyak=0.005,
                hidden_dim=64, exploration_fraction=0.05, end_e=0.025, log_interval=50,
                seed=0, verbose=False)
RECQ = {
    "qmix_rnn_3m": dict(_RQ_BASE, mixing="qmix", buffer_size=5_000, max_updates_per_iter=8),
    "vdn_rnn_3m": dict(_RQ_BASE, mixing="vdn", buffer_size=5_000, max_updates_per_iter=8),
    "vdn_rnn_seq_3m": dict(_RQ_BASE, mixing="vdn", replay="sequence", seq_length=10,
                           burn_in=8, buffer_size=20_000),
}
RECQ_DRIVEN = ("qmix_rnn_3m", "vdn_rnn_seq_3m")   # vdn_rnn_3m differs by the mixer only
RECQ_BLOCKS = 2
# one train_block of the qmix_rnn_3m recipe's width (50 iterations of 64 envs)
QMIX_RNN_CLI = ["--env_type", "smaclite", "--env_name", "3m", "--device", "cuda",
                "--num_envs", "64", "--buffer_size", "500", "--batch_size", "32",
                "--hidden_dim", "64", "--max_updates_per_iter", "8", "--log_interval", "50",
                "--total_timesteps", "3200", "--eval_steps", "3200", "--seed", "0"]


def _recq_batch(cfg, env, seed):
    """Random records of the recipe's widths on the CPU: (B, T_max)
    episodes and their step mask, or (B, L) chunks → ``meta["update"]`` or
    ``meta["update_seq"]``'s arguments after the params."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    seq = cfg.replay == "sequence"
    B, T, n, A = cfg.batch_size, cfg.seq_length if seq else env.episode_limit, \
        env.n_agents, env.n_actions

    def avail():
        a = rng.rand(B, T, n, A) < 0.7
        a[..., 1] = True
        return torch.as_tensor(a)
    av = avail()
    batch = {"obs": rng.randn(B, T, n, env.obs_dim), "state": rng.randn(B, T, env.state_dim),
             "reward": rng.randn(B, T), "next_obs": rng.randn(B, T, n, env.obs_dim),
             "next_state": rng.randn(B, T, env.state_dim)}
    batch = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in batch.items()}
    batch.update(action=torch.argmax(torch.as_tensor(rng.rand(B, T, n, A)) * av, -1),
                 done=torch.as_tensor(rng.rand(B, T) < 0.05), next_avail=avail())
    if seq:
        return (batch,)
    lengths = rng.randint(10, T + 1, (B, 1))
    return batch, torch.as_tensor((np.arange(T)[None] < lengths).astype(np.float32))


def _recq(name, device, table=None):
    from cleanmarl_tpu_torch.algos import recurrent_q

    cfg = recurrent_q.RecurrentQConfig(**(table or RECQ)[name], device=device)
    return cfg, recurrent_q.make_train(cfg)


def check_recq_updates_against_cpu(table=None, tag="recq"):
    """One update of each recipe of ``table`` (RECQ) on the card (kernel
    route, TF32 off) equals the same update on the CPU (scan route), from
    the same params, optimizer state (after one update on the CPU) and
    batch of the recipe's widths: 32 episodes padded to 150 steps, or 32
    chunks of 10 with a burn-in of 8. → {name: max |diff|}."""
    import torch
    from cleanmarl_tpu_torch.core.params import tree_leaves, tree_map
    from cleanmarl_tpu_torch.envs import registry

    def to_cuda(x):
        return x.cuda() if isinstance(x, torch.Tensor) else x
    env = registry.make("smaclite", "3m", agent_ids=True)
    out = {}
    for name in (table or RECQ):
        cfg, (init_c, _, _, meta_c) = _recq(name, "cpu", table)
        _, (_, _, _, meta_g) = _recq(name, "cuda", table)
        if (meta_c["gru_impl"], meta_g["gru_impl"]) != ("scan", "kernel"):
            fail(f"{name}: GRU routes {meta_c['gru_impl']} (CPU) / {meta_g['gru_impl']} (card)")
        key = "update_seq" if cfg.replay == "sequence" else "update"
        runner = init_c(torch.Generator().manual_seed(0))
        p, o, _, _ = meta_c[key](runner.params, runner.target_params, runner.opt_state,
                                 *_recq_batch(cfg, env, 0))
        args = _recq_batch(cfg, env, 1)
        state = (p, runner.target_params, o)
        p_c, _, loss_c, gn_c = meta_c[key](*state, *args)
        p_g, _, loss_g, gn_g = meta_g[key](*tree_map(to_cuda, state), *tree_map(to_cuda, args))
        pairs = [(loss_g, loss_c), (gn_g, gn_c)] + list(zip(tree_leaves(p_g), tree_leaves(p_c)))
        worst = max(float((a.cpu() - b).abs().max()) for a, b in pairs)
        if not all(torch.allclose(a.cpu(), b, **PPO_TOL) for a, b in pairs):
            fail(f"{name} update on the card disagrees with the CPU (max |diff| {worst})")
        log(f"[{tag}] one {name} update, card (kernels) vs CPU (scan): loss {float(loss_g):.6f} "
            f"vs {float(loss_c):.6f}, grad norm {float(gn_g):.6f} vs {float(gn_c):.6f}, "
            f"max |diff| over loss, norm and params {worst:.3e}")
        out[name] = worst
    return out


def recq_clock(cfg, runner, origin) -> int:
    """Updates the recipe owes: one per ``train_freq`` crossings of its
    clock (completed episodes, or iterations with sequence replay) from
    the iteration whose commit first made the ring hold a batch on;
    ``origin`` is (step, episodes) just before that iteration."""
    seq = cfg.replay == "sequence"
    now, before = (runner.step, origin[0]) if seq else (runner.episodes, origin[1])
    return now // cfg.train_freq - before // cfg.train_freq


def drive_recq(name, counters):
    """One recipe at full width on the card: warm-up blocks (iteration by
    iteration, to find where the ring first holds a batch) until updates
    run, driven blocks, one eval, finite metrics, the clock's update
    count; every kernel count set to 0 before init and read after eval:
    K2, K3 and dw must have launched, the L2 routes and K1 not."""
    import torch
    from cleanmarl_tpu_torch.core.driver import to_host

    cfg, (init, train_block, eval_fn, meta) = _recq(name, "cuda")
    for table in counters:
        for k in table:
            table[k] = 0
    runner = init(torch.Generator("cuda").manual_seed(cfg.seed))
    origin, n_warm = None, 0
    while origin is None or runner.num_updates == 0:
        for _ in range(cfg.log_interval):
            before = (runner.step, runner.episodes)
            runner, _ = meta["train_iter"](runner)
            if origin is None and runner.ring.size >= cfg.batch_size:
                origin = before
        runner = runner.replace(stats=runner.stats.flush())
        n_warm += 1
        if n_warm > 6:
            fail(f"{name}: no update after {n_warm} warm-up blocks")
    updates, seen = [], []
    for _ in range(RECQ_BLOCKS):
        n0 = runner.num_updates
        runner, metrics = train_block(runner)
        seen.append(to_host(metrics))
        updates.append(runner.num_updates - n0)
    evals = to_host(eval_fn(runner.params, torch.Generator("cuda").manual_seed(1)))
    torch.cuda.synchronize()
    launches = {k: v for table in counters for k, v in table.items()}
    for k, v in [kv for m in seen for kv in m.items()] + list(evals.items()):
        if not math.isfinite(v):
            fail(f"{name}: non-finite metric {k}={v}")
    for k in ("gru_seq_fwd", "gru_seq_bwd", "gru_seq_dw"):
        if launches[k] <= 0:
            fail(f"{name}: kernel {k} was not launched on this path")
    for k in ("gru_seq_fwd_l2", "gru_seq_bwd_l2", "lambda_returns"):
        if launches[k] != 0:
            fail(f"{name}: {k} launched {launches[k]} times on a path that must not take it")
    want = recq_clock(cfg, runner, origin)
    owed = runner.num_updates + runner.update_debt
    if owed != want or seen[-1]["train/num_updates"] != runner.num_updates:
        fail(f"{name}: {runner.num_updates} updates + {runner.update_debt} debt after "
             f"{runner.step} iterations and {runner.episodes} episodes, the clock says {want}")
    if sum(updates) == 0:
        fail(f"{name}: the driven blocks ran no update")
    num_updates = runner.num_updates
    per_update = {k: launches[k] / num_updates for k in ("gru_seq_fwd", "gru_seq_bwd",
                                                         "gru_seq_dw")}
    log(f"[{name}] smaclite 3m, {cfg.num_envs} envs, {meta['steps_per_block']} env steps per "
        f"train_block, GRU route {meta['gru_impl']!r}; {n_warm} warm-up block(s) (incl. init), "
        f"driven blocks with {updates} updates")
    log(f"[{name}] kernel launches {launches} ({per_update} per update)")
    log(f"[{name}] {num_updates} updates + {runner.update_debt} debt after {runner.step} "
        f"iterations and {runner.episodes} episodes = the clock's {want} (from (step, "
        f"episodes) {origin}); last block {json.dumps(seen[-1], sort_keys=True)}")
    log(f"[{name}] eval {json.dumps(evals, sort_keys=True)}")
    return dict(updates_per_block=updates, warmup_blocks=n_warm, launches=launches,
                launches_per_update=per_update, num_updates=num_updates,
                update_debt=runner.update_debt, step=runner.step, clock=want,
                metrics=seen[-1], eval=evals)


# ---------------------------------------------------------------------------
# phase 7: MADDPG, FACMAC and COMA (K1 at COMA's shapes, K2, K3 and dw on
# the recurrent actors)
# ---------------------------------------------------------------------------

# the JAX package's validated recipes (scripts/validate_baselines.py:72-96
# maddpg_sl and facmac_sl, :209-220 maddpg_rnn_sl, :272-285 coma_3m),
# copied, not imported; random weights, seed 0. coma_rnn_3m is coma_3m with
# the GRU actor (actor_hidden_dim 64)
_SL = dict(env_type="mpe", env_name="simple_speaker_listener_v4", num_envs=32,
           total_timesteps=2_000_000, buffer_size=5_000, batch_size=32, actor_hidden_dim=64,
           critic_hidden_dim=128, log_interval=40, seed=0, verbose=False)
_COMA = dict(env_type="smaclite", env_name="3m", num_envs=64, total_timesteps=2_000_000,
             actor_hidden_dim=64, critic_hidden_dim=128, learning_rate_actor=5e-4,
             learning_rate_critic=5e-4, td_lambda=0.8, normalize_advantage=True,
             entropy_coef=0.001, start_e=0.5, end_e=0.002, exploration_fraction=100.0,
             log_interval=8, seed=0, verbose=False)
PATHS7 = {"maddpg_sl": ("maddpg", _SL), "maddpg_rnn_sl": ("maddpg", dict(_SL, recurrent=True)),
          "facmac_sl": ("facmac", _SL), "coma_3m": ("coma", _COMA),
          "coma_rnn_3m": ("coma", dict(_COMA, recurrent=True))}
# run length only: a driven COMA or IPPO block is 2 rollouts (the recipes
# log every 2-8), and they time 2 blocks, MADDPG and FACMAC 3
ONPOLICY_LOG_INTERVAL = 2
# pursuit's blocks are cut further (its env step costs 3x LBF's): IPPO
# one rollout a block, VDN 100 iterations a block (its recipe logs at 200)
DRIVE_LOG_INTERVAL = {"ippo_pursuit": 1, "vdn_pursuit": 100}
# kernel launches per update: K1, K2, K3, dw (the L2 routes never launch)
KERNEL_KEYS = ("lambda_returns", "gru_seq_fwd", "gru_seq_bwd", "gru_seq_dw")
PATHS7_LAUNCHES = {"maddpg_sl": (0, 0, 0, 0), "maddpg_rnn_sl": (0, 2, 1, 1),
                   "facmac_sl": (0, 0, 0, 0), "coma_3m": (1, 0, 0, 0),
                   "coma_rnn_3m": (1, 1, 1, 1)}
MADDPG_RNN_SHAPE = (25, 64, 64)    # 32 speaker-listener episodes x 2 agents at H=64
COMA_RNN_SHAPE = (150, 192, 64)    # a 3m rollout of 64 envs x 3 agents at H=64
MADDPG_RNN_CLI = ["--env_type", "mpe", "--env_name", "simple_speaker_listener_v4",
                  "--device", "cuda", "--num_envs", "32", "--recurrent", "true",
                  "--actor_hidden_dim", "64", "--log_interval", "40",
                  "--total_timesteps", "1280", "--eval_steps", "1280", "--seed", "0"]
COMA_RNN_CLI = ["--env_type", "smaclite", "--env_name", "3m", "--device", "cuda",
                "--num_envs", "64", "--recurrent", "true", "--log_interval", "1",
                "--total_timesteps", "9600", "--eval_steps", "9600", "--seed", "0"]


def _recipe(name, device, log_interval=None):
    """(module, config) of a phase-7 or phase-8 recipe on ``device``."""
    from cleanmarl_tpu_torch.algos import coma, facmac, ippo, maddpg, vdn

    algo, kw = {**PATHS7, **PATHS8}[name]
    mod, cls = {"maddpg": (maddpg, maddpg.MADDPGConfig), "facmac": (facmac, facmac.FACMACConfig),
                "coma": (coma, coma.COMAConfig), "ippo": (ippo, ippo.IPPOConfig),
                "vdn": (vdn, vdn.VDNConfig)}[algo]
    return mod, cls(**dict(kw, log_interval=log_interval or kw["log_interval"]), device=device)


def coma_rollout_flags():
    """The team reward and end flags (T=150, 64 envs) of one ``coma_3m``
    rollout on the card at random weights: the shapes and episode ends of
    COMA's λ-returns and of its GRU actor's resets."""
    import torch

    mod, cfg = _recipe("coma_3m", "cuda")
    init, _, _, meta = mod.make_train(cfg)
    _, traj, _ = meta["collect_rollout"](init(torch.Generator("cuda").manual_seed(0)),
                                         cfg.start_e)
    return traj["reward"], traj["ended"]


def time_k1_at(results, key, r, e, v, b, lam, want_R, label):
    """K1 at one update's inputs (r, e, v (T, E, n), b (E, n)) against its
    plain version, with the repeat factors ``want_R`` it must read them at
    (an input broadcast over the agents uncopied), timed as the main path's
    row: cold and warm device ms, the wrapper's host ms, the plain version
    and one copy of as many bytes. Adds ``results["lambda_returns"][key]``."""
    import torch
    from cleanmarl_tpu_torch.ops import returns_kernel as rk

    (kr, ke, kv, _), Rr, Rv = rk.kernel_args(r, e, v, b)
    views = [(k, x) for k, x, R in ((kr, r, Rr), (ke, e, Rr), (kv, v, Rv)) if R > 1]
    if (Rr, Rv) != want_R or any(k.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
                                 for k, x in views):
        fail(f"lambda_returns at {label} would read R=({Rr}, {Rv}), expected {want_R} with "
             "the broadcast inputs uncopied")
    n0 = rk.LAUNCHES["lambda_returns"]
    got = rk.lambda_returns_kernel(r, e, v, b, 0.99, lam)
    if rk.LAUNCHES["lambda_returns"] != n0 + 1:
        fail("lambda_returns_kernel did not count its launch")
    want = rk.lambda_returns_plain(r, e, v, b, 0.99, lam)
    err = max_err(got, want)
    if not close(got, want, RET_TOL):
        fail(f"lambda_returns disagrees with its plain version at {label}")
    T, B = v.shape[0], v[0].numel()
    # the bound counts each input once at its own base, whatever the
    # kernel reads (r and e share one repeat factor there)
    base_R = [(rk.repeat_base(x) or (None, 1))[1] for x in (r, e, v)]
    n_bytes = returns_bytes(T, B, base_R[0], base_R[2], base_R[1])
    bnd = n_bytes / PEAK_BYTES_PER_S * 1e3     # the yardstick's least time of K1: its bytes
    ms, warm = device_ms(lambda: rk.lambda_returns_kernel(r, e, v, b, 0.99, lam))
    host = host_ms(lambda: rk.lambda_returns_kernel(r, e, v, b, 0.99, lam))
    plain = time_ms(lambda: rk.lambda_returns_plain(r, e, v, b, 0.99, lam), 10)
    src = torch.empty(n_bytes // 8, device="cuda")
    dst = torch.empty_like(src)
    copy_ms, copy_warm = device_ms(lambda: dst.copy_(src))
    log(f"[kernels] lambda_returns at {label} (T={T}, {B} columns, R=({Rr}, {Rv}) read, "
        f"inputs' own R (r, e, v)={tuple(base_R)}, "
        f"{int(e[..., 0].sum())} episode ends): max_abs_err={err:.3e}; {n_bytes} B, bound "
        f"{bnd:.6f} ms (bytes); device ms cold/warm: kernel {ms:.5f}/{warm:.5f} "
        f"({ms * 1e3 / T:.3f} µs a step cold), one copy of {n_bytes} B {copy_ms:.5f}/"
        f"{copy_warm:.5f}; wrapper host {host:.5f} ms per call; plain {plain:.4f} ms")
    row = results["lambda_returns"]
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row[key] = dict(T=T, columns=B, R=[Rr, Rv], input_R=base_R, ms=ms, warm_ms=warm,
                    bound_ms=bnd, plain_ms=plain, library_ms=None, copy_ms=copy_ms,
                    copy_warm_ms=copy_warm, host_ms=host, max_abs_err=err,
                    us_per_step=ms * 1e3 / T, bytes=n_bytes)


def check_paths7_shapes(results):
    """K1 at COMA's update shape (T=150, 64 envs x 3 agents: the rollout's
    team reward and end flags broadcast over the agents, per-agent values)
    against its plain version, timed as the main path's row; K2, K3 and dw
    at the recurrent MADDPG update's shape (no resets) and the recurrent
    COMA update's (resets at the rollout's episode ends), held and timed.
    Adds ``coma_3m_shape`` to K1's row and ``maddpg_rnn_sl_shapes`` /
    ``coma_rnn_3m_shapes`` to each tensor-core GRU row."""
    import torch

    reward, ended = coma_rollout_flags()
    T, E, n = reward.shape[0], reward.shape[1], 3
    g = torch.Generator("cuda").manual_seed(11)
    r, e = reward[..., None].expand(T, E, n), ended[..., None].expand(T, E, n)
    v = torch.randn(T, E, n, generator=g, device="cuda")
    b = torch.randn(E, n, generator=g, device="cuda")
    time_k1_at(results, "coma_3m_shape", r, e, v, b, 0.8, (n, 1), "COMA's shape on 3m")

    keep_coma = (1.0 - ended.float())[..., None].expand(T, E, n).reshape(T, E * n).contiguous()
    for group, (T_, M, H), keep in (
            ("maddpg_rnn_sl_shapes", MADDPG_RNN_SHAPE,
             torch.ones(MADDPG_RNN_SHAPE[:2], device="cuda")),
            ("coma_rnn_3m_shapes", COMA_RNN_SHAPE, keep_coma)):
        errs, ins, hs, rec = check_gru_shape(T_, M, H, seed=M, keep=keep)
        add_shape_rows(results, group, T_, M, H, time_gru(T_, M, H, ins, hs, rec))
        keep_max_err(results, errs)


def _sl_batch(env, cfg, seed):
    """Random episodes of a speaker-listener recipe's widths on the CPU:
    (B, 25) records with one-hot actions and their step mask."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    B, T, n, A = cfg.batch_size, env.episode_limit, env.n_agents, env.n_actions
    av = rng.rand(B, T, n, A) < 0.7
    av[..., 0] = True
    batch = {"obs": rng.randn(B, T, n, env.obs_dim), "state": rng.randn(B, T, env.state_dim),
             "reward": rng.randn(B, T), "next_obs": rng.randn(B, T, n, env.obs_dim),
             "next_state": rng.randn(B, T, env.state_dim),
             "action": np.eye(A)[np.argmax(rng.rand(B, T, n, A) * av, -1)]}
    batch = {k: torch.as_tensor(x, dtype=torch.float32) for k, x in batch.items()}
    batch.update(avail=torch.as_tensor(av), next_avail=torch.ones(B, T, n, A, dtype=torch.bool),
                 ended=torch.as_tensor(rng.rand(B, T) < 0.05))
    mask = np.arange(T)[None] < rng.randint(10, T + 1, (B, 1))
    return batch, torch.as_tensor(mask.astype(np.float32))


def check_updates_against_cpu(names, tag):
    """One update of each recipe in ``names`` on the card (kernels, TF32
    off) equals the same update on the CPU (plain versions, scan), from the
    same params and Adam states (after one update on the CPU), on the same
    batch and Gumbel noise (MADDPG, FACMAC: random episodes of the recipe's
    widths; VDN: its transition ring after 25 CPU iterations) or the same
    rollout (COMA, IPPO: the recipe's second rollout on the CPU, whose GRU
    carry at the start is not zero; COMA's truncation bootstrap takes a
    uniform sample of the terminal observations' actions)."""
    import dataclasses
    import torch
    from cleanmarl_tpu_torch.core.params import tree_leaves, tree_map
    from cleanmarl_tpu_torch.envs import registry
    from cleanmarl_tpu_torch.envs.base import categorical

    def to_cuda(x):
        return x.cuda() if isinstance(x, torch.Tensor) else x

    def move(runner):
        skip = ("env_state", "stats", "generator", "ring", "buffer")
        return runner.replace(**{f.name: tree_map(to_cuda, getattr(runner, f.name))
                                 for f in dataclasses.fields(runner) if f.name not in skip})
    env = registry.make(_SL["env_type"], _SL["env_name"], agent_ids=True)
    for name in names:
        algo, kw = {**PATHS7, **PATHS8}[name]
        mod, cfg_c = _recipe(name, "cpu")
        init_c, _, _, meta_c = mod.make_train(cfg_c)
        _, _, _, meta_g = mod.make_train(_recipe(name, "cuda")[1])
        if kw.get("recurrent") and (meta_c["gru_impl"], meta_g["gru_impl"]) != ("scan", "kernel"):
            fail(f"{name}: GRU routes {meta_c['gru_impl']} (CPU) / {meta_g['gru_impl']} (card)")
        runner = init_c(torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(1)
        if algo in ("coma", "ippo"):
            eps = (cfg_c.start_e,) if algo == "coma" else ()
            upd = meta_c["update"] if algo == "coma" else meta_c["ppo_update"]
            upd_g = meta_g["update"] if algo == "coma" else meta_g["ppo_update"]

            def a_last(traj):
                if algo == "coma" and cfg_c.bootstrap_truncation:
                    avail = traj["final_avail"]
                    return (categorical(torch.where(avail, 0.0, float("-inf")), gen),)
                return ()
            runner, traj, h0 = meta_c["collect_rollout"](runner, *eps)
            runner, _ = upd(runner, traj, h0, *eps, *a_last(traj))
            runner, traj, h0 = meta_c["collect_rollout"](runner, *eps)
            if kw.get("recurrent") and not float(h0.abs().sum()) > 0:
                fail(f"{name}: the second rollout starts from a zero GRU carry")
            last = a_last(traj)
            out_c, m_c = upd(runner, traj, h0, *eps, *last)
            out_g, m_g = upd_g(move(runner), tree_map(to_cuda, traj), h0.cuda(), *eps,
                               *tree_map(to_cuda, last))
            pairs = [(m_g[k], m_c[k]) for k in sorted(m_c)]
            params = ("actor_params", "critic_params") + (
                ("target_critic",) if algo == "coma" else ())
            pairs += [(a, b) for p in params for a, b in zip(
                tree_leaves(getattr(out_g, p)), tree_leaves(getattr(out_c, p)))]
            loss = (float(m_g["train/critic_loss"]), float(m_c["train/critic_loss"]))
        elif algo == "vdn":
            for _ in range(25):
                runner, _ = meta_c["train_iter"](runner)
            args = (runner.buffer.sample(gen, cfg_c.batch_size * cfg_c.num_envs),)
            state = (runner.params, runner.target_params, runner.opt_state)
            p_c, _, loss_c, gn_c = meta_c["update"](*state, *args)
            p_g, _, loss_g, gn_g = meta_g["update"](*tree_map(to_cuda, state),
                                                    *tree_map(to_cuda, args))
            pairs = [(loss_g, loss_c), (gn_g, gn_c)] + list(zip(tree_leaves(p_g),
                                                                tree_leaves(p_c)))
            loss = (float(loss_g), float(loss_c))
        else:
            batch, mask = _sl_batch(env, cfg_c, 0)
            a_p, c_p, a_o, c_o, *_ = meta_c["update"](runner, batch, mask,
                                                      meta_c["draw_noise"](
                                                          gen, batch["action"].shape))
            runner = runner.replace(actor_params=a_p, critic_params=c_p, actor_opt=a_o,
                                    critic_opt=c_o)
            batch, mask = _sl_batch(env, cfg_c, 1)
            noise = meta_c["draw_noise"](gen, batch["action"].shape)
            out_c = meta_c["update"](runner, batch, mask, noise)
            out_g = meta_g["update"](move(runner), tree_map(to_cuda, batch), mask.cuda(),
                                     tree_map(to_cuda, noise))
            pairs = list(zip(out_g[4:], out_c[4:])) + list(zip(
                tree_leaves(out_g[:2]), tree_leaves(out_c[:2])))
            loss = (float(out_g[5]), float(out_c[5]))
        worst = max(float((a.cpu() - b).abs().max()) for a, b in pairs)
        if not all(torch.allclose(a.cpu(), b, **PPO_TOL) for a, b in pairs):
            fail(f"{name} update on the card disagrees with the CPU (max |diff| {worst})")
        log(f"[{tag}] one {name} update, card vs CPU: {'critic ' * (algo != 'vdn')}loss "
            f"{loss[0]:.6f} vs {loss[1]:.6f}; max |diff| over losses, norms and params "
            f"{worst:.3e}")


def drive_recipe(name, counters):
    """One phase-7 or phase-8 recipe at its widths on the card: warm-up
    blocks (incl. init) until updates run, driven blocks, one eval, finite
    metrics; the update clock (MADDPG, FACMAC: updates + debt = one per
    completed episode from the first commit, which fills the batch; COMA:
    one per rollout; IPPO: epochs x minibatches per rollout); every
    kernel's launches, counted from 0 before init to after eval, equal to
    its launches per update call (IPPO: per rollout) times the calls."""
    import torch
    from cleanmarl_tpu_torch.core.driver import to_host

    algo = {**PATHS7, **PATHS8}[name][0]
    onpolicy = algo in ("coma", "ippo")
    mod, cfg = _recipe(name, "cuda", DRIVE_LOG_INTERVAL.get(name, ONPOLICY_LOG_INTERVAL)
                       if onpolicy else None)
    init, train_block, eval_fn, meta = mod.make_train(cfg)
    n_driven = 2 if onpolicy else 3
    per_call = cfg.epochs * max(1, cfg.num_minibatches) if algo == "ippo" else 1
    for table in counters:
        for k in table:
            table[k] = 0
    runner = init(torch.Generator("cuda").manual_seed(cfg.seed))
    seen, n_warm = [], 0
    while runner.num_updates == 0:
        runner, metrics = train_block(runner)
        seen.append(to_host(metrics))
        n_warm += 1
        if n_warm > 3:
            fail(f"{name}: no update after {n_warm} warm-up blocks")
    updates = []
    for _ in range(n_driven):
        n0 = runner.num_updates
        runner, metrics = train_block(runner)
        seen.append(to_host(metrics))
        updates.append(runner.num_updates - n0)
    evals = to_host(eval_fn(runner.actor_params, torch.Generator("cuda").manual_seed(1)))
    torch.cuda.synchronize()
    launches = {k: v for table in counters for k, v in table.items()}
    for k, v in [kv for m in seen for kv in m.items()] + list(evals.items()):
        if not math.isfinite(v):
            fail(f"{name}: non-finite metric {k}={v}")
    calls = runner.num_updates // per_call
    per_update = dict(zip(KERNEL_KEYS, {**PATHS7_LAUNCHES, **PATHS8_LAUNCHES}[name]))
    for k, v in launches.items():
        if v != per_update.get(k, 0) * calls:
            fail(f"{name}: {k} launched {v} times in {calls} update calls, expected "
                 f"{per_update.get(k, 0)} per call")
    if onpolicy:
        rollouts = (n_warm + n_driven) * cfg.log_interval
        clock = rollouts * per_call
        ok = (runner.num_updates == clock
              and runner.step == rollouts * meta["rollout_len"] * cfg.num_envs)
    else:
        clock = offpolicy_clock("qmix", cfg, runner.step)
        ok = (runner.num_updates + runner.update_debt == clock
              and seen[-1]["train/update_debt"] == runner.update_debt)
    if not ok or seen[-1]["train/num_updates"] != runner.num_updates:
        fail(f"{name}: {runner.num_updates} updates after {runner.step} "
             f"{'env steps' if onpolicy else 'iterations'}, the clock says {clock}")
    log(f"[{name}] {cfg.env_type} {cfg.env_name}, {cfg.num_envs} envs, "
        f"{meta['steps_per_block']} env steps per train_block, GRU route "
        f"{meta.get('gru_impl')!r}; {n_warm} warm-up block(s) (incl. init), driven blocks "
        f"with {updates} updates")
    log(f"[{name}] kernel launches {launches} = {per_update} per update call x {calls} calls")
    log(f"[{name}] {runner.num_updates} updates (+ {getattr(runner, 'update_debt', 0)} debt) "
        f"after {runner.step} {'env steps' if onpolicy else 'iterations'} = the clock's "
        f"{clock}; last block {json.dumps(seen[-1], sort_keys=True)}")
    log(f"[{name}] eval {json.dumps(evals, sort_keys=True)}")
    return dict(updates_per_block=updates, warmup_blocks=n_warm, launches=launches,
                launches_per_update=per_update, update_calls=calls,
                num_updates=runner.num_updates, step=runner.step, clock=clock,
                metrics=seen[-1], eval=evals)


# ---------------------------------------------------------------------------
# phase 8: IPPO, pursuit and LBF, the host-env route, SMAClite collisions
# ---------------------------------------------------------------------------

# the JAX package's validated recipes (scripts/validate_baselines.py:60-71
# ippo_lbf, :155-166 ippo_rnn_lbf, :168-181 coma_rnn_lbf, :224-234
# vdn_pursuit, :237-248 ippo_pursuit, :442-455 coma_lbf), copied, not
# imported; random weights, seed 0
LBF_MAP = "Foraging-8x8-2p-3f-v3"
_IPPO_LBF = dict(env_type="lbf", env_name=LBF_MAP, num_envs=64, total_timesteps=2_000_000,
                 learning_rate_actor=5e-4, learning_rate_critic=5e-4, entropy_coef=0.01,
                 anneal_entropy=True, epochs=4, normalize_advantage=True, actor_hidden_dim=64,
                 critic_hidden_dim=64, log_interval=4, seed=0, verbose=False)
_COMA_LBF = dict(env_type="lbf", env_name=LBF_MAP, num_envs=64, total_timesteps=2_000_000,
                 per_agent_rewards=True, entropy_coef=0.003, exploration_fraction=3000.0,
                 learning_rate_actor=1e-4, learning_rate_critic=3e-4, anneal_lr=True,
                 actor_hidden_dim=64, critic_hidden_dim=128, log_interval=4, seed=0,
                 verbose=False)
PATHS8 = {
    "ippo_pursuit": ("ippo", dict(env_type="pursuit", num_envs=64, total_timesteps=2_000_000,
                                  rollout_len=100, epochs=4, entropy_coef=0.01,
                                  anneal_entropy=True, normalize_advantage=True,
                                  learning_rate_actor=5e-4, learning_rate_critic=5e-4,
                                  actor_hidden_dim=64, critic_hidden_dim=64, log_interval=2,
                                  seed=0, verbose=False)),
    "ippo_lbf": ("ippo", _IPPO_LBF),
    "ippo_rnn_lbf": ("ippo", dict(_IPPO_LBF, recurrent=True)),
    "coma_lbf": ("coma", dict(_COMA_LBF, bootstrap_truncation=True)),
    "coma_rnn_lbf": ("coma", dict(_COMA_LBF, recurrent=True, bootstrap_truncation=False)),
    "vdn_pursuit": ("vdn", dict(env_type="pursuit", num_envs=32, total_timesteps=2_000_000,
                                buffer_size=100_000, batch_size=4, learning_starts=10_000,
                                train_freq=1, exploration_fraction=0.1, hidden_dim=64,
                                log_interval=200, seed=0, verbose=False)),
}
# driven by drive_recipe; vdn_pursuit by drive_offpolicy; ippo_lbf and
# coma_lbf differ from the driven LBF recipes only by recurrence or the
# truncation bootstrap, and are held card vs CPU
PATHS8_DRIVEN = ("ippo_pursuit", "ippo_rnn_lbf", "coma_rnn_lbf")
# K1, K2, K3, dw per update call (IPPO: per rollout, 4 epochs x 1 minibatch)
PATHS8_LAUNCHES = {"ippo_pursuit": (1, 0, 0, 0), "ippo_rnn_lbf": (1, 4, 4, 4),
                   "coma_rnn_lbf": (1, 1, 1, 1)}
LBF_RNN_SHAPE = (150, 128, 64)     # an LBF rollout of 64 envs x 2 agents at H=64
IPPO_RNN_CLI = ["--env_type", "lbf", "--env_name", LBF_MAP, "--device", "cuda",
                "--num_envs", "64", "--recurrent", "true", "--actor_hidden_dim", "64",
                "--log_interval", "1", "--total_timesteps", "9600", "--eval_steps", "9600",
                "--seed", "0"]


def check_paths8_shapes(results):
    """K1 at IPPO's update shapes on pursuit (T=100, 64 envs x 8 pursuers)
    and LBF (T=150, 64 x 2), the team reward and flag broadcast over the
    agents, and at COMA's on LBF (per-agent rewards: only the flag is
    broadcast, so the kernel reads both materialised); K2, K3 and dw at
    the recurrent IPPO and COMA updates' shape on LBF (T=150, M=128, H=64)
    with per-env resets and a carried h0. Adds ``ippo_pursuit_shape``,
    ``ippo_lbf_shape`` and ``coma_lbf_shape`` to K1's row and
    ``lbf_rnn_shapes`` to each tensor-core GRU row."""
    import torch

    g = torch.Generator("cuda").manual_seed(12)
    lam_coma = PATHS8["coma_rnn_lbf"][1].get("td_lambda", 0.8)
    for key, (T, E, n), p_end, lam, per_agent, label in (
            ("ippo_pursuit_shape", (100, 64, 8), 0.002, 0.95, False, "IPPO's shape on pursuit"),
            ("ippo_lbf_shape", (150, 64, 2), 0.02, 0.95, False, "IPPO's shape on LBF"),
            ("coma_lbf_shape", (150, 64, 2), 0.02, lam_coma, True,
             "COMA's shape on LBF, per-agent rewards")):
        r = torch.randn((T, E, n) if per_agent else (T, E), generator=g, device="cuda")
        r = r if per_agent else r[..., None].expand(T, E, n)
        e = (torch.rand(T, E, generator=g, device="cuda") < p_end)[..., None].expand(T, E, n)
        v = torch.randn(T, E, n, generator=g, device="cuda")
        b = torch.randn(E, n, generator=g, device="cuda")
        time_k1_at(results, key, r, e, v, b, lam, (1, 1) if per_agent else (n, 1), label)

    T, M, H = LBF_RNN_SHAPE
    ended = torch.rand(T, M // 2, generator=g, device="cuda") < 0.02
    keep = (1.0 - ended.float())[..., None].expand(T, M // 2, 2).reshape(T, M).contiguous()
    errs, ins, hs, rec = check_gru_shape(T, M, H, seed=1281, keep=keep)
    add_shape_rows(results, "lbf_rnn_shapes", T, M, H, time_gru(T, M, H, ins, hs, rec))
    keep_max_err(results, errs)


def check_host_route(counters):
    """The host-env route on the card: a numpy host env written here, behind
    ``HostEnvFamily``: 12 steps of 8 envs whose live and pre-reset
    ``final`` views (obs, state, reward, done, battle_won, agent_rewards)
    equal the host envs' own arrays, as tensors on the card; then one IPPO
    block (K1 once per rollout) and one QMIX episode-ring block on it."""
    import numpy as np
    import torch
    from cleanmarl_tpu_torch.algos import ippo, qmix
    from cleanmarl_tpu_torch.core.driver import to_host
    from cleanmarl_tpu_torch.envs.external import HostEnvFamily

    class CountingHostEnv:
        """2 agents, 3 actions; episodes of 3 or 4 steps (by the reset
        seed's parity) that end by ``done``; obs and state carry the step
        and the seed; reward = half the sum of the actions, agent_rewards
        = half each action; battle_won on an episode's last step iff every
        agent played 1. Keeps what its last ``step`` returned."""
        n_agents, obs_dim, state_dim, n_actions, episode_limit = 2, 4, 6, 3, 5
        provides_agent_rewards = True

        def __init__(self):
            self.t, self.seed, self.last = 0, 0, None

        def close(self):
            pass

        def reset(self, seed=None):
            self.t, self.seed = 0, int(seed) % 1000
            return self.obs()

        def obs(self):
            return np.stack([np.array([self.t, self.seed / 1000, i, 1.0], np.float32)
                             for i in range(2)])

        def get_state(self):
            return np.array([self.t, self.seed / 1000, 0, 1, 2, 3], np.float32)

        def get_avail_actions(self):
            return np.ones((2, 3), bool)

        def step(self, actions):
            actions = np.asarray(actions)
            self.t += 1
            done = self.t >= 3 + self.seed % 2
            info = {"battle_won": float(done and (actions == 1).all()),
                    "agent_rewards": 0.5 * actions.astype(np.float32)}
            self.last = (self.obs(), self.get_state(), 0.5 * float(actions.sum()), done, info)
            return self.last[0], self.last[2], done, False, info

    fam = HostEnvFamily(CountingHostEnv, seed=0)
    vec = fam.make_vec(8)
    gen = torch.Generator("cuda").manual_seed(3)
    state, ts = vec.reset(gen)
    ends = 0
    for _ in range(12):
        state, ts, final = vec.step(state, vec.sample(gen, ts.avail), gen)
        views = [ts.obs, ts.state, ts.avail, ts.reward, final.obs, final.info["agent_rewards"]]
        if not all(x.is_cuda for x in views):
            fail("the host route returned tensors off the card")
        for i, env in enumerate(vec.envs):
            obs, st, reward, done, info = env.last
            pairs = {"final obs": (final.obs[i], obs), "final state": (final.state[i], st),
                     "final reward": (final.reward[i], reward), "reward": (ts.reward[i], reward),
                     "done": (final.done[i], done),
                     "battle_won": (final.info["battle_won"][i], info["battle_won"]),
                     "agent_rewards": (ts.info["agent_rewards"][i], info["agent_rewards"]),
                     "live obs": (ts.obs[i], env.obs()),
                     "live state": (ts.state[i], env.get_state())}
            for k, (got, want) in pairs.items():
                got_np = got.cpu().numpy()
                if not np.array_equal(got_np, np.asarray(want, dtype=got_np.dtype)):
                    fail(f"host route: env {i} {k} {got.cpu().numpy()} differs from the host "
                         f"env's {want}")
            ends += done
    if not ends:
        fail("host route: no episode ended in 12 steps")
    log(f"[host] 12 steps of 8 host envs: live and final obs, state, reward, done, battle_won "
        f"and agent_rewards equal the host envs' arrays ({ends} episode ends)")

    for table in counters:
        for k in table:
            table[k] = 0
    cfg = ippo.IPPOConfig(env_type="pz", num_envs=8, rollout_len=10, log_interval=2,
                          actor_hidden_dim=16, critic_hidden_dim=16, num_eval_ep=2, seed=0,
                          verbose=False)
    init, train_block, _, _ = ippo.make_train(cfg, env=fam)
    _, m_ippo = train_block(init(torch.Generator("cuda").manual_seed(0)))
    m_ippo = to_host(m_ippo)
    k1 = counters[0]["lambda_returns"]
    cfg = qmix.QMIXConfig(env_type="pz", num_envs=8, buffer_size=64, batch_size=4, hidden_dim=16,
                          hyper_dim=8, embed_dim=4, log_interval=25, num_eval_ep=2, seed=0,
                          start_e=1.0, end_e=1.0, verbose=False)
    init, train_block, eval_fn, _ = qmix.make_train(cfg, fam)
    runner, m_qmix = train_block(init(torch.Generator("cuda").manual_seed(0)))
    m_qmix = to_host(m_qmix)
    ev = to_host(eval_fn(runner.params, torch.Generator("cuda").manual_seed(1)))
    for k, v in list(m_ippo.items()) + list(m_qmix.items()) + list(ev.items()):
        if not math.isfinite(v):
            fail(f"host route: non-finite metric {k}={v}")
    if k1 != 2 or runner.num_updates == 0 or m_qmix["rollout/num_episodes"] < 40 \
            or not 3.0 <= ev["eval/ep_length"] <= 4.0:
        fail(f"host route: K1 launched {k1} times in 2 IPPO rollouts, QMIX ran "
             f"{runner.num_updates} updates over {m_qmix['rollout/num_episodes']} episodes, "
             f"eval episodes of {ev['eval/ep_length']} steps")
    log(f"[host] one IPPO block (2 rollouts, K1 {k1}x): actor loss "
        f"{m_ippo['train/actor_loss']:.4f}; one QMIX block: {runner.num_updates} updates over "
        f"{m_qmix['rollout/num_episodes']:.0f} episodes, loss {m_qmix['train/loss']:.4f}, "
        f"battle_won {m_qmix['rollout/battle_won']:.3f}; eval {json.dumps(ev, sort_keys=True)}")
    return dict(ippo=m_ippo, qmix=m_qmix, eval=ev, launches={"lambda_returns": k1},
                episode_ends=ends)


def check_collisions(counters):
    """SMAClite 3m with ``unit_collisions``: one step of 64 envs from spawns
    squeezed together on the card against the CPU env (positions, obs,
    state, reward within 1e-5; the push-out moved units), then one MAPPO
    block at the bench widths with the kernel counts read."""
    import dataclasses
    import torch
    from cleanmarl_tpu_torch.algos.mappo import make_train
    from cleanmarl_tpu_torch.algos.ppo_common import PPOConfig
    from cleanmarl_tpu_torch.core.driver import to_host
    from cleanmarl_tpu_torch.core.params import tree_map
    from cleanmarl_tpu_torch.envs import smaclite

    cpu = smaclite.make("3m", unit_collisions=True, device="cpu")
    card = smaclite.make("3m", unit_collisions=True)
    s, _ = cpu.reset(64, torch.Generator().manual_seed(0))
    s = dataclasses.replace(
        s, ally_pos=16.0 + 0.3 * (s.ally_pos - s.ally_pos.mean(1, keepdim=True)),
        enemy_pos=16.5 + 0.3 * (s.enemy_pos - s.enemy_pos.mean(1, keepdim=True)))
    actions = cpu.sample(torch.Generator().manual_seed(1), cpu._avail(s))
    s_c, ts_c = cpu.step(s, actions)
    s_g, ts_g = card.step(tree_map(lambda x: x.cuda(), s), actions.cuda())
    plain, _ = smaclite.make("3m", device="cpu").step(s, actions)
    pairs = [(s_g.ally_pos, s_c.ally_pos), (s_g.enemy_pos, s_c.enemy_pos), (ts_g.obs, ts_c.obs),
             (ts_g.state, ts_c.state), (ts_g.reward, ts_c.reward)]
    err = max_err([a.cpu() for a, _ in pairs], [b for _, b in pairs])
    moved = float((s_c.ally_pos - plain.ally_pos).abs().max())
    if err > 1e-5 or moved <= 0.0:
        fail(f"3m with collisions: card vs CPU max |diff| {err:.3e}, push-out moved units by "
             f"{moved:.3e}")

    for table in counters:
        for k in table:
            table[k] = 0
    cfg = PPOConfig(**BENCH, unit_collisions=True, device="cuda")
    init, train_block, _, meta = make_train(cfg)
    _, metrics = train_block(init(torch.Generator("cuda").manual_seed(0)))
    metrics = to_host(metrics)
    launches = {k: v for table in counters for k, v in table.items()}
    for k, v in metrics.items():
        if not math.isfinite(v):
            fail(f"3m with collisions: non-finite metric {k}={v}")
    if min(launches[k] for k in KERNEL_KEYS) <= 0:
        fail(f"3m with collisions: a kernel of the path did not launch: {launches}")
    log(f"[collisions] one step of 64 squeezed 3m envs, card vs CPU: max |diff| {err:.3e} "
        f"(the push-out moved allies up to {moved:.3f}); one MAPPO block at the bench widths "
        f"({meta['steps_per_block']} env steps), launches {launches}, "
        f"ep_reward {metrics.get('rollout/ep_reward', float('nan')):.4f}")
    return dict(max_abs_err=err, moved=moved, launches=launches, metrics=metrics)


# ---------------------------------------------------------------------------
# phase 9: checkpoint and resume, data-parallel MAPPO over 2 ranks, the CLIs
# ---------------------------------------------------------------------------

DP_WORLD = 2                 # ranks on the one card (gloo)
# a resumed runner must equal the one it was saved from, bit for bit; a
# tensor that differs is named and held to PPO_TOL (a non-deterministic op)
RESUME_TOL = PPO_TOL
# the 2-rank gradient against the single-process one, per leaf, relative to
# its largest entry (float32 sums over 24,576 rows in another order)
DP_GRAD_TOL = 1e-4
# 2-process CLIs: one rollout of 16 envs a block (2,400 env steps), a save
# every block; the resumed cluster runs two blocks more
DP_CLI = ["--recurrent", "true", "--env_type", "smaclite", "--env_name", "3m",
          "--device", "cuda", "--num_envs", "16", "--log_interval", "1",
          "--eval_steps", "1000000", "--seed", "0", "--verbose", "true"]
DP_CLI_STEPS = (4800, 9600)


def check_paths9_shapes(results):
    """K1, K2, K3 and dw at the shapes one rank of ``mappo_dp`` gives them:
    K1 over the rank's 4096 envs (T=60; reward, flag and value per env,
    broadcast over the 3 agents, as on the main path), the GRU kernels
    over the rank's rows of one minibatch (T=60, 512 envs x 3 agents =
    1536 rows, H=128) with per-env resets at the main path's rate (2% a
    step, as ``RETURNS_MAIN``) shared by the agents and a carried h0.
    Held against their plain versions at the usual tolerances and timed.
    Adds ``mappo_dp_shape`` to K1's row and ``mappo_dp_shapes`` to each
    tensor-core GRU row."""
    import torch

    E = BENCH["num_envs"] // DP_WORLD
    T, H, n = BENCH["rollout_len"], BENCH["actor_hidden_dim"], 3
    r, e, v, b = _returns_inputs(T, E, n, 0.02, True, True, seed=13)
    time_k1_at(results, "mappo_dp_shape", r, e, v, b, 0.95, (n, n),
               f"a rank's shape in mappo_dp ({E} envs)")
    mb_envs = E // BENCH["num_minibatches"]
    M = mb_envs * n
    g = torch.Generator("cuda").manual_seed(14)
    ended = torch.rand(T, mb_envs, generator=g, device="cuda") < 0.02
    keep = (1.0 - ended.float())[..., None].expand(T, mb_envs, n).reshape(T, M).contiguous()
    errs, ins, hs, rec = check_gru_shape(T, M, H, seed=M, keep=keep)
    add_shape_rows(results, "mappo_dp_shapes", T, M, H, time_gru(T, M, H, ins, hs, rec))
    keep_max_err(results, errs)


def _flat_state(runner):
    """(path, leaf) of the runner as a checkpoint writes it: CPU tensors,
    generator states, host numbers."""
    from cleanmarl_tpu_torch.core.checkpoint import to_state

    def walk(x, path):
        if isinstance(x, dict):
            return [y for k in sorted(x) for y in walk(x[k], f"{path}.{k}")]
        if isinstance(x, list):
            return [y for i, v in enumerate(x) for y in walk(v, f"{path}[{i}]")]
        return [(path, x)]
    return walk(to_state(runner), "runner")


def compare_runners(a, b, what):
    """Generator states and host numbers must be equal; tensors equal, else
    each that differs is listed and held to RESUME_TOL. → (bitwise, {path:
    max |diff|} of the tensors that differ)."""
    import torch

    fa, fb = _flat_state(a), _flat_state(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        fail(f"{what}: the runners' structures differ")
    differ = {}
    for (path, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or x.shape != y.shape:
                fail(f"{what}: {path} has another dtype or shape")
            if not torch.equal(x, y):
                if "generator" in path:
                    fail(f"{what}: generator state {path} differs")
                differ[path] = float((x.double() - y.double()).abs().max())
                if not torch.allclose(x.double(), y.double(), **RESUME_TOL):
                    fail(f"{what}: {path} differs by {differ[path]:.3e} (> {RESUME_TOL})")
        elif type(x) is not type(y) or x != y:
            fail(f"{what}: {path} is {x!r} against {y!r}")
    return not differ, differ


def check_resume(optimizer: str = "adam", tag: str = "resume"):
    """Recurrent MAPPO on 3m at the main path's widths with ``optimizer``:
    one block, a save, a restore into an init of another seed, then one
    more block from both."""
    import shutil
    import tempfile

    import torch
    from cleanmarl_tpu_torch.algos.mappo import make_train
    from cleanmarl_tpu_torch.algos.ppo_common import PPOConfig
    from cleanmarl_tpu_torch.core.checkpoint import Checkpointer
    from cleanmarl_tpu_torch.core.driver import to_host
    from cleanmarl_tpu_torch.distributed import DATA_FIELD_DIMS

    cfg = PPOConfig(**dict(BENCH, optimizer=optimizer), device="cuda")
    init, train_block, _, _ = make_train(cfg)
    runner, _ = train_block(init(torch.Generator("cuda").manual_seed(0)))
    work = tempfile.mkdtemp(dir=ROOT, prefix=".chip_smoke_")
    try:
        ckpt = Checkpointer(work, field_dims=DATA_FIELD_DIMS["PPO"], seed=cfg.seed)
        ckpt.save(runner.step, runner, wait=True)
        restored = ckpt.restore(init(torch.Generator("cuda").manual_seed(1)))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    same, differ = compare_runners(restored, runner, "restored runner")
    if not same:
        fail(f"the restored runner differs from the saved one: {differ}")
    a, ma = train_block(runner)
    b, mb = train_block(restored)
    ma, mb = to_host(ma), to_host(mb)
    bitwise, differ = compare_runners(b, a, "resumed block")
    if bitwise and ma != mb:
        fail(f"resumed block's metrics differ: {ma} vs {mb}")
    state = ("bitwise identical" if bitwise else
             f"within {RESUME_TOL}, not bitwise at {differ}")
    log(f"[{tag}] {optimizer}: checkpoint of {BENCH['num_envs']} envs at step {runner.step}; "
        f"resumed block ends at step {b.step} (uninterrupted {a.step}); params, optimizer "
        f"moments, env state, generators and counters {state}")
    return dict(step=runner.step, resumed_step=b.step, bitwise=bitwise, differ=differ)


def _rank_entry(rank, world, port, body, args, out):
    """One spawned rank: TF32 off, then the function of this module named
    ``body``; sends (rank, status, result) to the parent."""
    import traceback

    try:
        sys.path.insert(0, ROOT)
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out.put((rank, "ok", globals()[body](rank, world, port, *args)))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))
        raise


def _join_group(rank, world, port):
    """This spawned rank joins the ranks' group at ``localhost:port``."""
    import dataclasses

    from cleanmarl_tpu_torch.algos.qmix import QMIXConfig
    from cleanmarl_tpu_torch.distributed import multihost

    multihost.maybe_initialize(dataclasses.replace(
        QMIXConfig(device="cuda"), coordinator_address=f"localhost:{port}",
        num_processes=world, process_id=rank))


def spawn_ranks(body, *args, timeout=600):
    """The function of this module named ``body`` on DP_WORLD spawned ranks
    (each joins the group itself, ``_join_group``) → their results in rank
    order; fails if a rank raises, gives no result within ``timeout``
    seconds or exits non-zero."""
    import multiprocessing

    from cleanmarl_tpu_torch.distributed import multihost

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = multihost.free_port()
    procs = [ctx.Process(target=_rank_entry, args=(r, DP_WORLD, port, body, args, out))
             for r in range(DP_WORLD)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(DP_WORLD):
            rank, status, value = out.get(timeout=timeout)
            if status != "ok":
                fail(f"{body} on rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    if any(p.exitcode != 0 for p in procs):
        fail(f"a rank of {body} exited with {[p.exitcode for p in procs]}")
    return [results[r] for r in range(DP_WORLD)]


def _dp_rank_body(rank, world, port):
    """One rank of phase 9's data-parallel MAPPO (``spawn_ranks``)."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from cleanmarl_tpu_torch.algos.mappo import make_train
    from cleanmarl_tpu_torch.algos.ppo_common import PPOConfig
    from cleanmarl_tpu_torch.core.driver import to_host
    from cleanmarl_tpu_torch.core.params import tree_leaves
    from cleanmarl_tpu_torch.distributed import DATA_FIELD_DIMS, dp
    from cleanmarl_tpu_torch.ops import gru_kernel, returns_kernel

    cfg = PPOConfig(**BENCH, device="cuda")
    one_step = dataclasses.replace(cfg, epochs=1, num_minibatches=1)
    variants = {"one_step_scan": dataclasses.replace(one_step, gru_impl="scan"),
                "one_step_kernel": one_step, "bench_kernel": cfg}
    # the single-process updates on a fixed trajectory, before the group
    # exists (make_train steps all 8192 envs); every rank draws the same one
    full = {name: make_train(c)[3] for name, c in variants.items()}
    init_f = make_train(cfg)[0]
    r1, traj, h0 = full["bench_kernel"]["collect_rollout"](
        init_f(torch.Generator("cuda").manual_seed(0)))
    ref = {}
    if rank == 0:
        ref = {name: meta_f["ppo_update"](r1, traj, h0) for name, meta_f in full.items()}
    del full, init_f
    _join_group(rank, world, port)
    local = dp.shard_runner(r1, DATA_FIELD_DIMS["PPO"], rank, world)
    traj_l = {k: v[:, rank::world].contiguous() for k, v in traj.items()}
    h0_l = h0[rank::world].contiguous()
    res = dict(rank=rank, update={})

    def params(r):
        return tree_leaves(r.actor_params) + tree_leaves(r.critic_params)

    def grads(r):
        """The gradient of a single Adam step from zero moments: mu / (1 - b1)."""
        return [m / 0.1 for m in tree_leaves(r.actor_opt["mu"])
                + tree_leaves(r.critic_opt["mu"])]
    for name, c in variants.items():
        init, train_block, _, meta = make_train(c)
        out, m = meta["ppo_update"](local, traj_l, h0_l)
        res.update(local_envs=meta["local_envs"], device=str(params(out)[0].device))
        if rank == 0:
            want, m_ref = ref[name]
            got_p, want_p = params(out), params(want)
            errs = [float((a - b).abs().max()) for a, b in zip(got_p, want_p)]
            res["update"][name] = dict(
                params_err=max(errs), params_err_leaf=errs.index(max(errs)),
                params_outside=sum(int((~torch.isclose(a, b, **PPO_TOL)).sum())
                                   for a, b in zip(got_p, want_p)),
                params_total=sum(a.numel() for a in got_p),
                grads_rel_err=max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                                  for a, b in zip(grads(out), grads(want))),
                metrics_err=max(abs(float(m[k]) - float(m_ref[k])) for k in m_ref),
                metrics_close=all(torch.allclose(m[k], m_ref[k], **PPO_TOL) for k in m_ref))
    del ref, r1, traj, h0, traj_l, h0_l, local, out
    # the driven blocks below take the kernel route (the last make_train)

    def identical(runner):
        """Every rank's params bitwise equal to rank 0's (one broadcast)."""
        flat = torch.cat([x.reshape(-1) for x in
                          tree_leaves(runner.actor_params) + tree_leaves(runner.critic_params)])
        ref0 = flat.clone()
        dist.broadcast(ref0, src=0)
        bad = torch.tensor([0.0 if torch.equal(flat, ref0) else 1.0], device=flat.device)
        dist.all_reduce(bad)
        return float(bad) == 0.0

    runner = dp.global_runner_init(init, torch.Generator("cuda").manual_seed(
        dp.rank_seed(cfg.seed, rank)), DATA_FIELD_DIMS["PPO"])
    counters = (returns_kernel.LAUNCHES, gru_kernel.LAUNCHES)
    for table in counters:
        for k in table:
            table[k] = 0
    for block in range(3):
        if block == 2:
            dp.COMM.reset()
        runner, metrics = train_block(runner)
        metrics = to_host(metrics)
        if block == 0:
            res["launches"] = {k: v for table in counters for k, v in table.items()}
    res.update(metrics=metrics, step=runner.step, params_identical=identical(runner),
               comm_calls=dp.COMM.calls, comm_bytes=dp.COMM.bytes,
               finite=all(math.isfinite(v) for v in metrics.values()))
    return res


def check_data_parallel():
    """Two ranks of MAPPO on the one card (gloo), 8192 envs in all: one
    update on a fixed trajectory split by the interleave against the
    single-process update. Held: one Adam step over all envs (epochs = 1,
    one minibatch) on the scan and the kernel route, params and metrics to
    PPO_TOL and the gradient (Adam's first moment over 1 - b1) to
    DP_GRAD_TOL of each leaf's largest; the main path's own update (8
    epochs x 8 minibatches) has its metrics held and its params' difference
    reported, since over 64 Adam steps an element whose gradient is near
    Adam's eps (1e-8) moves by the sign of its float32 summation noise,
    which the split changes. Then three driven blocks per rank (the first
    counts the kernels' launches, the third the collectives)."""
    results = dict(enumerate(spawn_ranks("_dp_rank_body", timeout=600)))
    r0 = results[0]
    for name in ("one_step_scan", "one_step_kernel"):
        u = r0["update"][name]
        if u["params_outside"] or not u["metrics_close"] or u["grads_rel_err"] > DP_GRAD_TOL:
            fail(f"the 2-rank update ({name}) disagrees with the single-process one: {u}")
    bench = r0["update"]["bench_kernel"]
    if not bench["metrics_close"]:
        fail(f"the 2-rank update's metrics (bench_kernel) disagree with the single-process "
             f"one: {bench}")
    for r in results.values():
        if not r["params_identical"]:
            fail(f"params differ across ranks after the driven blocks (rank {r['rank']})")
        if not r["finite"]:
            fail(f"non-finite metrics on rank {r['rank']}: {r['metrics']}")
        for k in KERNEL_KEYS:
            if r["launches"].get(k, 0) <= 0:
                fail(f"kernel {k} was not launched on rank {r['rank']}: {r['launches']}")
    log(f"[dp] {DP_WORLD} ranks on one card (gloo), {r0['local_envs']} envs each, one update "
        f"on a fixed trajectory against the single-process one (params and metrics max "
        f"|diff|, gradients relative to each leaf's largest):")
    for name, u in r0["update"].items():
        held = ("held to PPO_TOL, gradients to DP_GRAD_TOL" if name.startswith("one_step")
                else "metrics held, params reported")
        log(f"[dp]   {name}: params {u['params_err']:.3e} ({u['params_outside']} of "
            f"{u['params_total']} outside PPO_TOL), gradients {u['grads_rel_err']:.3e}, "
            f"metrics {u['metrics_err']:.3e}; {held}")
    log(f"[dp] params bitwise identical across ranks after 3 driven blocks (kernel route); "
        f"{r0['comm_calls']} collectives, {r0['comm_bytes']} bytes in block 3")
    for rank in sorted(results):
        r = results[rank]
        log(f"[dp] rank {rank} on {r['device']}: launches in block 1 {r['launches']}")
    return dict(ranks=results, launches=r0["launches"])


def run_procs(cmds, timeout=600, module="mappo"):
    """Start every CLI command of ``module`` (an algorithm) at once from the
    repo root → their outputs; fails if any exits non-zero."""
    procs = [subprocess.Popen([sys.executable, "-m", f"cleanmarl_tpu_torch.algos.{module}"] + c,
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            fail(f"CLI exited {p.returncode}:\n{o[-3000:]}")
    return outs


def check_dp_cli():
    """A 2-process MAPPO CLI cluster that saves, a resumed cluster that ends
    at its total, and (beside the first) a ``--profile_dir`` run."""
    import shutil
    import tempfile

    from cleanmarl_tpu_torch.distributed import multihost

    work = tempfile.mkdtemp(dir=ROOT, prefix=".chip_smoke_")
    ckpt, prof = os.path.join(work, "ckpt"), os.path.join(work, "prof")

    def cluster(total, resume):
        port = multihost.free_port()
        return [DP_CLI + ["--total_timesteps", str(total), "--checkpoint_dir", ckpt,
                          "--checkpoint_every", "2400", "--resume", str(resume).lower(),
                          "--coordinator_address", f"localhost:{port}",
                          "--num_processes", str(DP_WORLD), "--process_id", str(i)]
                for i in range(DP_WORLD)]
    try:
        outs = run_procs(cluster(DP_CLI_STEPS[0], False) + [
            DP_CLI + ["--total_timesteps", "7200", "--profile_dir", prof]])
        if "[dist] 2 ranks, backend gloo" not in outs[0] or "[MAPPO]" in outs[1]:
            fail(f"2-process CLI: rank 0 must print alone:\n{outs[0][-1500:]}\n{outs[1][-1500:]}")
        saved = sorted(int(d) for d in os.listdir(ckpt) if d.isdigit())
        if saved[-1:] != [DP_CLI_STEPS[0]]:
            fail(f"2-process CLI saved steps {saved}")
        traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
        if not traces or "[MAPPO] phases:" not in outs[2]:
            fail(f"--profile_dir left no trace or printed no phases:\n{outs[2][-2000:]}")
        outs2 = run_procs(cluster(DP_CLI_STEPS[1], True))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    want = f"[MAPPO] resumed from step {DP_CLI_STEPS[0]}"
    if want not in outs2[0] or "resumed" in outs2[1]:
        fail(f"resumed cluster: {want!r} must print on rank 0 only:\n{outs2[0][-1500:]}")
    steps = [int(x) for x in re.findall(r"\[MAPPO\] step=(\d+)", outs2[0])]
    if not steps or steps[0] <= DP_CLI_STEPS[0] or steps[-1] != DP_CLI_STEPS[1]:
        fail(f"resumed cluster's steps {steps}, expected ({DP_CLI_STEPS[0]}, "
             f"{DP_CLI_STEPS[1]}]")
    dist_line = next(x for x in outs[0].splitlines() if x.startswith("[dist]"))
    for line in [dist_line, want] + outs2[0].strip().splitlines()[-2:]:
        log(f"[dp-cli] {line}")
    log(f"[dp-cli] saved {saved}; resumed cluster steps {steps}; profile trace "
        f"{len(traces)} file(s)")
    return dict(saved=saved, resumed_steps=steps, trace_files=len(traces))


# ---------------------------------------------------------------------------
# phase 10: data-parallel QMIX, VDN, recurrent Q, MADDPG and FACMAC over 2
# ranks on the one card (gloo; rings sharded by capacity)
# ---------------------------------------------------------------------------

# (a) injected steps of 64 envs into each ring kind, at a capacity the 2
# ranks divide and one they do not; records of 3m's obs, action and avail
# widths; T_max cut to 20 (the commit does not depend on it)
P10_COMMITS = {"episode_100": ("episode", 100, 20), "episode_101": ("episode", 101, 20),
               "sequence_256": ("sequence", 256, 10), "sequence_257": ("sequence", 257, 10),
               "transition_1000": ("transition", 1000, None),
               "transition_1001": ("transition", 1001, None)}
P10_ENVS, P10_COMMIT_STEPS = 64, 60
# (b) phase 9's one-step check: params (max |diff|), gradients (Adam's first
# moment over 1 - b1, relative to each leaf's largest), metrics (loss and
# gradient norms, relative to each one's magnitude where it is above 1: a
# norm near 100 has float32 steps of 8e-6)
P10_PARAM_TOL, P10_GRAD_TOL, P10_METRIC_TOL = 5e-5, 1e-5, 1e-5
# (c) qmix_rnn_3m at its recipe's width: driven blocks
P10_BLOCKS = 3
# (d) scripts/validate_baselines.py:286-298 facmac_3m, copied; the other
# recipes are phases 5-7's. Each runs blocks until an update has run, then
# one more; run length only is cut (vdn_spread: 100 iterations a block)
FACMAC_3M = dict(env_type="smaclite", env_name="3m", num_envs=64, total_timesteps=2_000_000,
                 buffer_size=5_000, batch_size=64, train_freq=1, learning_rate_actor=5e-4,
                 learning_rate_critic=5e-4, actor_hidden_dim=64, critic_hidden_dim=64,
                 hyper_dim=64, polyak=0.005, exploration_fraction=750.0,
                 max_updates_per_iter=8, log_interval=50, seed=0, verbose=False)
P10_OTHERS = ("qmix_spread", "vdn_spread", "vdn_rnn_seq_3m", "maddpg_rnn_sl", "facmac_3m")
P10_LOG_INTERVAL = {"vdn_spread": 100}
# (e) the 2-process QMIX CLI (qmix_spread's widths): one block of 40
# iterations x 32 envs saved, then a resumed cluster of one more block
P10_CLI = ["--env_type", "mpe", "--env_name", "simple_spread_v3", "--device", "cuda",
           "--num_envs", "32", "--buffer_size", "5000", "--batch_size", "32",
           "--exploration_fraction", "0.1", "--hidden_dim", "64", "--log_interval", "40",
           "--eval_steps", "1000000", "--seed", "0", "--verbose", "true"]
P10_CLI_STEPS = (1280, 2560)
P10_RESUME_BUFFER = 500     # qmix_rnn_3m's resume check: the ring cut from 5000 episodes


def check_paths10_shapes(results):
    """K2, K3 and dw at the shapes a rank's update gives them in phase 10:
    ``qmix_rnn_3m`` (T=150, 16 episodes x 3 agents = 48 rows, H=64, no
    resets: episodes start at t=0) and ``maddpg_rnn_sl`` (T=25, 16 x 2 =
    32 rows). Held against their plain versions and timed; adds
    ``paths10_shapes`` to each tensor-core GRU row."""
    import torch

    for T, M, H in ((150, 48, 64), (25, 32, 64)):
        keep = torch.ones(T, M, device="cuda")
        errs, ins, hs, rec = check_gru_shape(T, M, H, seed=M + T, keep=keep)
        add_shape_rows(results, "paths10_shapes", T, M, H, time_gru(T, M, H, ins, hs, rec))
        keep_max_err(results, errs)


def _p10_recipe(name, device, buffer_size=None):
    """(module, config, runner fields table) of a phase-10 recipe."""
    import dataclasses

    from cleanmarl_tpu_torch.algos import facmac, maddpg, qmix, recurrent_q, vdn
    from cleanmarl_tpu_torch.distributed import DATA_FIELD_DIMS

    if name in RECQ:
        mod, cfg = recurrent_q, recurrent_q.RecurrentQConfig(**RECQ[name], device=device)
        table = "RECURRENT_Q"
    elif name == "facmac_3m":
        mod, cfg, table = facmac, facmac.FACMACConfig(**FACMAC_3M, device=device), "FACMAC"
    elif name == "maddpg_rnn_sl":
        mod, cfg, table = maddpg, _recipe(name, device)[1], "MADDPG"
    elif name == "qmix_spread":
        mod, cfg, table = qmix, qmix.QMIXConfig(**OFFPOLICY["qmix"], device=device), "QMIX"
    else:
        mod, cfg, table = vdn, vdn.VDNConfig(**OFFPOLICY["vdn"], device=device), "VDN"
    if name in P10_LOG_INTERVAL:
        cfg = dataclasses.replace(cfg, log_interval=P10_LOG_INTERVAL[name])
    if buffer_size:
        cfg = dataclasses.replace(cfg, buffer_size=buffer_size)
    return mod, cfg, DATA_FIELD_DIMS[table]


def _p10_steps(seed):
    """P10_COMMIT_STEPS injected (record, ended) steps of P10_ENVS envs."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(P10_COMMIT_STEPS):
        avail = rng.rand(P10_ENVS, 3, RQ_ACTIONS) < 0.7
        out.append(({"obs": rng.randn(P10_ENVS, 3, RQ_OBS).astype(np.float32),
                     "action": rng.randint(0, RQ_ACTIONS, (P10_ENVS, 3)),
                     "reward": rng.randn(P10_ENVS).astype(np.float32),
                     "avail": avail}, rng.rand(P10_ENVS) < 0.08))
    return out


def _p10_feed(kind, cap, length, steps, rank, world):
    """``steps`` into a ring of ``kind`` on the card (this rank's envs ``rank
    :: world``) → (its rows and lengths as numpy, the host counters after
    each step, this rank's rows of a sample of 32 from a seeded
    generator)."""
    import numpy as np
    import torch
    from cleanmarl_tpu_torch.buffers.episode import EpisodeAccumulator, EpisodeBuffer
    from cleanmarl_tpu_torch.buffers.sequence import SequenceAccumulator, SequenceBuffer
    from cleanmarl_tpu_torch.buffers.transition import TransitionBuffer
    from cleanmarl_tpu_torch.core.params import tree_map

    def cuda(x):
        return torch.as_tensor(np.ascontiguousarray(x[rank::world])).to("cuda")
    example = {k: torch.zeros(v.shape[1:], dtype=torch.as_tensor(v).dtype, device="cuda")
               for k, v in steps[0][0].items()}
    n = P10_ENVS // world
    acc = None
    if kind == "episode":
        ring = EpisodeBuffer.create(cap, length, example, rank, world)
        acc = EpisodeAccumulator.create(n, length, example)
    elif kind == "sequence":
        ring = SequenceBuffer.create(cap, length, example, rank, world)
        acc = SequenceAccumulator.create(n, length, example)
    else:
        ring = TransitionBuffer.create(cap, example, rank, world)
    counters = []
    for rec, ended in steps:
        rec = {k: cuda(v) for k, v in rec.items()}
        if acc is None:
            ring.add_batch(rec)
            counts = None
        else:
            counts = acc.add_step(ring, rec, cuda(ended))
        counters.append((ring.cursor, ring.size, counts))
    torch.cuda.synchronize()
    sample = ring.sample(torch.Generator("cuda").manual_seed(3), 32)
    numpy = lambda t: tree_map(lambda x: x.cpu().numpy(), t)  # noqa: E731
    return dict(data=numpy(ring.data), length=numpy(getattr(ring, "length", {})),
                counters=counters, sample=numpy(sample))


def _p10_updates(world):
    """One ``qmix_rnn_3m`` and one ``maddpg_rnn_sl`` update at this rank's
    rows ``rank::world`` of a fixed batch (random records of the recipes'
    widths, seeded; MADDPG's Gumbel noise drawn at the full batch shape
    from a seeded generator), from the recipes' init params and fresh Adam
    states (the ring cut to 64 rows: init draws nothing for it) → {name:
    (params, gradients (Adam's first moment / 0.1), metrics)}."""
    import torch
    from cleanmarl_tpu_torch.core.params import tree_leaves, tree_map
    from cleanmarl_tpu_torch.distributed import dp
    from cleanmarl_tpu_torch.envs import registry

    rank = dp.rank_world()[0]

    def mine(x):
        return x[rank::world].contiguous().to("cuda") if isinstance(x, torch.Tensor) else x
    out = {}
    mod, cfg, _ = _p10_recipe("qmix_rnn_3m", "cuda", buffer_size=64)
    init, _, _, meta = mod.make_train(cfg)
    runner = init(torch.Generator("cuda").manual_seed(0))
    batch, mask = _recq_batch(cfg, registry.make("smaclite", "3m", agent_ids=True,
                                                device="cuda"), 0)
    p, o, loss, gnorm = meta["update"](runner.params, runner.target_params, runner.opt_state,
                                       tree_map(mine, batch), mine(mask))
    out["qmix_rnn_3m"] = ([x.cpu().numpy() for x in tree_leaves(p)],
                          [m.cpu().numpy() / 0.1 for m in tree_leaves(o["mu"])],
                          [float(loss), float(gnorm)])
    del runner
    mod, cfg, _ = _p10_recipe("maddpg_rnn_sl", "cuda", buffer_size=64)
    init, _, _, meta = mod.make_train(cfg)
    runner = init(torch.Generator("cuda").manual_seed(0))
    env = registry.make(_SL["env_type"], _SL["env_name"], agent_ids=True, device="cuda")
    batch, mask = _sl_batch(env, cfg, 0)
    noise = meta["draw_noise"](torch.Generator("cuda").manual_seed(1), batch["action"].shape)
    a_p, c_p, a_o, c_o, *metrics = meta["update"](runner, tree_map(mine, batch), mine(mask),
                                                  tuple(mine(x) for x in noise))
    out["maddpg_rnn_sl"] = ([x.cpu().numpy() for x in tree_leaves(a_p) + tree_leaves(c_p)],
                            [m.cpu().numpy() / 0.1 for m in tree_leaves(a_o["mu"])
                             + tree_leaves(c_o["mu"])],
                            [float(m) for m in metrics])
    return out


def _p10_identical(tree):
    """Every rank's leaves of ``tree`` bitwise equal to rank 0's (one
    broadcast, one all-reduce)."""
    import torch
    import torch.distributed as dist
    from cleanmarl_tpu_torch.core.params import tree_leaves

    flat = torch.cat([x.reshape(-1).float() for x in tree_leaves(tree)])
    ref0 = flat.clone()
    dist.broadcast(ref0, src=0)
    bad = torch.tensor([0.0 if torch.equal(flat, ref0) else 1.0], device=flat.device)
    dist.all_reduce(bad)
    return float(bad) == 0.0


def _p10_params(runner):
    return {k: getattr(runner, k) for k in ("params", "actor_params", "critic_params")
            if hasattr(runner, k)}


def _p10_drive(name, counters, blocks):
    """``name`` on this rank of the group at its recipe's width: init
    (``global_runner_init``), warm-up iterations until the ring holds a
    batch and an update has run, then ``blocks`` blocks (kernel counts and
    ``dp.COMM`` set to 0 before them). → what this rank saw."""
    import torch
    from cleanmarl_tpu_torch.core.driver import to_host
    from cleanmarl_tpu_torch.core.params import tree_leaves
    from cleanmarl_tpu_torch.distributed import dp

    mod, cfg, table = _p10_recipe(name, "cuda")
    rank = dp.rank_world()[0]
    init, train_block, _, meta = mod.make_train(cfg)
    runner = dp.global_runner_init(init, torch.Generator("cuda").manual_seed(
        dp.rank_seed(cfg.seed, rank)), table)
    ring = getattr(runner, "ring", None) or runner.buffer
    warm = 0
    while runner.num_updates == 0:
        out = meta["train_iter"](runner)      # MADDPG's returns the runner alone
        runner = out[0] if isinstance(out, tuple) else out
        warm += 1
        if warm > 20 * cfg.log_interval:
            fail(f"{name}: no update after {warm} warm-up iterations on rank {rank}")
    runner = runner.replace(stats=runner.stats.flush())
    for table_ in counters:
        for k in table_:
            table_[k] = 0
    dp.COMM.reset()
    updates, seen = [], []
    for _ in range(blocks):
        n0 = runner.num_updates
        runner, metrics = train_block(runner)
        seen.append(to_host(metrics))
        updates.append(runner.num_updates - n0)
    torch.cuda.synchronize()
    launches = {k: v for t in counters for k, v in t.items()}
    calls, sent = dp.COMM.calls, dp.COMM.bytes
    dp.COMM.reset()
    return dict(
        name=name, rank=rank, local_envs=meta["local_envs"], warmup_iters=warm,
        updates=updates, metrics=seen,
        finite=all(math.isfinite(v) for m in seen for v in m.values()),
        step=runner.step, episodes=getattr(runner, "episodes", None),
        num_updates=runner.num_updates, cursor=ring.cursor, size=ring.size,
        capacity=ring.capacity, rows=tree_leaves(ring.data)[0].shape[0], launches=launches,
        comm_calls=calls, comm_bytes=sent, identical=_p10_identical(_p10_params(runner)))


def _p10_rank_body(rank, world, port):
    """One rank of phase 10 (``spawn_ranks``)."""
    from cleanmarl_tpu_torch.ops import gru_kernel, returns_kernel

    cases = {name: (kind, cap, length, _p10_steps(i))
             for i, (name, (kind, cap, length)) in enumerate(sorted(P10_COMMITS.items()))}
    res = dict(rank=rank)
    if rank == 0:        # the single-process references, before the group exists
        res["commit_ref"] = {n: _p10_feed(*c, 0, 1) for n, c in cases.items()}
        res["update_ref"] = _p10_updates(1)
    _join_group(rank, world, port)
    res["commit"] = {n: _p10_feed(*c, rank, world) for n, c in cases.items()}
    res["update"] = _p10_updates(world)
    counters = (returns_kernel.LAUNCHES, gru_kernel.LAUNCHES)
    res["drive"] = {"qmix_rnn_3m": _p10_drive("qmix_rnn_3m", counters, P10_BLOCKS)}
    for name in P10_OTHERS:
        res["drive"][name] = _p10_drive(name, counters, 1)
    return res


def _p10_union(ranks, key, cap):
    """Global rows ``0..cap-1`` of a ring from the ranks' local rows (row
    ``i`` on rank ``i % world`` at ``i // world``)."""
    import numpy as np
    from cleanmarl_tpu_torch.core.params import tree_map

    world = len(ranks)
    return tree_map(lambda *xs: np.stack([xs[i % world][i // world] for i in range(cap)]),
                    *[r[key] for r in ranks])


def check_offpolicy_dp():
    """Phase 10 (a)-(d) over two gloo ranks on the card; see the module
    docstring."""
    import numpy as np
    from cleanmarl_tpu_torch.core.params import tree_leaves
    from cleanmarl_tpu_torch.distributed import dp

    ranks = spawn_ranks("_p10_rank_body", timeout=900)
    r0 = ranks[0]

    # (a) the commit: the union of the ranks' rows equals the single-process
    # ring (scratch row aside), the counters after every step too, and each
    # rank's rows of a sample are the single-process sample's
    for name, (kind, cap, _) in sorted(P10_COMMITS.items()):
        ref = r0["commit_ref"][name]
        got = [r["commit"][name] for r in ranks]
        rows = [dp.owned_rows(cap, r, DP_WORLD) + (kind != "transition")
                for r in range(DP_WORLD)]
        if [tree_leaves(g["data"])[0].shape[0] for g in got] != rows:
            fail(f"[p10 commit] {name}: ranks hold {[len(tree_leaves(g['data'])[0]) for g in got]} "
                 f"rows, expected {rows}")
        pairs = list(zip(tree_leaves(_p10_union(got, "data", cap)),
                         [x[:cap] for x in tree_leaves(ref["data"])]))
        if kind == "episode":
            pairs.append((_p10_union([{"l": g["length"]} for g in got], "l", cap),
                          ref["length"][:cap]))
        if not all(np.array_equal(a, b) for a, b in pairs):
            fail(f"[p10 commit] {name}: the 2-rank ring differs from the single-process one")
        if any(g["counters"] != ref["counters"] for g in got):
            fail(f"[p10 commit] {name}: host counters differ from the single process")
        for r, g in enumerate(got):
            for a, b in zip(tree_leaves(g["sample"]), tree_leaves(ref["sample"])):
                if not np.array_equal(a, b[r::DP_WORLD]):
                    fail(f"[p10 commit] {name}: rank {r}'s sample rows differ")
        last = ref["counters"][-1]
        log(f"[p10 commit] {name}: {P10_COMMIT_STEPS} steps of {P10_ENVS} envs, cursor "
            f"{last[0]} size {last[1]} (capacity {cap}); union of the ranks' rows "
            f"{rows} equals the single-process ring bitwise (scratch row aside), counters "
            f"every step and each rank's sample rows too")

    # (b) one update split over the ranks against the single process
    upd = {}
    for name, (p_ref, g_ref, m_ref) in r0["update_ref"].items():
        p_got, g_got, m_got = r0["update"][name]
        params_err = max(float(np.abs(a - b).max()) for a, b in zip(p_got, p_ref))
        grads_err = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                        for a, b in zip(g_got, g_ref))
        metrics_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(m_got, m_ref))
        same = all(np.array_equal(a, b) for a, b in zip(ranks[1]["update"][name][0], p_got))
        upd[name] = dict(params_err=params_err, grads_rel_err=grads_err,
                         metrics_err=metrics_err, ranks_identical=same)
        log(f"[p10 update] {name}: {DP_WORLD} ranks vs 1 on the same batch: params {params_err:.3e} "
            f"(tol {P10_PARAM_TOL}), gradients {grads_err:.3e} of each leaf's largest (tol "
            f"{P10_GRAD_TOL}), metrics {metrics_err:.3e} (tol {P10_METRIC_TOL}; "
            f"{[round(m, 6) for m in m_got]} against {[round(m, 6) for m in m_ref]}); params "
            f"{'bitwise identical' if same else 'DIFFERENT'} across the ranks")
        if (params_err > P10_PARAM_TOL or grads_err > P10_GRAD_TOL
                or metrics_err > P10_METRIC_TOL or not same):
            fail(f"[p10 update] {name}: the 2-rank update disagrees with the single process")

    # (c), (d) the driven paths
    drive = {}
    for name in r0["drive"]:
        d = [r["drive"][name] for r in ranks]
        for r in d:
            if not (r["identical"] and r["finite"]):
                fail(f"[p10 {name}] rank {r['rank']}: params identical {r['identical']}, "
                     f"finite metrics {r['finite']}")
            for k in ("step", "episodes", "num_updates", "cursor", "size", "updates"):
                if r[k] != d[0][k]:
                    fail(f"[p10 {name}] {k} differs across the ranks: {[x[k] for x in d]}")
            if r["metrics"] != d[0]["metrics"]:
                fail(f"[p10 {name}] the block metrics differ across the ranks")
        if sum(d[0]["updates"]) == 0:
            fail(f"[p10 {name}] the blocks ran no update")
        per_update = {k: [r["launches"][k] / max(sum(d[0]["updates"]), 1) for r in d]
                      for k in ("gru_seq_fwd", "gru_seq_bwd", "gru_seq_dw")}
        recurrent = name in ("qmix_rnn_3m", "vdn_rnn_seq_3m", "maddpg_rnn_sl")
        for r in d:
            for k in ("gru_seq_fwd", "gru_seq_bwd", "gru_seq_dw"):
                if recurrent and r["launches"][k] <= 0:
                    fail(f"[p10 {name}] {k} was not launched on rank {r['rank']}")
            for k in ("gru_seq_fwd_l2", "gru_seq_bwd_l2", "lambda_returns") + (
                    () if recurrent else ("gru_seq_fwd", "gru_seq_bwd", "gru_seq_dw")):
                if r["launches"][k]:
                    fail(f"[p10 {name}] {k} launched {r['launches'][k]} times on rank "
                         f"{r['rank']}, a path that must not take it")
        drive[name] = dict(ranks=d, launches_per_update=per_update, launches=d[0]["launches"])
        log(f"[p10 {name}] {DP_WORLD} ranks x {d[0]['local_envs']} envs; warm-up "
            f"{d[0]['warmup_iters']} iterations; {len(d[0]['updates'])} block(s) with "
            f"{d[0]['updates']} updates; step {d[0]['step']}, episodes {d[0]['episodes']}, "
            f"cursor {d[0]['cursor']}, size {d[0]['size']} on every rank; params bitwise "
            f"identical")
        log(f"[p10 {name}] rows {[r['rows'] for r in d]} of {d[0]['capacity']} by rank; "
            f"collectives {d[0]['comm_calls']} ({d[0]['comm_bytes']} bytes); launches per "
            f"update by rank {per_update}")
    return dict(commit=sorted(P10_COMMITS), update=upd, drive=drive)


def check_offpolicy_resume():
    """``qmix_rnn_3m`` in one process (the ring cut to P10_RESUME_BUFFER
    episodes): blocks until updates run, a save, a restore into another
    seed's init, one more block from both; the runners compared with the
    ring's scratch row cleared (the rows of envs whose episode did not end
    all write it, and which write lands is not specified on the card)."""
    import shutil
    import tempfile

    import torch
    from cleanmarl_tpu_torch.core.checkpoint import Checkpointer
    from cleanmarl_tpu_torch.core.driver import to_host
    from cleanmarl_tpu_torch.core.params import tree_leaves

    def clear_scratch(runner):
        for x in tree_leaves(runner.ring.data) + [runner.ring.length]:
            x[-1] = 0
        return runner
    mod, cfg, table = _p10_recipe("qmix_rnn_3m", "cuda", buffer_size=P10_RESUME_BUFFER)
    init, train_block, _, _ = mod.make_train(cfg)
    runner = init(torch.Generator("cuda").manual_seed(0))
    while runner.num_updates == 0:
        runner, _ = train_block(runner)
    work = tempfile.mkdtemp(dir=ROOT, prefix=".chip_smoke_")
    try:
        ckpt = Checkpointer(work, field_dims=table, seed=cfg.seed)
        ckpt.save(runner.step, runner, wait=True)
        restored = ckpt.restore(init(torch.Generator("cuda").manual_seed(1)))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    same, differ = compare_runners(restored, runner, "restored off-policy runner")
    if not same:
        fail(f"the restored off-policy runner differs from the saved one: {differ}")
    a, ma = train_block(runner)
    b, mb = train_block(restored)
    ma, mb = to_host(ma), to_host(mb)
    bitwise, differ = compare_runners(clear_scratch(b), clear_scratch(a), "resumed block")
    if bitwise and ma != mb:
        fail(f"resumed off-policy block's metrics differ: {ma} vs {mb}")
    state = ("bitwise identical" if bitwise else
             f"within {RESUME_TOL}, not bitwise at {differ}")
    log(f"[p10 resume] qmix_rnn_3m ({cfg.num_envs} envs, ring of {cfg.buffer_size} episodes) "
        f"at step {runner.step}: resumed block ({b.num_updates - runner.num_updates} updates) "
        f"{state} but for the ring's scratch row")
    return dict(step=runner.step, bitwise=bitwise, differ=differ)


def check_offpolicy_cli():
    """A 2-process QMIX CLI cluster (qmix_spread's widths) that saves, and a
    resumed cluster that prints ``resumed from step N`` on rank 0 only and
    ends at its total."""
    import shutil
    import tempfile

    from cleanmarl_tpu_torch.distributed import multihost

    work = tempfile.mkdtemp(dir=ROOT, prefix=".chip_smoke_")
    ckpt = os.path.join(work, "ckpt")

    def cluster(total, resume):
        port = multihost.free_port()
        return [P10_CLI + ["--total_timesteps", str(total), "--checkpoint_dir", ckpt,
                           "--checkpoint_every", str(P10_CLI_STEPS[0]),
                           "--resume", str(resume).lower(),
                           "--coordinator_address", f"localhost:{port}",
                           "--num_processes", str(DP_WORLD), "--process_id", str(i)]
                for i in range(DP_WORLD)]
    try:
        outs = run_procs(cluster(P10_CLI_STEPS[0], False), module="qmix")
        saved = sorted(int(d) for d in os.listdir(ckpt) if d.isdigit())
        files = sorted(os.listdir(os.path.join(ckpt, str(P10_CLI_STEPS[0]))))
        outs2 = run_procs(cluster(P10_CLI_STEPS[1], True), module="qmix")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if "[dist] 2 ranks, backend gloo" not in outs[0] or "[QMIX]" in outs[1]:
        fail(f"2-process QMIX CLI: rank 0 must print alone:\n{outs[0][-1500:]}")
    if saved != [P10_CLI_STEPS[0]] or files != ["meta.json", "rank0.pt", "rank1.pt"]:
        fail(f"2-process QMIX CLI saved steps {saved}, files {files}")
    want = f"[QMIX] resumed from step {P10_CLI_STEPS[0]}"
    if want not in outs2[0] or "resumed" in outs2[1]:
        fail(f"resumed QMIX cluster: {want!r} must print on rank 0 only:\n{outs2[0][-1500:]}")
    steps = [int(x) for x in re.findall(r"\[QMIX\] step=(\d+)", outs2[0])]
    if not steps or steps[0] <= P10_CLI_STEPS[0] or steps[-1] != P10_CLI_STEPS[1]:
        fail(f"resumed QMIX cluster's steps {steps}")
    log(f"[p10 cli] saved {saved} ({files}); {want}; resumed cluster steps {steps}")
    return dict(saved=saved, resumed_steps=steps)


# phase 11: the validation runner (cleanmarl_tpu_torch/validate.py) over
# the ten recipes that had not trained through the port, one block each
PATHS11 = ("qmix_rnn_5m6m", "mappo_2s3z", "mappo_3s5z", "mappo_mmm", "mappo_mmm2",
           "mappo_5m6m_paper", "mappo_8m9m_paper", "mappo_27m30m_paper", "mappo_reference",
           "qmix_spread_memeff")
P11_27M_ENVS, P11_27M_AGENTS = 512, 27      # mappo_27m30m_paper: one minibatch of 512 x 27
P11_5M6M_SHAPE = (150, 32 * 5, 64)         # qmix_rnn_5m6m: 32 episodes x 5 agents, H=64


def check_paths11_shapes(results):
    """K1 at ``mappo_27m30m_paper``'s update (T=60, 512 envs x 27 agents:
    the team reward and end flags broadcast over the agents, the values
    per agent as ``normalize_values`` leaves them), and K2, K3 and dw at
    its one minibatch (T=60, M=13824, H=128, per-env resets at 2 % a step
    shared by the agents) and at ``qmix_rnn_5m6m``'s update (T=150, 32
    episodes x 5 agents = 160 rows, H=64, no resets). Held against their
    plain versions and timed; adds ``mappo_27m30m_shape`` to K1's row and
    ``paths11_shapes`` to each tensor-core GRU row."""
    import torch

    T, E, n, H = 60, P11_27M_ENVS, P11_27M_AGENTS, 128
    r, e, v, b = _returns_inputs(T, E, n, 0.02, True, False, seed=15)
    time_k1_at(results, "mappo_27m30m_shape", r, e, v, b, 0.95, (n, 1),
               f"mappo_27m30m_paper's update ({E} envs x {n} agents)")
    g = torch.Generator("cuda").manual_seed(16)
    ended = torch.rand(T, E, generator=g, device="cuda") < 0.02
    keep = (1.0 - ended.float())[..., None].expand(T, E, n).reshape(T, E * n).contiguous()
    for (T_, M, H_), kp in (((T, E * n, H), keep),
                            (P11_5M6M_SHAPE, torch.ones(P11_5M6M_SHAPE[:2], device="cuda"))):
        errs, ins, hs, rec = check_gru_shape(T_, M, H_, seed=M + T_, keep=kp)
        add_shape_rows(results, "paths11_shapes", T_, M, H_, time_gru(T_, M, H_, ins, hs, rec))
        keep_max_err(results, errs)


def p11_expected(cfg, algo):
    """{kernel: launches in one block} of a recipe's path, or None where
    only "launched" is checked (recurrent Q: its updates follow the
    episodes that end, 2 K2, 1 K3 and 1 dw each)."""
    if algo == "mappo":
        per_mb = cfg.log_interval * cfg.epochs * max(1, cfg.num_minibatches)
        gru = per_mb if cfg.recurrent else 0
        return {"lambda_returns": cfg.log_interval, "gru_seq_fwd": gru, "gru_seq_bwd": gru,
                "gru_seq_dw": gru}
    if algo == "qmix":
        return dict.fromkeys(KERNEL_KEYS, 0)
    return None


def check_validate(counters):
    """Phase 11: ``validate.run_config`` on the card for one block of each
    of ``PATHS11`` at full width (its budget one block's steps), with every
    kernel count set to 0 just before and read just after. Each run must
    return finite results, its eval the recipe's metric, and launch each
    kernel of its path (MAPPO: K1 once an update, K2, K3 and dw once a
    minibatch on the recurrent actor; recurrent Q: K2, K3 and dw, K2 twice
    as often; QMIX none)."""
    import torch
    from cleanmarl_tpu_torch import validate
    from cleanmarl_tpu_torch.recipes import RECIPES

    out_dir = os.path.join(ROOT, "runs", "validate_torch", "chip_smoke")
    out = {}
    for name in PATHS11:
        spec = RECIPES[name]
        cfg, *_, spb, _ = validate.build(spec["algo"], validate.recipe_kwargs(name, 0, "cuda"))
        torch.cuda.synchronize()
        for table in counters:
            for k in table:
                table[k] = 0
        os.environ["BASELINES_BUDGET"] = str(spb)
        try:
            result, stats = validate.run_config(name, seed=0, device="cuda", out_dir=out_dir)
        finally:
            os.environ.pop("BASELINES_BUDGET")
        torch.cuda.synchronize()
        launches = {k: v for table in counters for k, v in table.items()}
        main = {k: launches[k] for k in KERNEL_KEYS}
        with open(stats["curve"]) as f:
            curve = [json.loads(x) for x in f]
        metric = spec.get("metric", "eval/ep_reward").replace("/", "_")
        numbers = [result["tail_mean"], result["best"], stats["env_steps_per_s"],
                   stats["train_s"], stats["eval_s"], stats["peak_mem_gib"],
                   *[v for rec in curve for v in rec.values()]]
        if len(curve) != 1 or metric not in curve[0]:
            fail(f"[p11] {name}: the eval did not return {metric}: {curve}")
        if not all(math.isfinite(x) for x in numbers):
            fail(f"[p11] {name}: non-finite result {result} {stats} {curve}")
        if result["env_steps"] != spb or stats["num_blocks"] != 1:
            fail(f"[p11] {name}: ran {result['env_steps']} steps, not one block of {spb}")
        want = p11_expected(cfg, spec["algo"])
        if want is not None and main != want:
            fail(f"[p11] {name}: launches {main}, expected {want} in one block")
        if want is None and not (main["gru_seq_fwd"] > 0 and main["lambda_returns"] == 0
                                 and main["gru_seq_fwd"] == 2 * main["gru_seq_bwd"]
                                 == 2 * main["gru_seq_dw"]):
            fail(f"[p11] {name}: launches {main}, expected K2 = 2 x K3 = 2 x dw > 0, no K1")
        if any(v for k, v in launches.items() if k not in KERNEL_KEYS):
            fail(f"[p11] {name}: an L2 GRU route was launched: {launches}")
        log(f"[p11] {name}: one block of {spb} env steps, eval of 64 episodes, "
            f"{metric}={curve[0][metric]:.4f}, launches K1/K2/K3/dw "
            f"{'/'.join(str(main[k]) for k in KERNEL_KEYS)}")
        out[name] = dict(result=result, stats=stats, launches=launches)
    return out


# ---------------------------------------------------------------------------
# phase 12: restore a checkpoint at another world size (core/checkpoint.py,
# dp.unshard_runners); two gloo ranks on the one card, as phases 9 and 10
# ---------------------------------------------------------------------------

P12_CASES = ("mappo", "qmix_rnn_3m")


def _p12_case(name, device):
    """(module, config, fields table) of a phase-12 case: the main path's
    MAPPO (``BENCH``) or ``qmix_rnn_3m`` with the ring cut to
    ``P10_RESUME_BUFFER``."""
    from cleanmarl_tpu_torch.algos import mappo
    from cleanmarl_tpu_torch.distributed import DATA_FIELD_DIMS

    if name == "mappo":
        return mappo, mappo.PPOConfig(**BENCH, device=device), DATA_FIELD_DIMS["PPO"]
    return _p10_recipe(name, device, buffer_size=P10_RESUME_BUFFER)


def _p12_checkpointer(work, name, wrote, table, cfg):
    from cleanmarl_tpu_torch.core.checkpoint import Checkpointer

    return Checkpointer(os.path.join(work, name, str(wrote)), field_dims=table, seed=cfg.seed)


def _p12_block(name, train_block, runner, counters):
    """One driven block from a restored runner, every kernel count set to
    0 just before and read just after → (runner, what it saw)."""
    from cleanmarl_tpu_torch.core.driver import to_host

    for table in counters:
        for k in table:
            table[k] = 0
    n0 = runner.num_updates
    runner, metrics = train_block(runner)
    metrics = to_host(metrics)
    launches = {k: v for table in counters for k, v in table.items()}
    if not all(math.isfinite(v) for v in metrics.values()):
        fail(f"[p12] {name}: non-finite metrics after the restore: {metrics}")
    if runner.num_updates <= n0:
        fail(f"[p12] {name}: no update ran in the block after the restore")
    wanted = KERNEL_KEYS if name == "mappo" else KERNEL_KEYS[1:]
    if any(launches[k] <= 0 for k in wanted):
        fail(f"[p12] {name}: the block after the restore did not launch {wanted}: {launches}")
    return runner, dict(updates=runner.num_updates - n0, launches=launches, metrics=metrics)


def _p12_save_body(rank, world, port, work):
    """Each case on this rank of the group: init, training until an update
    has run (MAPPO: one block), a save by the ranks."""
    import torch
    from cleanmarl_tpu_torch.distributed import dp

    _join_group(rank, world, port)
    for name in P12_CASES:
        mod, cfg, table = _p12_case(name, "cuda")
        init, train_block, _, meta = mod.make_train(cfg)
        runner = dp.global_runner_init(init, torch.Generator("cuda").manual_seed(
            dp.rank_seed(cfg.seed, rank)), table)
        if name == "mappo":
            runner, _ = train_block(runner)
        while runner.num_updates == 0:
            out = meta["train_iter"](runner)
            runner = out[0] if isinstance(out, tuple) else out
        ckpt = _p12_checkpointer(work, name, world, table, cfg)
        dp.barrier()
        ckpt.save(runner.step, runner)


def _p12_restore_body(rank, world, port, work):
    """Each case's single-process checkpoint restored on this rank of the
    group and written as it came back (``_p12_restored_path``) for the
    parent to hold, then one driven block; the params bitwise identical
    across the ranks after it."""
    import torch
    from cleanmarl_tpu_torch.core.checkpoint import to_state
    from cleanmarl_tpu_torch.distributed import dp
    from cleanmarl_tpu_torch.ops import gru_kernel, returns_kernel

    _join_group(rank, world, port)
    counters = (returns_kernel.LAUNCHES, gru_kernel.LAUNCHES)
    res = {}
    for name in P12_CASES:
        mod, cfg, table = _p12_case(name, "cuda")
        init, train_block, _, meta = mod.make_train(cfg)
        template = dp.global_runner_init(init, torch.Generator("cuda").manual_seed(
            dp.rank_seed(cfg.seed, rank)), table)
        ckpt = _p12_checkpointer(work, name, 1, table, cfg)
        dp.barrier()
        restored = ckpt.restore(template)
        torch.save(to_state(restored), _p12_restored_path(work, name, rank))
        runner, block = _p12_block(name, train_block, restored, counters)
        res[name] = dict(block=block, local_envs=meta["local_envs"],
                         identical=_p10_identical(_p10_params(runner)))
    return res


def _p12_restored_path(work, name, rank):
    return os.path.join(work, name, f"restored{rank}.pt")


def _p12_load(path):
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def _p12_leaves(state, table, rank=0, world=1):
    """A runner's ``to_state`` tree as three {path: leaf} maps, cut to rank
    ``rank``'s share of ``world`` ranks by index arithmetic of this
    script's own (not ``dp.shard_runner``'s): (1) every leaf but those of
    (2) and (3), a per-env one cut to the envs ``rank, rank + world, ...``
    on its field's axis, a ring's rows to the rows ``i`` with ``i % world
    == rank``, its scratch row (unread) left out; (2) the 0-d partial sums
    of the per-env fields, whole; (3) the generator states, whole."""
    import torch

    cut, sums, gens = {}, {}, {}

    def walk(x, path, axis, ring):
        if isinstance(x, dict) and "__generator_state__" in x:
            gens[path] = x["__generator_state__"]
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{path}.{k}", axis, ring)
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]", axis, ring)
        elif not isinstance(x, torch.Tensor) or axis is None:
            cut[path] = x
        elif x.dim() == 0:
            sums[path] = x
        elif ring:
            cut[path] = x[:-1][rank::world]
        else:
            cut[path] = x[(slice(None),) * axis + (slice(rank, None, world),)]

    for name in sorted(state):
        if name == "ring":         # rows, then one scratch row, in its leaves
            for k in sorted(state[name]):  # (an episode ring's stored) and length
                walk(state[name][k], f"ring.{k}", 0, k in ("stored", "length"))
        else:
            walk(state[name], name, table.get(name), False)
    return cut, sums, gens


def _p12_same(a, b):
    """Tensors of one dtype and shape, equal bit for bit; else equal values
    of one type."""
    import torch

    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b))
    return type(a) is type(b) and a == b


def _p12_hold(whole, shares, table, what):
    """Fails unless each of ``shares`` (``to_state`` trees in rank order)
    is its rank's cut of the single-process runner ``whole``
    (``_p12_leaves``) and the shares' partial sums add up to ``whole``'s.
    Generators are the caller's to hold."""
    world = len(shares)
    total = None
    for k, share in enumerate(shares):
        want = _p12_leaves(whole, table, k, world)[0]
        got, sums, _ = _p12_leaves(share, table)
        if sorted(got) != sorted(want):
            fail(f"[p12] {what}: rank {k}'s fields {sorted(set(got) ^ set(want))} are not "
                 f"the runner's")
        bad = [p for p in want if not _p12_same(got[p], want[p])]
        if bad:
            fail(f"[p12] {what}: rank {k} is not its share of the runner at {bad[:8]}")
        total = sums if total is None else {p: total[p] + sums[p] for p in total}
    whole_sums = _p12_leaves(whole, table)[1]
    bad = [p for p in whole_sums if not _p12_same(total.get(p), whole_sums[p])]
    if sorted(total) != sorted(whole_sums) or bad:
        fail(f"[p12] {what}: the ranks' partial sums do not add up to the runner's at {bad}")


def _p12_same_gens(a, b):
    return sorted(a) == sorted(b) and all(_p12_same(a[p], b[p]) for p in a)


def check_elastic_resume():
    """Phase 12: each of ``P12_CASES`` saved by DP_WORLD gloo ranks and
    restored here at 1 (each rank's file its share of the restored runner,
    partial sums added, rank 0's generator; then one driven block), saved
    here and restored by DP_WORLD ranks (each rank's restored runner its
    share of the runner saved, rank 0's generator the saved one and rank
    1's the rule's new stream, the two different; then one block each,
    params identical). Shares are cut by ``_p12_leaves``, not by the
    ``dp`` code under test."""
    import shutil
    import tempfile

    import torch
    from cleanmarl_tpu_torch.core.checkpoint import to_state
    from cleanmarl_tpu_torch.distributed import dp
    from cleanmarl_tpu_torch.ops import gru_kernel, returns_kernel

    counters = (returns_kernel.LAUNCHES, gru_kernel.LAUNCHES)
    work = tempfile.mkdtemp(dir=ROOT, prefix=".chip_smoke_")
    out, kept = {}, {}
    try:
        spawn_ranks("_p12_save_body", work)
        for name in P12_CASES:
            mod, cfg, table = _p12_case(name, "cuda")
            init, train_block, _, _ = mod.make_train(cfg)
            ckpt = _p12_checkpointer(work, name, DP_WORLD, table, cfg)
            step = ckpt.latest_step()
            restored = ckpt.restore(init(torch.Generator("cuda").manual_seed(cfg.seed)))
            whole = to_state(restored)
            files = [_p12_load(os.path.join(ckpt.directory, str(step), f"rank{k}.pt"))["runner"]
                     for k in range(DP_WORLD)]
            _p12_hold(whole, files, table, f"{name} {DP_WORLD} -> 1")
            if not _p12_same_gens(_p12_leaves(whole, table)[2], _p12_leaves(files[0], table)[2]):
                fail(f"[p12] {name} {DP_WORLD} -> 1: the generator is not rank 0's")
            del whole, files
            runner, block = _p12_block(name, train_block, restored, counters)
            kept[name] = to_state(runner)
            _p12_checkpointer(work, name, 1, table, cfg).save(runner.step, runner)
            out[name] = {"2to1": dict(step=step, block=block), "1to2": dict(step=runner.step)}
            del runner, restored
        restored2 = spawn_ranks("_p12_restore_body", work)
        for name in P12_CASES:
            _, cfg, table = _p12_case(name, "cuda")
            what = f"{name} 1 -> {DP_WORLD}"
            shares = [_p12_load(_p12_restored_path(work, name, k)) for k in range(DP_WORLD)]
            _p12_hold(kept[name], shares, table, what)
            gens = [_p12_leaves(s, table)[2] for s in shares]
            if not _p12_same_gens(gens[0], _p12_leaves(kept[name], table)[2]):
                fail(f"[p12] {what}: rank 0's generator is not the saved one")
            seed = dp.resume_seed(cfg.seed, 1, DP_WORLD, out[name]["1to2"]["step"])
            new = torch.Generator("cuda").manual_seed(seed).get_state()
            if not all(_p12_same(g, new) for g in gens[1].values()):
                fail(f"[p12] {what}: rank 1's generator is not the rule's new stream")
            if any(_p12_same(gens[0][p], gens[1][p]) for p in gens[0]):
                fail(f"[p12] {what}: the two ranks restored the same generator state")
            del shares, kept[name]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for name in P12_CASES:
        ranks = [r[name] for r in restored2]
        if not all(r["identical"] for r in ranks):
            fail(f"[p12] {name}: params differ across the ranks after the 1 -> 2 block")
        out[name]["1to2"].update(block=ranks[0]["block"], local_envs=ranks[0]["local_envs"],
                                 launches_by_rank=[r["block"]["launches"] for r in ranks])
        for key, (n, m) in (("2to1", (DP_WORLD, 1)), ("1to2", (1, DP_WORLD))):
            o = out[name][key]
            log(f"[p12] {name} {n} -> {m} ranks at step {o['step']}: resumed block with "
                f"{o['block']['updates']} updates, launches "
                f"{'/'.join(str(o['block']['launches'][k]) for k in KERNEL_KEYS)} (K1/K2/K3/dw)")
    log("[p12] each rank's file bitwise its share of the runner restored at 1 (2 -> 1), each "
        "rank's restored runner bitwise its share of the one saved at 1 (1 -> 2; rank 1's "
        "generator the rule's new stream), shares cut independently of dp; params identical "
        "across ranks")
    return out


# ---------------------------------------------------------------------------
# phase 13: every optax optimizer the JAX package trains with (core/optim.py)
# ---------------------------------------------------------------------------

# (a) a tree with the main path's kinds of leaves, its GRU recurrent weight
# at H=128 (128 x 384: Adafactor factors it) among them; P13_STEPS updates
# with clip and the LR anneal on (clip only for the names optax refuses
# under a schedule), card against CPU. Elementwise ops are the same float32
# ops on both; norms (clip, trust ratios) sum in another order, rsqrt is
# not correctly rounded on the card
P13_TREE = {"gru": {"wi": (40, 384), "wh": (128, 384), "bi": (384,)},
            "head": {"w": (128, 10), "b": (10,)}}
P13_LR, P13_CLIP, P13_ANNEAL, P13_STEPS = 1e-3, 0.5, 10, 3
P13_TOL = dict(rtol=1e-5, atol=1e-6)
# noisy_sgd: the card's and the CPU's generators draw different noise, so
# the card is held by the noise's variance eta / (1 + count)^gamma (optax's
# defaults eta 0.01, gamma 0.55) over the 49,152 entries of wh: the sample
# variance's standard error is 0.64 %
P13_NOISE = dict(eta=0.01, gamma=0.55, rel_tol=0.05)
# (c) the two recipes driven with the QMIX paper's optimizer, optax's
# defaults: the main path (BENCH) and scripts/validate_baselines.py's
# qmix_rnn_3m (RECQ)
P13_RECQ = {"qmix_rnn_3m_rmsprop": dict(RECQ["qmix_rnn_3m"], optimizer="rmsprop")}


def _p13_tree(rng, scale=1.0):
    import torch

    return {k: {n: torch.as_tensor((scale * rng.randn(*shape)).astype("float32"))
                for n, shape in v.items()} for k, v in P13_TREE.items()}


def check_optimizers_card_vs_cpu():
    """(a) Every name of ``core/optim.SUPPORTED``: P13_STEPS updates on the
    card and on the CPU from the same params and gradients; params and
    optimizer state held to P13_TOL, counts equal; Adafactor's state
    factored at wh. ``noisy_sgd`` on the card by its distribution: (noisy
    − sgd) / −lr has the variance eta / (1 + count)^gamma, and the same
    count draws the same noise. → {name: max |diff|}."""
    import numpy as np
    import torch
    from cleanmarl_tpu_torch.core import optim
    from cleanmarl_tpu_torch.core.params import tree_leaves, tree_map

    rng = np.random.RandomState(13)
    params = _p13_tree(rng)
    grads = [_p13_tree(rng, 1.0 if k % 2 else 0.05) for k in range(P13_STEPS)]

    def run(opt, device):
        p = tree_map(lambda x: x.to(device), params)
        s = opt.init(p)
        for g in grads:
            p, s = opt.update(tree_map(lambda x: x.to(device), g), s, p)
        return p, s

    out = {}
    for name in optim.SUPPORTED:
        if name == "noisy_sgd":
            continue
        anneal = 0 if name in optim.NO_SCHEDULE else P13_ANNEAL
        opt = optim.make_optimizer(name, P13_LR, P13_CLIP, anneal)
        (pg, sg), (pc, sc) = run(opt, "cuda"), run(opt, "cpu")
        if sg["count"] != sc["count"] or sc["count"] != P13_STEPS:
            fail(f"[p13] {name}: counts {sg['count']} (card) and {sc['count']} (CPU)")
        pairs = list(zip(tree_leaves((pg, sg)), tree_leaves((pc, sc))))
        worst = max(float((a.cpu() - b).abs().max()) for a, b in pairs
                    if isinstance(a, torch.Tensor))
        if not all(torch.allclose(a.cpu(), b, **P13_TOL) for a, b in pairs
                   if isinstance(a, torch.Tensor)):
            fail(f"[p13] {name}: {P13_STEPS} updates on the card disagree with the CPU "
                 f"(max |diff| {worst:.3e})")
        out[name] = worst
    fac = optim.make_optimizer("adafactor", P13_LR).init(params)["adafactor"]
    if tuple(fac["v_row"]["gru"]["wh"].shape) != (128,) or fac["v"]["gru"]["wh"].numel() != 1:
        fail("[p13] adafactor did not factor the 128 x 384 leaf")

    eta, gamma = P13_NOISE["eta"], P13_NOISE["gamma"]
    noisy = optim.make_optimizer("noisy_sgd", P13_LR, P13_CLIP, P13_ANNEAL)
    sgd = optim.make_optimizer("sgd", P13_LR, P13_CLIP, P13_ANNEAL)
    p = tree_map(lambda x: x.cuda(), params)
    s_n, s_s = noisy.init(p), sgd.init(p)
    ratios = []
    for c, g in enumerate(grads):
        g = tree_map(lambda x: x.cuda(), g)
        pn, s_n2 = noisy.update(g, s_n, p)
        ps, s_s = sgd.update(g, s_s, p)
        again, _ = noisy.update(g, s_n, p)
        if not all(torch.equal(a, b) for a, b in zip(tree_leaves(again), tree_leaves(pn))):
            fail(f"[p13] noisy_sgd drew other noise for the same count {c}")
        noise = (pn["gru"]["wh"] - ps["gru"]["wh"]) / -noisy.step_size(c)
        ratio = float(noise.var()) / (eta / (1 + c) ** gamma)
        if abs(ratio - 1.0) > P13_NOISE["rel_tol"]:
            fail(f"[p13] noisy_sgd's noise variance at count {c} is {ratio:.4f} x "
                 f"eta / (1 + count)^gamma")
        ratios.append(ratio)
        s_n = s_n2
    log(f"[p13] {len(out)} optimizers, {P13_STEPS} updates with clip {P13_CLIP} and anneal "
        f"{P13_ANNEAL} (clip only: {', '.join(optim.NO_SCHEDULE)}), card vs CPU within "
        f"{P13_TOL}: worst max |diff| {max(out.values()):.3e} ({max(out, key=out.get)}); "
        f"adafactor factored the 128 x 384 leaf; noisy_sgd's noise variance / eta(1+c)^-gamma "
        f"on the card {', '.join(f'{r:.4f}' for r in ratios)}, the same noise for the same "
        f"count")
    return dict(max_abs_err=out, noisy_sgd_variance_ratio=ratios)


def check_optimizers_on_main_path():
    """(b) One MAPPO update (8 epochs x 8 minibatches = 64 optimizer steps
    of actor and critic) at the main path's width for every name, from the
    same runner and rollout: its metrics finite, its count 64."""
    import torch
    from cleanmarl_tpu_torch.algos.mappo import make_train
    from cleanmarl_tpu_torch.algos.ppo_common import PPOConfig
    from cleanmarl_tpu_torch.core import optim
    from cleanmarl_tpu_torch.core.driver import to_host

    init, _, _, meta = make_train(PPOConfig(**BENCH, device="cuda"))
    runner, traj, h0 = meta["collect_rollout"](init(torch.Generator("cuda").manual_seed(0)))
    params = (runner.actor_params, runner.critic_params)
    for name in optim.SUPPORTED:
        cfg = PPOConfig(**dict(BENCH, optimizer=name), device="cuda")
        _, _, _, m = make_train(cfg)
        opts = [optim.make_optimizer(name, lr, cfg.clip_gradients)
                for lr in (cfg.learning_rate_actor, cfg.learning_rate_critic)]
        r = runner.replace(actor_opt=opts[0].init(params[0]), critic_opt=opts[1].init(params[1]))
        upd, metrics = m["ppo_update"](r, traj, h0)
        metrics = to_host(metrics)
        bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
        if bad or upd.actor_opt["count"] != cfg.epochs * cfg.num_minibatches:
            fail(f"[p13] {name}: the main-path update gave {bad or upd.actor_opt['count']}")
        del upd
    log(f"[p13] {len(optim.SUPPORTED)} optimizers: one MAPPO update each at the main path's "
        f"width, metrics finite, {BENCH['epochs'] * BENCH['num_minibatches']} optimizer steps")


def _reset(counters):
    for table in counters:
        for k in table:
            table[k] = 0


def p13_drive_mappo(counters, optimizer):
    """(c) The main path with ``optimizer``: one warm-up block (with init),
    one driven block, one eval; every count set to 0 before init and read
    after eval: K1 once per PPO update, K2, K3 and dw once per minibatch
    (each ``num_updates``)."""
    import torch
    from cleanmarl_tpu_torch.algos.mappo import make_train
    from cleanmarl_tpu_torch.algos.ppo_common import PPOConfig
    from cleanmarl_tpu_torch.core.driver import to_host

    cfg = PPOConfig(**dict(BENCH, optimizer=optimizer), device="cuda")
    init, train_block, eval_fn, _ = make_train(cfg)
    _reset(counters)
    runner = init(torch.Generator("cuda").manual_seed(cfg.seed))
    runner, metrics = train_block(runner)
    warm = to_host(metrics)
    runner, metrics = train_block(runner)
    metrics = to_host(metrics)
    evals = to_host(eval_fn(runner.actor_params, torch.Generator("cuda").manual_seed(1)))
    torch.cuda.synchronize()
    launches = {k: v for table in counters for k, v in table.items()}
    n_ppo = runner.num_updates // (cfg.epochs * cfg.num_minibatches)
    want = dict(dict.fromkeys(launches, 0), lambda_returns=n_ppo,
                gru_seq_fwd=runner.num_updates, gru_seq_bwd=runner.num_updates,
                gru_seq_dw=runner.num_updates)
    if launches != want or n_ppo == 0:
        fail(f"[p13] mappo {optimizer}: launches {launches}, expected {want}")
    for k, v in {**warm, **metrics, **evals}.items():
        if not math.isfinite(v):
            fail(f"[p13] mappo {optimizer}: non-finite metric {k}={v}")
    log(f"[p13] mappo {optimizer}: launches {launches} = K1 once per PPO update ({n_ppo}), "
        f"K2/K3/dw once per minibatch ({runner.num_updates}); last block "
        f"{json.dumps(metrics, sort_keys=True)}; eval {json.dumps(evals, sort_keys=True)}")
    return dict(launches=launches, metrics=metrics, eval=evals, ppo_updates=n_ppo,
                num_updates=runner.num_updates)


def p13_drive_recq(counters, optimizer):
    """(c) qmix_rnn_3m with ``optimizer``: blocks (the first with init)
    until the updates have started, then one driven block and one eval,
    every count set to 0 before init and read after eval: K2 twice per
    update (target and online streams), K3 and dw once, no K1."""
    import torch
    from cleanmarl_tpu_torch.core.driver import to_host

    name = f"qmix_rnn_3m_{optimizer}"
    table = {name: dict(RECQ["qmix_rnn_3m"], optimizer=optimizer)}
    cfg, (init, train_block, eval_fn, _) = _recq(name, "cuda", table)
    _reset(counters)
    runner = init(torch.Generator("cuda").manual_seed(cfg.seed))
    seen, n_warm = [], 0
    while runner.num_updates == 0:
        runner, metrics = train_block(runner)
        seen.append(to_host(metrics))
        n_warm += 1
        if n_warm > 6:
            fail(f"[p13] {name}: no update after {n_warm} warm-up blocks")
    n0 = runner.num_updates
    runner, metrics = train_block(runner)
    seen.append(to_host(metrics))
    evals = to_host(eval_fn(runner.params, torch.Generator("cuda").manual_seed(1)))
    torch.cuda.synchronize()
    launches = {k: v for table in counters for k, v in table.items()}
    n = runner.num_updates
    want = dict(dict.fromkeys(launches, 0), gru_seq_fwd=2 * n, gru_seq_bwd=n, gru_seq_dw=n)
    if launches != want or n == n0:
        fail(f"[p13] {name}: launches {launches} after {n} updates ({n - n0} driven), "
             f"expected {want}")
    for k, v in [kv for m in seen for kv in m.items()] + list(evals.items()):
        if not math.isfinite(v):
            fail(f"[p13] {name}: non-finite metric {k}={v}")
    if runner.opt_state["count"] != n:
        fail(f"[p13] {name}: optimizer count {runner.opt_state['count']} after {n} updates")
    log(f"[p13] {name}: {n_warm} warm-up block(s) (incl. init), a driven block with {n - n0} "
        f"updates; launches {launches} = K2 2x, K3 and dw 1x the {n} updates; last block "
        f"{json.dumps(seen[-1], sort_keys=True)}; eval {json.dumps(evals, sort_keys=True)}")
    return dict(updates=n - n0, num_updates=n, launches=launches, metrics=seen[-1],
                eval=evals)


def check_optimizers(counters):
    """Phase 13: (a) card vs CPU for every name, (b) each name's update on
    the main path, (c) the main path and qmix_rnn_3m driven with rmsprop,
    each with one update card vs CPU, and with adam right after it, (d) a
    bitwise rmsprop resume."""
    lap = time.perf_counter()

    def lap_s():
        nonlocal lap
        lap, dt = time.perf_counter(), time.perf_counter() - lap
        return f"{dt:.1f} s"
    card_vs_cpu = check_optimizers_card_vs_cpu()
    log(f"[p13] (a) in {lap_s()}")
    check_optimizers_on_main_path()
    log(f"[p13] (b) in {lap_s()}")
    update_err = {"mappo_rmsprop": check_update_against_cpu("rmsprop", "p13"),
                  **check_recq_updates_against_cpu(P13_RECQ, "p13")}
    driven = {f"{path}_{opt}": drive(counters, opt)
              for path, drive in (("mappo", p13_drive_mappo), ("qmix_rnn_3m", p13_drive_recq))
              for opt in ("rmsprop", "adam")}
    log(f"[p13] (c) in {lap_s()}")
    resume = check_resume("rmsprop", "p13")
    if not resume["bitwise"]:
        fail(f"[p13] the rmsprop resume is not bitwise: {resume['differ']}")
    log(f"[p13] (d) in {lap_s()}")
    return dict(card_vs_cpu=card_vs_cpu, update_max_abs_err=update_err, driven=driven,
                resume=resume)


def check_dp_ranks(world):
    """``--dp_ranks``: phase 10's rank checks (commit, one-step updates, the
    driven paths) over ``world`` ranks, one a card when there are as many
    cards (nccl), then recurrent QMIX and FACMAC on 3m through the CLI
    with ``--use_mesh`` (one rank per visible card)."""
    global DP_WORLD
    DP_WORLD = world
    check_offpolicy_dp()
    for mod, batch in (("qmix_rnn", "32"), ("facmac", "64")):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", f"cleanmarl_tpu_torch.algos.{mod}",
                            "--env_type", "smaclite", "--env_name", "3m", "--num_envs", "64",
                            "--buffer_size", "5000", "--batch_size", batch,
                            "--max_updates_per_iter", "8", "--log_interval", "50",
                            "--total_timesteps", "9600", "--eval_steps", "9600",
                            "--use_mesh", "true", "--seed", "0"],
                           capture_output=True, text=True, timeout=600, cwd=ROOT)
        lines = (p.stdout + p.stderr).strip().splitlines()
        for line in [x for x in lines if x.startswith("[dist]")] + lines[-4:]:
            log(f"[mesh {mod}] {line}")
        if p.returncode != 0:
            fail(f"{mod} --use_mesh exited {p.returncode}")
        log(f"[mesh {mod}] rc 0 in {time.perf_counter() - t0:.1f} s")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write all results to this JSON file")
    ap.add_argument("--dp_ranks", type=int, default=0,
                    help="only build the kernels and run phase 10's rank checks over this many "
                         "ranks (one a card: nccl) and the --use_mesh CLIs; no result line")
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
    t_start = t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[build] {len(built)} sources in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(k + (' cached' if v['cached'] else '') for k, v in built.items())})")
    for name, info in built.items():
        for kernel, usage in ptxas_usage(info["ptxas"]):
            log(f"[build] {name}: {kernel}: {usage}")
    if args.dp_ranks:
        check_dp_ranks(args.dp_ranks)
        log(f"[dp_ranks] done in {time.perf_counter() - t_start:.1f} s")
        return

    # phase 2: kernels vs plain versions, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[kernels] TF32 off (matmul and cuDNN) for the plain versions; the GRU tensor-core "
        "kernels run 3xTF32; tolerances: returns "
        f"{RET_TOL}, GRU values {VAL_TOL}, GRU grads {GRAD_TOL} x max(1, max|grad|)")
    results = {}
    check_returns(results)
    gru_times = check_gru(results)
    check_rnn_seq_apply()
    rq_routes = check_recurrent_q_shapes(results)
    check_paths7_shapes(results)
    check_paths8_shapes(results)
    check_paths9_shapes(results)
    check_paths10_shapes(results)
    check_paths11_shapes(results)

    # phase 3: the main path
    check_update_against_cpu()
    counters = (returns_kernel.LAUNCHES, gru_kernel.LAUNCHES)
    main_path = drive_main_path(counters)

    # phase 4: the CLIs
    run_cli("mappo", MAPPO_CLI)
    run_cli("qmix", QMIX_CLI)
    run_cli("qmix_rnn", QMIX_RNN_CLI)
    run_cli("maddpg", MADDPG_RNN_CLI)
    run_cli("coma", COMA_RNN_CLI)
    run_cli("ippo", IPPO_RNN_CLI)

    # phase 5: the off-policy slice (no kernel on its path)
    check_offpolicy_updates_against_cpu()
    offpolicy = {name: drive_offpolicy(name, counters) for name in OFFPOLICY}

    # phase 6: recurrent QMIX and VDN on SMAClite 3m
    t6 = time.perf_counter()
    check_recq_updates_against_cpu()
    recq = {name: drive_recq(name, counters) for name in RECQ_DRIVEN}
    log(f"[recq] phase 6 in {time.perf_counter() - t6:.1f} s")

    # phase 7: MADDPG, FACMAC and COMA
    t7 = time.perf_counter()
    check_updates_against_cpu(PATHS7, "paths7")
    paths7 = {name: drive_recipe(name, counters) for name in PATHS7}
    log(f"[paths7] phase 7 in {time.perf_counter() - t7:.1f} s")

    # phase 8: IPPO, pursuit and LBF, the host-env route, SMAClite collisions
    t8 = lap = time.perf_counter()

    def lap_s():
        nonlocal lap
        lap, dt = time.perf_counter(), time.perf_counter() - lap
        return f"{dt:.1f} s"
    check_updates_against_cpu(PATHS8, "paths8")
    log(f"[paths8] updates held card vs CPU in {lap_s()}")
    paths8 = {}
    for name in PATHS8_DRIVEN:
        paths8[name] = drive_recipe(name, counters)
        log(f"[paths8] {name} driven in {lap_s()}")
    paths8["vdn_pursuit"] = drive_offpolicy("vdn_pursuit", counters)
    if any(paths8["vdn_pursuit"]["launches"].values()):
        fail(f"vdn_pursuit launched a kernel: {paths8['vdn_pursuit']['launches']}")
    log(f"[paths8] vdn_pursuit driven in {lap_s()}")
    host_route = check_host_route(counters)
    log(f"[paths8] host route in {lap_s()}")
    collisions = check_collisions(counters)
    log(f"[paths8] collisions in {lap_s()}; phase 8 in {time.perf_counter() - t8:.1f} s")

    # phase 9: checkpoint and resume, data-parallel MAPPO, the CLIs
    t9 = lap = time.perf_counter()
    resume = check_resume()
    log(f"[resume] in {lap_s()}")
    data_parallel = check_data_parallel()
    log(f"[dp] in {lap_s()}")
    dp_cli = check_dp_cli()
    log(f"[dp-cli] in {lap_s()}; phase 9 in {time.perf_counter() - t9:.1f} s")

    # phase 10: data-parallel QMIX, VDN, recurrent Q, MADDPG and FACMAC
    t10 = lap = time.perf_counter()
    offpolicy_dp = check_offpolicy_dp()
    log(f"[p10] two ranks (commit, updates, driven paths) in {lap_s()}")
    offpolicy_resume = check_offpolicy_resume()
    log(f"[p10 resume] in {lap_s()}")
    offpolicy_cli = check_offpolicy_cli()
    log(f"[p10 cli] in {lap_s()}; phase 10 in {time.perf_counter() - t10:.1f} s")

    # phase 11: the validation runner over the ten recipes new to the port
    t11 = time.perf_counter()
    paths11 = check_validate(counters)
    log(f"[p11] phase 11 in {time.perf_counter() - t11:.1f} s")

    # phase 12: restore a checkpoint at another world size
    t12 = time.perf_counter()
    elastic = check_elastic_resume()
    log(f"[p12] phase 12 in {time.perf_counter() - t12:.1f} s")

    # phase 13: every optax optimizer the JAX package trains with
    t13 = time.perf_counter()
    optimizers = check_optimizers(counters)
    log(f"[p13] phase 13 in {time.perf_counter() - t13:.1f} s")

    by_path = {"mappo": main_path["launches"],
               **{k: v["launches"] for k, v in {**recq, **paths7, **paths8}.items()},
               "host_ippo": dict(dict.fromkeys(KERNEL_KEYS, 0), **host_route["launches"]),
               "mappo_3m_collisions": collisions["launches"],
               "mappo_dp": data_parallel["launches"],
               **{f"{k}_dp": v["launches"] for k, v in offpolicy_dp["drive"].items()},
               "validate": {k: sum(v["launches"][k] for v in paths11.values())
                            for k in next(iter(paths11.values()))["launches"]},
               **{f"{k}_resume_{d}": v[d]["block"]["launches"] for k, v in elastic.items()
                  for d in ("2to1", "1to2")},
               **{k: v["launches"] for k, v in optimizers["driven"].items()
                  if k.endswith("_rmsprop")}}
    kernels = [dict(name=name, route="cuda", launches=main_path["launches"][name],
                    launches_by_path={p: c.get(name, 0) for p, c in by_path.items()}, **r)
               for name, r in results.items()]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                           kernels=kernels, gru_times=gru_times, main_path=main_path,
                           offpolicy=offpolicy, recurrent_q_routes=rq_routes,
                           recurrent_q=recq, paths7=paths7, paths8=paths8, host_route=host_route,
                           collisions=collisions, resume=resume,
                           data_parallel=data_parallel, dp_cli=dp_cli,
                           offpolicy_dp=offpolicy_dp, offpolicy_resume=offpolicy_resume,
                           offpolicy_cli=offpolicy_cli, paths11=paths11,
                           elastic_resume=elastic, optimizers=optimizers),
                      f, indent=1, sort_keys=True)
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
