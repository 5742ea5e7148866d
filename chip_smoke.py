#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``cleanmarl_tpu_torch``) on one
NVIDIA GPU, from the sources in this checkout.

    python3 chip_smoke.py [--out results.json]

Phases, each of which must pass:

1. print the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and build every CUDA kernel from ``csrc/`` (one
   ``nvcc`` per source, all at once);
2. hold each kernel against its plain PyTorch version on the card (TF32
   off), at the test shapes, the ragged-edge shapes and the main path's
   shapes; time kernel, plain version and, where one PyTorch call
   computes the same function, that call (a yardstick only: the port
   never calls it);
3. check one PPO update of the port on the card against the same update
   on the CPU (plain versions) on a small input, then drive the main
   path: recurrent MAPPO on SMAClite 3m at the bench settings (GRU
   actor and critic of width 128, 8192 envs, rollouts of 60 steps, 8
   epochs x 8 minibatches), one warm-up ``train_block``, two timed ones
   and one ``eval_fn``, with every kernel's launch count set to 0 just
   before and read just after;
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


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOPS * 1e3
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


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_returns(results):
    import torch
    from cleanmarl_tpu_torch.ops import returns_kernel as rk

    gen = torch.Generator("cuda").manual_seed(0)
    errs = []
    for shape, p_end in (((7, 5, 3), 0.2), ((25, 130), 0.0), ((60, 8192, 3), 0.02)):
        r = torch.randn(shape, generator=gen, device="cuda")
        e = torch.rand(shape, generator=gen, device="cuda") < p_end
        v = torch.randn(shape, generator=gen, device="cuda")
        b = torch.randn(shape[1:], generator=gen, device="cuda")
        got = rk.lambda_returns_kernel(r, e, v, b, 0.99, 0.95)
        want = rk.lambda_returns_plain(r, e, v, b, 0.99, 0.95)
        err = max_err(got, want)
        log(f"[kernels] lambda_returns {shape}: max_abs_err={err:.3e}")
        if not close(got, want, RET_TOL):
            fail(f"lambda_returns disagrees with its plain version at {shape}")
        errs.append(err)
    T, B = 60, 8192 * 3
    ms = time_ms(lambda: rk.lambda_returns_kernel(r, e, v, b, 0.99, 0.95), 200)
    plain = time_ms(lambda: rk.lambda_returns_plain(r, e, v, b, 0.99, 0.95), 10)
    bnd, by = bound_ms(T * B * (4 + 1 + 4 + 4 + 4) + 4 * B, 8 * T * B)
    log(f"[kernels] lambda_returns (60, 8192, 3): kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {bnd:.4f} ms ({by})")
    results["lambda_returns"] = dict(
        source="cleanmarl_tpu_torch/csrc/lambda_returns.cu",
        replaces="cleanmarl_tpu/ops/pallas_returns.py:35",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
        library_ms=None)


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
    backward kernel against its plain version."""
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

    (vals_k, grads_k) = run(gk.gru_seq)
    (vals_p, grads_p) = run(gk.gru_seq_fwd_plain)
    errs = {"fwd": max_err(vals_k, vals_p), "grads": max_err(grads_k, grads_p)}
    ok = close(vals_k, vals_p, VAL_TOL) and close_scaled(grads_k, grads_p, GRAD_TOL)
    hs = vals_k[0]
    rec_k = gk.gru_seq_bwd(*ins[:3], hs, ins[3], ins[4], w_seq, w_fin)
    rec_p = gk.gru_seq_bwd_plain(*ins[:3], hs, ins[3], ins[4], w_seq, w_fin)
    dw_k = gk.gru_seq_dw(ins[2], hs, ins[4], rec_k[0], rec_k[1])
    dw_p = gk.gru_seq_dw_plain(ins[2], hs, ins[4], rec_k[0], rec_k[1])
    errs["bwd"] = max_err(rec_k, rec_p)
    errs["dw"] = max_err(dw_k, dw_p)
    ok = (ok and close_scaled(rec_k, rec_p, GRAD_TOL)
          and close_scaled(dw_k, dw_p, GRAD_TOL))
    scale = max(float(x.abs().max()) for x in grads_p + list(dw_p))
    log(f"[kernels] gru T={T} M={M} H={H}: " + " ".join(
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
    f = 4
    flops = 2.0 * T * M * H * 3 * H
    fwd_bytes = f * (H * 3 * H + 3 * H + M * H + T * M * 3 * H + T * M + T * M * H + M * H)
    bwd_bytes = f * (H * 3 * H + 3 * H + M * H + 2 * T * M * H + T * M * 3 * H + T * M
                     + M * H + T * M * 3 * H + T * M * H + M * H)
    dw_bytes = f * (M * H + T * M * H + T * M + T * M * 3 * H + T * M * H
                    + H * 3 * H + 3 * H)
    return {"fwd": bound_ms(fwd_bytes, flops + 10.0 * T * M * H),
            "bwd": bound_ms(bwd_bytes, 2 * flops + 20.0 * T * M * H),
            "dw": bound_ms(dw_bytes, flops + T * M * 3 * H)}


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
    log(f"[kernels] rnn_seq_apply bench minibatch, kernel vs scan route: "
        f"values_err={err_v:.3e} grads_err={err_g:.3e}")
    if not (close(vals_k, vals_s, VAL_TOL) and close_scaled(grads_k, grads_s, GRAD_TOL)):
        fail("rnn_seq_apply kernel route disagrees with the scan route")


def check_gru(results):
    errs = {"fwd": 0.0, "bwd": 0.0, "dw": 0.0, "grads": 0.0}

    def keep_max(e):
        for k in errs:
            errs[k] = max(errs[k], e[k])

    for T, M, H in ((7, 12, 16), (5, 3, 8), (9, 37, 128)):
        keep_max(check_gru_shape(T, M, H, seed=H)[0])
    timings = {}
    for H in (128, 256):
        e, ins, hs, rec = check_gru_shape(60, 3072, H, seed=H + 1)
        keep_max(e)
        timings[H] = time_gru(60, 3072, H, ins, hs, rec)
    t, b = timings[128], gru_bounds(60, 3072, 128)
    src = "cleanmarl_tpu_torch/csrc/"
    results["gru_seq_fwd"] = dict(
        source=src + "gru_seq_fwd.cu", replaces="cleanmarl_tpu/ops/pallas_gru.py:67",
        max_abs_err=errs["fwd"], ms=t["fwd_ms"], plain_ms=t["fwd_plain_ms"],
        bound_ms=b["fwd"][0], bound_by=b["fwd"][1], library_ms=t["fwd_library_ms"])
    results["gru_seq_bwd"] = dict(
        source=src + "gru_seq_bwd.cu", replaces="cleanmarl_tpu/ops/pallas_gru.py:130",
        max_abs_err=max(errs["bwd"], errs["grads"]), ms=t["bwd_ms"],
        plain_ms=t["bwd_plain_ms"], bound_ms=b["bwd"][0], bound_by=b["bwd"][1],
        library_ms=None)
    results["gru_seq_dw"] = dict(
        source=src + "gru_seq_bwd.cu", replaces="cleanmarl_tpu/ops/pallas_gru.py:173",
        max_abs_err=errs["dw"], ms=t["dw_ms"], plain_ms=t["dw_plain_ms"],
        bound_ms=b["dw"][0], bound_by=b["dw"][1], library_ms=t["dw_library_ms"])
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
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the main path")
    phases = meta["phase_timer"](runner, iters=1)
    log(f"[main] phase_timer {json.dumps(phases, sort_keys=True)}")
    return dict(launches=launches, env_steps_per_s=sps, block_s=block_s,
                peak_gib=peak / 2**30, metrics=metrics, eval=evals, phases=phases,
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

    # phase 2: kernels vs plain versions, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[kernels] TF32 off (matmul and cuDNN); tolerances: returns "
        f"{RET_TOL}, GRU values {VAL_TOL}, GRU grads {GRAD_TOL} x max(1, max|grad|)")
    results = {}
    check_returns(results)
    gru_times = check_gru(results)
    check_rnn_seq_apply()

    # phase 3: the main path
    check_update_against_cpu()
    counters = (returns_kernel.LAUNCHES, gru_kernel.LAUNCHES)
    main_path = drive_main_path(counters)

    # phase 4: the CLI
    run_cli()

    kernels = [dict(name=name, route="cuda", source=r["source"], replaces=r["replaces"],
                    launches=main_path["launches"][name], max_abs_err=r["max_abs_err"],
                    ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])
               for name, r in results.items()]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                           kernels=kernels, gru_times=gru_times, main_path=main_path),
                      f, indent=1, sort_keys=True)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
