"""Host-side training driver (port of ``cleanmarl_tpu/core/driver.py``).

Every algorithm exposes (init, train_block, eval_fn); this loop runs the
blocks, moves each block's metrics to the host in one transfer, logs
them with the JAX package's scalar names, evaluates every
``eval_steps`` env steps and prints progress.

Checkpointing, the device mesh, multi-process runs and profiling are not
ported yet (ROADMAP Queue A, Slice 7); asking for them raises.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from cleanmarl_tpu_torch.core.device import resolve_device
from cleanmarl_tpu_torch.core.logger import Logger

_NOT_PORTED = ("checkpoint_dir", "resume", "use_mesh", "profile_dir",
               "coordinator_address")


def to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """All scalar metrics of a block in one device→host transfer."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    return dict(zip(keys, vals.cpu().tolist()))


def run_training(
    algo_name: str,
    cfg: Any,
    init: Callable,
    train_block: Callable,
    eval_fn: Callable,
    steps_per_block: int,
    eval_params: Callable[[Any], Any],
    steps_of: Optional[Callable[[Any], int]] = None,
    print_keys: Tuple[str, ...] = ("rollout/ep_reward",),
    logger: Optional[Logger] = None,
) -> Tuple[Any, Dict[str, float]]:
    """Returns (final runner, last eval metrics)."""
    for name in _NOT_PORTED:
        if getattr(cfg, name, None):
            raise NotImplementedError(
                f"--{name} is not yet ported to cleanmarl_tpu_torch "
                f"(ROADMAP Queue A, Slice 7)")
    if getattr(cfg, "num_processes", 1) > 1:
        raise NotImplementedError("multi-process training is not yet ported to "
                                  "cleanmarl_tpu_torch (ROADMAP Queue A, Slice 7)")
    device = resolve_device(getattr(cfg, "device", "cuda"))
    own_logger = logger is None
    if own_logger:
        logger = Logger(algo_name, cfg, use_wnb=getattr(cfg, "use_wnb", False))
    verbose = getattr(cfg, "verbose", False)
    init_gen = torch.Generator(device).manual_seed(cfg.seed)
    eval_gen = torch.Generator(device).manual_seed(cfg.seed + 1)
    runner = init(init_gen)
    if steps_of is None:
        steps_of = lambda r: int(r.step)  # noqa: E731

    num_blocks = max(1, cfg.total_timesteps // steps_per_block)
    eval_every = max(1, cfg.eval_steps // steps_per_block)
    eval_metrics: Dict[str, float] = {}
    t0 = time.time()
    steps0 = None
    for block in range(num_blocks):
        runner, metrics = train_block(runner)
        metrics = to_host(metrics)
        env_steps = steps_of(runner)
        if steps0 is None:
            steps0 = env_steps - steps_per_block
        metrics["perf/env_steps_per_s"] = (env_steps - steps0) / max(
            time.time() - t0, 1e-9)
        logger.log(metrics, env_steps)
        if verbose:
            parts = [f"[{algo_name}] step={env_steps}"]
            for k in print_keys:
                if k in metrics:
                    parts.append(f"{k.split('/')[-1]}={metrics[k]:.3f}")
            parts.append(f"sps={metrics['perf/env_steps_per_s']:,.0f}")
            print(" ".join(parts), flush=True)
        if (block + 1) % eval_every == 0:
            eval_metrics = to_host(eval_fn(eval_params(runner), eval_gen))
            logger.log(eval_metrics, env_steps)
            if verbose:
                print(f"[{algo_name}] eval step={env_steps} ep_reward="
                      f"{eval_metrics['eval/ep_reward']:.3f} battle_won="
                      f"{eval_metrics['eval/battle_won']:.4f} "
                      f"wall_s={time.time() - t0:.1f}", flush=True)
    if own_logger:
        logger.close()
    return runner, eval_metrics
