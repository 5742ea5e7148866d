"""Host-side training driver (port of ``cleanmarl_tpu/core/driver.py``).

Every algorithm exposes (init, train_block, eval_fn); this loop runs the
blocks, moves each block's metrics to the host in one transfer, logs
them with the JAX package's scalar names, evaluates every
``eval_steps`` env steps, prints progress, checkpoints and resumes the
whole runner (``core/checkpoint.py``), profiles one block under
``torch.profiler`` and, in a process group, runs as one rank of a
data-parallel run (``distributed/dp.py``).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from cleanmarl_tpu_torch.core.device import resolve_device
from cleanmarl_tpu_torch.core.logger import Logger
from cleanmarl_tpu_torch.core.tracing import recording, span
from cleanmarl_tpu_torch.distributed import dp


class _NullLogger:
    """Ranks other than 0 log nothing (rank 0 owns TB/W&B)."""

    def log(self, scalars, step):
        pass

    def close(self):
        pass


def to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """All scalar metrics of a block in one device→host transfer."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    return dict(zip(keys, vals.cpu().tolist()))


def _block(train_block, runner):
    """One block and its one host read → (runner, host metrics)."""
    with span("driver.block"):
        runner, metrics = train_block(runner)
    with span("driver.to_host"):
        return runner, to_host(metrics)


def _profiled_block(train_block, runner, profile_dir: str, device: torch.device):
    """One block under ``torch.profiler`` with the program's spans on
    (``core/tracing.py``), its trace written for TensorBoard's profile
    plugin (``tensorboard_trace_handler``)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with recording(), profile(activities=activities,
                              on_trace_ready=tensorboard_trace_handler(profile_dir)):
        return _block(train_block, runner)


def run_training(
    algo_name: str,
    cfg: Any,
    init: Callable,
    train_block: Callable,
    eval_fn: Callable,
    steps_per_block: int,
    eval_params: Callable[[Any], Any],
    data_field_dims: Dict[str, int],
    steps_of: Optional[Callable[[Any], int]] = None,
    print_keys: Tuple[str, ...] = ("rollout/ep_reward",),
    logger: Optional[Logger] = None,
    phase_timer: Optional[Callable[[Any], Dict[str, float]]] = None,
) -> Tuple[Any, Dict[str, float]]:
    """Returns (final runner, last eval metrics).

    Config knobs read here (all optional on cfg): ``total_timesteps``,
    ``eval_steps``, ``seed``, ``verbose``, ``device``, ``checkpoint_dir``
    (enables checkpointing), ``checkpoint_every`` (env steps between
    saves), ``resume`` (restore the latest checkpoint before training),
    ``profile_dir`` (trace block 1). ``data_field_dims`` is the family's
    table of per-env fields (``dp.DATA_FIELD_DIMS``), which a data-parallel
    init leaves on each rank.
    """
    rank, world = dp.rank_world()
    is_main = rank == 0
    device = resolve_device(getattr(cfg, "device", "cuda"))
    own_logger = logger is None
    if own_logger:
        logger = (Logger(algo_name, cfg, use_wnb=getattr(cfg, "use_wnb", False))
                  if is_main else _NullLogger())
    verbose = getattr(cfg, "verbose", False) and is_main
    init_gen = torch.Generator(device).manual_seed(dp.rank_seed(cfg.seed, rank))
    eval_gen = torch.Generator(device).manual_seed(cfg.seed + 1)   # not checkpointed
    if world > 1:
        runner = dp.global_runner_init(init, init_gen, data_field_dims)
    else:
        runner = init(init_gen)
    if steps_of is None:
        steps_of = lambda r: int(r.step)  # noqa: E731

    ckpt = None
    done_steps = 0
    ckpt_dir = getattr(cfg, "checkpoint_dir", "")
    if ckpt_dir:
        from cleanmarl_tpu_torch.core.checkpoint import Checkpointer

        ckpt = Checkpointer(ckpt_dir, field_dims=data_field_dims, seed=cfg.seed)
        if getattr(cfg, "resume", False) and ckpt.latest_step() is not None:
            written = ckpt.meta()["world"]
            runner = ckpt.restore(runner)      # at any world size the layout allows
            done_steps = steps_of(runner)
            if is_main:
                moved = f" (written by {written} ranks, now {world})" if written != world else ""
                print(f"[{algo_name}] resumed from step {ckpt.latest_step()}{moved}",
                      flush=True)

    # a resumed run trains only the REMAINING budget, so interrupt+resume
    # completes exactly total_timesteps overall
    remaining = max(0, cfg.total_timesteps - done_steps)
    num_blocks = remaining // steps_per_block if done_steps else max(
        1, cfg.total_timesteps // steps_per_block)
    eval_every = max(1, cfg.eval_steps // steps_per_block)
    ckpt_every = max(1, getattr(cfg, "checkpoint_every", 0) // steps_per_block) if ckpt else 0
    eval_metrics: Dict[str, float] = {}
    profile_dir = getattr(cfg, "profile_dir", "")
    t0 = time.time()
    steps0 = None
    for block in range(num_blocks):
        if profile_dir and block == 1:
            # block 0 paid the kernel builds and warm-up; trace one
            # steady-state block
            runner, metrics = _profiled_block(train_block, runner, profile_dir, device)
            if phase_timer is not None:
                phases = {k: float(v) for k, v in phase_timer(runner).items()}
                logger.log(phases, steps_of(runner))
                if verbose:
                    print(f"[{algo_name}] phases: {phases}", flush=True)
        else:
            runner, metrics = _block(train_block, runner)
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
        if is_main and (block + 1) % eval_every == 0:
            eval_metrics = to_host(eval_fn(eval_params(runner), eval_gen))
            logger.log(eval_metrics, env_steps)
            if verbose:
                print(f"[{algo_name}] eval step={env_steps} ep_reward="
                      f"{eval_metrics['eval/ep_reward']:.3f} battle_won="
                      f"{eval_metrics['eval/battle_won']:.4f} "
                      f"wall_s={time.time() - t0:.1f}", flush=True)
        if ckpt_every and (block + 1) % ckpt_every == 0:
            ckpt.save(env_steps, runner)
    if ckpt is not None:
        ckpt.save(int(cfg.total_timesteps), runner, wait=True)
        ckpt.close()
    if own_logger:
        logger.close()
    return runner, eval_metrics
