"""Learning-curve validation of the port: trains the recipes of
``recipes.py`` and holds each converged eval tail against its threshold
(port of ``scripts/validate_baselines.py``'s ``build``, ``run_config``
and ``run_all``, with the same schedule and the same ``RESULT`` keys).

A run trains ``total_timesteps // steps_per_block`` train blocks (at least
one), evaluates ``num_eval_ep`` episodes every ``max(1, blocks // 40)``
blocks and after the last, writes one curve record per eval to
``<out>/<name>_s<seed>.jsonl`` and prints ``RESULT {json}``: the tail
is the mean of the last 5 evals of the recipe's metric. Each eval's
generator is seeded from the block index (the JAX script's
``PRNGKey(block)``; JAX PRNG streams themselves cannot be reproduced).
``BASELINES_BUDGET`` overrides ``total_timesteps``, as in the JAX script.

    python -m cleanmarl_tpu_torch.validate --config mappo_reference      # on the card
    python -m cleanmarl_tpu_torch.validate --config qmix_spread --device cpu
    python -m cleanmarl_tpu_torch.validate --all                         # one after another
    python -m cleanmarl_tpu_torch.validate --config mappo_mmm mappo_mmm2 --parallel 2

One recipe at one seed runs in this process. ``--all``, several recipes
or several seeds run one subprocess each (a crash costs one run),
``--parallel K`` at a time on the one card, each with its output in
``<out>/<name>_s<seed>.log``; their ``RESULT`` records (or a ``crashed``
record) go to ``<out>/summary.jsonl``. Curves go under
``runs/validate_torch/`` unless ``--out`` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from cleanmarl_tpu_torch.core.driver import to_host
from cleanmarl_tpu_torch.recipes import RECIPES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "runs", "validate_torch")
TAIL = 5            # evals in the tail mean
NUM_EVALS = 40      # evals over a run (at least; one after the last block too)


def build(algo: str, kwargs: dict):
    """→ (cfg, init, train_block, eval_fn, steps_per_block, eval_params)."""
    if algo in ("ippo", "mappo"):
        from cleanmarl_tpu_torch.algos import ippo, mappo
        from cleanmarl_tpu_torch.algos.ppo_common import PPOConfig

        cfg = PPOConfig(**kwargs)
        make_train = {"ippo": ippo.make_train, "mappo": mappo.make_train}[algo]
        params_of = lambda r: r.actor_params  # noqa: E731
    elif algo in ("vdn", "qmix", "recurrent_q"):
        from cleanmarl_tpu_torch.algos import qmix, recurrent_q, vdn

        mod, cls = {"vdn": (vdn, vdn.VDNConfig), "qmix": (qmix, qmix.QMIXConfig),
                    "recurrent_q": (recurrent_q, recurrent_q.RecurrentQConfig)}[algo]
        cfg, make_train = cls(**kwargs), mod.make_train
        params_of = lambda r: r.params  # noqa: E731
    elif algo in ("maddpg", "facmac", "coma"):
        from cleanmarl_tpu_torch.algos import coma, facmac, maddpg

        mod, cls = {"maddpg": (maddpg, maddpg.MADDPGConfig),
                    "facmac": (facmac, facmac.FACMACConfig),
                    "coma": (coma, coma.COMAConfig)}[algo]
        cfg, make_train = cls(**kwargs), mod.make_train
        params_of = lambda r: r.actor_params  # noqa: E731
    else:
        raise ValueError(algo)
    init, train_block, eval_fn, meta = make_train(cfg)
    return cfg, init, train_block, eval_fn, meta["steps_per_block"], params_of


def recipe_kwargs(name: str, seed: int, device: str, num_eval_ep: int = 64) -> dict:
    """The config kwargs of one run: the recipe's, with the seed, the
    device, quiet output, ``num_eval_ep`` and ``BASELINES_BUDGET`` as
    ``total_timesteps`` where it is set."""
    kwargs = dict(RECIPES[name]["kwargs"], seed=seed, verbose=False,
                  num_eval_ep=num_eval_ep, device=device)
    if os.environ.get("BASELINES_BUDGET"):  # smoke-test override
        kwargs["total_timesteps"] = int(os.environ["BASELINES_BUDGET"])
    return kwargs


def run_config(name: str, seed: int = 1, device: str = "cuda", out_dir: str = DEFAULT_OUT,
               num_eval_ep: int = 64):
    """Train one recipe at one seed → (result, stats). ``result`` has the
    JAX script's ``RESULT`` keys and is printed as ``RESULT {json}``;
    ``stats`` adds the steps per block, the blocks, the train and eval
    seconds (each block ended by its metrics' one transfer to the host),
    env-steps/s over the train seconds and the peak device memory."""
    spec = RECIPES[name]
    metric = spec.get("metric", "eval/ep_reward")
    cfg, init, train_block, eval_fn, spb, eval_params = build(
        spec["algo"], recipe_kwargs(name, seed, device, num_eval_ep))
    dev = torch.device(cfg.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runner = init(torch.Generator(dev).manual_seed(seed))
    num_blocks = max(1, cfg.total_timesteps // spb)
    eval_every = max(1, num_blocks // NUM_EVALS)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{name}_s{seed}.jsonl")
    t0 = time.time()
    train_s = eval_s = 0.0
    curve = []
    with open(out_path, "w") as out:
        for block in range(num_blocks):
            tb = time.time()
            runner, metrics = train_block(runner)
            metrics = to_host(metrics)
            train_s += time.time() - tb
            if (block + 1) % eval_every == 0 or block == num_blocks - 1:
                te = time.time()
                ev = to_host(eval_fn(eval_params(runner),
                                      torch.Generator(dev).manual_seed(block)))
                eval_s += time.time() - te
                rec = {
                    "env_steps": (block + 1) * spb,
                    "wall_s": round(time.time() - t0, 1),
                    "eval_ep_reward": float(ev["eval/ep_reward"]),
                    "rollout_ep_reward": float(metrics["rollout/ep_reward"]),
                }
                if metric != "eval/ep_reward":
                    rec[metric.replace("/", "_")] = float(ev[metric])
                curve.append(float(ev[metric]))
                out.write(json.dumps(rec) + "\n")
                out.flush()
    tail = curve[-TAIL:]
    tail_mean = sum(tail) / len(tail)
    result = {
        "config": name, "seed": seed, "tail_mean": round(tail_mean, 3),
        "best": round(max(curve), 3), "threshold": spec["threshold"],
        "passed": tail_mean >= spec["threshold"],
        "wall_s": round(time.time() - t0, 1),
        "env_steps": num_blocks * spb,
    }
    stats = {
        "steps_per_block": spb, "num_blocks": num_blocks, "eval_every": eval_every,
        "train_s": train_s, "eval_s": eval_s,
        "env_steps_per_s": num_blocks * spb / max(train_s, 1e-9),
        "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                         if dev.type == "cuda" else None),
        "device": str(dev), "curve": out_path,
    }
    print("RESULT " + json.dumps(result), flush=True)
    print("STATS " + json.dumps(stats), flush=True)
    return result, stats


def run_many(names, seeds, device: str = "cuda", out_dir: str = DEFAULT_OUT,
             parallel: int = 1) -> int:
    """One subprocess per (recipe, seed), ``parallel`` at a time, each
    with its output in ``<out>/<name>_s<seed>.log``; every ``RESULT``
    record, or a ``crashed`` record, goes to ``<out>/summary.jsonl`` as
    its run ends. → the number of runs that did not pass."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = [(n, s) for s in seeds for n in names]
    running = []
    failures = 0
    with open(os.path.join(out_dir, "summary.jsonl"), "w") as summary:
        def finish(job, proc, log_path):
            nonlocal failures
            with open(log_path) as f:
                text = f.read()
            rec = {"config": job[0], "seed": job[1], "error": "crashed",
                   "returncode": proc.returncode, "tail": text[-600:]}
            for line in text.splitlines():
                if line.startswith("RESULT "):
                    rec = json.loads(line[len("RESULT "):])
                elif line.startswith("STATS ") and rec.get("error") is None:
                    rec["stats"] = json.loads(line[len("STATS "):])
            summary.write(json.dumps(rec) + "\n")
            summary.flush()
            print(json.dumps(rec), flush=True)
            if not rec.get("passed", False):
                failures += 1

        try:
            while jobs or running:
                while jobs and len(running) < max(1, parallel):
                    name, seed = jobs.pop(0)
                    log_path = os.path.join(out_dir, f"{name}_s{seed}.log")
                    cmd = [sys.executable, "-m", "cleanmarl_tpu_torch.validate",
                           "--config", name, "--seed", str(seed), "--device", device,
                           "--out", out_dir]
                    with open(log_path, "w") as log:
                        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                                cwd=REPO)
                    running.append(((name, seed), proc, log_path))
                time.sleep(0.5)
                for item in [r for r in running if r[1].poll() is not None]:
                    running.remove(item)
                    finish(*item)
        finally:
            for _, proc, _ in running:      # interrupted: stop what still runs
                proc.terminate()
            for _, proc, _ in running:
                proc.wait()
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", nargs="+", choices=sorted(RECIPES), default=None)
    ap.add_argument("--all", action="store_true", help="every recipe, one subprocess each")
    ap.add_argument("--seed", type=int, nargs="+", default=[1])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=DEFAULT_OUT, help="directory of the curves and logs")
    ap.add_argument("--parallel", type=int, default=1,
                    help="subprocesses at a time when several runs are asked for")
    args = ap.parse_args(argv)
    names = list(RECIPES) if args.all else args.config
    if not names:
        ap.error("need --config NAME [NAME ...] or --all")
    if args.all or len(names) > 1 or len(args.seed) > 1:
        sys.exit(1 if run_many(names, args.seed, args.device, args.out, args.parallel) else 0)
    run_config(names[0], args.seed[0], args.device, args.out)


if __name__ == "__main__":
    main()
