"""The MAPPO family: the program's ``cleanmarl_tpu_torch.algos.mappo`` driven
by blocks (``train_block`` and one host read), as a training run is.

Set-up builds the runner with ``make_train(cfg)`` and ``init``, hands it the
benchmark's inputs (weights, first env state, generator), and runs the
window's own call, ``train_block``, through the first two iterations with
the recorder on (``families/common.Recorder``), then one block more; the
same runner goes on into the window.

A family of the same program path with a reference of its own is a short
file that imports this one's ``Run``, ``setup``, ``check``, ``control``,
``shapes``, ``GAINS``, ``numbers`` and ``TRACE_BLOCKS`` and defines its own
``reference`` (the reference module) and ``ref_cfg``: this file's code
looks both up on the cell's family module (``harness.family``).
"""
from __future__ import annotations

import math

import torch

from benchmark import harness
from benchmark import yardstick as Y
from benchmark.families import common
from benchmark.reference import common as C
from benchmark.reference import mappo as reference

TRACE_BLOCKS = 1


def _dims(cell: dict, device):
    p = cell["config_file"]["params"]
    return C.make_env(p, 1, device), p


def shapes(cell: dict, device) -> dict:
    env, p = _dims(cell, device)
    return {"actor": C.shapes_rnn(env.obs_dim, p["actor_hidden_dim"], env.n_actions),
            "critic": C.shapes_mlp(env.state_dim, p["critic_hidden_dim"], 1,
                                   p.get("critic_num_layers", 1))}


GAINS = {"actor": {"/head/w": 0.01}, "critic": {"/head/w": 1.0}}


def ref_cfg(cell: dict) -> dict:
    """The configuration file's values, which state every option the
    program reads, and the traffic's envs; the options this reference does
    not follow are refused by name."""
    p = dict(cell["config_file"]["params"])
    for k in ("normalize_reward", "normalize_advantage", "normalize_return",
              "normalize_values", "death_masking", "anneal_lr", "anneal_entropy",
              "remat_actor"):
        if p[k]:
            raise ValueError(f"the MAPPO reference does not take {k}=True")
    if p["clip_gradients"] > 0 or p["optimizer"] != "adam" or not p["recurrent"] or p["tbptt"]:
        raise ValueError("the MAPPO reference takes the recurrent actor, Adam, no clipping")
    p["num_envs"] = cell["traffic_file"]["num_envs"]
    return p


class Run:
    trace_blocks = TRACE_BLOCKS

    def __init__(self, cell: dict, seed: int, device: str):
        from cleanmarl_tpu_torch.algos import mappo, ppo_common
        from cleanmarl_tpu_torch.core.driver import to_host

        t = cell["traffic_file"]
        self.to_host = to_host
        cfg = ppo_common.PPOConfig(**cell["config_file"]["params"], num_envs=t["num_envs"],
                                   log_interval=t["log_interval"], device=device,
                                   seed=seed % 2**31, verbose=False)
        self.cfg = cfg
        init, self.train_block, _, self.meta = mappo.make_train(cfg)
        runner = init(torch.Generator(device).manual_seed(common.sub_seed(seed, "init")))
        ins = common.inputs(seed, device, shapes(cell, device), GAINS)
        self.runner = runner.replace(
            actor_params=C.tmap(torch.clone, ins["params"]["actor"]),
            critic_params=C.tmap(torch.clone, ins["params"]["critic"]),
            **common.hand_over(runner, ins, cell["config_file"]["params"], device))
        del ins, runner
        env, _ = _dims(cell, device)
        self.steps_per_block = self.meta["steps_per_block"]
        self.flops_per_step = Y.mappo_flops_per_step(
            env.obs_dim, env.state_dim, env.n_agents, env.n_actions, cfg.actor_hidden_dim,
            cfg.critic_hidden_dim, cfg.critic_num_layers, self.meta["rollout_len"], cfg.epochs)
        self.n_agents = env.n_agents
        self.flops = 0.0
        with common.Recorder(ppo_common, cfg.epochs * cfg.num_minibatches,
                             self.meta["rollout_len"], harness.family(cell).reference.STEPS) as rec:
            for _ in range(math.ceil(2 / cfg.log_interval)):
                self.block()
        self.capture = rec.rec
        self.block()                    # one more, outside the recorder

    def block(self):
        """One ``train_block`` and its one host read → (env steps, metrics)."""
        self.runner, m = self.train_block(self.runner)
        host = self.to_host(m)
        self.flops += self.steps_per_block * self.flops_per_step
        return self.steps_per_block, host

    def traced_block(self) -> int:
        """The work of one block, through the calls ``train_block`` composes,
        inside the benchmark's spans."""
        from torch.profiler import record_function

        r = self.runner
        with record_function("bench.block"):
            for _ in range(self.cfg.log_interval):
                with record_function("bench.rollout"):
                    r, traj, h0 = self.meta["collect_rollout"](r)
                with record_function("bench.update"):
                    r, ms = self.meta["ppo_update"](r, traj, h0)
            metrics = {**r.stats.rollout_metrics(), **ms}
            r = r.replace(stats=r.stats.flush())
        with record_function("bench.to_host"):
            self.to_host(metrics)
        self.runner = r
        return self.steps_per_block

    def timings(self) -> dict:
        """The program's ``phase_timer``: rollout and update, each alone
        between device syncs, the generator put back."""
        t = self.meta["phase_timer"](self.runner)
        return {"mappo.rollout_s": t["perf/rollout_s"], "mappo.update_s": t["perf/update_s"]}

    def shapes(self) -> dict:
        cfg, n = self.cfg, self.n_agents
        n_loc = self.meta["local_envs"]
        mb = n_loc // max(1, cfg.num_minibatches)
        return {"gru": [(self.meta["rollout_len"], mb * n, cfg.actor_hidden_dim)],
                "returns": (self.meta["rollout_len"], n_loc * n, n, n)}

    def free(self):
        self.runner = self.train_block = self.meta = None


def setup(cell, seed, device) -> Run:
    return Run(cell, seed, device)


def check(cell: dict, seed: int, capture: dict, device: str) -> dict:
    """The numbers of the program's run against the reference's."""
    fam = harness.family(cell)
    ins = common.inputs(seed, device, shapes(cell, device), GAINS)
    ref = fam.reference.run(fam.ref_cfg(cell), ins, device, given=capture)
    return numbers(capture, ref, ins["params"])


def numbers(prog: dict, ref: dict, init: dict) -> dict:
    out = {"action_gap": ref["action_gap"]}
    out.update(common.training_numbers(prog, ref, init, reference.KEYS))
    return out


def control(cell: dict, seed: int, device: str, tf32: bool = True, fault: str = "") -> dict:
    """The reference in the program's place, in TF32 or with a fault
    planted, judged by the reference in float32."""
    fam = harness.family(cell)
    ins = common.inputs(seed, device, shapes(cell, device), GAINS)
    cfg = fam.ref_cfg(cell)
    low = common.to_cpu(fam.reference.run(cfg, ins, device, tf32=tf32, fault=fault))
    ref = fam.reference.run(cfg, ins, device, given=low)
    return numbers(low, ref, ins["params"])
