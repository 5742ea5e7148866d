"""The recurrent QMIX family: the program's
``cleanmarl_tpu_torch.algos.recurrent_q`` driven by blocks (``train_block``
and one host read), as a training run is.

Set-up builds the runner with ``make_train(cfg)`` and ``init``, hands it
the benchmark's inputs (the same weights to ``params`` and
``target_params``, the first env state and the generator), and runs the
window's own call, ``train_block``, with the recorder on until it holds
both stages of the check (``reference/qmix.py``), then one block more; the
same runner goes on into the window.

The traced block runs the program's two halves of an iteration,
``act_iter`` and ``update_iter``, under ``bench.act`` and
``bench.update``. The family's own readings (``timings``):

- ``qmix.update_s``: one TD update (``meta["update"]`` on one sampled
  batch: target stream, loss, gradient, Adam), timed alone between device
  syncs, the mean of 3, the generator put back;
- ``qmix.mixer_s``: the device seconds an update of the operations
  launched inside the program's span ``net.mixer``, over one profiled
  block (``spans.profiled_block``);
- ``qmix.ring_s``: the device seconds an iteration of the operations
  launched inside ``ring.commit`` and ``ring.sample``, over that block;
- ``qmix.valid_share``: the program's counters ``rq.valid_steps`` over
  ``rq.padded_steps`` through one recorded block.

Where the program has no such span or counter, each of the last three is
None.
"""
from __future__ import annotations

import time

import torch

from benchmark import harness, spans
from benchmark.families import common
from benchmark.reference import common as C
from benchmark.reference import qmix as reference

TRACE_BLOCKS = 1
GAINS = {"q": {"/head/w": 1.0}, "mixer": {"/head/w": 1.0, "/hb1/w": 1.0}}
# the recorded blocks of a set-up that never fills the check: a guard, not a size
MAX_RECORDED_BLOCKS = 1000


def _env_params(cell: dict) -> dict:
    """The configuration's params as the reference's env takes them: the
    program builds SMAClite with its default, no unit collisions
    (``RecurrentQConfig`` has no such option)."""
    return dict(cell["config_file"]["params"], unit_collisions=False)


def shapes(cell: dict, device) -> dict:
    """The weights' shapes: the Q-net on obs with ids, and the mixer's four
    hypernetworks on the state, as the program's ``mixer_init`` lays them
    out."""
    env = C.make_env(_env_params(cell), 1, device)
    p = cell["config_file"]["params"]
    S, E, Hh = env.state_dim, p["embed_dim"], p["hyper_dim"]
    return {"q": C.shapes_rnn(env.obs_dim, p["hidden_dim"], env.n_actions),
            "mixer": {"hw1": C.shapes_mlp(S, Hh, env.n_agents * E, 0),
                      "hb1": {"w": (S, E), "b": (E,)},
                      "hw2": C.shapes_mlp(S, Hh, E, 0),
                      "hb2": C.shapes_mlp(S, Hh, 1, 0)}}


def ref_cfg(cell: dict) -> dict:
    """The configuration file's values, which state every option the
    program reads, and the traffic's envs; the options this reference does
    not follow are refused by name."""
    p = _env_params(cell)
    if p["mixing"] != "qmix" or p["replay"] != "episode":
        raise ValueError("the QMIX reference takes mixing qmix with episode replay")
    for k in ("normalize_reward", "tbptt"):
        if p[k]:
            raise ValueError(f"the QMIX reference does not take {k}={p[k]!r}")
    if p["clip_gradients"] > 0 or p["optimizer"] != "adam" or p["compute_dtype"] != "float32":
        raise ValueError("the QMIX reference takes Adam in float32, no clipping")
    p["num_envs"] = cell["traffic_file"]["num_envs"]
    return p


def flops(env, p: dict) -> tuple:
    """Model FLOPs (2 × matmul MACs; biases, gates and the elementwise mix
    left out) → (an env step's acting, one update). An update computes
    every padded step of its ``batch_size`` episodes of T_max: the online
    Q-net and mixer forward, their backward as 2 × forward, the target's
    stream on ``obs`` and its step ahead on ``next_obs``, and its mixer."""
    D, H, A, n = env.obs_dim, p["hidden_dim"], env.n_actions, env.n_agents
    S, E, Hh = env.state_dim, p["embed_dim"], p["hyper_dim"]
    q_macs = D * H + 2 * H * 3 * H + H * A
    target_macs = 2 * (D * H + H * 3 * H) + 2 * H * 3 * H + H * A
    mix_macs = S * Hh + Hh * n * E + S * E + S * Hh + Hh * E + S * Hh + Hh + n * E + E
    rows = p["batch_size"] * env.episode_limit
    update = 3 * (rows * n * q_macs + rows * mix_macs) + rows * n * target_macs + rows * mix_macs
    return 2.0 * n * q_macs, 2.0 * update


class Recorder:
    """Records, in the record ``reference.run`` writes, what the program's
    first iterations do: the actions of every iteration through the one of
    update ``STEPS`` (``eps_greedy``); the losses of updates 1 to ``STEPS``
    and of ``STEPS`` later ones (``value_and_grad``); Adam's first moment
    after update 1 and the parameters after update ``STEPS``
    (``Optimizer.update``); the target after that iteration's Polyak step
    (``soft_update``); and before each of the later updates the
    generator's state, the ring's rows below ``size`` and the target, the
    parameters and Adam state before the first (``EpisodeBuffer.sample``).
    Each wrap is put back on exit."""

    def __init__(self):
        self.acts, self.iters, self.vag_calls, self.upd_calls = [], 0, 0, 0
        self.latest = self.target = self._snap_iter = None
        self.rec = {"losses": [], "late": {"rings": [], "targets": [], "updates": []}}

    @property
    def done(self) -> bool:
        return len(self.rec["losses"]) == 2 * reference.STEPS

    def __enter__(self):
        from cleanmarl_tpu_torch.algos import recurrent_q
        from cleanmarl_tpu_torch.buffers.episode import EpisodeBuffer
        from cleanmarl_tpu_torch.core import networks, optim

        S, r, late = reference.STEPS, self.rec, self.rec["late"]
        self._saved = [(recurrent_q, "eps_greedy"), (recurrent_q, "value_and_grad"),
                       (optim.Optimizer, "update"), (networks, "soft_update"),
                       (EpisodeBuffer, "sample")]
        self._saved = [(o, k, getattr(o, k)) for o, k in self._saved]
        eps_greedy, vag, upd, soft, sample = (f for _, _, f in self._saved)
        rec = self

        def eps_greedy_(generator, q, avail, epsilon):
            a = eps_greedy(generator, q, avail, epsilon)
            rec.iters += 1
            if "target3" not in r:
                rec.acts.append(a.to(torch.uint8))
            return a

        def value_and_grad_(fn, params, *args):
            loss, aux, grads = vag(fn, params, *args)
            rec.vag_calls += 1
            if rec.vag_calls <= S or len(r["losses"]) < S + len(late["updates"]):
                r["losses"].append(float(loss))
            return loss, aux, grads

        def update_(opt, grads, state, params):
            new_params, new_state = upd(opt, grads, state, params)
            rec.upd_calls += 1
            if rec.upd_calls == 1:
                r["mu1"] = common.to_cpu(opt.trees(new_state)["mu"])
            if rec.upd_calls == S:
                r["params3"] = common.to_cpu(new_params)
            rec.latest = (new_params, new_state)
            return new_params, new_state

        def soft_update_(target_params, online_params, polyak):
            out = soft(target_params, online_params, polyak)
            rec.target = out
            if rec.upd_calls >= S and "target3" not in r:
                r["target3"] = common.to_cpu(out)
            return out

        def sample_(ring, generator, batch_size):
            if "target3" in r and len(late["updates"]) < S:
                if not late["updates"]:
                    late["params"], late["opt"] = (common.to_cpu(x) for x in rec.latest)
                if rec._snap_iter != rec.iters:
                    rows = ring.size
                    late["rings"].append(common.to_cpu(
                        {"data": {k: v[:rows] for k, v in ring.data.items()},
                         "length": ring.length[:rows]}))
                    late["targets"].append(common.to_cpu(rec.target))
                    rec._snap_iter = rec.iters
                i = len(late["rings"]) - 1
                late["updates"].append({"gen_state": generator.get_state(), "ring": i,
                                        "target": i})
            return sample(ring, generator, batch_size)

        for (o, k, _), f in zip(self._saved, (eps_greedy_, value_and_grad_, update_,
                                              soft_update_, sample_)):
            setattr(o, k, f)
        return self

    def __exit__(self, *exc):
        for o, k, f in self._saved:
            setattr(o, k, f)
        self.latest = self.target = None
        if exc[0] is None:
            if not self.done:
                raise RuntimeError("the recorded blocks did not fill the check's record")
            self.rec["actions"] = [a.cpu() for a in self.acts]
        return False


class Run:
    trace_blocks = TRACE_BLOCKS

    def __init__(self, cell: dict, seed: int, device: str):
        from cleanmarl_tpu_torch.algos import recurrent_q
        from cleanmarl_tpu_torch.core.driver import to_host

        t = cell["traffic_file"]
        self.device, self.to_host = device, to_host
        cfg = recurrent_q.RecurrentQConfig(
            **cell["config_file"]["params"], num_envs=t["num_envs"],
            log_interval=t["log_interval"], device=device, seed=seed % 2**31, verbose=False)
        self.cfg = cfg
        init, self.train_block, _, self.meta = recurrent_q.make_train(cfg)
        self.act_iter, self.update_iter = self.meta["act_iter"], self.meta["update_iter"]
        runner = init(torch.Generator(device).manual_seed(common.sub_seed(seed, "init")))
        ins = common.inputs(seed, device, shapes(cell, device), GAINS)
        self.runner = runner.replace(
            params=C.tmap(torch.clone, ins["params"]),
            target_params=C.tmap(torch.clone, ins["params"]),
            **common.hand_over(runner, ins, _env_params(cell), device))
        del ins, runner
        env = C.make_env(_env_params(cell), 1, device)
        self.n_agents, self.t_max = env.n_agents, env.episode_limit
        self.flops_per_step, self.flops_per_update = flops(env, cell["config_file"]["params"])
        self.steps_per_block = self.meta["steps_per_block"]
        self.flops, self.updates = 0.0, 0
        with Recorder() as rec:
            for _ in range(MAX_RECORDED_BLOCKS):
                self.block()
                if rec.done:
                    break
        self.capture = rec.rec
        self.block()                    # one more, outside the recorder

    def _count(self, num_updates: int):
        self.flops += (self.steps_per_block * self.flops_per_step
                       + (num_updates - self.updates) * self.flops_per_update)
        self.updates = num_updates

    def block(self):
        """One ``train_block`` and its one host read → (env steps, metrics)."""
        self.runner, m = self.train_block(self.runner)
        host = self.to_host(m)
        self._count(int(host["train/num_updates"]))
        return self.steps_per_block, host

    def traced_block(self) -> int:
        """The work of one block, through the two halves of
        ``train_iter``, inside the benchmark's spans."""
        from torch.profiler import record_function

        r = self.runner
        with record_function("bench.block"):
            for _ in range(self.cfg.log_interval):
                with record_function("bench.act"):
                    r, n_ended, _ = self.act_iter(r)
                with record_function("bench.update"):
                    r = self.update_iter(r, n_ended)
            metrics = {**r.stats.rollout_metrics(), "train/loss": r.last_loss,
                       "train/grads": r.last_gnorm}
            r = r.replace(stats=r.stats.flush())
        with record_function("bench.to_host"):
            self.to_host(metrics)
        self.runner = r
        self._count(r.num_updates)
        return self.steps_per_block

    def timings(self) -> dict:
        tracing = spans.tracing_module()
        out = {"qmix.update_s": self._update_s()}
        out.update(self._span_device_s(tracing))
        out["qmix.valid_share"] = self._valid_share(tracing)
        return out

    def _update_s(self) -> float:
        """One TD update on one sampled batch, alone between device syncs,
        the mean of 3; the generator put back."""
        r = self.runner
        saved = r.generator.get_state()
        try:
            batch, mask = r.ring.sample(r.generator, self.cfg.batch_size)
            total = 0.0
            for _ in range(3):
                harness.sync(self.device)
                t0 = time.perf_counter()
                self.meta["update"](r.params, r.target_params, r.opt_state, batch, mask)
                harness.sync(self.device)
                total += time.perf_counter() - t0
            return total / 3
        finally:
            r.generator.set_state(saved)

    def _span_device_s(self, tracing) -> dict:
        """Device seconds an update inside ``net.mixer`` and an iteration
        inside ``ring.commit`` and ``ring.sample``, over one profiled block,
        or None where it launched nothing in them."""
        out = {"qmix.mixer_s": None, "qmix.ring_s": None}
        if tracing is None:
            return out
        before = self.runner.num_updates
        ops = spans.profiled_block(self, self.device, tracing)["span_ops"]
        updates = self.runner.num_updates - before

        def device_s(names):
            found = [ops[n]["device_s"] for n in names if ops.get(n, {}).get("ops")]
            return sum(found) if found else None
        mixer, ring = device_s(("net.mixer",)), device_s(("ring.commit", "ring.sample"))
        if mixer is not None and updates:
            out["qmix.mixer_s"] = mixer / updates
        if ring is not None:
            out["qmix.ring_s"] = ring / (self.trace_blocks * self.cfg.log_interval)
        return out

    def _valid_share(self, tracing):
        """The real steps' share of the sampled rows through one block, or
        None where the block ran no update."""
        if tracing is None or not hasattr(tracing, "count"):
            return None
        with tracing.recording() as rec:
            self.block()
        c = rec.counter_values()
        if not c.get("rq.padded_steps"):
            return None
        return c["rq.valid_steps"] / c["rq.padded_steps"]

    def shapes(self) -> dict:
        return {"gru": [(self.t_max, self.cfg.batch_size * self.n_agents, self.cfg.hidden_dim)]}

    def free(self):
        self.runner = self.train_block = self.meta = self.act_iter = self.update_iter = None


def setup(cell, seed, device) -> Run:
    return Run(cell, seed, device)


def check(cell: dict, seed: int, capture: dict, device: str) -> dict:
    """The numbers of the program's run against the reference's."""
    ins = common.inputs(seed, device, shapes(cell, device), GAINS)
    ref = reference.run(ref_cfg(cell), ins, device, given=capture)
    return numbers(capture, ref, ins["params"])


def numbers(prog: dict, ref: dict, init: dict) -> dict:
    """``action_gap``; the losses, the first gradient and the change after
    update ``STEPS`` (``common.training_numbers``); ``target_gap``: the
    target's change after that iteration's Polyak step, by ``norm_gap``."""
    out = {"action_gap": ref["action_gap"]}
    out.update(common.training_numbers(prog, ref, init, reference.KEYS))
    out["target_gap"] = max(
        common.norm_gap(common.delta(prog["target3"][k], init[k]),
                        common.delta(ref["target3"][k], init[k]), common.moved(ref["grads1"][k]))
        for k in reference.KEYS)
    return out


def control(cell: dict, seed: int, device: str, tf32: bool = True, fault: str = "") -> dict:
    """The reference in the program's place, in TF32 or with a fault
    planted, judged by the reference in float32."""
    ins = common.inputs(seed, device, shapes(cell, device), GAINS)
    cfg = ref_cfg(cell)
    low = common.to_cpu(reference.run(cfg, ins, device, tf32=tf32, fault=fault))
    ref = reference.run(cfg, ins, device, given=low)
    return numbers(low, ref, ins["params"])
