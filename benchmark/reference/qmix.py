"""Plain reference of recurrent QMIX's first iterations at the port's
``qmix_rnn_3m`` recipe, as the program's ``train_iter`` runs them.

QMIX (Rashid et al., arXiv:1803.11485): per-agent GRU Q-nets (fc1 → GRU →
head, fed each agent's observation with its one-hot id) whose Qs a mixing
network folds into Q_tot; hypernetworks make the mixer's weights from the
global state and the mixing weights are taken as |·|, so that Q_tot is
monotonic in every agent's Q. It learns by TD on whole replayed episodes
against a target network. An iteration, from the benchmark's inputs
(weights, first env state, generator seed):

- acting: each agent's Q from its GRU carry, which is zeroed where the
  env's episode ended; ε-greedy from the generator in the program's
  order: one uniform an env, then a uniform draw among the available
  actions (Gumbel max), else the masked argmax; ε linear over
  ``exploration_fraction × total_timesteps`` env steps;
- the env batch (the frozen SMAClite, ``common.VecEnv``) stepped with
  those actions and auto-reset from the same generator;
- each env's episode kept step by step and, when it ends, padded with
  zeros to T_max with its length and committed to the ring at the
  cursor, the envs in order;
- the cadence: once the ring holds a batch, one update a completed
  episode, at most ``max_updates_per_iter`` an iteration, the rest
  carried as debt;
- an update: ``batch_size`` rows drawn uniformly from the generator; the
  TD target r + γ(1 − d)·Q_tot′ from the target network (its GRU stream on
  ``obs`` from zeros, its head one GRU step ahead on ``next_obs``, the
  max over ``next_avail``, the target mixer on ``next_state``); the loss
  Σ m·(target − Q_tot)² / max(Σ m, 1) over the step mask m; Adam;
- after an iteration's k updates, one Polyak step with
  τ_k = 1 − (1 − τ)^k in float32, which is k steps in a row.

Departures from the paper, each the program's, which it follows from the
JAX package:

- Adam, not RMSprop;
- a Polyak step each update (τ = 0.005), not a copy of the online network
  into the target every 200 episodes;
- one exploration draw per env, not per agent: an env's agents explore
  together;
- T_max = 150, SMAClite's limit for 3m, not SMAC's 60;
- episodes padded to T_max and masked, where pymarl trims a batch to its
  longest episode.

Judging the program (``given``: its record), the reference runs stage 1
from the inputs, acting with the program's actions (each judged where it
was drawn), through the iteration of the ``STEPS``-th update and its
Polyak step; then stage 2: ``STEPS`` later updates from the program's
parameters, Adam state and targets, each from the ring's rows below
``size`` and the generator's state as the program had them just before
it (their losses). As the control (``given`` None) it runs on from stage
1 with its own draws and records the same things.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import common as C

STEPS = 3
KEYS = ("q", "mixer")
FIELDS = ("obs", "state", "action", "reward", "done", "next_obs", "next_state", "next_avail")


def epsilon(cfg: dict, it: int) -> float:
    """ε at iteration ``it``: linear from ``start_e`` to ``end_e`` over
    ``exploration_fraction × total_timesteps`` env steps, in float32."""
    duration = cfg["exploration_fraction"] * cfg["total_timesteps"]
    slope = np.float32((cfg["end_e"] - cfg["start_e"]) / duration)
    t = np.float32(it * cfg["num_envs"])
    return float(np.maximum(slope * t + np.float32(cfg["start_e"]), np.float32(cfg["end_e"])))


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------
def mixer(p, qs, state):
    """Q_tot from the agents' Qs (..., n) and the state (..., S)."""
    embed = p["hb1"]["b"].shape[0]
    w1 = torch.abs(C.mlp(p["hw1"], state)).reshape(state.shape[:-1] + (qs.shape[-1], embed))
    b1 = C.dense(p["hb1"], state)
    hidden = torch.nn.functional.elu((qs[..., None] * w1).sum(-2) + b1)
    w2 = torch.abs(C.mlp(p["hw2"], state))
    return (hidden * w2).sum(-1) + C.mlp(p["hb2"], state)[..., 0]


def q_stream(p, obs):
    """The Q-net over time-major ``obs`` (T, ..., D) from a zero carry."""
    h0 = torch.zeros(obs.shape[1:-1] + (p["gru"]["wh"].shape[0],), device=obs.device)
    return C.rnn_seq(p, h0, obs)


def q_ahead(p, obs, next_obs):
    """The target's Qs: the carry advanced on ``obs`` from zeros, the head
    read one GRU step ahead on ``next_obs`` at every t."""
    gi, gn = C.input_proj(p, obs), C.input_proj(p, next_obs)
    h = torch.zeros(gi.shape[1:-1] + (gi.shape[-1] // 3,), device=obs.device)
    ahead = []
    for t in range(gi.shape[0]):
        h = C.gru_cell(p["gru"], h, gi[t])
        ahead.append(C.gru_cell(p["gru"], h, gn[t]))
    return C.dense(p["head"], torch.stack(ahead))


def td_grads(cfg, params, target, batch, mask):
    """→ (loss, grads) of one TD update on sampled episodes (B, T, ...)."""
    tm = {k: v.movedim(0, 1) for k, v in batch.items()}
    m = mask.t()
    with torch.no_grad():
        q_next = q_ahead(target["q"], tm["obs"], tm["next_obs"])
        best = torch.where(tm["next_avail"], q_next, C.MASK_NEG).max(-1).values
        y = tm["reward"] + cfg["gamma"] * (1.0 - tm["done"].float()) * \
            mixer(target["mixer"], best, tm["next_state"])

    def loss(p):
        q = q_stream(p["q"], tm["obs"])
        q_taken = q.gather(-1, tm["action"][..., None])[..., 0]
        err = torch.square(y - mixer(p["mixer"], q_taken, tm["state"])) * m
        return err.sum() / torch.clamp(m.sum(), min=1.0)

    return C.grads_of(loss, params)


def polyak(cfg, target, params, k):
    """k Polyak steps in a row as one, τ_k = 1 − (1 − τ)^k in float32."""
    tau = float(np.float32(1.0) - np.float32(1.0 - cfg["polyak"]) ** np.float32(k))
    return C.tmap(lambda t, o: (1.0 - tau) * t + tau * o, target, params)


# ---------------------------------------------------------------------------
# the ring of episodes
# ---------------------------------------------------------------------------
class Ring:
    """Episodes in the order committed, row ``cursor`` next, ``capacity``
    rows at most."""

    def __init__(self, capacity: int):
        self.capacity, self.rows, self.lengths, self.cursor = capacity, [], [], 0

    def commit(self, episode: dict, length: int):
        if self.cursor == len(self.rows):
            self.rows.append(episode)
            self.lengths.append(length)
        else:
            self.rows[self.cursor], self.lengths[self.cursor] = episode, length
        self.cursor = (self.cursor + 1) % self.capacity

    def snapshot(self, device) -> dict:
        """Every stored row as the program's ring holds its rows below
        ``size``: {"data": {field: (size, T, ...)}, "length": (size,)}."""
        return {"data": {k: torch.stack([r[k] for r in self.rows]) for k in FIELDS},
                "length": torch.tensor(self.lengths, dtype=torch.int64, device=device)}


def sample(ring: dict, gen, batch_size: int):
    """``batch_size`` rows drawn uniformly → (batch, step mask (B, T))."""
    length = ring["length"]
    idx = torch.randint(0, max(length.shape[0], 1), (batch_size,), generator=gen,
                        device=length.device)
    batch = {k: v[idx] for k, v in ring["data"].items()}
    t_max = batch["obs"].shape[1]
    mask = (torch.arange(t_max, device=length.device)[None, :] < length[idx][:, None]).float()
    return batch, mask


def update(cfg, params, target, opt, ring, gen, tf32, fault=""):
    """One TD update → (params, Adam state, loss, grads)."""
    batch, mask = sample(ring, gen, cfg["batch_size"])
    if fault == "half":
        half = cfg["batch_size"] // 2
        batch, mask = {k: v[:half] for k, v in batch.items()}, mask[:half]
    with C.precision(tf32):
        loss, grads = td_grads(cfg, params, target, batch, mask)
        with torch.no_grad():
            new, opt = C.adam_step(grads, opt, params, cfg["learning_rate"])
    return (params if fault == "unchanged" else new), opt, float(loss), grads


# ---------------------------------------------------------------------------
# acting
# ---------------------------------------------------------------------------
@torch.no_grad()
def act(cfg, q_params, h, obs, avail, eps, gen, chosen, tf32, alter):
    """ε-greedy from the generator → (h', actions taken, the widest gap of a
    taken action, whether an action was altered). ``chosen``: the
    program's actions, judged and taken (None: the reference's own).
    On an exploring env an action must be the uniform draw, else the gap
    is inf; on a greedy one the gap is its Q's below the best available
    Q. ``alter``: the first greedy agent with more than one action to
    choose from takes its worst."""
    with C.precision(tf32):
        h2, q = C.rnn_step(q_params, h, obs)
    explore = torch.rand((obs.shape[0],), generator=gen, device=obs.device) < eps
    allowed = avail.bool()
    drawn = C.gumbel_scores(torch.where(allowed, 0.0, float("-inf")), gen).argmax(-1)
    q_avail = torch.where(allowed, q, float("-inf"))
    own = torch.where(explore[:, None], drawn, q_avail.argmax(-1))
    altered = False
    if alter:
        worst = torch.where(allowed, q, float("inf")).argmin(-1)
        candidates = (~explore[:, None] & (allowed.sum(-1) > 1)).flatten()
        if bool(candidates.any()):
            first = int(candidates.int().argmax())
            own = own.clone().flatten()
            own[first] = worst.flatten()[first]
            own, altered = own.view_as(worst), True
    a = own if chosen is None else chosen.long()
    greedy_gap = q_avail.max(-1).values - q_avail.gather(-1, a[..., None])[..., 0]
    gap = torch.where(explore[:, None], torch.where(a == drawn, 0.0, float("inf")),
                      greedy_gap)
    return h2, a, float(gap.max()), altered


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------
def run(cfg: dict, inputs: dict, device, given=None, tf32: bool = False, fault: str = ""):
    """→ the record: "actions" [per iteration of stage 1, (N, n) uint8],
    "losses" (stage 1's first ``STEPS`` updates, then stage 2's), "mu1"
    (Adam's first moment after update 1), "grads1", "params3" (after
    update ``STEPS``), "target3" (after that iteration's Polyak step),
    "late" (stage 2's inputs: "params", "opt", "rings", "targets" and per
    update its "gen_state" and the index of its ring and target), and with
    ``given`` "action_gap". ``fault`` plants one of the faults the check
    must catch ("half": the TD loss over half the sampled episodes;
    "altered": one greedy action made the worst available; "unchanged":
    Adam returns the parameters as they were; "frozen_target": no Polyak
    step)."""
    def dev(tree):
        return C.tmap(lambda x: x.to(device) if torch.is_tensor(x) else x, tree)

    env = C.make_env(cfg, cfg["num_envs"], device)
    N, n, t_max = cfg["num_envs"], env.n_agents, env.episode_limit
    B, tf = cfg["batch_size"], cfg["train_freq"]
    n_slots = cfg["max_updates_per_iter"] if cfg["max_updates_per_iter"] > 0 else N
    gen = torch.Generator(device).manual_seed(inputs["gen_seed"])
    env_state, ts = env.reset(torch.Generator(device).manual_seed(inputs["reset_seed"]))
    obs, state, avail = ts.obs, ts.state, ts.avail
    h = torch.zeros((N, n, cfg["hidden_dim"]), device=device)
    params = {k: inputs["params"][k] for k in KEYS}
    target, opt = params, C.adam_init(params)
    ring = Ring(cfg["buffer_size"])
    acc, steps = None, torch.zeros((N,), dtype=torch.int64, device=device)
    envs = torch.arange(N, device=device)
    out = {"actions": [], "losses": [], "action_gap": 0.0}
    late = {"rings": [], "targets": [], "updates": []}
    it = episodes = debt = n_updates = 0
    alter = fault == "altered"
    while "target3" not in out or not given and len(late["updates"]) < STEPS:
        stage1 = "target3" not in out
        chosen = None
        if given is not None:
            if it >= len(given["actions"]):          # the program stopped short
                out["action_gap"] = float("inf")
                break
            chosen = given["actions"][it].to(device)
        h2, a, gap, altered = act(cfg, params["q"], h, obs, avail, epsilon(cfg, it), gen,
                                  chosen, tf32, alter and stage1)
        alter = alter and not altered
        if stage1:
            out["actions"].append(a.to(torch.uint8))
            out["action_gap"] = max(out["action_gap"], gap)
        env_state, ts2, final = env.step(env_state, a, gen)
        ended = ts2.done | ts2.truncated
        h = torch.where(ended[:, None, None], 0.0, h2)
        rec = {"obs": obs, "state": state, "action": a, "reward": ts2.reward,
               "done": ts2.done if cfg["bootstrap_truncation"] else ended,
               "next_obs": final.obs, "next_state": final.state,
               "next_avail": final.avail.bool()}
        if acc is None:
            acc = {k: torch.zeros((N, t_max) + v.shape[1:], dtype=v.dtype, device=device)
                   for k, v in rec.items()}
        for k, v in rec.items():
            acc[k][envs, steps] = v
        steps = steps + 1
        for e in ended.nonzero()[:, 0].tolist():           # the envs in order
            ring.commit({k: acc[k][e].clone() for k in FIELDS}, int(steps[e]))
            for k in FIELDS:
                acc[k][e] = 0
            steps[e] = 0
        obs, state, avail = ts2.obs, ts2.state, ts2.avail
        prev, episodes = episodes, episodes + int(ended.sum())
        due = episodes // tf - prev // tf if len(ring.rows) >= B else 0
        n_run = min(debt + due, n_slots)
        debt += due - n_run
        snap = None
        for _ in range(n_run):
            if not stage1 and len(late["updates"]) < STEPS:
                if not late["updates"]:
                    late["params"], late["opt"] = params, opt
                if snap is None:
                    late["rings"].append(ring.snapshot(device))
                    late["targets"].append(target)
                    snap = len(late["rings"]) - 1
                late["updates"].append({"gen_state": gen.get_state(), "ring": snap,
                                        "target": snap})
            rows = ring.snapshot(device) if snap is None else late["rings"][snap]
            params, opt, loss, grads = update(cfg, params, target, opt, rows, gen, tf32, fault)
            n_updates += 1
            if n_updates <= STEPS or not stage1 and len(out["losses"]) < 2 * STEPS:
                out["losses"].append(loss)
            if n_updates == 1:
                out["grads1"], out["mu1"] = grads, opt["mu"]
            if n_updates == STEPS:
                out["params3"] = params
            if not stage1 and len(out["losses"]) == 2 * STEPS:
                break
        prev_t = (n_updates - n_run) * tf
        due_t = (prev_t + n_run * tf) // cfg["target_network_update_freq"] - \
            prev_t // cfg["target_network_update_freq"]
        if due_t > 0 and fault != "frozen_target":
            target = polyak(cfg, target, params, due_t)
        if stage1 and n_updates >= STEPS:
            out["target3"] = target
        it += 1
    if given is not None and "late" in given:
        g = given["late"]
        params, opt = dev(g["params"]), dev(g["opt"])
        for u in g["updates"]:
            gen2 = torch.Generator(device)
            gen2.set_state(u["gen_state"])
            params, opt, loss, _ = update(cfg, params, dev(g["targets"][u["target"]]), opt,
                                          dev(g["rings"][u["ring"]]), gen2, tf32)
            out["losses"].append(loss)
    else:
        out["late"] = late
    return out
