"""Plain reference of recurrent MAPPO's first two iterations with the MAPPO
paper's practices on SMAC (Yu et al., arXiv:2103.01955): death masking,
value normalization and advantage normalization.

The record, ``STEPS``, ``KEYS``, the ``given`` protocol and the faults are
``reference/mappo.py``'s; the rollout is its ``rollout``. What this module
adds, over a trajectory of T steps, N envs and n agents:

- Alive mask: ``alive[t, e, i] = 1`` where agent i has an action besides
  the no-op available, or its no-op is unavailable; else 0 (a dead agent
  has only the no-op).
- Denormalized values: with value normalization, the critic's values and
  the bootstrap are first mapped as ``v · (sqrt(var) + 1e-8) + mean``, with
  the running statistics from before this update; the λ-returns G and the
  advantages A = G − V follow from them.
- Weighted means: ``wmean(x) = Σ x · w / max(Σ w, 1)`` over the whole
  (T, N, n) batch, ``w`` the alive mask with death masking, else 1.
- Advantages: ``A ← (A − m) / (sqrt(s) + 1e-8)``, ``m = wmean(A)``,
  ``s = wmean((A − m)²)``.
- Running statistics: (mean, var, count) start at (0, 1, 1e-4); each
  update merges G's batch (``b_m = wmean(G)``, ``b_v = wmean((G − b_m)²)``,
  ``b_c = max(Σ w, 1)``) as Welford's parallel merge: ``c' = c + b_c``,
  ``d = b_m − mean``, ``mean' = mean + d · b_c / c'``, ``var' = (var · c +
  b_v · b_c + d² · c · b_c / c') / c'``. Then ``G ← (G − mean') /
  (sqrt(var') + 1e-8)``, the critic's target. The statistics carry from
  update 1 into update 2.
- Losses: in the actor's clipped objective, its entropy and the critic's
  squared error every mean over the minibatch becomes
  ``Σ x · w / max(Σ w over the minibatch, 1)``.

Departures from the paper's own description, each as the program has it:

- Death masking here weights dead agents' loss terms by 0 (the paper's
  code's active masks); the paper describes feeding the critic a zero
  state with the agent's id for dead agents. The critic here sees the one
  global state, its value shared by every agent.
- Value normalization keeps an exact running mean and variance of every
  target so far (the Welford merge above); the paper's keeps exponential
  moving averages (PopArt-style, β close to 1).
- The critic's loss is the plain squared error: no value clipping and no
  Huber loss, which the paper's code also applies.
- Advantage normalization divides by ``sqrt(s) + 1e-8``, not ``+ 1e-5``.
"""
from __future__ import annotations

import torch

from benchmark.reference import common as C
from benchmark.reference.mappo import KEYS, STEPS, rollout

__all__ = ["KEYS", "STEPS", "alive_mask", "run"]


def alive_mask(avail):
    """(T, N, n, actions) availability → (T, N, n) float 1/0."""
    a = avail.float()
    return ((a.sum(-1) > 1.0) | (a[..., 0] == 0.0)).float()


def wmean(x, w):
    return (x * w).sum() / torch.clamp(w.sum(), min=1.0)


def vnorm_init(device):
    return {"mean": torch.zeros((), device=device), "var": torch.ones((), device=device),
            "count": torch.full((), 1e-4, device=device)}


def vnorm_merge(vn, batch, w):
    """Welford's merge of ``batch``'s weighted mean and variance into the
    running statistics."""
    bm = wmean(batch, w)
    bv = wmean(torch.square(batch - bm), w)
    bc = torch.clamp(w.sum(), min=1.0)
    tot = vn["count"] + bc
    d = bm - vn["mean"]
    mean = vn["mean"] + d * bc / tot
    m2 = vn["var"] * vn["count"] + bv * bc + torch.square(d) * vn["count"] * bc / tot
    return {"mean": mean, "var": m2 / tot, "count": tot}


def run(cfg: dict, inputs: dict, device, given=None, tf32: bool = False, fault: str = ""):
    """→ ``reference/mappo.run``'s record, with "alive" (per rollout the
    alive mask's sum and its element count). ``fault`` plants one of the
    faults the check must catch ("half": each loss over half of each
    minibatch; "altered": one action changed where it was drawn;
    "unchanged": Adam's step returns the parameters as they were)."""
    n_steps = cfg["epochs"] * cfg["num_minibatches"]
    if n_steps < 2 * STEPS:
        raise ValueError("the reference records the first and the last steps of an update")

    def dev(tree):
        return C.tmap(lambda x: x.to(device) if torch.is_tensor(x) else x, tree)

    env = C.make_env(cfg, cfg["num_envs"], device)
    gen = torch.Generator(device).manual_seed(inputs["gen_seed"])
    env_state, ts = env.reset(torch.Generator(device).manual_seed(inputs["reset_seed"]))
    carry = (env_state, ts.obs, ts.state, ts.avail,
             torch.zeros((cfg["num_envs"], env.n_agents, cfg["actor_hidden_dim"]),
                         device=device))
    params = {k: inputs["params"][k] for k in KEYS}
    opt = {k: C.adam_init(v) for k, v in params.items()}
    vnorm = vnorm_init(device)
    out = {"actions": [], "losses": [], "action_gap": 0.0, "alive": []}
    late = n_steps - STEPS
    for it in range(2):
        if it == 1:
            out["p_mid"] = params = dev(given["p_mid"]) if given else params
        acts = given["actions"][it].to(device) if given else None
        carry, traj, h0, gap = rollout(cfg, env, params["actor"], carry, gen, acts, tf32,
                                       alter=fault == "altered" and it == 0)
        out["actions"].append(traj["action"].to(torch.uint8))
        out["action_gap"] = max(out["action_gap"], gap)
        full, vnorm = update_batch(cfg, params["critic"], traj, carry, vnorm, tf32)
        out["alive"].append((float(full["alive"].sum()), full["alive"].numel()))
        if it == 0:
            steps = range(STEPS) if given else range(n_steps)
        else:
            if given:
                params, opt = dev(given["p_late"]), dev(given["opt_late"])
            else:
                for k in range(late):
                    params, opt, _ = opt_step(cfg, full, h0, params, opt, k, tf32, fault)
            out["p_late"], out["opt_late"] = params, opt
            steps = range(late, n_steps)
        for k in steps:
            params, opt, rec = opt_step(cfg, full, h0, params, opt, k, tf32, fault)
            if it == 1 or k < STEPS:
                out["losses"] += rec["losses"]
            if it == 0 and k == 0:
                out["grads1"] = rec["grads"]
                out["mu1"] = {key: opt[key]["mu"] for key in KEYS}
            if it == 0 and k == STEPS - 1:
                out["params3"] = params
    return out


@torch.no_grad()
def update_batch(cfg, critic, traj, carry, vnorm, tf32):
    """The update's data (the trajectory with the alive weights, the
    critic's targets and the advantages) and the running statistics after
    it."""
    T, N, n_agents = traj["action"].shape
    w = (alive_mask(traj["avail"]) if cfg["death_masking"]
         else torch.ones((T, N, n_agents), device=traj["reward"].device))
    with C.precision(tf32):
        values = C.mlp(critic, traj["state"])[..., 0]                 # (T, N)
        vboot = C.mlp(critic, carry[2])[..., 0]
        if cfg["normalize_values"]:
            sigma = torch.sqrt(vnorm["var"]) + 1e-8
            values = values * sigma + vnorm["mean"]
            vboot = vboot * sigma + vnorm["mean"]
        G, A = C.lambda_returns(traj["reward"], traj["ended"], values, vboot,
                                cfg["gamma"], cfg["td_lambda"])
    G = G[..., None].expand(T, N, n_agents)
    A = A[..., None].expand(T, N, n_agents)
    if cfg["normalize_advantage"]:
        m = wmean(A, w)
        A = (A - m) / (torch.sqrt(wmean(torch.square(A - m), w)) + 1e-8)
    if cfg["normalize_values"]:
        vnorm = vnorm_merge(vnorm, G, w)
        G = (G - vnorm["mean"]) / (torch.sqrt(vnorm["var"]) + 1e-8)
    full = dict(traj)
    full["returns"], full["adv"], full["alive"] = G, A, w
    return full, vnorm


def opt_step(cfg, full, h0, params, opt, k, tf32, fault=""):
    """Optimizer step ``k`` of an update (minibatch ``k`` mod the number of
    minibatches) → (params, Adam state, {"losses", "grads"})."""
    n_mb = cfg["num_minibatches"]
    mb = full["action"].shape[1] // n_mb
    i = k % n_mb
    sl = slice(i * mb, i * mb + (mb // 2 if fault == "half" else mb))
    batch = {key: v[:, sl] for key, v in full.items()}
    n_agents = batch["action"].shape[-1]
    clip = cfg["ppo_clip"]
    w = batch["alive"]

    def wsum(x):
        return (x * w).sum() / torch.clamp(w.sum(), min=1.0)

    def actor_loss(p):
        logits = C.masked(C.rnn_seq(p, h0[sl], batch["obs"],
                                    batch["ended"][..., None].expand(-1, -1, n_agents)),
                          batch["avail"])
        logp_all = torch.log_softmax(logits, -1)
        logp = logp_all.gather(-1, batch["action"][..., None])[..., 0]
        ratio = torch.exp(logp - batch["logp"])
        pg = wsum(torch.minimum(batch["adv"] * ratio,
                                batch["adv"] * ratio.clamp(1.0 - clip, 1.0 + clip)))
        entropy = wsum(-(logp_all.exp() * logp_all).sum(-1))
        return -pg - cfg["entropy_coef"] * entropy

    def critic_loss(p):
        v = C.mlp(p, batch["state"])[..., 0]
        return wsum(torch.square(v[..., None] - batch["returns"]))

    with C.precision(tf32):
        la, ga = C.grads_of(actor_loss, params["actor"])
        lc, gc = C.grads_of(critic_loss, params["critic"])
        with torch.no_grad():
            new, new_opt = {}, {}
            for key, g, lr in (("actor", ga, cfg["learning_rate_actor"]),
                               ("critic", gc, cfg["learning_rate_critic"])):
                new[key], new_opt[key] = C.adam_step(g, opt[key], params[key], lr)
    if fault == "unchanged":
        new = params
    return new, new_opt, {"losses": [float(la), float(lc)],
                          "grads": {"actor": ga, "critic": gc}}
