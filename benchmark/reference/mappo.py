"""Plain reference of recurrent MAPPO's first two iterations (a rollout and
an update each), as a block of the program runs them.

MAPPO (Yu et al., arXiv:2103.01955): a GRU actor fed each agent's
observation with its one-hot id, a centralized critic on the global state
whose value every agent shares, λ-returns, and clipped PPO over contiguous
env-axis minibatches with Adam.

- A rollout: the actor's logits from the reference's own observations and
  hidden state, the Gumbel-max draw replayed from the same generator, the
  env stepped with the actions the program chose (the program's outputs,
  judged here by how far each lies below the reference's best draw), every
  env's auto-reset drawn from the same generator.
- An update: values, λ-returns and advantages, then per optimizer step the
  actor's and critic's losses, their gradients and Adam.

Judging the program (``given``: its record), the reference follows the
first ``STEPS`` optimizer steps of update 1 from the benchmark's inputs;
then rollout 2 from its own carried env state, hidden state and generator,
acting with the program's weights after update 1; then the last ``STEPS``
steps of update 2 (the last epoch's last minibatches) from the program's
weights and Adam state before them (their losses). As the control (``given`` None) it runs both
iterations whole and records the same things.
"""
from __future__ import annotations

import torch

from benchmark.reference import common as C

STEPS = 3
KEYS = ("actor", "critic")


def run(cfg: dict, inputs: dict, device, given=None, tf32: bool = False, fault: str = ""):
    """→ the record: "actions" [per rollout (T, N, n) uint8], "losses"
    [actor, critic per recorded step], "mu1" (Adam's first moment after step
    1), "grads1", "params3", "p_mid" (after update 1), "p_late", "opt_late"
    (before update 2's last ``STEPS`` steps), and with ``given``
    "action_gap". ``fault`` plants one of the faults the check must catch
    ("half": the loss over half of each minibatch; "altered": one action
    changed where it was drawn; "unchanged": Adam's step returns the
    parameters as they were)."""
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
    out = {"actions": [], "losses": [], "action_gap": 0.0}
    late = n_steps - STEPS
    for it in range(2):
        if it == 1:
            out["p_mid"] = params = dev(given["p_mid"]) if given else params
        acts = given["actions"][it].to(device) if given else None
        carry, traj, h0, gap = rollout(cfg, env, params["actor"], carry, gen, acts, tf32,
                                       alter=fault == "altered" and it == 0)
        out["actions"].append(traj["action"].to(torch.uint8))
        out["action_gap"] = max(out["action_gap"], gap)
        full = update_batch(cfg, params["critic"], traj, carry, tf32)
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
def rollout(cfg, env, actor, carry, gen, actions, tf32, alter=False):
    """``rollout_len`` steps from ``carry`` (env state, obs, state, avail,
    hidden state) → (carry after them, trajectory, the hidden state it
    started from, the widest gap of a chosen action below the best)."""
    env_state, obs, state, avail, h = carry
    h0 = h
    cols = {k: [] for k in ("obs", "state", "avail", "action", "logp", "reward", "ended")}
    gap = torch.zeros((), device=h.device)
    with C.precision(tf32):
        for t in range(cfg["rollout_len"]):
            h2, logits = C.rnn_step(actor, h, obs)
            logits = C.masked(logits, avail)
            scores = C.gumbel_scores(logits, gen)
            a = scores.argmax(-1) if actions is None else actions[t].long()
            if alter and t == 0:
                a = C.altered(a, scores)
            gap = torch.maximum(gap, C.gap_below_best(scores, a).max())
            logp = torch.log_softmax(logits, -1).gather(-1, a[..., None])[..., 0]
            env_state, ts2, _ = env.step(env_state, a, gen)
            ended = ts2.done | ts2.truncated
            h = torch.where(ended[:, None, None], 0.0, h2)
            for k, v in (("obs", obs), ("state", state), ("avail", avail), ("action", a),
                         ("logp", logp), ("reward", ts2.reward), ("ended", ended)):
                cols[k].append(v)
            obs, state, avail = ts2.obs, ts2.state, ts2.avail
    traj = {k: torch.stack(v) for k, v in cols.items()}
    return (env_state, obs, state, avail, h), traj, h0, float(gap)


@torch.no_grad()
def update_batch(cfg, critic, traj, carry, tf32):
    """The update's data: the trajectory with λ-returns and advantages from
    the critic's values, bootstrapped on the state after the rollout."""
    T, N, n_agents = traj["action"].shape
    with C.precision(tf32):
        values = C.mlp(critic, traj["state"])[..., 0]                 # (T, N)
        vboot = C.mlp(critic, carry[2])[..., 0]
        G, A = C.lambda_returns(traj["reward"], traj["ended"], values, vboot,
                                cfg["gamma"], cfg["td_lambda"])
    full = dict(traj)
    full["returns"] = G[..., None].expand(T, N, n_agents)
    full["adv"] = A[..., None].expand(T, N, n_agents)
    return full


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

    def actor_loss(p):
        logits = C.masked(C.rnn_seq(p, h0[sl], batch["obs"],
                                    batch["ended"][..., None].expand(-1, -1, n_agents)),
                          batch["avail"])
        logp_all = torch.log_softmax(logits, -1)
        logp = logp_all.gather(-1, batch["action"][..., None])[..., 0]
        ratio = torch.exp(logp - batch["logp"])
        pg = torch.minimum(batch["adv"] * ratio,
                           batch["adv"] * ratio.clamp(1.0 - clip, 1.0 + clip)).mean()
        entropy = (-(logp_all.exp() * logp_all).sum(-1)).mean()
        return -pg - cfg["entropy_coef"] * entropy

    def critic_loss(p):
        v = C.mlp(p, batch["state"])[..., 0]
        return torch.square(v[..., None] - batch["returns"]).mean()

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
