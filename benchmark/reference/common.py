"""Plain PyTorch pieces that the benchmark's references share.

Everything here is written out from the published algorithms (fc1 → GRU →
head networks in nn.GRUCell's gate order, optax's Adam, λ-returns) in
float32 with no kernel, no cache and no batching trick. It imports nothing of the program: the benchmark makes the
inputs (weights, the first env state, the generator's seed) and hands the
same ones to the program and to these functions.
"""
from __future__ import annotations

import dataclasses
import math
from contextlib import contextmanager
from typing import Dict

import numpy as np
import torch

MASK_NEG = -1e9          # the logit of an unavailable action
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults


@dataclasses.dataclass(frozen=True)
class TimeStep:
    obs: torch.Tensor
    state: torch.Tensor
    avail: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    truncated: torch.Tensor
    info: Dict[str, torch.Tensor]

    def replace(self, **kw) -> "TimeStep":
        return dataclasses.replace(self, **kw)


@contextmanager
def precision(tf32: bool):
    """float32 matmuls with TF32 off (the reference), or on (its control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# trees (nested dicts and lists of tensors)
# ---------------------------------------------------------------------------
def tmap(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tmap(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [tmap(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
    return fn(tree, *rest)


def leaves(tree, prefix=""):
    """[(path, leaf)] in a fixed order; dicts and lists are nodes, anything
    else (a tensor, a shape tuple) a leaf."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree) for x in leaves(t, f"{prefix}/{i}")]
    return [(prefix, tree)]


def unflatten(tree, flat):
    it = iter(flat)
    return tmap(lambda _: next(it), tree)


# ---------------------------------------------------------------------------
# inputs the benchmark makes
# ---------------------------------------------------------------------------
def shapes_rnn(in_dim, hidden, out_dim):
    return {"fc1": {"w": (in_dim, hidden), "b": (hidden,)},
            "gru": {"wi": (hidden, 3 * hidden), "wh": (hidden, 3 * hidden),
                    "bi": (3 * hidden,), "bh": (3 * hidden,)},
            "head": {"w": (hidden, out_dim), "b": (out_dim,)}}


def shapes_mlp(in_dim, hidden, out_dim, num_layers=1):
    layers, d = [], in_dim
    for _ in range(num_layers + 1):
        layers.append({"w": (d, hidden), "b": (hidden,)})
        d = hidden
    return {"layers": layers, "head": {"w": (d, out_dim), "b": (out_dim,)}}


def make_weights(shapes, gains: Dict[str, float], seed: int, device) -> dict:
    """Random weights for a tree of shapes, from one draw on ``device``:
    each matrix N(0, gain² / fan_in) (the scale of an orthogonal init of
    that gain), each bias N(0, 0.1²), so that no gradient is zero by
    construction. ``gains`` maps a path suffix (``"/head/w"``) to its gain;
    other matrices take √2, the GRU's take 1."""
    flat = leaves(shapes)
    total = sum(math.prod(s) for _, s in flat)
    gen = torch.Generator(device).manual_seed(seed)
    z = torch.randn((total,), generator=gen, device=device)
    out, at = [], 0
    for path, shape in flat:
        n = math.prod(shape)
        x = z[at:at + n].reshape(shape)
        at += n
        if len(shape) == 2:
            gain = next((g for k, g in gains.items() if path.endswith(k)),
                        1.0 if "/gru/" in path else math.sqrt(2.0))
            x = x * (gain / math.sqrt(shape[0]))
        else:
            x = x * 0.1
        out.append(x.contiguous())
    return unflatten(shapes, out)


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------
def dense(p, x):
    return x @ p["w"] + p["b"]


def mlp(p, x):
    for layer in p["layers"]:
        x = torch.relu(dense(layer, x))
    return dense(p["head"], x)


def gru_cell(p, h, gi):
    """One GRU step from the input projection gi = x @ wi + bi (gates r, z,
    n; the reset gate multiplies the hidden side's projection)."""
    gh = h @ p["wh"] + p["bh"]
    ir, iz, in_ = gi.chunk(3, -1)
    hr, hz, hn = gh.chunk(3, -1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(in_ + r * hn)
    return (1.0 - z) * n + z * h


def input_proj(p, x):
    return torch.relu(dense(p["fc1"], x)) @ p["gru"]["wi"] + p["gru"]["bi"]


def rnn_step(p, h, x):
    """fc1 → ReLU → GRU → head, one step → (h', out)."""
    h2 = gru_cell(p["gru"], h, input_proj(p, x))
    return h2, dense(p["head"], h2)


def rnn_seq(p, h0, x_seq, reset_seq=None):
    """fc1 → GRU → head over a time-major sequence; the carry is zeroed after
    step t's output where ``reset_seq[t]`` is set → out_seq (T, ..., out)."""
    gi = input_proj(p, x_seq)
    h, outs = h0, []
    for t in range(gi.shape[0]):
        h2 = gru_cell(p["gru"], h, gi[t])
        outs.append(h2)
        h = h2 if reset_seq is None else torch.where(reset_seq[t][..., None], 0.0, h2)
    return dense(p["head"], torch.stack(outs))


def masked(logits, avail):
    return torch.where(avail.bool(), logits, MASK_NEG)


# ---------------------------------------------------------------------------
# sampling, optimizer, returns
# ---------------------------------------------------------------------------
def gumbel_scores(logits, generator):
    """The Gumbel-max draw of a categorical: ``logits − log(−log u)`` with
    one uniform per entry from ``generator``; the sample is its argmax."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32).clamp_(min=torch.finfo(torch.float32).tiny)
    return logits - torch.log(-torch.log(u))


def gap_below_best(scores, chosen):
    """How far the chosen entry's score lies below the best score, per row."""
    return scores.max(-1).values - scores.gather(-1, chosen[..., None])[..., 0]


def altered(actions, scores):
    """The fault "an answer altered where it is produced": the first agent,
    env by env, with more than one action to choose from (env 0's first
    where it has) takes its lowest-scoring available action instead."""
    worst = torch.where(scores > MASK_NEG / 2, scores, float("inf")).argmin(-1)
    first = int((worst != actions).flatten().int().argmax())
    out = actions.clone().flatten()
    out[first] = worst.flatten()[first]
    return out.view_as(actions)


def adam_init(params):
    return {"count": 0, "mu": tmap(torch.zeros_like, params),
            "nu": tmap(torch.zeros_like, params)}


def adam_step(grads, state, params, lr):
    """optax.adam (b1 0.9, b2 0.999, eps 1e-8) then ``p + u``; the bias
    corrections in float32 on the host, as optax computes them."""
    count = state["count"] + 1
    c1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** np.float32(count))
    c2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** np.float32(count))
    mu = tmap(lambda m, g: ADAM_B1 * m + (1.0 - ADAM_B1) * g, state["mu"], grads)
    nu = tmap(lambda v, g: ADAM_B2 * v + (1.0 - ADAM_B2) * g * g, state["nu"], grads)
    upd = tmap(lambda m, v: -lr * (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS), mu, nu)
    new = tmap(lambda p, u: p + u, params, upd)
    return new, {"count": count, "mu": mu, "nu": nu}


def grads_of(loss_fn, params):
    """→ (loss, grads) with autograd over a tree of leaves."""
    flat = [x.detach().requires_grad_(True) for _, x in leaves(params)]
    loss = loss_fn(unflatten(params, flat))
    g = torch.autograd.grad(loss, flat)
    return loss.detach(), unflatten(params, [x.detach() for x in g])


def lambda_returns(reward, ended, values, bootstrap, gamma, lam):
    """G_t = r_t + γ(1 − e_t)(λ G_{t+1} + (1 − λ) V_{t+1}), G_T = V_T → (G, G − V)."""
    T = reward.shape[0]
    g_next, v_next = bootstrap, bootstrap
    out = [None] * T
    for t in range(T - 1, -1, -1):
        g = reward[t] + gamma * (1.0 - ended[t].float()) * (lam * g_next + (1.0 - lam) * v_next)
        out[t] = g
        g_next, v_next = g, values[t]
    G = torch.stack(out)
    return G, G - values


# ---------------------------------------------------------------------------
# the env batch: SMAClite's maps, agent ids on the observation, auto-reset
# ---------------------------------------------------------------------------
class VecEnv:
    """``num_envs`` copies of ``env``, with one-hot agent ids appended to each
    observation where ``agent_ids`` is set; an env that ends takes a fresh
    reset's obs, state and avail (every step draws a reset for the whole
    batch, as the program does), the step's reward and end flags kept."""

    def __init__(self, env, num_envs: int, agent_ids: bool):
        self.env, self.num_envs, self.agent_ids = env, num_envs, agent_ids
        self.n_agents, self.n_actions = env.n_agents, env.n_actions
        self.obs_dim = env.obs_dim + (env.n_agents if agent_ids else 0)
        self.state_dim = env.state_dim
        self.episode_limit = env.episode_limit
        self.eye = torch.eye(env.n_agents, device=env.device)

    def _ids(self, ts):
        if not self.agent_ids:
            return ts
        eye = self.eye.expand(ts.obs.shape[0], -1, -1)
        return ts.replace(obs=torch.cat([ts.obs, eye], dim=-1))

    def reset(self, generator):
        s, ts = self.env._reset(self.num_envs, generator)
        return s, self._ids(ts)

    def step(self, state, actions, generator):
        """→ (state', ts with the reset's obs where ended, final ts)."""
        s2, ts = self.env._step(state, actions, generator)
        ts = self._ids(ts)
        r_state, r_ts = self.reset(generator)
        ended = ts.done | ts.truncated

        def pick(a, b):
            return torch.where(ended.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
        new_state = type(s2)(**{f.name: pick(getattr(r_state, f.name), getattr(s2, f.name))
                                for f in dataclasses.fields(s2)})
        out = ts.replace(obs=pick(r_ts.obs, ts.obs), state=pick(r_ts.state, ts.state),
                         avail=pick(r_ts.avail, ts.avail))
        return new_state, out, ts


def _smaclite_units(env_name: str):
    """(ally types, enemy types) of a SMAClite map, named as the program
    names it: ``Nm``, ``Nm_vs_Mm``, ``NsMz``, ``MMM``, ``MMM2``."""
    import re

    m = re.fullmatch(r"(\d+)m", env_name)
    if m:
        return ["marine"] * int(m.group(1)), ["marine"] * int(m.group(1))
    m = re.fullmatch(r"(\d+)m_vs_(\d+)m", env_name)
    if m:
        return ["marine"] * int(m.group(1)), ["marine"] * int(m.group(2))
    m = re.fullmatch(r"(\d+)s(\d+)z", env_name)
    if m:
        types = ["stalker"] * int(m.group(1)) + ["zealot"] * int(m.group(2))
        return types, list(types)
    mmm = ["medivac"] + ["marauder"] * 2 + ["marine"] * 7
    if env_name.upper() == "MMM":
        return mmm, list(mmm)
    if env_name.upper() == "MMM2":
        return mmm, ["medivac"] + ["marauder"] * 3 + ["marine"] * 8
    raise ValueError(f"the reference has no SMAClite map {env_name!r}")


def make_env(cfg: dict, num_envs: int, device) -> VecEnv:
    """The env a configuration's ``params`` name (``env_type``, ``env_name``,
    ``agent_ids``, ``unit_collisions``), ``num_envs`` of it, from the
    frozen copy of SMAClite."""
    from benchmark.reference import smaclite

    if cfg["env_type"] != "smaclite":
        raise ValueError(f"the reference has no env_type {cfg['env_type']!r}")
    for key in ("agent_ids", "unit_collisions"):
        if not isinstance(cfg[key], bool):
            raise ValueError(f"the reference takes {key} true or false, not {cfg[key]!r}")
    allies, enemies = _smaclite_units(cfg["env_name"])
    env = smaclite.MicroCombat(allies, enemies, unit_collisions=cfg["unit_collisions"],
                               device=device)
    return VecEnv(env, num_envs, cfg["agent_ids"])
