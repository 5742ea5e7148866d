"""The gradient transforms that ``core/optim.py`` composes into optax's
aliases (ports of optax 0.2.6's ``transform.py``, ``factorized.py`` and
``clipping.py``, at the defaults the aliases pass them).

A transform is ``update(u, state, params, count) -> (u, state)``:
``state`` holds its own trees by the field names optax gives them (and
``optax_state`` names optax's state class, by which ``core/params.py``
carries an optax state across); ``count`` is the optimizer's host
integer, the number of updates taken before this one. Every transform
in one chain advances together, so the one count stands for the counts
optax keeps per transform. What depends on the count alone is computed
here on the host in float32 (as optax computes it on the device), and
every per-leaf branch on data is a ``torch.where`` on the device: no
update reads a value back to the host.

Float32 rounding: each expression keeps optax's order of operations;
host scalars are float32 values handed to torch as Python floats.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from cleanmarl_tpu_torch.core.params import tree_leaves, tree_map, tree_unflatten

f32 = np.float32
# optax.noisy_sgd's default key is jax.random.key(0); the port draws each
# update's noise from a generator seeded with this seed and the count
NOISE_SEED = 0


def _bias(decay: float, count: int) -> float:
    """1 − decay^count in float32 (``optax.tree.bias_correction``)."""
    return float(f32(1.0) - f32(decay) ** f32(count))


def _ema(u, m, decay: float):
    """(1 − decay)·g + decay·m per leaf (``optax.tree.update_moment``)."""
    return tree_map(lambda g, x: (1 - decay) * g + decay * x, u, m)


def _ema_sq(u, v, decay: float):
    """(1 − decay)·g² + decay·v per leaf."""
    return tree_map(lambda g, x: (1 - decay) * (g ** 2) + decay * x, u, v)


def _map_n(fn, n: int, tree, *rest):
    """``tree_map`` of an ``fn`` that returns ``n`` values → ``n`` trees of
    ``tree``'s structure (``rest`` may hold lists at its leaves)."""
    outs = []
    tree_map(lambda *a: outs.append(fn(*a)), tree, *rest)
    return tuple(tree_unflatten(tree, [o[i] for o in outs]) for i in range(n))


class Schedule:
    """The learning rate at the update whose pre-increment count is
    ``count``: ``value``, or ``optax.linear_schedule(value, 0,
    anneal_steps)`` when ``anneal_steps > 0`` (float32, as optax)."""

    def __init__(self, value: float, anneal_steps: int):
        self.value = value
        self.anneal_steps = anneal_steps

    def __call__(self, count: int) -> np.float32:
        lr = f32(self.value)
        if not self.anneal_steps:
            return lr
        c = f32(min(max(count, 0), self.anneal_steps))
        return lr * (f32(1.0) - c / f32(self.anneal_steps))


class Transform:
    fields: Tuple[str, ...] = ()
    optax_state: Optional[str] = None

    def init(self, params) -> dict:
        return {f: tree_map(torch.zeros_like, params) for f in self.fields}

    def update(self, u, state, params, count):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# stateless steps
# ---------------------------------------------------------------------------

class ScaleByLR(Transform):
    """``scale_by_learning_rate``: −lr·u (``flip_sign=False``: lr·u)."""

    def __init__(self, schedule: Schedule, flip_sign: bool = True):
        self.schedule, self.sign = schedule, -1.0 if flip_sign else 1.0

    def update(self, u, state, params, count):
        lr = self.sign * float(self.schedule(count))
        return tree_map(lambda g: lr * g, u), {}


class Scale(Transform):
    def __init__(self, step_size: float):
        self.step_size = step_size

    def update(self, u, state, params, count):
        return tree_map(lambda g: self.step_size * g, u), {}


class AddDecayedWeights(Transform):
    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    def update(self, u, state, params, count):
        return tree_map(lambda g, p: g + self.weight_decay * p, u, params), {}


class ScaleBySign(Transform):
    def update(self, u, state, params, count):
        return tree_map(torch.sign, u), {}


class ScaleByTrustRatio(Transform):
    """Each leaf times tc·‖p‖ / (‖u‖ + eps), or 1 where either norm is 0;
    norms below ``min_norm`` count as ``min_norm`` (``safe_norm``)."""

    def __init__(self, min_norm: float = 0.0, trust_coefficient: float = 1.0,
                 eps: float = 0.0):
        self.min_norm, self.tc, self.eps = min_norm, trust_coefficient, eps

    def update(self, u, state, params, count):
        def one(g, p):
            pn = torch.clamp(torch.linalg.vector_norm(p), min=self.min_norm)
            un = torch.clamp(torch.linalg.vector_norm(g), min=self.min_norm)
            ratio = self.tc * pn / (un + self.eps)
            return g * torch.where((pn == 0.0) | (un == 0.0), 1.0, ratio)
        return tree_map(one, u, params), {}


class ClipByBlockRms(Transform):
    def __init__(self, threshold: float):
        self.threshold = threshold

    def update(self, u, state, params, count):
        def one(g):
            return g / torch.clamp(torch.sqrt(torch.mean(g * g)) / self.threshold, min=1.0)
        return tree_map(one, u), {}


class ScaleByParamBlockRms(Transform):
    def __init__(self, min_scale: float = 1e-3):
        self.min_scale = min_scale

    def update(self, u, state, params, count):
        return tree_map(lambda g, p: g * torch.clamp(torch.sqrt(torch.mean(p * p)),
                                                     min=self.min_scale), u, params), {}


class AddNoise(Transform):
    """u + √(eta / (count+1)^gamma)·N(0, 1). The noise comes from a
    generator made afresh from ``NOISE_SEED`` and the count, on the
    leaves' device: ranks that take the same update draw the same noise,
    and the state stays a host integer. JAX's stream itself is not
    reproduced."""

    def __init__(self, eta: float = 0.01, gamma: float = 0.55):
        self.eta, self.gamma = eta, gamma

    def update(self, u, state, params, count):
        c = count + 1
        std = float(np.sqrt(f32(self.eta) / f32(c) ** f32(self.gamma)))
        leaves = tree_leaves(u)
        gen = torch.Generator(leaves[0].device).manual_seed((NOISE_SEED << 32) + c)
        noisy = [g + std * torch.randn(g.shape, generator=gen, device=g.device, dtype=g.dtype)
                 for g in leaves]
        return tree_unflatten(u, noisy), {}


class FromageStep(Transform):
    """Fromage's step: −lr/√(1 + lr²)·u (float32, as optax computes it
    from a float or from the schedule's value)."""

    def __init__(self, schedule: Schedule):
        self.schedule = schedule

    def mult(self, count: int) -> Tuple[np.float32, np.float32]:
        """(1/√(1 + lr²), lr) at ``count``."""
        if not self.schedule.anneal_steps:           # lr ** 2 in float64 first
            lr = self.schedule.value
            return f32(1.0) / np.sqrt(f32(1.0 + lr ** 2)), f32(lr)
        lr = self.schedule(count)
        return f32(1.0) / np.sqrt(f32(1.0) + lr * lr), lr

    def update(self, u, state, params, count):
        m, lr = self.mult(count)
        step = -float(lr * m)
        return tree_map(lambda g: step * g, u), {}


class FromageDecay(FromageStep):
    """Fromage's decayed weights, u + (1/√(1 + lr²) − 1)·p. Under a
    schedule optax's ``add_decayed_weights`` keeps a count it never
    advances, so the decay stays the one at count 0."""

    def update(self, u, state, params, count):
        wd = float(self.mult(0)[0] - f32(1.0))
        return tree_map(lambda g, p: g + wd * p, u, params), {}


# ---------------------------------------------------------------------------
# the Adam family
# ---------------------------------------------------------------------------

class ScaleByAdam(Transform):
    fields, optax_state = ("mu", "nu"), "ScaleByAdamState"

    def __init__(self, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, nesterov=False):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.nesterov = nesterov

    def update(self, u, state, params, count):
        b1, b2, eps, eps_root = self.b1, self.b2, self.eps, self.eps_root
        mu, nu = _ema(u, state["mu"], b1), _ema_sq(u, state["nu"], b2)
        bc1, bc2 = _bias(b1, count + 1), _bias(b2, count + 1)
        if self.nesterov:
            bc1_next = _bias(b1, count + 2)
            mu_hat = tree_map(lambda m, g: b1 * (m / bc1_next) + (1 - b1) * (g / bc1), mu, u)
            out = tree_map(lambda m, v: m / (torch.sqrt(v / bc2 + eps_root) + eps), mu_hat, nu)
        else:
            out = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2 + eps_root) + eps),
                           mu, nu)
        return out, {"mu": mu, "nu": nu}


class ScaleByRadam(ScaleByAdam):
    """Adam with the variance rectification r once ρ_t ≥ ``threshold``,
    else the bias-corrected first moment alone (ρ_t from the count, on
    the host)."""

    def __init__(self, threshold: float = 5.0):
        super().__init__()
        self.threshold = threshold

    def rectifier(self, c: int) -> Optional[float]:
        b2 = self.b2
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = f32(b2) ** f32(c)
        ro = f32(ro_inf) - f32(2 * c) * b2t / (f32(1.0) - b2t)
        if not ro >= f32(self.threshold):
            return None
        num = (ro - f32(4.0)) * (ro - f32(2.0)) * f32(ro_inf)
        den = f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro
        return float(np.sqrt(num / den))

    def update(self, u, state, params, count):
        b1, b2, eps, eps_root = self.b1, self.b2, self.eps, self.eps_root
        mu, nu = _ema(u, state["mu"], b1), _ema_sq(u, state["nu"], b2)
        bc1, bc2 = _bias(b1, count + 1), _bias(b2, count + 1)
        r = self.rectifier(count + 1)
        if r is None:
            out = tree_map(lambda m: m / bc1, mu)
        else:
            out = tree_map(lambda m, v: r * (m / bc1) / (torch.sqrt(v / bc2 + eps_root) + eps),
                           mu, nu)
        return out, {"mu": mu, "nu": nu}


class ScaleByAmsgrad(Transform):
    fields, optax_state = ("mu", "nu", "nu_max"), "ScaleByAmsgradState"

    def __init__(self, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def update(self, u, state, params, count):
        b1, b2, eps, eps_root = self.b1, self.b2, self.eps, self.eps_root
        mu, nu = _ema(u, state["mu"], b1), _ema_sq(u, state["nu"], b2)
        bc1, bc2 = _bias(b1, count + 1), _bias(b2, count + 1)
        nu_max = tree_map(lambda vm, v: torch.maximum(vm, v / bc2), state["nu_max"], nu)
        out = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v + eps_root) + eps), mu, nu_max)
        return out, {"mu": mu, "nu": nu, "nu_max": nu_max}


class ScaleByBelief(Transform):
    """AdaBelief: the second moment of g − μ, plus ``eps_root`` kept in
    the state."""
    fields, optax_state = ("mu", "nu"), "ScaleByBeliefState"

    def __init__(self, b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def update(self, u, state, params, count):
        b1, b2 = self.b1, self.b2
        mu = _ema(u, state["mu"], b1)
        nu = tree_map(lambda g, m, v: (1 - b2) * ((g - m) ** 2) + b2 * v + self.eps_root,
                      u, mu, state["nu"])
        bc1, bc2 = _bias(b1, count + 1), _bias(b2, count + 1)
        out = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + self.eps), mu, nu)
        return out, {"mu": mu, "nu": nu}


class ScaleByYogi(Transform):
    fields, optax_state = ("mu", "nu"), "ScaleByAdamState"

    def __init__(self, b1=0.9, b2=0.999, eps=1e-3, initial_accumulator_value=1e-6):
        self.b1, self.b2, self.eps, self.init_value = b1, b2, eps, initial_accumulator_value

    def init(self, params):
        return {f: tree_map(lambda p: torch.full_like(p, self.init_value), params)
                for f in self.fields}

    def update(self, u, state, params, count):
        b1, b2 = self.b1, self.b2
        mu = _ema(u, state["mu"], b1)
        nu = tree_map(lambda g, v: v - (1 - b2) * torch.sign(v - g * g) * (g * g),
                      u, state["nu"])
        bc1, bc2 = _bias(b1, count + 1), _bias(b2, count + 1)
        out = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + self.eps), mu, nu)
        return out, {"mu": mu, "nu": nu}


class ScaleByAdamax(Transform):
    fields, optax_state = ("mu", "nu"), "ScaleByAdamState"

    def __init__(self, b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def update(self, u, state, params, count):
        mu = _ema(u, state["mu"], self.b1)
        nu = tree_map(lambda g, v: torch.maximum(g.abs() + self.eps, self.b2 * v),
                      u, state["nu"])
        bc1 = _bias(self.b1, count + 1)
        return tree_map(lambda m, v: (m / bc1) / v, mu, nu), {"mu": mu, "nu": nu}


class ScaleByLion(Transform):
    fields, optax_state = ("mu",), "ScaleByLionState"

    def __init__(self, b1=0.9, b2=0.99):
        self.b1, self.b2 = b1, b2

    def update(self, u, state, params, count):
        b1, b2 = self.b1, self.b2
        out = tree_map(lambda g, m: torch.sign((1.0 - b1) * g + b1 * m), u, state["mu"])
        return out, {"mu": _ema(u, state["mu"], b2)}


class ScaleByAdan(Transform):
    fields, optax_state = ("m", "v", "n", "g"), "ScaleByAdanState"

    def __init__(self, b1=0.98, b2=0.92, b3=0.99, eps=1e-8, eps_root=1e-8):
        self.b1, self.b2, self.b3, self.eps, self.eps_root = b1, b2, b3, eps, eps_root

    def update(self, u, state, params, count):
        b1, b2, b3 = self.b1, self.b2, self.b3
        if count == 0:
            diff = tree_map(torch.zeros_like, u)
        else:
            diff = tree_map(lambda g, gp: g - gp, u, state["g"])
        m, v = _ema(u, state["m"], b1), _ema(diff, state["v"], b2)
        n = tree_map(lambda g, d, x: (1 - b3) * ((g + (1 - b2) * d) ** 2) + b3 * x,
                     u, diff, state["n"])
        bc1, bc2, bc3 = (_bias(b, count + 1) for b in (b1, b2, b3))
        out = tree_map(lambda a, b, c: (a / bc1 + (1 - b2) * (b / bc2))
                       / (torch.sqrt(c / bc3 + self.eps_root) + self.eps), m, v, n)
        return out, {"m": m, "v": v, "n": n, "g": u}


class ScaleByNovograd(Transform):
    """One second moment per leaf (its squared norm); the first update
    sets both moments instead of decaying them (a count branch, on the
    host)."""
    fields, optax_state = ("mu", "nu"), "ScaleByNovogradState"

    def __init__(self, b1=0.9, b2=0.25, eps=1e-6, eps_root=0.0):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def init(self, params):
        return {"mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(lambda p: p.new_zeros(()), params)}

    def update(self, u, state, params, count):
        b1, b2 = self.b1, self.b2
        sq = tree_map(lambda g: torch.linalg.vector_norm(g) ** 2, u)
        first = count == 0
        nu = sq if first else _ema(sq, state["nu"], b2)
        step = tree_map(lambda g, v: g / (torch.sqrt(v + self.eps_root) + self.eps), u, nu)
        mu = step if first else tree_map(lambda m, s: b1 * m + s, state["mu"], step)
        return mu, {"mu": mu, "nu": nu}


class ScaleByOptimisticGradient(Transform):
    """(alpha + beta)·g − beta·g_prev, with g_prev = g at the first
    update (a count branch, on the host)."""
    fields, optax_state = ("previous_gradient",), "ScaleByOptimisticGradientState"

    def __init__(self, alpha: float = 1.0, beta: float = 1.0):
        self.alpha, self.beta = alpha, beta

    def update(self, u, state, params, count):
        prev = u if count == 0 else state["previous_gradient"]
        out = tree_map(lambda g, gp: (self.alpha + self.beta) * g - self.beta * gp, u, prev)
        return out, {"previous_gradient": u}


# ---------------------------------------------------------------------------
# the rest
# ---------------------------------------------------------------------------

class ScaleByRms(Transform):
    """RMSprop's scaling: g / √(ν + eps), eps inside the square root."""
    fields, optax_state = ("nu",), "ScaleByRmsState"

    def __init__(self, decay=0.9, eps=1e-8):
        self.decay, self.eps = decay, eps

    def update(self, u, state, params, count):
        nu = _ema_sq(u, state["nu"], self.decay)
        return tree_map(lambda g, v: torch.rsqrt(v + self.eps) * g, u, nu), {"nu": nu}


class ScaleByRss(Transform):
    """Adagrad: the sum of squares starts at ``initial_accumulator_value``."""
    fields, optax_state = ("sum_of_squares",), "ScaleByRssState"

    def __init__(self, initial_accumulator_value=0.1, eps=1e-7):
        self.init_value, self.eps = initial_accumulator_value, eps

    def init(self, params):
        return {"sum_of_squares": tree_map(lambda p: torch.full_like(p, self.init_value),
                                           params)}

    def update(self, u, state, params, count):
        sos = tree_map(lambda g, t: g * g + t, u, state["sum_of_squares"])
        out = tree_map(lambda g, t: torch.where(t > 0, torch.rsqrt(t + self.eps), 0.0) * g,
                       u, sos)
        return out, {"sum_of_squares": sos}


class Trace(Transform):
    fields, optax_state = ("trace",), "TraceState"

    def __init__(self, decay: float):
        self.decay = decay

    def update(self, u, state, params, count):
        t = tree_map(lambda g, x: g + self.decay * x, u, state["trace"])
        return t, {"trace": t}


class ScaleByAdadelta(Transform):
    fields, optax_state = ("e_g", "e_x"), "ScaleByAdaDeltaState"

    def __init__(self, rho=0.9, eps=1e-6):
        self.rho, self.eps = rho, eps

    def update(self, u, state, params, count):
        eps = self.eps
        e_g = _ema_sq(u, state["e_g"], self.rho)
        out = tree_map(lambda g, eg, ex: torch.sqrt(ex + eps) / torch.sqrt(eg + eps) * g,
                       u, e_g, state["e_x"])
        e_x = _ema_sq(out, state["e_x"], self.rho)
        return out, {"e_g": e_g, "e_x": e_x}


class ScaleByFactoredRms(Transform):
    """Adafactor's second moment: factored into row and column means for
    a leaf whose two largest dimensions are both ≥
    ``min_dim_size_to_factor`` (a shape rule, fixed at init), else kept
    whole. Unused slots hold (1,) zeros, as optax's do; the decay
    1 − (count+1)^−0.8 is computed on the host."""
    fields, optax_state = ("v_row", "v_col", "v"), "FactoredState"

    def __init__(self, min_dim_size_to_factor=128, decay_rate=0.8, epsilon=1e-30):
        self.min_dim, self.decay_rate, self.epsilon = min_dim_size_to_factor, decay_rate, \
            epsilon

    def dims(self, shape) -> Optional[Tuple[int, int]]:
        """(second largest, largest) dimension of a factored leaf, or None."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < self.min_dim:
            return None
        return int(order[-2]), int(order[-1])

    def init(self, params):
        def one(p):
            z = lambda *s: p.new_zeros(s)  # noqa: E731
            d = self.dims(tuple(p.shape))
            if d is None:
                return z(1), z(1), torch.zeros_like(p)
            d1, d0 = d
            return (z(*np.delete(p.shape, d0).tolist()), z(*np.delete(p.shape, d1).tolist()),
                    z(1))
        v_row, v_col, v = _map_n(one, 3, params)
        return {"v_row": v_row, "v_col": v_col, "v": v}

    def update(self, u, state, params, count):
        decay = f32(1.0) - f32(count + 1) ** f32(-self.decay_rate)
        keep, new = float(decay), float(f32(1.0) - decay)

        def one(g, vr, vc, v):
            sq = g * g + self.epsilon
            d = self.dims(tuple(g.shape))
            if d is None:
                v = keep * v + new * sq
                return g * v ** -0.5, g.new_zeros(1), g.new_zeros(1), v
            d1, d0 = d
            vr = keep * vr + new * sq.mean(dim=d0)
            vc = keep * vc + new * sq.mean(dim=d1)
            row_col_mean = vr.mean(dim=d1 - 1 if d1 > d0 else d1, keepdim=True)
            row = (vr / row_col_mean) ** -0.5
            col = vc ** -0.5
            return g * row.unsqueeze(d0) * col.unsqueeze(d1), vr, vc, g.new_zeros(1)
        out, vr, vc, v = _map_n(one, 4, u, state["v_row"], state["v_col"], state["v"])
        return out, {"v_row": vr, "v_col": vc, "v": v}


class ScaleByRprop(Transform):
    """Per-element step sizes grown by ``eta_plus`` where the gradient
    kept its sign and cut by ``eta_minus`` where it flipped. As optax
    0.2.6, the update emitted is the previous step (zero where the sign
    flipped)."""
    fields, optax_state = ("step_sizes", "prev_updates"), "ScaleByRpropState"

    def __init__(self, learning_rate: float, eta_minus=0.5, eta_plus=1.2,
                 min_step_size=1e-6, max_step_size=50.0):
        self.learning_rate = learning_rate
        self.eta_minus, self.eta_plus = eta_minus, eta_plus
        self.min_step, self.max_step = min_step_size, max_step_size

    def init(self, params):
        return {"step_sizes": tree_map(lambda p: torch.full_like(p, self.learning_rate),
                                       params),
                "prev_updates": tree_map(torch.zeros_like, params)}

    def update(self, u, state, params, count):
        def one(g, step, prev):
            s = g * prev
            grown = torch.clamp(step * torch.where(s > 0, self.eta_plus, self.eta_minus),
                                min=self.min_step, max=self.max_step)
            step = torch.where(s == 0, step, grown)
            new_prev = torch.where(s < 0, 0.0, step * torch.sign(g))
            return torch.where(s < 0, 0.0, prev), step, new_prev
        out, step, prev = _map_n(one, 3, u, state["step_sizes"], state["prev_updates"])
        return out, {"step_sizes": step, "prev_updates": prev}


class ScaleBySM3(Transform):
    """SM3: one accumulator vector per dimension of each leaf (``mu``, a
    list per leaf), their broadcast minimum standing for the leaf's
    accumulator; momentum ``b1`` on the scaled gradient (``nu``)."""
    fields, optax_state = ("mu", "nu"), "ScaleBySM3State"

    def __init__(self, b1=0.9, eps=1e-8):
        self.b1, self.eps = b1, eps

    def init(self, params):
        return {"mu": tree_map(lambda p: [p.new_zeros(s) for s in p.shape], params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(self, u, state, params, count):
        def one(g, vs, nu):
            if g.dim() < 2:
                acc = g ** 2 + vs[0]
            else:
                shaped = [v.reshape([1] * i + [-1] + [1] * (g.dim() - i - 1))
                          for i, v in enumerate(vs)]
                acc = g ** 2 + functools.reduce(torch.minimum, shaped)
            step = g * torch.where(acc > 0, torch.rsqrt(acc + self.eps), 0.0)
            nu = (1 - self.b1) * step + self.b1 * nu
            if g.dim() < 2:
                return nu, [acc]
            return nu, [torch.amax(acc, dim=[j for j in range(g.dim()) if j != i])
                        for i in range(g.dim())]
        nu, mu = _map_n(one, 2, u, state["mu"], state["nu"])
        return nu, {"mu": mu, "nu": nu}
