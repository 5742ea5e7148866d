"""What the families share: the benchmark's inputs, the recorder of the
program's first iterations, and the numbers the output check compares.

The recorded iterations are set-up's first blocks: the program's own
``train_block``, the call the window times. The recorder wraps three of
the program's entry points for those blocks only and puts them back
before the window: ``categorical`` and ``value_and_grad`` in the family's
module (each action drawn, each loss) and ``Optimizer.update`` (the
gradients as the optimizer gets them, and its parameters and state after
chosen steps).
"""
from __future__ import annotations

import statistics

import torch

from benchmark.harness import sub_seed
from benchmark.reference import common as C


def inputs(seed: int, device, shapes: dict, gains: dict) -> dict:
    """The inputs both sides get: the weights, and the seeds of the first
    env state's draw and of the run's generator."""
    params = {k: C.make_weights(s, gains.get(k, {}), sub_seed(seed, f"weights/{k}"), device)
              for k, s in shapes.items()}
    return {"params": params, "reset_seed": sub_seed(seed, "reset"),
            "gen_seed": sub_seed(seed, "generator")}


def to_cpu(tree):
    return C.tmap(lambda x: x.detach().to("cpu", copy=True) if torch.is_tensor(x) else x, tree)


def hand_over(runner, inputs: dict, params: dict, device):
    """The benchmark's first env state and generator, in the program's types;
    ``params`` the configuration's, which name the env."""
    n_loc = runner.obs.shape[0]
    env = C.make_env(params, n_loc, device)
    state, ts = env.reset(torch.Generator(device).manual_seed(inputs["reset_seed"]))
    cls = type(runner.env_state)
    fields = {f: getattr(state, f).clone() for f in cls.__dataclass_fields__}
    return dict(env_state=cls(**fields), obs=ts.obs.clone(), state=ts.state.clone(),
                avail=ts.avail.clone(),
                generator=torch.Generator(device).manual_seed(inputs["gen_seed"]))


class Recorder:
    """Records the program's first two iterations (a rollout and an update
    of ``n_steps`` optimizer steps each, two optimizers, ``keys``, called in
    turn each step) in the record the reference writes (``reference/mappo``):
    the actions drawn; the losses of update 1's first ``steps`` steps and of
    update 2's last ``steps``; Adam's first moment after step 1, the
    parameters after step ``steps`` and after update 1; the parameters and
    state before update 2's last ``steps`` steps."""

    def __init__(self, module, n_steps: int, rollout_len: int, steps: int,
                 keys=("actor", "critic")):
        self.module, self.S, self.T, self.steps, self.keys = (module, n_steps, rollout_len,
                                                              steps, keys)
        self.acts, self.vag_calls, self.upd_calls = [], 0, 0
        self.rec = {"losses": [], **{k: {} for k in (
            "mu1", "params3", "p_mid", "p_late", "opt_late")}}

    def _recorded(self, step: int) -> bool:
        return step <= self.steps or 2 * self.S - self.steps < step <= 2 * self.S

    def __enter__(self):
        from cleanmarl_tpu_torch.core import optim

        self._optim = optim
        self._cat, self._vag = self.module.categorical, self.module.value_and_grad
        self._upd = optim.Optimizer.update
        rec, r = self, self.rec

        def categorical(logits, generator):
            a = rec._cat(logits, generator)
            if len(rec.acts) < 2 * rec.T:
                rec.acts.append(a.to(torch.uint8))
            return a

        def value_and_grad(fn, params, *args):
            loss, aux, grads = rec._vag(fn, params, *args)
            rec.vag_calls += 1
            if rec._recorded((rec.vag_calls + 1) // len(rec.keys)):
                r["losses"].append(float(loss))
            return loss, aux, grads

        def update(opt, grads, state, params):
            new_params, new_state = rec._upd(opt, grads, state, params)
            key = rec.keys[rec.upd_calls % len(rec.keys)]
            rec.upd_calls += 1
            step, S, k = (rec.upd_calls + 1) // len(rec.keys), rec.S, rec.steps
            if step == 1:
                r["mu1"][key] = to_cpu(opt.trees(new_state)["mu"])
            if step == k:
                r["params3"][key] = to_cpu(new_params)
            if step == S:
                r["p_mid"][key] = to_cpu(new_params)
            if step == 2 * S - k:
                r["p_late"][key], r["opt_late"][key] = to_cpu(new_params), to_cpu(new_state)
            return new_params, new_state

        self.module.categorical, self.module.value_and_grad = categorical, value_and_grad
        optim.Optimizer.update = update
        return self

    def __exit__(self, *exc):
        self.module.categorical, self.module.value_and_grad = self._cat, self._vag
        self._optim.Optimizer.update = self._upd
        if exc[0] is None:
            if self.upd_calls < 2 * self.S * len(self.keys) or len(self.acts) < 2 * self.T:
                raise RuntimeError("the recorded blocks ran fewer than two iterations")
            self.rec["actions"] = [torch.stack(self.acts[:self.T]).cpu(),
                                   torch.stack(self.acts[self.T:2 * self.T]).cpu()]
        return False


# ---------------------------------------------------------------------------
# the numbers compared
# ---------------------------------------------------------------------------
def _norms(tree):
    return [float(torch.linalg.vector_norm(x.double())) for _, x in C.leaves(tree)]


def norm_gap(prog_tree, ref_tree, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger; ``keep`` leaves out leaves (a list of booleans)."""
    p, r = _norms(prog_tree), _norms(ref_tree)
    if keep is not None:
        p = [x for x, k in zip(p, keep) if k]
        r = [x for x, k in zip(r, keep) if k]
    med = statistics.median(r)
    return max(abs(a - b) / max(b, med) for a, b in zip(p, r))


def moved(grads_ref) -> list:
    """The leaves that count for a change: the reference's gradient of the
    leaf is at least a thousandth of the median leaf's (a gradient that is
    nought but for rounding moves a leaf under Adam by round-off)."""
    n = _norms(grads_ref)
    med = statistics.median(n)
    return [x >= 1e-3 * med for x in n]


def delta(after, before):
    return C.tmap(lambda a, b: a.detach().cpu().double() - b.detach().cpu().double(),
                  after, before)


def loss_gap(prog_losses, ref_losses) -> float:
    if len(prog_losses) != len(ref_losses):
        return float("inf")
    return max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses))


def training_numbers(prog: dict, ref: dict, init: dict, keys) -> dict:
    """The numbers of a training cell from the program's record and the
    reference's (``reference/mappo``'s keys); ``init`` the weights both
    started from. The losses are those of both stages: update 1's first
    steps from the inputs, and update 2's last steps from the program's
    weights and state before them. The gradient is step 1's and the change
    that of the first steps: in update 2's, PPO's clip, a kink in the
    gradient, lets rounding switch single samples' terms on or off, where
    the loss, continuous there, does not move."""
    b1 = 1.0 - C.ADAM_B1
    grad, change = [], []
    for k in keys:
        g_p = C.tmap(lambda m: m.double() / b1, prog["mu1"][k])
        g_r = C.tmap(lambda m: m.detach().cpu().double() / b1, ref["mu1"][k])
        grad.append(norm_gap(g_p, g_r))
        change.append(norm_gap(delta(prog["params3"][k], init[k]),
                               delta(ref["params3"][k], init[k]), moved(ref["grads1"][k])))
    return {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
            "grad_gap": max(grad), "change_gap": max(change)}
