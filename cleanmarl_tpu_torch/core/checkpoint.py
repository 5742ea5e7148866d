"""Full-runner checkpoint and resume (port of
``cleanmarl_tpu/core/checkpoint.py``).

The whole runner is saved, not only the weights: params, target params,
optimizer moments and counts, replay rings and accumulators, env state,
GRU carries, episode statistics, value-norm statistics, every
``torch.Generator`` and the host-integer counters (``step``,
``num_updates``, ``episodes``, ``update_debt``). A restored runner
continues bit-exactly where the saved one stopped.

Layout, as orbax lays it out: one directory per step, named by the step's
digits, under ``directory``; only the newest ``max_to_keep`` are kept. A
step is written under a hidden temporary name (``.tmp-<step>``) and
renamed once complete, so a run killed mid-write leaves no step directory
for ``latest_step`` to find. Each rank of a data-parallel run writes its
own runner (``rank<r>.pt``: a rank holds only its share of the envs and
of the ring rows); ``meta.json`` holds the step, the world size, the
run's seed and the global ``num_envs`` and ring ``capacity``.

**Another world size.** A checkpoint written by ``n`` ranks restores at
any ``m`` ranks that the layout allows, as orbax lays the JAX package's
global arrays out on another mesh. ``make_train`` at ``m`` ranks has
already refused a world the envs or the batch do not split over
(``dp.check_layout``, ``dp.check_split``); ``restore`` then checks, before
it reads a runner, that the files' global ``num_envs`` and ring capacity
are the template's (a rank's envs times ``m``), reads all ``n`` files on
the CPU, puts the global runner back together (``dp.unshard_runners``),
takes this rank's share (``dp.shard_runner``) and lays it onto the
template. What comes back is exactly the global state the ``n`` ranks
held. The generators cannot be re-split, so:

- rank ``r < min(n, m)`` keeps saved rank ``r``'s generator state, and
  rank 0's is never advanced: rank 0 draws every replay sample
  (``dp.rank0_randint``), so an off-policy run samples from the stream it
  would have used at ``n``;
- rank ``r >= n`` gets a new generator seeded with ``dp.resume_seed(seed,
  r, m, step)``, whose low 32 bits (all the CPU generator keeps) are never
  those of an init or eval generator's seed, nor another new rank's.

A run resumed at ``m`` ranks is therefore not the run that would have
continued at ``n`` (the ranks' env streams differ), but it starts from
the same state. With ``n == m`` each rank reads only its own file.

A runner is written as a plain nested dict: tensors moved to the CPU,
generators as their ``get_state()``, host numbers as they are. Restore
walks a *template* runner (a fresh ``init``): each tensor is copied onto
the template's device and dtype, each generator takes its saved state,
and any difference of structure or shape raises, naming the field. Files
are read with ``torch.load(..., weights_only=True)``.

Saves are synchronous, so ``save(..., wait=True)`` and ``close()`` have
nothing left to wait for; they keep the JAX module's calls.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch

from cleanmarl_tpu_torch.distributed import dp

_GEN = "__generator_state__"
_META = "meta.json"


def to_state(tree) -> Any:
    """A runner (or any part of one) → nested dicts and lists of CPU
    tensors and host numbers."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, torch.Generator):
        return {_GEN: tree.get_state()}
    if isinstance(tree, dict):
        return {k: to_state(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_state(v) for v in tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: to_state(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    if hasattr(tree, "__dict__"):           # replay rings and accumulators
        return {k: to_state(v) for k, v in vars(tree).items()}
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def from_state(template, saved, path: str = "runner", as_saved: bool = False) -> Any:
    """``saved`` (from ``to_state``) laid onto ``template``: the template's
    structure, devices and dtypes with the saved values. Raises ValueError
    naming the field where the two differ. With ``as_saved`` the tensors
    stay as the file holds them (shape, dtype, the CPU) and each generator
    is a new one on the template generator's device: one rank's runner as
    it was written, whatever the template's world."""
    def mismatch(what):
        return ValueError(f"checkpoint does not fit the runner at {path}: {what}")

    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise mismatch(f"expected a tensor, found {type(saved).__name__}")
        if as_saved:
            return saved
        if tuple(saved.shape) != tuple(template.shape):
            raise mismatch(f"shape {tuple(saved.shape)} in the file, "
                           f"{tuple(template.shape)} in the runner")
        return saved.to(device=template.device, dtype=template.dtype)
    if isinstance(template, torch.Generator):
        if not (isinstance(saved, dict) and _GEN in saved):
            raise mismatch("expected a generator state")
        gen = torch.Generator(template.device) if as_saved else template
        gen.set_state(saved[_GEN])
        return gen
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            got = sorted(saved) if isinstance(saved, dict) else type(saved).__name__
            raise mismatch(f"keys {got} in the file, {sorted(template)} in the runner")
        return {k: from_state(v, saved[k], f"{path}.{k}", as_saved)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, list) or len(saved) != len(template):
            raise mismatch(f"expected a sequence of {len(template)}")
        out = [from_state(v, s, f"{path}[{i}]", as_saved) for i, (v, s) in
               enumerate(zip(template, saved))]
        return type(template)(out)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        names = [f.name for f in dataclasses.fields(template)]
        if not isinstance(saved, dict) or set(saved) != set(names):
            raise mismatch(f"expected the fields {names}")
        return dataclasses.replace(template, **{
            k: from_state(getattr(template, k), saved[k], f"{path}.{k}", as_saved)
            for k in names})
    if template is None or isinstance(template, (bool, int, float, str)):
        if type(saved) is not type(template):
            raise mismatch(f"{type(saved).__name__} in the file, "
                           f"{type(template).__name__} in the runner")
        return saved
    if hasattr(template, "__dict__"):
        attrs = vars(template)
        if not isinstance(saved, dict) or set(saved) != set(attrs):
            # e.g. an episode ring of another layout: ``data`` where this
            # one keeps ``stored`` and ``pairs`` (buffers/episode.py)
            got = sorted(saved) if isinstance(saved, dict) else type(saved).__name__
            raise mismatch(f"the file's {type(template).__name__} has the attributes {got}, "
                           f"this one {sorted(attrs)}")
        out = copy.copy(template)
        out.__dict__.update({k: from_state(v, saved[k], f"{path}.{k}", as_saved)
                             for k, v in attrs.items()})
        return out
    raise TypeError(f"cannot restore a {type(template).__name__} at {path}")


class Checkpointer:
    """``field_dims`` is the family's ``dp.DATA_FIELD_DIMS`` entry, by which
    a restore at another world size re-lays the runner out; ``seed`` is the
    run's, written into ``meta.json`` for the generator rule (module
    docstring)."""

    def __init__(self, directory: str, field_dims: Dict[str, int], seed: int,
                 max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.field_dims = field_dims
        self.seed = seed
        self.rank, self.world = dp.rank_world()
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        """Complete steps, oldest first: digit-named directories that hold
        the metadata file, which is written last before the rename."""
        out = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(os.path.join(self.directory, name, _META)):
                out.append(int(name))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, runner: Any, wait: bool = False) -> None:
        """Write ``runner`` as ``step`` (every rank calls this at the same
        step). A step already on disk is kept as it is, as orbax skips it."""
        del wait                                   # saves are synchronous
        step = int(step)
        if step in self.all_steps():
            return
        tmp = os.path.join(self.directory, f".tmp-{step}")
        if self.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)   # a killed run's leftovers
            os.makedirs(tmp)
        dp.barrier()
        part = os.path.join(tmp, f"rank{self.rank}.pt")
        torch.save({"step": step, "rank": self.rank, "world": self.world,
                    "runner": to_state(runner)}, part + ".part")
        os.replace(part + ".part", part)
        dp.barrier()
        if self.rank == 0:
            with open(os.path.join(tmp, _META), "w") as f:
                json.dump({"step": step, "world": self.world, "seed": self.seed,
                           **dp.global_layout(runner, self.world)}, f)
            os.replace(tmp, self._step_dir(step))
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        dp.barrier()

    def meta(self, step: Optional[int] = None) -> Dict[str, Any]:
        """``meta.json`` of ``step`` (the latest by default)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        with open(os.path.join(self._step_dir(step), _META)) as f:
            return json.load(f)

    def load_ranks(self, target: Any, step: Optional[int] = None) -> List[Any]:
        """Every rank's runner of ``step`` as it was written, in rank order:
        ``target``'s structure with the files' tensors on the CPU."""
        meta = self.meta(step)
        out = []
        for r in range(meta["world"]):
            blob = torch.load(os.path.join(self._step_dir(meta["step"]), f"rank{r}.pt"),
                              map_location="cpu", weights_only=True)
            out.append(from_state(target, blob["runner"], as_saved=True))
        return out

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        """``target`` is a runner with the right structure and shapes (a
        fresh ``init`` at this run's world); returns the restored runner,
        from a checkpoint of any world size the layout allows."""
        meta = self.meta(step)
        step, written = meta["step"], meta["world"]
        if written == self.world:
            blob = torch.load(os.path.join(self._step_dir(step), f"rank{self.rank}.pt"),
                              map_location="cpu", weights_only=True)
            return from_state(target, blob["runner"])
        local = int(target.obs.shape[0])
        for key, want in dp.global_layout(target, self.world).items():
            if key in meta and meta[key] != want:
                per_rank = (f" ({local} per rank x {self.world} ranks)"
                            if key == "num_envs" else "")
                raise ValueError(f"checkpoint {self._step_dir(step)} holds {key}="
                                 f"{meta[key]}; this run has {key}={want}{per_rank}")
        parts = self.load_ranks(target, step)
        full = dp.unshard_runners(parts, self.field_dims)
        mine = dp.shard_runner(full, self.field_dims, self.rank, self.world)
        for f in dataclasses.fields(mine):
            gen = getattr(mine, f.name)
            if not isinstance(gen, torch.Generator):
                continue
            if self.rank < written:
                gen.set_state(getattr(parts[self.rank], f.name).get_state())
            else:
                gen.manual_seed(dp.resume_seed(meta.get("seed", self.seed), self.rank,
                                               self.world, step))
        return from_state(target, to_state(mine))

    def close(self) -> None:
        pass
