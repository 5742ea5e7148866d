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
own runner (``rank<r>.pt``: a rank holds only its share of the envs), and
a checkpoint restores only at the world size that wrote it.

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
from typing import Any, List, Optional

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


def from_state(template, saved, path: str = "runner") -> Any:
    """``saved`` (from ``to_state``) laid onto ``template``: the template's
    structure, devices and dtypes with the saved values. Raises ValueError
    naming the field where the two differ."""
    def mismatch(what):
        return ValueError(f"checkpoint does not fit the runner at {path}: {what}")

    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise mismatch(f"expected a tensor, found {type(saved).__name__}")
        if tuple(saved.shape) != tuple(template.shape):
            raise mismatch(f"shape {tuple(saved.shape)} in the file, "
                           f"{tuple(template.shape)} in the runner")
        return saved.to(device=template.device, dtype=template.dtype)
    if isinstance(template, torch.Generator):
        if not (isinstance(saved, dict) and _GEN in saved):
            raise mismatch("expected a generator state")
        template.set_state(saved[_GEN])
        return template
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            got = sorted(saved) if isinstance(saved, dict) else type(saved).__name__
            raise mismatch(f"keys {got} in the file, {sorted(template)} in the runner")
        return {k: from_state(v, saved[k], f"{path}.{k}") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, list) or len(saved) != len(template):
            raise mismatch(f"expected a sequence of {len(template)}")
        out = [from_state(v, s, f"{path}[{i}]") for i, (v, s) in
               enumerate(zip(template, saved))]
        return type(template)(out)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        names = [f.name for f in dataclasses.fields(template)]
        if not isinstance(saved, dict) or set(saved) != set(names):
            raise mismatch(f"expected the fields {names}")
        return dataclasses.replace(template, **{
            k: from_state(getattr(template, k), saved[k], f"{path}.{k}") for k in names})
    if template is None or isinstance(template, (bool, int, float, str)):
        if type(saved) is not type(template):
            raise mismatch(f"{type(saved).__name__} in the file, "
                           f"{type(template).__name__} in the runner")
        return saved
    if hasattr(template, "__dict__"):
        attrs = vars(template)
        if not isinstance(saved, dict) or set(saved) != set(attrs):
            raise mismatch(f"expected the attributes {sorted(attrs)}")
        out = copy.copy(template)
        out.__dict__.update({k: from_state(v, saved[k], f"{path}.{k}")
                             for k, v in attrs.items()})
        return out
    raise TypeError(f"cannot restore a {type(template).__name__} at {path}")


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
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
                json.dump({"step": step, "world": self.world}, f)
            os.replace(tmp, self._step_dir(step))
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        dp.barrier()

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        """``target`` is a runner with the right structure and shapes (a
        fresh ``init``); returns the restored runner."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        with open(os.path.join(self._step_dir(step), _META)) as f:
            world = json.load(f)["world"]
        if world != self.world:
            raise ValueError(
                f"checkpoint {self._step_dir(step)} was written by {world} rank(s); "
                f"this run has {self.world}: restore at the same world size")
        blob = torch.load(os.path.join(self._step_dir(step), f"rank{self.rank}.pt"),
                          map_location="cpu", weights_only=True)
        return from_state(target, blob["runner"])

    def close(self) -> None:
        pass
