"""Spans and counters at the port's layer boundaries.

``span(name)`` marks one call of a layer, named ``<layer>.<what>``
(``env.step``, ``optim.update``, ...); ``count(name, value)`` adds to a
counter of the same kind of name (``ppo.alive_agent_steps``).
``recording()`` switches both on for its extent and yields the ``Record``
they fill:

    with recording() as rec:
        runner, metrics = train_block(runner)
    rec.spans["env.step"]      # {"calls", "host_s", "self_s"}
    rec.counter_values()       # {"ppo.agent_steps": ..., ...}

With no recording open, ``span`` returns one shared no-op context: it
reads no clock, enters no ``record_function`` and allocates nothing, so a
run that records nothing pays one check a span; ``count`` returns after
the same check.

A counter takes a host number or a device tensor. A tensor is summed on
its device and stays there: counting reads nothing back, so it costs no
host sync. ``Record.counter_values`` reads every counter to the host in
one transfer, once the recording has closed.

With a recording open, each span adds to its name's entry: ``calls``;
``host_s``, the host's wall between entry and exit
(``time.perf_counter_ns``); and ``self_s``, that less the part its child
spans cover. While a ``torch.profiler`` runs, each span also enters
``record_function(name)``, so that it lies on the profiler's timeline,
the clock of every device operation.

Spans are opened on the thread that opened the recording (the program
opens none on other threads). The record stays in memory; nothing is
written to disk here.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Union

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()
_record: Optional["Record"] = None


class Record:
    """What the spans and counters of one recording measured, by name."""

    def __init__(self):
        self.spans: Dict[str, dict] = {}
        self.counters: Dict[str, Union[float, torch.Tensor]] = {}
        self._open: List[list] = []       # [name, child ns] of each open span, innermost last

    def counter_values(self) -> Dict[str, float]:
        """Every counter as a host float, the device's in one transfer."""
        out = {k: float(v) for k, v in self.counters.items() if not torch.is_tensor(v)}
        on_device = [k for k, v in self.counters.items() if torch.is_tensor(v)]
        if on_device:
            values = torch.stack([self.counters[k] for k in on_device]).tolist()
            out.update(zip(on_device, values))
        return out

    def _stats(self, name: str) -> dict:
        s = self.spans.get(name)
        if s is None:
            s = self.spans[name] = {"calls": 0, "host_s": 0.0, "self_s": 0.0}
        return s


class _Span:
    __slots__ = ("record", "frame", "t0", "annotation")

    def __init__(self, name: str, record: Record):
        self.record = record
        self.frame = [name, 0]

    def __enter__(self):
        self.annotation = None
        if _profiler._is_profiler_enabled:
            self.annotation = _profiler.record_function(self.frame[0])
            self.annotation.__enter__()
        self.record._open.append(self.frame)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        stack = self.record._open
        stack.pop()
        if stack:
            stack[-1][1] += dt
        name, child_ns = self.frame
        s = self.record._stats(name)
        s["calls"] += 1
        s["host_s"] += dt * 1e-9
        s["self_s"] += (dt - child_ns) * 1e-9
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name: str):
    """A context that measures one call of a layer while a recording is
    open, and does nothing otherwise."""
    rec = _record
    if rec is None:
        return _OFF
    return _Span(name, rec)


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a tensor summed on its device in
    float64) to the counter ``name`` while a recording is open; nothing
    otherwise."""
    rec = _record
    if rec is None:
        return
    if torch.is_tensor(value):
        value = value.detach().sum(dtype=torch.float64)
    rec.counters[name] = rec.counters.get(name, 0) + value


@contextlib.contextmanager
def recording():
    """Spans and counters on for the extent of the block → the ``Record``
    they fill."""
    global _record
    if _record is not None:
        raise RuntimeError("a recording is already open")
    _record = Record()
    try:
        yield _record
    finally:
        _record = None
