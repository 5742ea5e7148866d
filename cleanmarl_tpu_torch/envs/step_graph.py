"""The batched env step replayed from CUDA graphs (``VecEnv.step`` on a card).

One eager ``VecEnv.step`` launches every op of the env's step, its all-env
reset and the auto-reset selection one by one: a few hundred small kernels
whose launches cost the host more than the device takes to run them. A
``StepGraph`` records them once and replays them, keeping the step's
functional contract:

- the caller's state and actions are copied into the graph's own input
  buffers, so a caller's tensors are never written;
- every output is handed out as a fresh copy, so a later call overwrites
  nothing a caller holds;
- the step's random draws come from the caller's generator, registered
  with the graphs: a replay advances it as the eager step does, from
  wherever ``set_state`` or ``manual_seed`` left it.

Two graphs, replayed in turn: ``step`` (the env's step; the new state goes
back into the input buffers) and, with auto-reset, ``reset`` (the all-env
reset and the selection, written over the step's buffers). The pre-reset
``final`` is copied out between them, so the graphs hold one state, the
actions and one ``TimeStep`` between calls, never two.

A capture runs no op: the call that captures replays at once, so no step is
repeated or skipped. The step and reset of a device ``Environment`` read
nothing back to the host (the JAX contract); a read inside them makes the
capture fail.
"""
from __future__ import annotations

import dataclasses

import torch

from cleanmarl_tpu_torch.core.tracing import span
from cleanmarl_tpu_torch.types import TimeStep

_SELECTED = ("obs", "state", "avail")     # the fields auto-reset replaces


def capturable(env) -> bool:
    """Whether ``env``'s step can be captured: its tensors live on a card."""
    return env.device.type == "cuda"


def capture(fn, generator: torch.Generator, device, pool=None):
    """Record ``fn``'s launches on ``device`` as one CUDA graph, drawing from
    ``generator`` → (replay, the graph's memory pool)."""
    with torch.cuda.device(device):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                fn()
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
    return graph.replay, graph.pool()


def layout(state, actions) -> tuple:
    """What a graph is fixed to: the state's class and each input's shape and
    dtype (strides are not: the inputs are copied into contiguous buffers)."""
    xs = [getattr(state, f.name) for f in dataclasses.fields(state)] + [actions]
    return (type(state),) + tuple((x.shape, x.dtype) for x in xs)


def _buffer(x: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _copy_ts(ts: TimeStep) -> TimeStep:
    return TimeStep(obs=ts.obs.clone(), state=ts.state.clone(), avail=ts.avail.clone(),
                    reward=ts.reward.clone(), done=ts.done.clone(),
                    truncated=ts.truncated.clone(),
                    info={k: v.clone() for k, v in ts.info.items()})


class StepGraph:
    """``vec``'s step captured for inputs laid out as ``state`` and
    ``actions``, drawing from ``generator``; ``self(state, actions)`` is
    ``vec.step(state, actions, generator)``."""

    def __init__(self, vec, state, actions, generator: torch.Generator):
        self.vec, self.env, self.auto_reset = vec, vec.env, vec.auto_reset
        self.generator, self.layout, self.cls = generator, layout(state, actions), type(state)
        self.state_in = {f.name: _buffer(getattr(state, f.name))
                         for f in dataclasses.fields(state)}
        self.actions_in = _buffer(actions)
        self.ts = None                     # the step's TimeStep, set by the capture
        dev = self.env.device
        with span("env.step.capture"):
            self._step, pool = capture(self._step_body, generator, dev)
            self._reset = (capture(self._reset_body, generator, dev, pool)[0]
                           if self.auto_reset else None)

    def fits(self, state, actions) -> bool:
        return layout(state, actions) == self.layout

    # -- what the graphs record ------------------------------------------
    def _step_body(self):
        state2, ts = self.env.step(self.cls(**self.state_in), self.actions_in, self.generator)
        self.ts = _copy_ts(ts)             # buffers that no env tensor shares
        for k, x in self.state_in.items():
            x.copy_(getattr(state2, k))    # a field the step kept is itself: no copy

    def _reset_body(self):
        state, ts = self.vec._auto_reset(self.cls(**self.state_in), self.ts, self.generator)
        for k, x in self.state_in.items():
            x.copy_(getattr(state, k))
        for k in _SELECTED:
            getattr(self.ts, k).copy_(getattr(ts, k))

    # -- a call ------------------------------------------------------------
    def __call__(self, state, actions):
        with span("env.step.replay"):
            for k, x in self.state_in.items():
                x.copy_(getattr(state, k))
            self.actions_in.copy_(actions)
            self._step()
            final = _copy_ts(self.ts)
            if self.auto_reset:
                self._reset()
                ts = final.replace(**{k: getattr(self.ts, k).clone() for k in _SELECTED})
            else:
                ts = final
            return self.cls(**{k: x.clone() for k, x in self.state_in.items()}), ts, final
