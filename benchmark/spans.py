"""The program's spans in one cell: where a block's host time goes, layer by
layer, and which layer launches each device operation.

    python3 benchmark/spans.py --workload mappo_rnn_3m-8192envs --seed 7 --seconds 30

from the root of a checkout, on a machine with a card. After the cell's
set-up and window (the harness's own), one block runs unprofiled with the
program's spans recording (``cleanmarl_tpu_torch/core/tracing.py``): host
time by span (``program_spans``: calls, ``host_s``, ``self_s``), and that
block's wall against the window's mean block, the cost of recording. Then
the cell's profiled block runs with the spans on: each device operation
goes to the innermost span, the program's or the benchmark's, open when the
host call that launched it began, on any thread (``span_ops``: calls,
operations, device seconds), and each idle gap to the innermost span open
when it began. From these, ``readings`` gives the per-layer numbers of
``READINGS``. Prints one JSON line.

Host times come from the unprofiled block, since the profiler's work at
each launch would swell the launch-heavy spans; operation counts come from
the profiled one, where they are exact. Where the program has no
``core/tracing.py`` nothing is recorded and the span readings are absent.
"""
from __future__ import annotations

import importlib
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402
from benchmark import trace as tr  # noqa: E402

TRACING = "cleanmarl_tpu_torch.core.tracing"


def tracing_module():
    """The program's tracing module, or None where the program has none."""
    try:
        return importlib.import_module(TRACING)
    except ModuleNotFoundError as e:
        if e.name != TRACING:
            raise
        return None


def traced_block(run, tracing) -> dict:
    """The window's own call, ``run.block()``, once with the spans recording
    and no profiler, timed as the window times a block."""
    with tracing.recording() as rec:
        b0 = time.perf_counter()
        _, host = run.block()
        wall = time.perf_counter() - b0
    spans = {k: {f: v[f] for f in ("calls", "host_s", "self_s")} for k, v in rec.spans.items()}
    return {"program_spans": spans, "traced_block_wall_s": wall,
            "failed": int(not all(math.isfinite(v) for v in host.values()))}


# ---------------------------------------------------------------------------
# the trace → device operations by span, idle gaps by span
# ---------------------------------------------------------------------------
def _is_launch(name: str) -> bool:
    """A call of the CUDA runtime or driver API (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...)."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def events(kineto_events, program: Sequence[str]):
    """One pass over the profiler's events → (device operations as [(name,
    start_us, end_us, launch_us or None)] in start order, spans as [(name,
    start_us, end_us)] in start order). A span is a host annotation of the
    benchmark's (``bench.*``) or named in ``program``. An operation's launch
    is the runtime call of its correlation id, on whichever thread made it."""
    program = set(program)
    launches: Dict[int, float] = {}
    device, spans = [], []
    for e in kineto_events:
        name, start = e.name(), e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        on_device = e.device_type().name == "CUDA"
        if tr._annotation(e):
            if not on_device and (name.startswith(tr.SPAN_PREFIX) or name in program):
                spans.append((name, start, end))
        elif on_device:
            if end > start:
                device.append((name, start, end, e.correlation_id()))
        elif _is_launch(name):
            launches[e.correlation_id()] = start
    device = [(n, s, e, launches.get(c)) for n, s, e, c in device]
    device.sort(key=lambda x: x[1])
    spans.sort(key=lambda x: x[1])
    return device, spans


def innermost(spans: List[Tuple[str, float, float]],
              points: Sequence[float]) -> List[Optional[str]]:
    """For each time of ``points`` (ascending), the span of ``spans`` (in
    start order) that began last among those open at that time, ends
    included, or None: one sweep over both."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(spans) and spans[i][1] <= t:
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def reduce(device, spans, top: int = 10) -> dict:
    """→ ``span_ops`` (name → calls, device operations launched inside it and
    no inner span, their device seconds; ``outside`` for those launched in
    no span), ``unmatched`` (operations whose launch was not found), the
    idle gaps by the span open when each began (the harness's
    ``breakdown``), and for the operations that took most device time, the
    spans that launched them. A trace with no device operation has no
    ``span_ops`` to read."""
    span_ops: Dict[str, dict] = {}
    for n, _, _ in spans if device else ():
        span_ops.setdefault(n, {"calls": 0, "ops": 0, "device_s": 0.0})["calls"] += 1
    launched = sorted((x for x in device if x[3] is not None), key=lambda x: x[3])
    by_op: Dict[str, Dict[str, float]] = {}
    for (op, s, e, _), name in zip(launched, innermost(spans, [x[3] for x in launched])):
        name = name or "outside"
        d = span_ops.setdefault(name, {"calls": 0, "ops": 0, "device_s": 0.0})
        d["ops"] += 1
        d["device_s"] += (e - s) / 1e6
        where = by_op.setdefault(op, {})
        where[name] = where.get(name, 0.0) + (e - s) / 1e6
    intervals = [(n, s, e) for n, s, e, _ in device]
    idle: Dict[str, float] = {}
    gaps = tr.gaps(intervals)
    for (g0, g1), name in zip(gaps, innermost(spans, [g[0] for g in gaps])):
        name = name or "outside"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e6
    ops = sorted(tr.kernel_totals(intervals).items(), key=lambda kv: -kv[1][0])[:top]
    return {"span_ops": span_ops, "unmatched": len(device) - len(launched),
            "breakdown": {"device_ops": [[n, v[0]] for n, v in ops],
                          "idle_gaps": sorted(([n, v] for n, v in idle.items()),
                                              key=lambda x: -x[1])[:top]},
            "top_ops_by_span": {n: dict(sorted(by_op.get(n, {}).items(), key=lambda kv: -kv[1]))
                                for n, _ in ops}}


def profiled_block(run, device: str, tracing) -> dict:
    """The cell's profiled block (``trace.profile``) with the spans on →
    ``reduce``'s result, the block's wall and the reduction's seconds."""
    with tracing.recording() as rec:
        prof, wall, _ = tr.profile(run, run.trace_blocks, device)
    t0 = time.perf_counter()
    out = reduce(*events(prof.profiler.kineto_results.events(), list(rec.spans)))
    out["reduce_s"] = time.perf_counter() - t0
    out["profiled_wall_s"] = wall
    return out


# ---------------------------------------------------------------------------
# the per-layer numbers
# ---------------------------------------------------------------------------
def _per_call(ctx: dict, key: str, name: str, field: str, scale: float = 1.0):
    s = ctx.get(key, {}).get(name)
    return None if not s or not s["calls"] else scale * s[field] / s["calls"]


def _grad_ms(ctx: dict):
    s = ctx.get("program_spans", {})
    if not {"ppo.minibatch", "ppo.actor_grad", "ppo.critic_grad"} <= set(s):
        return None
    return 1e3 * (s["ppo.actor_grad"]["host_s"] + s["ppo.critic_grad"]["host_s"]) / \
        s["ppo.minibatch"]["calls"]


READINGS = {
    # host ms of one batched env step, and the device operations it launches
    "env_step_ms.smaclite": lambda c: _per_call(c, "program_spans", "env.step", "self_s", 1e3),
    "env_step_ops.smaclite": lambda c: _per_call(c, "span_ops", "env.step", "ops"),
    # host ms of a rollout step but its env step: the actor, sampling, the writes
    "act_ms.mappo": lambda c: _per_call(c, "program_spans", "ppo.rollout_step", "self_s", 1e3),
    # host ms of one minibatch's forward and backward, actor and critic
    "grad_ms.mappo": _grad_ms,
    # host ms of one optimizer step of one network, and its device operations
    "optim_step_ms": lambda c: _per_call(c, "program_spans", "optim.update", "self_s", 1e3),
    "optim_step_ops": lambda c: _per_call(c, "span_ops", "optim.update", "ops"),
}


def readings(ctx: dict) -> Dict[str, Optional[float]]:
    """Each of ``READINGS`` from ``ctx``, None where it finds nothing to
    read (a ``ctx`` without ``program_spans`` or ``span_ops``)."""
    return {name: fn(ctx) for name, fn in READINGS.items()}


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------
def report(cell: dict, seed: int, seconds: float, device: str = "cuda") -> dict:
    """Set-up and the window as the harness runs them, then the traced and
    the profiled block → the readings, by span."""
    run = harness.family(cell).setup(cell, seed, device)
    win = harness.window(run, seconds)
    out = {"attempted": win["blocks"], "failed": win["failed"],
           "window_block_s": win["wall_s"] / win["blocks"]}
    tracing = tracing_module()
    if tracing is not None:
        t = traced_block(run, tracing)
        out["attempted"] += 1
        out["failed"] += t.pop("failed")
        out.update(t)
        out["tracing_cost"] = out["traced_block_wall_s"] / out["window_block_s"] - 1.0
        out.update(profiled_block(run, device, tracing))
        out["attempted"] += run.trace_blocks
    out["readings"] = readings(out)
    run.free()
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="The program's spans in one cell, on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = harness.cell_spec(args.workload)

    import torch
    if not torch.cuda.is_available():
        print("spans: needs a CUDA device", file=sys.stderr)
        return 2
    out = report(cell, args.seed, args.seconds)
    found = harness.forbidden_modules()
    if found:
        print(f"spans: modules of the JAX side were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    out["device"] = {"kind": torch.cuda.get_device_name(), "count": 1}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
