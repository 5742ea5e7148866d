"""The traced run's profile and its reduction to device time.

A few blocks run under ``torch.profiler`` (host and device activity), each
driven by the family through the program's layer calls inside the
benchmark's own spans (``record_function("bench.<layer>")``). From the
trace: every device operation's interval, their union (the device's busy
time; one stream, but copies and kernels may overlap), the totals by
name, and the idle gaps between device operations, each named by the
innermost benchmark span the host was in when the gap began.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

SPAN_PREFIX = "bench."


def profile(run, k: int, device: str):
    """``k`` of the family's traced blocks under the profiler → (profile,
    wall seconds, env steps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile

    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    steps = 0
    with _profile(activities=acts) as prof:
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            steps += run.traced_block()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall, steps


def _annotation(e) -> bool:
    """An annotation, not an operation: flagged so by the profiler where it
    can tell, else known by name (the benchmark's spans)."""
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag and flag()) or e.name().startswith(SPAN_PREFIX)


def _raw(prof):
    """[(name, kind, start_us, end_us)] of every recorded event; ``kind`` is
    "device" for an operation that ran on the device, "span" for an
    annotation on the host's timeline (the benchmark's spans), "mark" for
    one drawn on the device's (the spans' shadows: no operation of their
    own), "host" otherwise."""
    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type().name == "CUDA"
        if _annotation(e):
            kind = "mark" if on_device else "span"
        else:
            kind = "device" if on_device else "host"
        start = e.start_ns() / 1e3
        out.append((e.name(), kind, start, start + e.duration_ns() / 1e3))
    return out


def device_events(prof) -> List[Tuple[str, float, float]]:
    """[(name, start_us, end_us)] of every operation that ran on the device,
    in start order."""
    return sorted(((n, s, e) for n, kind, s, e in _raw(prof) if kind == "device" and e > s),
                  key=lambda x: x[1])


def kernel_totals(events) -> Dict[str, Tuple[float, int]]:
    """{name: (device seconds, count)}."""
    tot: Dict[str, list] = {}
    for n, s, e in events:
        t = tot.setdefault(n, [0.0, 0])
        t[0] += (e - s) / 1e6
        t[1] += 1
    return {k: (v[0], v[1]) for k, v in tot.items()}


def union_seconds(events) -> float:
    """Seconds in which at least one device operation ran."""
    busy, end = 0.0, float("-inf")
    for _, s, e in events:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e6


def gaps(events) -> List[Tuple[float, float]]:
    """The idle intervals (start_us, end_us) between device operations."""
    out, end = [], None
    for _, s, e in events:
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def breakdown(prof, events, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time between
    device operations summed by the benchmark span the host was in when
    each gap began (``outside`` where none was open)."""
    spans = sorted(((n, s, e) for n, kind, s, e in _raw(prof)
                    if kind == "span" and n.startswith(SPAN_PREFIX)), key=lambda x: x[1])
    idle: Dict[str, float] = {}
    for g0, g1 in gaps(events):
        inner = None
        for n, s, e in spans:
            if s > g0:
                break
            if e >= g0 and (inner is None or s >= inner[1]):
                inner = (n, s)
        name = inner[0] if inner else "outside"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e6
    ops = sorted(kernel_totals(events).items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_ops": [[n, v[0]] for n, v in ops],
            "idle_gaps": sorted(([n, v] for n, v in idle.items()), key=lambda x: -x[1])[:top]}
