"""The benchmark's harness: finds a cell's parts by name, runs set-up, the
measured window, with tracing the traced blocks after it, the output
check, and prints the result line.

Everything about one configuration, traffic mix or per-layer metric lives
in files of its own, found by the names in ``BENCHMARK.json``:

- ``benchmark/configs/<config>.json``: the configuration as it is run; its
  ``family`` names the adapter in ``benchmark/families/`` (set-up, block,
  traced block, output check) and the reference in ``benchmark/reference/``;
- ``benchmark/traffic/<traffic>.json``: the mix's parameters (envs,
  iterations a block);
- ``benchmark/limits/<cell>.json``: the limit of each number the output
  check compares;
- ``benchmark/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(ctx) -> float | None``.
"""
from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cleanmarl_tpu")


# ---------------------------------------------------------------------------
# finding things by name
# ---------------------------------------------------------------------------
def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_spec(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration, traffic, limits and the
    metrics it reports, each read from its own file."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have: {', '.join(cells)})")
    cell = dict(cells[name])
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    bench = root / "benchmark"
    cell["config_file"] = json.loads((root / conf["file"]).read_text())
    cell["traffic_file"] = json.loads((bench / "traffic" / f"{cell['traffic']}.json").read_text())
    cell["limits"] = json.loads((bench / "limits" / f"{name}.json").read_text())
    cell["end_to_end"] = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    cell["per_layer"] = [m for m in spec["per_layer"] if name in m.get("workloads", [name])]
    cell["root"] = str(root)
    return cell


def family(cell: dict):
    return importlib.import_module(f"benchmark.families.{cell['config_file']['family']}")


def metric_reader(name: str, root: Path = ROOT):
    path = Path(root) / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sub_seed(seed: int, tag: str) -> int:
    """A seed for one input of the run, derived from ``--seed``."""
    h = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") % (2**63)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def sync(device: str):
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# set-up, the window, then the traced blocks
# ---------------------------------------------------------------------------
def run_cell(cell: dict, seed: int, seconds: float, trace: bool, t0: float,
             device: str) -> dict:
    """Set-up, the measured window, and with ``trace`` the traced blocks
    after it. The program's state is freed before it returns; what the output
    check needs is in ``capture`` (CPU tensors)."""
    import torch

    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    run = family(cell).setup(cell, seed, device)
    sync(device)
    out = {"setup_s": time.perf_counter() - t0}
    out.update(window(run, seconds))
    if trace:
        out["ctx"] = traced(run, device, out)
        out["blocks"] += run.trace_blocks
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    out["kind"] = torch.cuda.get_device_name() if cuda else "cpu"
    out["capture"] = run.capture
    run.free()
    del run
    if cuda:
        torch.cuda.empty_cache()
    return out


def window(run, seconds: float) -> dict:
    """Whole blocks for ``seconds``: the env steps they completed, their
    model FLOPs, their wall (the last block's host read included) and each
    block's wall with the program's update count after it."""
    blocks = failed = steps = 0
    log = []
    flops0 = run.flops
    start = time.perf_counter()
    while time.perf_counter() - start < seconds or blocks == 0:
        b0 = time.perf_counter()
        n, host = run.block()
        log.append([time.perf_counter() - b0, host.get("train/num_updates", 0.0)])
        blocks, steps = blocks + 1, steps + n
        failed += not all(math.isfinite(v) for v in host.values())
    return {"blocks": blocks, "failed": failed, "steps": steps, "block_log": log,
            "wall_s": time.perf_counter() - start, "model_flops": run.flops - flops0}


def traced(run, device: str, win: dict) -> dict:
    """After the unprofiled window ``win``, ``run.trace_blocks`` blocks
    driven through the family's layer calls under ``torch.profiler`` with
    the benchmark's spans around them, then the family's own timings."""
    from benchmark import trace as tr

    k = run.trace_blocks
    prof, prof_wall, prof_steps = tr.profile(run, k, device)
    events = tr.device_events(prof)
    ctx = {"wall_s": win["wall_s"], "steps": win["steps"], "blocks": win["blocks"],
           "model_flops": win["model_flops"], "profiled_blocks": k,
           "profiled_wall_s": prof_wall, "profiled_steps": prof_steps,
           "kernels": tr.kernel_totals(events), "busy_s": tr.union_seconds(events),
           "breakdown": tr.breakdown(prof, events)}
    del prof, events
    ctx["spans"] = run.timings()
    ctx["shapes"] = run.shapes()
    return ctx


# ---------------------------------------------------------------------------
# a whole run → the result line
# ---------------------------------------------------------------------------
def execute(cell: dict, seed: int, seconds: float, trace: bool, t0: float,
            device: str = "cuda") -> dict:
    """Run the cell, check its outputs → the result dict (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, [``breakdown``],
    ``checks``)."""
    out = run_cell(cell, seed, seconds, trace, t0, device)
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    peak = out["memory_peak_bytes"]
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": out["kind"],
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": out["blocks"], "failed": out["failed"]}
    if not trace:
        values = {"env_steps_per_s": out["steps"] / out["wall_s"],
                  "peak_mem_gib": peak / 2**30,
                  "setup_s": out["setup_s"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    else:
        ctx = out["ctx"]
        metrics = {}
        for m in cell["per_layer"]:
            v = metric_reader(m["name"], Path(cell["root"]))(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = ctx["busy_s"]
        dev["window_s"] = ctx["profiled_wall_s"]
        result["breakdown"] = ctx["breakdown"]
    result["metrics"] = metrics
    result["device"] = dev
    # each block's wall in the window and the program's update count after it
    result["blocks"] = out["block_log"]
    checks = family(cell).check(cell, seed, out["capture"], device)
    compared = {k: {"value": v, "limit": cell["limits"][k]} for k, v in checks.items()}
    result["correct"] = (result["failed"] == 0 and
                         all(c["value"] <= c["limit"] for c in compared.values()))
    result["checks"] = compared
    return result


class ForbiddenImport(RuntimeError):
    pass


def main(argv=None, t0: float | None = None) -> int:
    import argparse

    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark on the card(s).")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cell_spec(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result = execute(cell, args.seed, args.seconds, bool(args.trace), t0)
    except ForbiddenImport as e:
        print(f"benchmark: modules of the JAX side were loaded: {', '.join(e.args[0])}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
