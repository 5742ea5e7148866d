"""The spread of a cell's end-to-end metrics between runs, and where the slow
runs lost their time:

    python3 benchmark/spread.py --workload mappo_rnn_3m-8192envs --seconds 30 \\
        --seeds 11 12 13 14 15 16 --sets 2 --out runs/spread.jsonl \\
        [--roots . .chipwork/parent]

from the root of a checkout, on a machine with the cell's card. Runs
``run.py --trace 0`` once for each seed, set and root, one process after
another: for each seed the sets in turn, and the roots in turn, their order
reversed every other time (parent, change, change, parent), as the
benchmark's check runs them. Each result line goes to ``--out`` with its
root, set and seed. The last line of standard output is the summary: for
each root and set, each end-to-end metric's values run for run and their
spread (the distance between the first and third quartiles of
``statistics.quantiles(values, n=4)`` over the median), also without the
run farthest from the median. The same of the window's blocks a second,
``blocks_per_s`` (the spread of any rate of the cell's fixed blocks), and
of one over the median block, ``blocks_per_s.median``; run by run, the
mean block over the median one and the slow blocks' indices. For each
root and metric, ``larger_spread`` is the larger of its sets' spreads,
and ``tightness`` the mean of its sets' spreads without their farthest
runs.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

SLOW = 1.25         # a block this many times the run's median block is slow
TIMEOUT_S = 360.0   # a run that prints no result by then has none


def quartile_spread(values) -> float:
    """(Q3 - Q1) / median; 0 for fewer than two values."""
    if len(values) < 2:
        return 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def spread_without_farthest(values) -> float:
    """The quartile spread of ``values`` without the one farthest from their
    median."""
    if len(values) < 3:
        return quartile_spread(values)
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return quartile_spread([v for i, v in enumerate(values) if i != far])


def block_reading(blocks) -> dict:
    """One run's block log (``[wall, updates]`` a block) → the mean block
    over the median one and the slow blocks' indices."""
    walls = [b[0] for b in blocks]
    med = statistics.median(walls)
    return {"blocks": len(walls), "median_s": med, "mean_s": statistics.fmean(walls),
            "mean_over_median": statistics.fmean(walls) / med,
            "slow": [i for i, w in enumerate(walls) if w > SLOW * med]}


def summarize(records) -> dict:
    """{root: {set: {metric: {"values", "spread", "spread_less_far"}, the
    same of "blocks_per_s" and "blocks_per_s.median", "runs":
    [block_reading]}, "larger_spread": {metric: max of the sets' spreads},
    "tightness": {metric: mean of the sets' spreads less far}}}."""
    out = {}
    for r in records:
        res = r["result"]
        s = out.setdefault(r["root"], {}).setdefault(str(r["set"]), {"runs": []})
        if res is None:
            s["runs"].append({"seed": r["seed"], "no_result": True})
            continue
        reading = block_reading(res["blocks"])
        values = {k: m["value"] for k, m in res["metrics"].items()}
        values["blocks_per_s"] = 1.0 / reading["mean_s"]
        values["blocks_per_s.median"] = 1.0 / reading["median_s"]
        for k, v in values.items():
            s.setdefault(k, {"values": []})["values"].append(v)
        s["runs"].append(dict(reading, seed=r["seed"], correct=res["correct"]))
    for sets in out.values():
        larger, tight = {}, {}
        for s in sets.values():
            for k, v in s.items():
                if k != "runs":
                    v["spread"] = quartile_spread(v["values"])
                    v["spread_less_far"] = spread_without_farthest(v["values"])
                    larger.setdefault(k, []).append(v["spread"])
                    tight.setdefault(k, []).append(v["spread_less_far"])
        sets["larger_spread"] = {k: max(v) for k, v in larger.items()}
        sets["tightness"] = {k: statistics.fmean(v) for k, v in tight.items()}
    return out


def card() -> str | None:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def run_one(root: str, workload: str, seed: int, seconds: float) -> dict:
    t0 = time.perf_counter()
    try:
        p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                            "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"],
                           cwd=root, capture_output=True, text=True, timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return {"rc": None, "seconds": time.perf_counter() - t0, "result": None,
                "stderr_tail": f"no result within {TIMEOUT_S} s"}
    lines = p.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    except ValueError:
        result = None
    return {"rc": p.returncode, "seconds": time.perf_counter() - t0, "result": result,
            "stderr_tail": p.stderr[-2000:] if result is None else ""}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    records, turn = [], 0
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps({"card": card(), "argv": sys.argv[1:]}) + "\n")
        for seed in args.seeds:
            for set_ in range(args.sets):
                roots = args.roots if turn % 2 == 0 else args.roots[::-1]
                turn += 1
                for root in roots:
                    rec = dict(run_one(os.path.abspath(root), args.workload, seed,
                                       args.seconds),
                               root=root, set=set_, seed=seed)
                    records.append(rec)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
    print(json.dumps(summarize(records)), flush=True)
    return 0 if all(r["result"] is not None for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
