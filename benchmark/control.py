"""Readings from which the output check's limits are set, on the card at a
cell's own size (the benchmark's own runs never run this):

- ``--program-seeds``: the program's set-up (its first two iterations
  through ``train_block``, recorded) and the check against the reference,
  one seed after another in one process: the lower readings;
- ``--control-seeds``: the control, the reference in the program's place
  computed with TF32 (the nearest precision below the configuration's
  float32), judged by the reference in float32: the upper readings;
- ``--faults``: the reference in the program's place with a fault planted
  (``half``: each loss over half of the batch; ``altered``: one action
  changed where it was drawn; ``unchanged``: a step that returns the
  parameters as they were), on the control seeds.

    python3 benchmark/control.py --workload mappo_rnn_3m-8192envs \\
        --program-seeds 1 2 3 --control-seeds 4 5 6 --faults half altered

One JSON line per reading on standard output.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.cell_spec(args.workload)
    fam = harness.family(cell)
    for seed in args.program_seeds:
        t0 = time.perf_counter()
        cap = harness.run_cell(cell, seed, 0.0, False, t0, args.device)["capture"]
        t1 = time.perf_counter()
        nums = fam.check(cell, seed, cap, args.device)
        print(json.dumps({"kind": "program", "seed": seed, "numbers": nums,
                          "setup_s": t1 - t0, "check_s": time.perf_counter() - t1}), flush=True)
    for fault in [""] + list(args.faults):
        for seed in args.control_seeds:
            t0 = time.perf_counter()
            nums = fam.control(cell, seed, args.device, tf32=not fault, fault=fault)
            print(json.dumps({"kind": fault or "tf32", "seed": seed, "numbers": nums,
                              "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
