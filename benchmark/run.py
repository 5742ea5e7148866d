"""Run one cell of the benchmark on the card(s):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the checks on standard error and the
result as the last line of standard output; exits non-zero, with no
result, without enough CUDA devices or if anything of the JAX side was
loaded.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
