"""K1, the λ-returns (``ops/returns_kernel.py``, ``csrc/lambda_returns.cu``):
the bytes it needs at the cell's shape over the memory bandwidth, times its
launches in the profiled blocks, over its device time there, in %."""
from benchmark.metrics._kernels import device_time
from benchmark.yardstick import returns_least_s


def read(ctx):
    secs, n = device_time(ctx, "lambda_returns_kernel")
    if secs <= 0 or "returns" not in ctx["shapes"]:
        return None
    return 100.0 * n["lambda_returns_kernel"] * returns_least_s(*ctx["shapes"]["returns"]) / secs
