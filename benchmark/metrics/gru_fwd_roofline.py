"""K2, the GRU sequence forward (``ops/gru_kernel.py``, ``csrc/gru_seq_fwd.cu``):
its least time at the cell's T, M and H times its launches in the profiled
blocks, over its device time there, in %."""
from benchmark.metrics._kernels import device_time
from benchmark.yardstick import gru_least_s


def read(ctx):
    secs, n = device_time(ctx, "gru_seq_fwd_tc_kernel")
    if secs <= 0:
        return None
    (T, M, H), = ctx["shapes"]["gru"]
    return 100.0 * n["gru_seq_fwd_tc_kernel"] * gru_least_s(T, M, H)["fwd"] / secs
