"""K3 and dw together, the GRU sequence backward (``ops/gru_kernel.py``,
``csrc/gru_seq_bwd.cu``: the recurrence, the recurrent weight's gradient
and its reduction): the least time of each at the cell's T, M and H times
its launches in the profiled blocks, over their device time there, in %."""
from benchmark.metrics._kernels import device_time
from benchmark.yardstick import gru_least_s

NAMES = ("gru_seq_bwd_tc_kernel", "gru_seq_dw_tc_kernel", "gru_seq_dw_reduce_kernel")


def read(ctx):
    secs, n = device_time(ctx, *NAMES)
    if secs <= 0:
        return None
    (T, M, H), = ctx["shapes"]["gru"]
    least = gru_least_s(T, M, H)
    return 100.0 * (n[NAMES[0]] * least["bwd"] + n[NAMES[1]] * least["dw"]) / secs
