"""The whole training step's share of the card's peak, in %: the model FLOPs
of the env steps the unprofiled window's blocks completed (the benchmark's
own count, ``yardstick``), over their wall, over the card's
highest float32-accurate matmul rate (495 TFLOP/s of TF32 over the three
TF32 products a float32 product takes)."""
from benchmark.yardstick import PEAK_MATMUL_F32_FLOPS


def read(ctx):
    if ctx["wall_s"] <= 0 or ctx["model_flops"] <= 0:
        return None
    return 100.0 * ctx["model_flops"] / ctx["wall_s"] / PEAK_MATMUL_F32_FLOPS
