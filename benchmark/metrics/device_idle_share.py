"""The device's idle share, in %: one minus the device time of the profiled
blocks (the union of every device operation's interval) over the wall that
as many blocks took, on average, in the unprofiled window just before, in
the same process."""


def read(ctx):
    if ctx["wall_s"] <= 0 or ctx["busy_s"] <= 0:
        return None
    block_s = ctx["wall_s"] / ctx["blocks"]
    return 100.0 * (1.0 - ctx["busy_s"] / (ctx["profiled_blocks"] * block_s))
