"""Every env step the whole blocks of the unprofiled window completed, over
the window's whole wall (the last block's host read included), in the
traced run before its profiled blocks: the rate a researcher pays for. It
is a per-layer reading, with no bound: on a host whose cores are shared it
spreads too widely between runs for one."""


def read(ctx):
    if ctx["wall_s"] <= 0 or ctx["steps"] <= 0:
        return None
    return ctx["steps"] / ctx["wall_s"]
