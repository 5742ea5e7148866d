"""The episode ring: the device time an iteration of the operations
launched inside the program's spans ``ring.commit`` (every env's step
written to its row or the scratch row) and ``ring.sample`` (the batches
gathered) over one profiled block (``families/qmix.py``), ms."""


def read(ctx):
    s = ctx["spans"].get("qmix.ring_s")
    return None if s is None else 1e3 * s
