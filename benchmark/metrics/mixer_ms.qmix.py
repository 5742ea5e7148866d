"""QMIX's hypernetwork mixer: the device time an update of the operations
launched inside the program's span ``net.mixer`` over one profiled block
(``families/qmix.py``), ms. The span holds the mixer's forward, the
target's and the online one's; the online mixer's backward runs under
``rq.td_grad`` and is not read here."""


def read(ctx):
    s = ctx["spans"].get("qmix.mixer_s")
    return None if s is None else 1e3 * s
