"""One recurrent-QMIX TD update (``meta["update"]`` on one sampled batch of
32 episodes of 150 steps: the target stream and mixer, the loss, its
gradient, Adam), timed alone between device syncs (mean of 3, the
generator put back; ``families/qmix.py``), ms."""


def read(ctx):
    s = ctx["spans"].get("qmix.update_s")
    return None if s is None else 1e3 * s
