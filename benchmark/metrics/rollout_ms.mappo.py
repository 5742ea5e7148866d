"""One MAPPO rollout (``collect_rollout``), timed alone between device syncs
by the program's ``phase_timer`` (mean of 3, the generator put back), ms."""


def read(ctx):
    s = ctx["spans"].get("mappo.rollout_s")
    return None if s is None else 1e3 * s
