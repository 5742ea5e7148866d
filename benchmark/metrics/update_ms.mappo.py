"""One MAPPO update (``ppo_update``: λ-returns, 8 epochs x 8 minibatches),
timed alone between device syncs by the program's ``phase_timer`` (mean of
3 on one rollout), ms."""


def read(ctx):
    s = ctx["spans"].get("mappo.update_s")
    return None if s is None else 1e3 * s
