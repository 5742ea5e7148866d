"""The MAPPO paper's death masking, value normalization and advantage
normalization: the device time an update of the operations launched inside
the program's spans ``ppo.death_mask``, ``ppo.value_norm`` and
``ppo.adv_norm`` (``families/mappo_paper.py``), ms."""


def read(ctx):
    s = ctx["spans"].get("mappo.mask_norm_s")
    return None if s is None else 1e3 * s
