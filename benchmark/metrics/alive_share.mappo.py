"""The share of the agent steps that the alive mask keeps, in %: the
program's counters ``ppo.alive_agent_steps`` over ``ppo.agent_steps``
through one block (``families/mappo_paper.py``). The rest is the GRU's
rows and the loss terms of dead agents, work that the mask weights by 0."""


def read(ctx):
    s = ctx["spans"].get("mappo.alive_share")
    return None if s is None else 100.0 * s
