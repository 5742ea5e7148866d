"""The real steps' share of the sampled episodes' rows, in %: the program's
counters ``rq.valid_steps`` (the step mask's sum) over ``rq.padded_steps``
(batch x T_max) through one block (``families/qmix.py``). The rest is
padding: GRU rows and TD terms that the mask weights by 0."""


def read(ctx):
    s = ctx["spans"].get("qmix.valid_share")
    return None if s is None else 100.0 * s
