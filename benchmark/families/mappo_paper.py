"""Recurrent MAPPO with the MAPPO paper's practices (death masking, value
normalization, advantage normalization): ``families/mappo.py``'s run and
check, judged by ``reference/mappo_paper.py``, with two readings of what
those practices cost and keep.

- ``mappo.mask_norm_s``: the device seconds an update of the operations
  launched inside the program's spans ``ppo.death_mask``,
  ``ppo.value_norm`` and ``ppo.adv_norm``, over ``trace_blocks`` profiled
  blocks (``spans.profiled_block``);
- ``mappo.alive_share``: the program's counters ``ppo.alive_agent_steps``
  over ``ppo.agent_steps`` through one block: the share of the agent
  steps, the GRU's rows and the loss terms, that the alive mask keeps.

Where the program has no such span or counter, each reading is None.
"""
from __future__ import annotations

from benchmark import spans
from benchmark.families import mappo
from benchmark.families.mappo import (GAINS, TRACE_BLOCKS, check, control,  # noqa: F401
                                      numbers, shapes)
from benchmark.reference import mappo_paper as reference  # noqa: F401

MASK_NORM_SPANS = ("ppo.death_mask", "ppo.value_norm", "ppo.adv_norm")


def ref_cfg(cell: dict) -> dict:
    """The configuration file's values and the traffic's envs; the options
    this reference does not follow are refused by name."""
    p = dict(cell["config_file"]["params"])
    for k in ("normalize_reward", "normalize_return", "anneal_lr", "anneal_entropy",
              "remat_actor"):
        if p[k]:
            raise ValueError(f"the MAPPO paper reference does not take {k}=True")
    if p["clip_gradients"] > 0 or p["optimizer"] != "adam" or not p["recurrent"] or p["tbptt"]:
        raise ValueError("the MAPPO paper reference takes the recurrent actor, Adam, "
                         "no clipping")
    p["num_envs"] = cell["traffic_file"]["num_envs"]
    return p


class Run(mappo.Run):
    def __init__(self, cell: dict, seed: int, device: str):
        self.device = device
        super().__init__(cell, seed, device)

    def timings(self) -> dict:
        out = super().timings()
        tracing = spans.tracing_module()
        out["mappo.mask_norm_s"] = self._mask_norm_s(tracing)
        out["mappo.alive_share"] = self._alive_share(tracing)
        return out

    def _mask_norm_s(self, tracing):
        """Device seconds an update inside the three spans, or None where
        the profiled blocks launched nothing in them."""
        if tracing is None:
            return None
        ops = spans.profiled_block(self, self.device, tracing)["span_ops"]
        found = [ops[n]["device_s"] for n in MASK_NORM_SPANS if ops.get(n, {}).get("ops")]
        if not found:
            return None
        return sum(found) / (self.trace_blocks * self.cfg.log_interval)

    def _alive_share(self, tracing):
        """The alive mask's share of the agent steps through one block."""
        if tracing is None or not hasattr(tracing, "count"):
            return None
        with tracing.recording() as rec:
            self.block()
        c = rec.counter_values()
        if not c.get("ppo.agent_steps"):
            return None
        return c["ppo.alive_agent_steps"] / c["ppo.agent_steps"]


def setup(cell, seed, device) -> Run:
    return Run(cell, seed, device)
