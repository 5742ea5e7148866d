"""Exploration schedules (port of ``cleanmarl_tpu/core/schedules.py``).

The step count is a host integer, so the schedule is host arithmetic in
float32, as the JAX function computes it on the device.
"""
from __future__ import annotations

import numpy as np


def linear_schedule(start_e: float, end_e: float, duration: float, t: int) -> float:
    """Linear decay from ``start_e`` to ``end_e`` over ``duration`` steps,
    clipped at ``end_e``."""
    slope = np.float32((end_e - start_e) / duration)
    return float(np.maximum(slope * np.float32(t) + np.float32(start_e),
                            np.float32(end_e)))
