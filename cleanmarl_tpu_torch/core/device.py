"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Asking
for CUDA on a machine without it raises: nothing silently carries on on
the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but CUDA is not available; "
            f"pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda|cpu)")
    return dev
