"""Environment registry (port of ``cleanmarl_tpu/envs/registry.py``).

Only the ``matrix`` and ``smaclite`` families are ported so far; every
other ``env_type`` raises and names the ROADMAP item that ports it.
"""
from __future__ import annotations

from cleanmarl_tpu_torch.envs.wrappers import AgentIDWrapper

_NOT_PORTED = {
    "mpe": "ROADMAP Queue A, Slice 2 (envs/mpe.py)",
    "pz": "ROADMAP Queue A, Slice 6 (host envs)",
    "pursuit": "ROADMAP Queue A, Slice 4 (envs/pursuit.py)",
    "lbf": "ROADMAP Queue A, Slice 5 (envs/lbf.py)",
}


def make(env_type: str, env_name: str, agent_ids: bool = False,
         env_family: str = "mpe", device="cpu", **kwargs):
    env_type = env_type.lower()
    if env_type == "matrix":
        from cleanmarl_tpu_torch.envs.matrix_game import MatrixGame

        env = MatrixGame(device=device, **kwargs)
    elif env_type == "smaclite":
        from cleanmarl_tpu_torch.envs import smaclite

        env = smaclite.make(env_name, device=device, **kwargs)
    elif env_type in _NOT_PORTED:
        raise NotImplementedError(
            f"env_type {env_type!r} is not ported to cleanmarl_tpu_torch yet; "
            f"see {_NOT_PORTED[env_type]}"
        )
    else:
        raise ValueError(f"unknown env_type {env_type!r}")
    if agent_ids:
        env = AgentIDWrapper(env)
    return env
