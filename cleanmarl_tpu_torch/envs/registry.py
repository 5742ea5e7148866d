"""Environment registry (port of ``cleanmarl_tpu/envs/registry.py``).

The ``matrix``, ``smaclite`` and ``mpe`` families are ported (``pz`` with
``env_family="mpe"`` is MPE, as in the JAX package); every other
``env_type`` or ``pz`` family raises and names the ROADMAP item that
ports it.
"""
from __future__ import annotations

from cleanmarl_tpu_torch.envs.wrappers import AgentIDWrapper

_NOT_PORTED = {
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
    elif env_type == "mpe" or (env_type == "pz" and env_family == "mpe"):
        from cleanmarl_tpu_torch.envs import mpe

        env = mpe.make(env_name, device=device, **kwargs)
    elif env_type == "smaclite":
        from cleanmarl_tpu_torch.envs import smaclite

        env = smaclite.make(env_name, device=device, **kwargs)
    elif env_type in _NOT_PORTED:
        what = f"env_type {env_type!r}" + (
            f" with env_family {env_family!r}" if env_type == "pz" else "")
        raise NotImplementedError(
            f"{what} is not ported to cleanmarl_tpu_torch yet; "
            f"see {_NOT_PORTED[env_type]}"
        )
    else:
        raise ValueError(f"unknown env_type {env_type!r}")
    if agent_ids:
        env = AgentIDWrapper(env)
    return env
