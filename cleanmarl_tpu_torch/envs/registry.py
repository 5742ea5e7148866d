"""Environment registry (port of ``cleanmarl_tpu/envs/registry.py``).

``make(env_type, env_name, ...)`` builds one env of a family, and
``make_vec(env_type, env_name, num_envs, ...)`` a batch of them: ``matrix``,
``mpe`` (and ``pz`` with ``env_family="mpe"``), ``smaclite``, ``pursuit``
and ``lbf`` are batched torch envs on ``device``; ``pz`` with any other
family is a real PettingZoo env stepped on the host
(``envs/external.HostEnvFamily`` over ``envs/pettingzoo_host``), whose
tensors land on ``device``. The device defaults to the card and resolves
through ``core/device.resolve_device``: asking for it without one raises.
"""
from __future__ import annotations

from cleanmarl_tpu_torch.core.device import resolve_device
from cleanmarl_tpu_torch.envs.wrappers import AgentIDWrapper


def make(env_type: str, env_name: str, agent_ids: bool = False,
         env_family: str = "mpe", device="cuda", **kwargs):
    env_type = env_type.lower()
    device = resolve_device(device)
    if env_type == "matrix":
        from cleanmarl_tpu_torch.envs.matrix_game import MatrixGame

        env = MatrixGame(device=device, **kwargs)
    elif env_type == "mpe" or (env_type == "pz" and env_family == "mpe"):
        from cleanmarl_tpu_torch.envs import mpe

        env = mpe.make(env_name, device=device, **kwargs)
    elif env_type == "pz":
        # a real PettingZoo env on the host; agent ids come from the host
        # adapter, so no AgentIDWrapper
        from cleanmarl_tpu_torch.envs.external import HostEnvFamily
        from cleanmarl_tpu_torch.envs.pettingzoo_host import PettingZooHostEnv

        return HostEnvFamily(
            lambda: PettingZooHostEnv(env_family, env_name, agent_ids=agent_ids,
                                      **kwargs),
            device=device)
    elif env_type == "smaclite":
        from cleanmarl_tpu_torch.envs import smaclite

        env = smaclite.make(env_name, device=device, **kwargs)
    elif env_type == "pursuit":
        # env_name is accepted for CLI symmetry ("pursuit_v4")
        from cleanmarl_tpu_torch.envs.pursuit import Pursuit

        env = Pursuit(device=device, **kwargs)
    elif env_type == "lbf":
        from cleanmarl_tpu_torch.envs import lbf

        env = lbf.make(env_name, device=device, **kwargs)
    else:
        raise ValueError(f"unknown env_type {env_type!r}")
    if agent_ids:
        env = AgentIDWrapper(env)
    return env


def make_vec(env_type: str, env_name: str, num_envs: int, agent_ids: bool = False,
             auto_reset: bool = True, device="cuda", **kwargs):
    """``num_envs`` copies of ``make``'s env stepped as one batch: a
    ``VecEnv``, or a ``HostVecEnv`` for a host family."""
    from cleanmarl_tpu_torch.envs.external import as_vec

    env = make(env_type, env_name, agent_ids=agent_ids, device=device, **kwargs)
    return as_vec(env, num_envs, auto_reset=auto_reset)
