from cleanmarl_tpu_torch.envs.base import Environment, VecEnv
from cleanmarl_tpu_torch.envs.registry import make

__all__ = ["Environment", "VecEnv", "make"]
