"""Host-side experiment logging (port of ``cleanmarl_tpu/core/logger.py``):
TensorBoard (+ optional W&B) with the same run naming and scalar names
(``rollout/*``, ``train/*``, ``eval/*``, ``perf/*``). Without
TensorBoard it writes JSON lines into the same run directory.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
from typing import Dict


class Logger:
    def __init__(self, algo: str, args, logdir: str = "runs", use_wnb: bool = False):
        env_type = getattr(args, "env_type", "env")
        env_name = getattr(args, "env_name", "")
        timestamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        self.run_name = f"{env_type}__{env_name}__{timestamp}"
        self.run_dir = os.path.join(logdir, f"{algo}-{self.run_name}")
        params = dataclasses.asdict(args) if dataclasses.is_dataclass(args) else vars(args)
        self._wandb = None
        if use_wnb:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                self._wandb = wandb
                wandb.init(project=getattr(args, "wnb_project", "") or None,
                           entity=getattr(args, "wnb_entity", "") or None,
                           sync_tensorboard=True, config=params,
                           name=f"{algo}-{self.run_name}")
        self._jsonl = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:   # tensorboard not installed → JSON lines
            SummaryWriter = None
        if SummaryWriter is not None:
            self.writer = SummaryWriter(self.run_dir)
            self.writer.add_text(
                "hyperparameters",
                "|param|value|\n|-|-|\n%s"
                % "\n".join([f"|{k}|{v}|" for k, v in params.items()]),
            )
        else:
            self.writer = None
            os.makedirs(self.run_dir, exist_ok=True)
            self._jsonl = open(os.path.join(self.run_dir, "scalars.jsonl"), "w")

    def log(self, scalars: Dict[str, float], step: int):
        if self.writer is not None:
            for k, v in scalars.items():
                self.writer.add_scalar(k, float(v), step)
        else:
            row = {"step": step, **{k: float(v) for k, v in scalars.items()}}
            self._jsonl.write(json.dumps(row) + "\n")

    def close(self):
        if self.writer is not None:
            self.writer.close()
        if self._jsonl is not None:
            self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
