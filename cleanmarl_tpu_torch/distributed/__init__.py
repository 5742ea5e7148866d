from cleanmarl_tpu_torch.distributed.dp import (
    DATA_FIELD_DIMS,
    all_reduce_sum,
    global_runner_init,
    global_sum,
    replicate,
    shard_runner,
    unshard_runners,
)
from cleanmarl_tpu_torch.distributed.multihost import is_main_process, maybe_initialize

__all__ = [
    "DATA_FIELD_DIMS",
    "all_reduce_sum",
    "global_runner_init",
    "global_sum",
    "is_main_process",
    "maybe_initialize",
    "replicate",
    "shard_runner",
    "unshard_runners",
]
