"""Distributed training utilities (counterpart of paddle_tpu/distributed/).

This slice of the port carries the single-process checkpoints
(``distributed.checkpoint``); collectives, meshes and the sharded train
step come with the port's parallel slice.
"""
from . import checkpoint  # noqa: F401
from .checkpoint import (AsyncCheckpointManager,  # noqa: F401
                         CheckpointManager, latest_step_dir,
                         restore_sharded, save_sharded, train_epoch_range)

__all__ = ["checkpoint", "CheckpointManager", "AsyncCheckpointManager",
           "latest_step_dir", "restore_sharded", "save_sharded",
           "train_epoch_range"]
