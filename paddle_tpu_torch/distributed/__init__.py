"""Distributed training utilities (counterpart of paddle_tpu/distributed/).

This slice of the port carries the single-process checkpoints
(``distributed.checkpoint``); collectives, meshes and the sharded train
step come with the port's parallel slice.
"""
from . import checkpoint  # noqa: F401
from .checkpoint import (CheckpointManager, latest_step_dir,  # noqa: F401
                         restore_sharded, save_sharded)

__all__ = ["checkpoint", "CheckpointManager", "latest_step_dir",
           "restore_sharded", "save_sharded"]
