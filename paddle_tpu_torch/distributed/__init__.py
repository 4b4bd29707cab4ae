"""Distributed training (counterpart of paddle_tpu/distributed/).

One process per rank on ``torch.distributed``: the environment and its
start (``env``), the collectives (``collective``), the eager data-parallel
wrapper (``DataParallel``), ``spawn`` and the ``launch`` command line, the
``fleet`` facade and the checkpoints (``checkpoint``: single- and
several-process).  The model of execution is in ``parallel``'s docstring.
The datasets (``InMemoryDataset``, ``QueueDataset``) and fleet's data
generators are not ported yet (ROADMAP §1 item 8).
"""
from . import checkpoint  # noqa: F401
from . import fleet  # noqa: F401
from .checkpoint import (AsyncCheckpointManager,  # noqa: F401
                         CheckpointManager, latest_step_dir,
                         restore_sharded, save_sharded, train_epoch_range)
from .collective import (ReduceOp, all_gather, all_reduce,  # noqa: F401
                         alltoall, barrier, broadcast, p2p, ppermute, recv,
                         reduce, reduce_scatter, scatter, send)
from .env import (ParallelEnv, get_rank, get_world_size,  # noqa: F401
                  init_parallel_env, is_initialized)
from .parallel_layer import DataParallel  # noqa: F401
from .spawn import spawn  # noqa: F401

__all__ = ["checkpoint", "fleet", "CheckpointManager",
           "AsyncCheckpointManager", "latest_step_dir", "restore_sharded",
           "save_sharded", "train_epoch_range", "ReduceOp", "all_reduce",
           "all_gather", "broadcast", "reduce", "scatter", "reduce_scatter",
           "alltoall", "send", "recv", "ppermute", "p2p", "barrier",
           "ParallelEnv", "init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "DataParallel", "spawn", "prepare_context"]


def prepare_context(strategy=None):
    """The fluid dygraph ``prepare_context``: start the process group when
    the launcher asked for more than one rank; returns the strategy."""
    from . import env as _env
    if _env.get_world_size() > 1:
        _env.init_parallel_env()
    return strategy
