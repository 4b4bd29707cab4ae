"""``fleet.utils`` (counterpart of paddle_tpu/distributed/fleet/utils.py):
``UtilBase``, the cross-trainer helpers.  The reference's filesystem
clients (``LocalFS``, ``HDFSClient``, from its ``io.fs``) are not ported
yet."""
from __future__ import annotations

import numpy as np
import torch

from .. import collective as _collective

__all__ = ["UtilBase"]


class UtilBase:
    """Cross-trainer helpers: trainer i takes ``files[i::n]``."""

    def __init__(self, fs=None):
        self._fs = fs

    def set_file_system(self, fs):
        self._fs = fs

    def get_file_shard(self, files):
        from ..env import get_rank, get_world_size
        n = max(1, get_world_size())
        return list(files)[get_rank() % n::n]

    def all_reduce(self, input, mode="sum"):  # noqa: A002
        from . import _workers
        t = torch.as_tensor(np.asarray(input)).clone()
        _collective.all_reduce(t, op=mode, group=_workers())
        return t.numpy()

    def barrier(self):
        from . import _workers
        _collective.barrier(group=_workers())

    def print_on_rank(self, message, rank_id=0):
        from ..env import get_rank
        if get_rank() == rank_id:
            print(message)
