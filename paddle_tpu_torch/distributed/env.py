"""The distributed environment (counterpart of
paddle_tpu/distributed/env.py).

The reference reads the launcher's variables and, with more than one
process, starts ``jax.distributed``.  The port is one process per rank: it
reads the same variables (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``,
``PADDLE_COORDINATOR``) and, with more than one rank, starts
``torch.distributed``: NCCL when the card is there, gloo on the CPU, with
the coordinator's TCP store as the rendezvous (``init_method=`` and
``backend=`` override both).  With one rank ``init_parallel_env`` starts
nothing, as the reference's.  A failed ``init_process_group`` raises; it
never carries on as a single process.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["ParallelEnv", "init_parallel_env", "get_rank", "get_world_size",
           "is_initialized"]

_TIMEOUT = datetime.timedelta(seconds=600)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _default_backend() -> str:
    """NCCL on the card, gloo on the CPU."""
    return "nccl" if torch.cuda.is_available() else "gloo"


class ParallelEnv:
    """This process's view of the run (``paddle.distributed.ParallelEnv``):
    the started process group's rank and size when there is one, else the
    launcher's variables."""

    def __init__(self):
        self._rank = get_rank()
        self._world_size = get_world_size()
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = eps.split(",") if eps else []
        self._current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
        self._local_rank = _env_int("PADDLE_LOCAL_RANK", self._rank)

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    @property
    def local_rank(self):
        return self._local_rank

    @property
    def nranks(self):
        return self._world_size

    @property
    def dev_id(self):
        """The rank's local CUDA device (0 without a card)."""
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return self._local_rank % n if n else 0

    @property
    def device_type(self):
        return "gpu" if torch.cuda.is_available() else "cpu"

    @property
    def current_endpoint(self):
        return self._current_endpoint

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints


def init_parallel_env(strategy=None, *, backend=None, init_method=None,
                      timeout=None) -> ParallelEnv:
    """``paddle.distributed.init_parallel_env``: with
    ``PADDLE_TRAINERS_NUM`` > 1, ``torch.distributed.init_process_group``
    over the coordinator (``PADDLE_COORDINATOR``, else the first trainer
    endpoint); with one rank, nothing.  Returns the ``ParallelEnv``."""
    nranks = _env_int("PADDLE_TRAINERS_NUM", 1)
    if nranks > 1 and not dist.is_initialized():
        rank = _env_int("PADDLE_TRAINER_ID", 0)
        if init_method is None:
            eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")
            coordinator = os.environ.get("PADDLE_COORDINATOR") or eps[0]
            if not coordinator:
                raise RuntimeError(
                    "init_parallel_env: PADDLE_TRAINERS_NUM > 1 but neither "
                    "PADDLE_COORDINATOR nor PADDLE_TRAINER_ENDPOINTS is set")
            init_method = f"tcp://{coordinator}"
        backend = backend or _default_backend()
        device = None
        if backend == "nccl":
            local = _env_int("PADDLE_LOCAL_RANK", rank)
            device = torch.device("cuda",
                                  local % torch.cuda.device_count())
            torch.cuda.set_device(device)
        # with its device the group makes its communicator now, and every
        # sub-group of the mesh splits from it as it is made, in the same
        # order on every rank
        dist.init_process_group(backend, init_method=init_method,
                                world_size=nranks, rank=rank,
                                timeout=timeout or _TIMEOUT,
                                device_id=device)
    return ParallelEnv()


def get_rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return _env_int("PADDLE_TRAINER_ID", 0)


def get_world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return _env_int("PADDLE_TRAINERS_NUM", 1)


def is_initialized() -> bool:
    return (dist.is_available() and dist.is_initialized()) or \
        get_world_size() == 1
