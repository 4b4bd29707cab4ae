"""Fleet, the distributed-training facade (counterpart of
paddle_tpu/distributed/fleet/__init__.py).

``init`` starts the process group (``init_parallel_env``) and sets the
mesh that the strategy resolves over the world's ranks
(``DistributedStrategy.mesh_axes``); ``distributed_optimizer`` wraps the
optimizer, which then steps eagerly as the inner one; the strategy takes
effect in ``distributed_train_step``: a ``parallel.LocalSGDTrainStep``
under ``localsgd`` (with the reference's refusals of the flags it does
not compose with), else a ``parallel.ShardedTrainStep``.  The
parameter-server roles exist for the API only.  ``data_generator`` holds
the MultiSlot data generators.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...parallel import (DistributedStrategy, ShardedTrainStep, create_mesh,
                         get_mesh, set_mesh)
from .. import collective as _collective
from ..env import get_rank, get_world_size, init_parallel_env

__all__ = ["init", "is_first_worker", "worker_index", "worker_num",
           "barrier_worker", "DistributedOptimizer", "distributed_optimizer",
           "distributed_model", "distributed_train_step", "get_strategy",
           "Role", "UserDefinedRoleMaker", "PaddleCloudRoleMaker",
           "UtilBase", "Fleet", "fleet"]

_fleet_initialized = False
_strategy: Optional[DistributedStrategy] = None


class UserDefinedRoleMaker:
    """The reference's role maker: the launcher's variables define the
    roles."""

    def __init__(self, is_collective=True, **kw):
        self._is_collective = is_collective


PaddleCloudRoleMaker = UserDefinedRoleMaker


def init(role_maker=None, is_collective=True, strategy=None):
    """``fleet.init``: the process group, then the strategy's mesh over
    the world's ranks."""
    global _fleet_initialized, _strategy
    _strategy = strategy or DistributedStrategy()
    init_parallel_env()
    set_mesh(create_mesh(_strategy.mesh_axes(get_world_size())))
    _fleet_initialized = True


def is_first_worker() -> bool:
    return get_rank() == 0


def worker_index() -> int:
    return get_rank()


def worker_num() -> int:
    return get_world_size()


def _workers():
    """Every worker: the started world (None: a world of one)."""
    import torch.distributed as dist
    return dist.group.WORLD if dist.is_available() and \
        dist.is_initialized() else None


def barrier_worker():
    _collective.barrier(group=_workers())


class DistributedOptimizer:
    """``fleet.distributed_optimizer``'s result: the inner optimizer for
    eager use; the strategy is read by ``distributed_train_step``."""

    def __init__(self, optimizer, strategy: DistributedStrategy):
        self._inner = optimizer
        self.user_defined_strategy = strategy

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        return self._inner.minimize(loss, startup_program, parameters,
                                    no_grad_set)

    def step(self):
        return self._inner.step()

    def clear_grad(self):
        return self._inner.clear_grad()


def distributed_optimizer(optimizer, strategy=None) -> DistributedOptimizer:
    global _strategy
    st = strategy or _strategy or DistributedStrategy()
    _strategy = st
    return DistributedOptimizer(optimizer, st)


def distributed_model(model):
    """The eager data-parallel wrapper."""
    from ..parallel_layer import DataParallel
    return DataParallel(model)


def distributed_train_step(model, loss_fn, optimizer, strategy=None):
    """The training step for the current mesh: ``LocalSGDTrainStep``
    under ``localsgd``, else ``ShardedTrainStep``."""
    st = strategy or _strategy or DistributedStrategy()
    inner = getattr(optimizer, "_inner", optimizer)
    mesh = get_mesh(create_default=True)
    if st.localsgd:
        if (st.sharding or st.tensor_parallel or st.sequence_parallel
                or st.pipeline or st.gradient_merge or st.recompute
                or st.fp16_allreduce):
            raise ValueError(
                "localsgd composes with plain DP (+AMP) only — disable "
                "sharding/tensor_parallel/sequence_parallel/pipeline/"
                "gradient_merge/recompute/fp16_allreduce")
        from ...parallel.localsgd import LocalSGDTrainStep
        k = (st.localsgd_configs or {}).get("k_steps", 4)
        return LocalSGDTrainStep(
            model, loss_fn, inner, k_steps=k, mesh=mesh,
            amp_level=("O1" if st.amp else None),
            amp_dtype=st.amp_configs.dtype)
    return ShardedTrainStep(model, loss_fn, inner, strategy=st, mesh=mesh)


def get_strategy() -> Optional[DistributedStrategy]:
    return _strategy


class Role:
    """Worker / server role constants; collective workers are the model."""
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class UtilBase:
    """``fleet.util``: helpers across every worker, over the collectives
    on the started world."""

    def all_reduce(self, input, mode="sum", comm_world="worker"):  # noqa: A002
        op = {"sum": _collective.ReduceOp.SUM, "min": _collective.ReduceOp.MIN,
              "max": _collective.ReduceOp.MAX}[mode]
        t = torch.as_tensor(np.asarray(input)).clone()
        _collective.all_reduce(t, op=op, group=_workers())
        return t.numpy()

    def barrier(self, comm_world="worker"):
        barrier_worker()

    def all_gather(self, input, comm_world="worker"):  # noqa: A002
        out = []
        _collective.all_gather(out, torch.as_tensor(np.asarray(input)),
                               group=_workers())
        return [o.numpy() for o in out]

    def get_file_shard(self, files):
        """Contiguous blocks of the file list, the remainder to the first
        workers."""
        n, rank = worker_num(), worker_index()
        per, rem = divmod(len(files), n)
        start = rank * per + min(rank, rem)
        return list(files[start:start + per + (1 if rank < rem else 0)])

    def print_on_rank(self, message, rank_id=0):
        if worker_index() == rank_id:
            print(message, flush=True)


class Fleet:
    """The class form of the facade; ``fleet`` is its instance."""

    util = UtilBase()

    def init(self, role_maker=None, is_collective=True, strategy=None):
        return init(role_maker, is_collective, strategy)

    def is_first_worker(self):
        return is_first_worker()

    def worker_index(self):
        return worker_index()

    def worker_num(self):
        return worker_num()

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def barrier_worker(self):
        barrier_worker()

    def distributed_optimizer(self, optimizer, strategy=None):
        return distributed_optimizer(optimizer, strategy)

    def distributed_model(self, model):
        return distributed_model(model)


fleet = Fleet()

from .data_generator import (  # noqa: F401,E402
    DataGenerator, MultiSlotDataGenerator, MultiSlotStringDataGenerator,
)
