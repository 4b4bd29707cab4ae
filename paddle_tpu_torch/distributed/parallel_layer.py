"""DataParallel: the eager data-parallel wrapper (counterpart of
paddle_tpu/distributed/parallel_layer.py).

The reference shards every batch input over the mesh's ``dp`` axis and
lets XLA reduce the gradients inside each gradient op.  The port runs one
process per rank, as Paddle's own ``DataParallel`` does: ``forward`` runs
the wrapped layer on this rank's rows of every batch-like input (axis 0
split over ``dp`` when it divides), so its outputs are the rank's rows,
not the global array; ``scale_loss`` is the identity (each rank's loss is
the mean over its rows); ``apply_collective_grads`` averages the
gradients over ``dp`` with all-reduces of buckets of ``comm_buffer_size``
MB (the Reducer's bucket knob).  A BatchNorm under it keeps each rank's
own statistics, as Paddle's does; ``SyncBatchNorm`` takes them over the
ranks.  The state methods delegate to the wrapped layer.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..nn.layer_base import Layer
from ..parallel.mesh import get_mesh

__all__ = ["DataParallel"]


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None, mesh=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self.comm_buffer_size = comm_buffer_size
        self.last_comm_buffer_size = last_comm_buffer_size
        self._mesh = mesh or get_mesh()
        if group is None:
            if self._mesh is not None:
                group = self._mesh.group("dp")
            elif dist.is_available() and dist.is_initialized():
                group = dist.group.WORLD
        self._group = group
        self._n = 1 if group is None else dist.get_world_size(group)
        self._me = 0 if group is None else dist.get_rank(group)

    def _shard_arg(self, x):
        """This rank's rows of a batch-like tensor; others pass through."""
        if self._n == 1 or not isinstance(x, torch.Tensor) or x.dim() == 0 \
                or x.shape[0] % self._n:
            return x
        n = x.shape[0] // self._n
        return x.narrow(0, self._me * n, n)

    def forward(self, *inputs, **kwargs):
        inputs = tuple(self._shard_arg(a) for a in inputs)
        kwargs = {k: self._shard_arg(v) for k, v in kwargs.items()}
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    @torch.no_grad()
    def apply_collective_grads(self):
        """Average every gradient over the ``dp`` ranks, in buckets of
        ``comm_buffer_size`` MB of one dtype."""
        if self._group is None:
            return
        cap = max(1, int(self.comm_buffer_size)) * (1 << 20)
        bucket, size = [], 0

        def flush():
            nonlocal bucket, size
            if not bucket:
                return
            flat = torch.cat([p.grad.reshape(-1) for p in bucket])
            dist.all_reduce(flat, group=self._group)
            flat /= self._n
            for p, part in zip(bucket, flat.split([p.grad.numel()
                                                   for p in bucket])):
                p.grad.copy_(part.view(p.grad.shape))
            bucket, size = [], 0
        for p in self._layers.parameters():
            g = p.grad
            if g is None:
                continue
            if bucket and (g.dtype != bucket[0].grad.dtype
                           or size + g.numel() * g.element_size() > cap):
                flush()
            bucket.append(p)
            size += g.numel() * g.element_size()
        flush()

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)

    set_dict = set_state_dict
    load_dict = set_state_dict

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)
