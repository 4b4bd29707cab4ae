"""ShardedEmbedding: a table row-sharded over a mesh axis (counterpart of
paddle_tpu/embedding/sharded.py).

The weight holds only this rank's rows (``num_embeddings / n`` of them,
``n`` the axis size, which must divide ``num_embeddings``); the lookup
dedups its ids and all-reduces the owners' rows (``functional.
psum_gather``); the gradient is always row-sparse and, in
``jit.TrainStep``, takes the lazy row update on the rank's rows only.
Without a mesh (or an axis of one rank) it is a one-shard deduped-gather
embedding, so model code does not depend on the mesh.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.errors import enforce
from ..nn import initializer as I
from ..nn.layer_base import Layer
from . import functional as EF

__all__ = ["ShardedEmbedding"]


class ShardedEmbedding(Layer):
    """(num_embeddings, embedding_dim) table whose rows are split over
    ``axis`` of ``mesh`` (default: the global mesh's ``tp``).  The
    parameters are the reference's, then ``device`` and ``generator`` (the
    whole table is drawn, as on one device, and this rank keeps its rows).
    The weight carries ``sparse_grad`` and ``row_shard = (mesh, axis)``."""

    def __init__(self, num_embeddings: int, embedding_dim: int, mesh=None,
                 axis: str = "tp", padding_idx: Optional[int] = None,
                 weight_attr=None, name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mesh is None:
            from ..parallel.mesh import get_mesh
            mesh = get_mesh()
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.padding_idx = (None if padding_idx is None else
                            padding_idx if padding_idx >= 0 else
                            num_embeddings + padding_idx)
        self.mesh = mesh
        self.axis = axis
        n = mesh.shape.get(axis, 1) if mesh is not None else 1
        enforce(self.num_embeddings % max(1, n) == 0,
                f"ShardedEmbedding: num_embeddings {num_embeddings} must "
                f"divide evenly over mesh axis {axis!r} (size {n})")
        whole = self.create_parameter(
            (self.num_embeddings, self.embedding_dim), attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0), device=device,
            generator=generator)
        rows = self.num_embeddings // max(1, n)
        start, _ = EF.row_range(mesh, axis, rows)
        with torch.no_grad():
            whole.data = whole.detach()[start:start + rows].clone()
            if self.padding_idx is not None and \
                    start <= self.padding_idx < start + rows:
                whole[self.padding_idx - start] = 0.0
        self.weight = whole
        self.weight.sparse_grad = True
        self.weight.row_shard = (mesh, axis)

    def forward(self, x):
        return EF.sharded_lookup(x, self.weight,
                                 padding_idx=self.padding_idx)

    def extra_repr(self):
        n = (self.mesh.shape.get(self.axis, 1) if self.mesh is not None
             else 1)
        return (f"{self.num_embeddings}, {self.embedding_dim}, "
                f"axis={self.axis!r}, shards={n}")
