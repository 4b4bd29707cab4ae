"""Linear, Embedding, Dropout (counterparts of paddle_tpu/nn/layer/common.py).

``Linear`` keeps Paddle's weight layout, (in_features, out_features), and
computes ``x @ weight + bias``, so reference weights load without a
transpose.  Parameters are created on ``device`` and filled by
``reset_parameters`` (normal with ``std``, zero bias); models that want a
seeded draw pass a ``torch.Generator``.  ``Linear`` goes through
``F.linear``, so AMP casts it.  ``Dropout`` draws its mask from an explicit
generator (``core.rng``), never from torch's global one.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.errors import UnimplementedError
from .. import functional as F
from ..layer_base import Layer

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(Layer):
    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, std: float = 0.02, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.weight = nn.Parameter(torch.empty(
            self.in_features, self.out_features, device=device))
        self.bias = (nn.Parameter(torch.empty(self.out_features,
                                              device=device))
                     if bias else None)
        self.reset_parameters(std, generator)

    @torch.no_grad()
    def reset_parameters(self, std: float = 0.02, generator=None):
        self.weight.normal_(0.0, std, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(Layer):
    """The reference's ``Embedding``: a (num_embeddings, embedding_dim)
    table looked up by ``F.embedding``.  A negative ``padding_idx`` counts
    from the end; that row alone is zeroed at construction, and the lookup
    zeroes its output rows, so it never takes a gradient.  The port's own
    ``std`` / ``device`` / ``generator`` come after the reference's
    parameters, as keywords.  ``sparse=True`` and ``weight_attr`` are not
    ported yet."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse=False, weight_attr=None, name=None,
                 *, std: float = 0.02, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if sparse:
            raise UnimplementedError(
                "Embedding(sparse=True): row-sparse gradients are not "
                "ported yet (ROADMAP section 1 item 4)")
        if weight_attr is not None:
            raise UnimplementedError(
                "Embedding(weight_attr=): ParamAttr is not ported yet "
                "(ROADMAP section 1 item 3)")
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.padding_idx = (None if padding_idx is None else
                            padding_idx if padding_idx >= 0 else
                            self.num_embeddings + padding_idx)
        self.sparse = sparse
        self.weight = nn.Parameter(torch.empty(num_embeddings, embedding_dim,
                                               device=device))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)
            if self.padding_idx is not None:
                self.weight[self.padding_idx] = 0.0

    def forward(self, ids):
        return F.embedding(ids, self.weight, padding_idx=self.padding_idx,
                           sparse=self.sparse)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    """The reference's ``Dropout(p, axis, mode)``.  The mask comes from the
    current generator of ``core.rng`` (the training step's, inside
    ``TrainStep``)."""

    def __init__(self, p: float = 0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        self.p = float(p)
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)
