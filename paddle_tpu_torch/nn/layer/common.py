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
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 std: float = 0.02, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, embedding_dim,
                                               device=device))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)

    def forward(self, ids):
        return self.weight[ids]


class Dropout(Layer):
    """Upscale-in-train dropout.  The mask comes from the current
    generator of ``core.rng`` (the training step's, inside
    ``TrainStep``)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training)
