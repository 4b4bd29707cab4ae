"""LayerNorm (counterpart of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from ..layer_base import Layer

__all__ = ["LayerNorm"]


class LayerNorm(Layer):
    def __init__(self, normalized_shape: int, epsilon: float = 1e-5,
                 device=None):
        super().__init__()
        self.normalized_shape = int(normalized_shape)
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape,
                                             device=device))

    def forward(self, x):
        # population variance, as the reference's layer_norm
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)
