"""ReLU (counterpart of paddle_tpu/nn/layer/activation.py)."""
from __future__ import annotations

from .. import functional as F
from ..layer_base import Layer

__all__ = ["ReLU"]


class ReLU(Layer):
    def forward(self, x):
        return F.relu(x)
