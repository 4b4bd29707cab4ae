"""LayerList and Sequential (counterparts of
paddle_tpu/nn/layer/container.py): children are named ``0, 1, ...`` as
Paddle's are, so ``blocks.3.qkv.weight`` and ``downsample.1._mean`` keys
line up with the reference.  Both are ``Layer`` s, with its Paddle
methods."""
from __future__ import annotations

from torch import nn

from ..layer_base import Layer

__all__ = ["LayerList", "Sequential"]


class LayerList(Layer, nn.ModuleList):
    def __init__(self, sublayers=None):
        nn.ModuleList.__init__(self, sublayers)


class Sequential(Layer, nn.Sequential):
    def __init__(self, *layers):
        nn.Sequential.__init__(self, *layers)
