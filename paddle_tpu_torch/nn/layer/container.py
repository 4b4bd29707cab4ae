"""LayerList, Sequential, ParameterList and LayerDict (counterparts of
paddle_tpu/nn/layer/container.py): children are named ``0, 1, ...`` as
Paddle's are, so ``blocks.3.qkv.weight`` and ``downsample.1._mean`` keys
line up with the reference (a ``ParameterList``'s parameters too; a
``LayerDict``'s children by their keys).  All are ``Layer`` s, with its
Paddle methods."""
from __future__ import annotations

from torch import nn

from ..layer_base import Layer

__all__ = ["LayerList", "Sequential", "ParameterList", "LayerDict"]


class LayerList(Layer, nn.ModuleList):
    def __init__(self, sublayers=None):
        nn.ModuleList.__init__(self, sublayers)


class Sequential(Layer, nn.Sequential):
    def __init__(self, *layers):
        nn.Sequential.__init__(self, *layers)


class ParameterList(Layer, nn.ParameterList):
    def __init__(self, parameters=None):
        nn.ParameterList.__init__(self, parameters)


class LayerDict(Layer, nn.ModuleDict):
    def __init__(self, sublayers=None):
        nn.ModuleDict.__init__(self, sublayers)
