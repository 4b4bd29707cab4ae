"""MoELayer, the mixture-of-experts FFN block (counterpart of
paddle_tpu/nn/layer/moe.py).

The expert weights carry a leading expert dim (``experts_w1`` (E,
d_model, d_hidden), ``experts_b1``, ``experts_w2``, ``experts_b2``), so
``parallel.sharding.ep_spec`` shards them over an ``ep`` axis; the
router ``gate_weight`` (d_model, E) stays whole.  The forward keeps the
step's auxiliary load-balance loss on ``aux_loss``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import initializer as I
from ..functional.moe import moe_ffn
from ..layer_base import Layer

__all__ = ["MoELayer"]


class MoELayer(Layer):
    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 activation: str = "gelu", weight_attr=None, name=None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.activation = activation
        init = I.Normal(std=0.02)
        kw = dict(device=device, generator=generator)
        self.gate_weight = self.create_parameter(
            (d_model, num_experts), attr=weight_attr,
            default_initializer=init, **kw)
        self.experts_w1 = self.create_parameter(
            (num_experts, d_model, d_hidden), default_initializer=init, **kw)
        self.experts_b1 = self.create_parameter(
            (num_experts, d_hidden), is_bias=True, **kw)
        self.experts_w2 = self.create_parameter(
            (num_experts, d_hidden, d_model), default_initializer=init, **kw)
        self.experts_b2 = self.create_parameter(
            (num_experts, d_model), is_bias=True, **kw)
        self.aux_loss = None

    def forward(self, x):
        y, aux = moe_ffn(x, self.gate_weight, self.experts_w1,
                         self.experts_b1, self.experts_w2, self.experts_b2,
                         top_k=self.top_k,
                         capacity_factor=self.capacity_factor,
                         activation=self.activation)
        self.aux_loss = aux
        return y

    def extra_repr(self):
        return (f"d_model={self.d_model}, d_hidden={self.d_hidden}, "
                f"num_experts={self.num_experts}, top_k={self.top_k}")
