"""Conv2D (counterpart of paddle_tpu/nn/layer/conv.py).

The weight is Paddle's (out_c, in_c / groups, kh, kw), which is torch's
own layout, drawn from Normal(0, sqrt(2 / fan_in)) as the reference's
default initializer; ``bias_attr=False`` means no bias (else a zero
bias).  Models that want a seeded draw pass a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import functional as F
from ..layer_base import Layer

__all__ = ["Conv2D"]


class Conv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias_attr=None,
                 data_format="NCHW", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ks = kernel_size if isinstance(kernel_size, (list, tuple)) \
            else (kernel_size,) * 2
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = tuple(int(k) for k in ks)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        self.data_format = data_format
        fan_in = in_channels // groups * self.kernel_size[0] * \
            self.kernel_size[1]
        self.weight = nn.Parameter(torch.empty(
            (out_channels, in_channels // groups) + self.kernel_size,
            device=device))
        with torch.no_grad():
            self.weight.normal_(0.0, (2.0 / fan_in) ** 0.5,
                                generator=generator)
        self.bias = (None if bias_attr is False else
                     nn.Parameter(torch.zeros(out_channels, device=device)))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")
