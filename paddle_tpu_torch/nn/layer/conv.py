"""Conv2D (counterpart of paddle_tpu/nn/layer/conv.py).

The reference's parameters in its order; the port's ``device`` /
``generator`` come after them, as keywords.  The weight is Paddle's
(out_c, in_c / groups, kh, kw), which is torch's own layout, drawn by
default from Normal(0, sqrt(2 / fan_in)) as the reference's
``_ConvNd``; the bias is zero, and ``bias_attr=False`` means none.
``padding_mode`` other than ``"zeros"`` pads the input by ``padding``
with ``"reflect"``, ``"replicate"`` or ``"circular"`` values first (the
reference's ``F.pad`` modes), then convolves unpadded, as Paddle's
``Conv2D`` does.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.errors import InvalidArgumentError
from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer

__all__ = ["Conv2D"]

_PAD_MODES = ("zeros", "reflect", "replicate", "circular")


class Conv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if padding_mode not in _PAD_MODES:
            raise InvalidArgumentError(
                f"Conv2D: padding_mode must be one of {_PAD_MODES}, got "
                f"{padding_mode!r}")
        ks = kernel_size if isinstance(kernel_size, (list, tuple)) \
            else (kernel_size,) * 2
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = tuple(int(k) for k in ks)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        self.padding_mode = padding_mode
        self.data_format = data_format
        fan_in = in_channels // groups * self.kernel_size[0] * \
            self.kernel_size[1]
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups) + self.kernel_size,
            attr=weight_attr,
            default_initializer=I.Normal(0.0, (2.0 / fan_in) ** 0.5),
            device=device, generator=generator)
        self.bias = self.create_parameter(
            (out_channels,), attr=bias_attr, is_bias=True, device=device,
            generator=generator)

    def forward(self, x):
        padding = self.padding
        if self.padding_mode != "zeros":
            ph, pw = (tuple(int(p) for p in padding)
                      if isinstance(padding, (list, tuple))
                      else (int(padding),) * 2)
            nhwc = self.data_format == "NHWC"
            if nhwc:
                x = x.permute(0, 3, 1, 2)
            x = torch.nn.functional.pad(x, (pw, pw, ph, ph),
                                        mode=self.padding_mode)
            if nhwc:
                x = x.permute(0, 2, 3, 1)
            padding = 0
        return F.conv2d(x, self.weight, self.bias, self.stride, padding,
                        self.dilation, self.groups, self.data_format)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")
