"""Conv1D / Conv2D / Conv3D and the transposed convolutions
(counterparts of paddle_tpu/nn/layer/conv.py).

The reference's parameters in its order; the port's ``device`` /
``generator`` come after them, as keywords.  The weight is Paddle's
(out_c, in_c / groups, *k) (a transposed layer's (in_c, out_c / groups,
*k)), which is torch's own layout, drawn by default from Normal(0,
sqrt(2 / fan_in)) with fan_in = in_c / groups * prod(k), as the
reference's ``_ConvNd``; the bias is zero, and ``bias_attr=False`` means
none.  ``padding_mode`` other than ``"zeros"`` pads the input by
``padding`` with ``"reflect"``, ``"replicate"`` or ``"circular"`` values
first, then convolves unpadded, as Paddle's layers do (the reference
keeps the mode and pads zeros).  The transposed layers'
``forward(x, output_size=None)`` passes ``output_size`` on, where it is
read nowhere, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core.errors import InvalidArgumentError
from .. import functional as F
from .. import initializer as I
from ..functional import _padding as P
from ..layer_base import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]

_PAD_MODES = ("zeros", "reflect", "replicate", "circular")


class _ConvNd(Layer):
    _dims = 2
    _transpose = False

    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, output_padding=0, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if padding_mode not in _PAD_MODES:
            raise InvalidArgumentError(
                f"{type(self).__name__}: padding_mode must be one of "
                f"{_PAD_MODES}, got {padding_mode!r}")
        n = self._dims
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = P.tup(kernel_size, n)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.output_padding = output_padding
        self.groups = groups
        self.padding_mode = padding_mode
        self.data_format = data_format
        if self._transpose:
            shape = (in_channels, out_channels // groups) + self.kernel_size
        else:
            shape = (out_channels, in_channels // groups) + self.kernel_size
        fan_in = in_channels // groups * int(np.prod(self.kernel_size))
        self.weight = self.create_parameter(
            shape, attr=weight_attr,
            default_initializer=I.Normal(0.0, (2.0 / fan_in) ** 0.5),
            device=device, generator=generator)
        self.bias = self.create_parameter(
            (out_channels,), attr=bias_attr, is_bias=True, device=device,
            generator=generator)

    def _mode_padded(self, x):
        """(x, padding): x padded by Paddle's non-zero padding mode first
        (then an unpadded convolution), else x and the padding as given."""
        if self.padding_mode == "zeros":
            return x, self.padding
        n = self._dims
        nc = self.data_format.startswith("NC")
        xc = x if nc else x.permute(0, n + 1, *range(1, n + 1))
        ext = [(k - 1) * d + 1 for k, d in
               zip(self.kernel_size, P.tup(self.dilation, n))]
        prs = P.pairs(P.spec(self.padding, n, self.data_format, full=True),
                      xc.shape[2:], ext, P.tup(self.stride, n))
        flat = [v for lo_hi in reversed(prs) for v in lo_hi]
        xc = torch.nn.functional.pad(xc, flat, mode=self.padding_mode)
        return (xc if nc else xc.permute(0, *range(2, n + 2), 1)), 0

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")


class _Conv(_ConvNd):
    def forward(self, x):
        x, padding = self._mode_padded(x)
        fn = (F.conv1d, F.conv2d, F.conv3d)[self._dims - 1]
        return fn(x, self.weight, self.bias, self.stride, padding,
                  self.dilation, self.groups, self.data_format)


class _ConvTranspose(_ConvNd):
    _transpose = True

    def forward(self, x, output_size=None):
        fn = (F.conv1d_transpose, F.conv2d_transpose,
              F.conv3d_transpose)[self._dims - 1]
        return fn(x, self.weight, self.bias, self.stride, self.padding,
                  self.output_padding, self.groups, self.dilation,
                  output_size, self.data_format)


class Conv1D(_Conv):
    _dims = 1

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)


class Conv2D(_Conv):
    _dims = 2

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)


class Conv3D(_Conv):
    _dims = 3

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)


class Conv1DTranspose(_ConvTranspose):
    _dims = 1

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, output_padding,
                         device=device, generator=generator)


class Conv2DTranspose(_ConvTranspose):
    _dims = 2

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, output_padding,
                         device=device, generator=generator)


class Conv3DTranspose(_ConvTranspose):
    _dims = 3

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, output_padding,
                         device=device, generator=generator)
