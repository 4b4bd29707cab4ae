"""Pooling layers (counterparts of paddle_tpu/nn/layer/pooling.py).

Each layer keeps its arguments and calls its functional.  The reference's
fixed-window pools take ``(kernel_size, stride, padding, **kw)`` and pass
``kw`` on; the port spells those keywords out, in the functional's order.
``MaxPool2D`` keeps ``return_mask`` / ``ceil_mode`` / ``data_format`` as
attributes: ``ops.fused_bn_act.fusable_pool_spec`` reads them to fold a
stock max pool into the fused BatchNorm epilogue.
"""
from __future__ import annotations

from .. import functional as F
from ..layer_base import Layer

__all__ = ["AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]


class _Pool(Layer):
    def __init__(self, kernel_size, stride, padding):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)


class AvgPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding)
        self.exclusive, self.ceil_mode = exclusive, ceil_mode

    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.exclusive, self.ceil_mode)


class AvgPool2D(_Pool):
    _fn = staticmethod(F.avg_pool2d)

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding)
        self.ceil_mode, self.exclusive = ceil_mode, exclusive
        self.divisor_override, self.data_format = (divisor_override,
                                                   data_format)

    def forward(self, x):
        return self._fn(x, self.kernel_size, self.stride, self.padding,
                        self.ceil_mode, self.exclusive,
                        self.divisor_override, self.data_format)


class AvgPool3D(AvgPool2D):
    _fn = staticmethod(F.avg_pool3d)

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive,
                         divisor_override, data_format)


class MaxPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding)
        self.return_mask, self.ceil_mode = return_mask, ceil_mode

    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode)


class MaxPool2D(_Pool):
    _fn = staticmethod(F.max_pool2d)

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding)
        self.return_mask, self.ceil_mode = return_mask, ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return self._fn(x, self.kernel_size, self.stride, self.padding,
                        self.return_mask, self.ceil_mode, self.data_format)


class MaxPool3D(MaxPool2D):
    _fn = staticmethod(F.max_pool3d)

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, return_mask,
                         ceil_mode, data_format)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    _fn = staticmethod(F.adaptive_avg_pool2d)

    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return self._fn(x, self.output_size, self.data_format)


class AdaptiveAvgPool3D(AdaptiveAvgPool2D):
    _fn = staticmethod(F.adaptive_avg_pool3d)

    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(output_size, data_format)


class AdaptiveMaxPool1D(Layer):
    _fn = staticmethod(F.adaptive_max_pool1d)

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return self._fn(x, self.output_size, self.return_mask)


class AdaptiveMaxPool2D(AdaptiveMaxPool1D):
    _fn = staticmethod(F.adaptive_max_pool2d)


class AdaptiveMaxPool3D(AdaptiveMaxPool1D):
    _fn = staticmethod(F.adaptive_max_pool3d)
