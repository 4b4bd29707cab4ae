"""Pooling (counterpart of paddle_tpu/nn/functional/pooling.py).

Plain torch pooling, as the reference's are ``lax.reduce_window``
outside any Pallas kernel; avg pooling counts exclusively (padding left
out of the divisor) by default, as Paddle's.  Channels-last memory flows
through; ``data_format="NHWC"`` takes (N, H, W, C) as a free permute.
Under O2 AMP the input is cast to the low type, under O1 not.
"""
from __future__ import annotations

import torch

from ...amp import amp_cast
from ...core.errors import UnimplementedError

__all__ = ["max_pool2d", "avg_pool2d", "adaptive_avg_pool2d"]


def _pair(v):
    return tuple(int(i) for i in v) if isinstance(v, (list, tuple)) \
        else (int(v), int(v))


def _nchw(x, data_format):
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _back(y, data_format):
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW"):
    if return_mask:
        raise UnimplementedError("max_pool2d(return_mask=True) comes with a "
                                 "later slice of the port")
    (x,) = amp_cast("max_pool2d", x)
    k = _pair(kernel_size)
    s = _pair(stride) if stride is not None else k
    y = torch.nn.functional.max_pool2d(_nchw(x, data_format), k, s,
                                       _pair(padding), ceil_mode=ceil_mode)
    return _back(y, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, data_format="NCHW"):
    (x,) = amp_cast("avg_pool2d", x)
    k = _pair(kernel_size)
    s = _pair(stride) if stride is not None else k
    y = torch.nn.functional.avg_pool2d(
        _nchw(x, data_format), k, s, _pair(padding), ceil_mode=ceil_mode,
        count_include_pad=not exclusive)
    return _back(y, data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    (x,) = amp_cast("adaptive_avg_pool2d", x)
    y = torch.nn.functional.adaptive_avg_pool2d(_nchw(x, data_format),
                                                output_size)
    return _back(y, data_format)
