"""conv2d (counterpart of paddle_tpu/nn/functional/conv.py).

The convolution itself is ``torch.nn.functional.conv2d`` (cuDNN on the
card), as the reference leaves it to ``lax.conv_general_dilated`` outside
any Pallas kernel.  The weight keeps Paddle's (out_c, in_c / groups, kh,
kw) layout, which is torch's own.  AMP white-listed.  Under
``layout_policy("NHWC")`` a logical-NCHW conv hands cuDNN its input and
weight in channels-last memory, and its output stays channels-last.
``data_format="NHWC"`` takes (N, H, W, C) inputs and returns (N, Ho, Wo,
C): both are free permutes of channels-last memory.
"""
from __future__ import annotations

import torch

from ...amp import amp_cast
from ...core import layout as _layout
from ...core.errors import InvalidArgumentError

__all__ = ["conv2d"]


def _pair(v):
    return tuple(int(i) for i in v) if isinstance(v, (list, tuple)) \
        else (int(v), int(v))


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    x, weight, bias = amp_cast("conv2d", x, weight, bias)
    if x.dim() != 4:
        raise InvalidArgumentError(
            f"[conv2d] expected a rank-4 input ({data_format}), got shape "
            f"{tuple(x.shape)}")
    channel_last = data_format == "NHWC"
    if channel_last:
        x = x.permute(0, 3, 1, 2)
    if channel_last or _layout.policy() == _layout.NHWC:
        cl = torch.channels_last
        x = x.contiguous(memory_format=cl)
        weight = weight.contiguous(memory_format=cl)
    if weight.shape[1] * groups != x.shape[1]:
        raise InvalidArgumentError(
            f"[conv2d] input channels {x.shape[1]} != weight in_channels "
            f"{weight.shape[1]} * groups {groups} (weight shape "
            f"{tuple(weight.shape)}, layout (out_c, in_c/groups, kh, kw))")
    out = torch.nn.functional.conv2d(x, weight, bias, _pair(stride),
                                     _pair(padding), _pair(dilation),
                                     groups)
    return out.permute(0, 2, 3, 1) if channel_last else out
