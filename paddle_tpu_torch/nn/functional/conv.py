"""Convolutions (counterpart of paddle_tpu/nn/functional/conv.py):
conv1d / conv2d / conv3d and their transposes.

The convolution itself is ``torch.nn.functional.conv{1,2,3}d`` /
``conv_transpose{1,2,3}d`` (cuDNN on the card), as the reference leaves
it to ``lax.conv_general_dilated`` outside any Pallas kernel.  The weight
keeps Paddle's (out_c, in_c / groups, *k) layout, which is torch's own;
a transposed convolution's is (in_c, out_c / groups, *k), torch's too
(the reference's group interleave gives torch's grouping).  All six are
AMP white-listed.  Under
``layout_policy("NHWC")`` a logical-NCHW conv hands cuDNN its input and
weight in channels-last memory, and its output stays channels-last.
``data_format="NHWC"`` takes (N, H, W, C) inputs and returns (N, Ho, Wo,
C): both are free permutes of channels-last memory; 1-D takes ``"NCL"`` /
``"NLC"``, 3-D ``"NCDHW"`` / ``"NDHWC"``, and the layout policy applies to
rank 4 only.

``padding`` takes the reference's forms (``_padding``): an int, a list
per spatial axis, a 2n-list ``[lo, hi, ...]``, the list of pairs over
every axis, or ``"SAME"`` / ``"VALID"``.  Symmetric paddings go to torch's
``padding=``; any other becomes one explicit zero pad before the
convolution.

A transposed convolution is the reference's gradient-of-conv form: the
input dilated by the stride, padded by (k' - 1 - lo, k' - 1 - hi +
output_padding) per axis (k' the dilated kernel extent), convolved with
the flipped kernel.  torch's ``padding`` / ``output_padding`` express the
result where they can; otherwise the full transposed output is cropped
(or zero-extended) to it before the bias.  A string padding is refused,
as the reference's ``lax.conv_general_dilated`` refuses it there.
``output_size`` is taken and read nowhere, as in
the reference.
"""
from __future__ import annotations

import torch

from ...amp import amp_cast
from ...core import layout as _layout
from ...core.errors import InvalidArgumentError
from . import _padding as P

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_TF = torch.nn.functional
_CONV = {1: _TF.conv1d, 2: _TF.conv2d, 3: _TF.conv3d}
_CONV_T = {1: _TF.conv_transpose1d, 2: _TF.conv_transpose2d,
           3: _TF.conv_transpose3d}


def _nc_format(data_format):
    """The 1-D formats' other spellings: NCL / NCW and NLC / NWC."""
    return "NCW" if data_format in ("NCL", "NCW") else (
        "NWC" if data_format in ("NLC", "NWC") else data_format)


def _to_nc(x, n):
    """(N, *spatial, C) -> (N, C, *spatial), a free permute."""
    return x.permute(0, n + 1, *range(1, n + 1))


def _from_nc(y, n):
    return y.permute(0, *range(2, n + 2), 1)


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          data_format):
    name = f"conv{n}d"
    x, weight, bias = amp_cast(name, x, weight, bias)
    if x.dim() != n + 2:
        raise InvalidArgumentError(
            f"[{name}] expected a rank-{n + 2} input ({data_format}), got "
            f"shape {tuple(x.shape)}")
    channel_last = not data_format.startswith("NC")
    if channel_last:
        x = _to_nc(x, n)
    if n == 2 and (channel_last or _layout.policy() == _layout.NHWC):
        cl = torch.channels_last
        x = x.contiguous(memory_format=cl)
        weight = weight.contiguous(memory_format=cl)
    if weight.shape[1] * groups != x.shape[1]:
        raise InvalidArgumentError(
            f"[{name}] input channels {x.shape[1]} != weight in_channels "
            f"{weight.shape[1]} * groups {groups} (weight shape "
            f"{tuple(weight.shape)}, layout (out_c, in_c/groups, *k))")
    stride, dilation = P.tup(stride, n), P.tup(dilation, n)
    extents = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilation)]
    prs = P.pairs(P.spec(padding, n, data_format, full=True),
                  x.shape[2:], extents, stride)
    pad = P.torch_padding(prs)
    if pad is None:
        x, pad = P.pad_input(x, prs), 0
    out = _CONV[n](x, weight, bias, stride, pad, dilation, groups)
    return _from_nc(out, n) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 _nc_format(data_format))


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


def _conv_transpose(x, weight, bias, stride, padding, output_padding, groups,
                    dilation, n, data_format):
    name = f"conv{n}d_transpose"
    x, weight, bias = amp_cast(name, x, weight, bias)
    if x.dim() != n + 2:
        raise InvalidArgumentError(
            f"[{name}] expected a rank-{n + 2} input ({data_format}), got "
            f"shape {tuple(x.shape)}")
    channel_last = not data_format.startswith("NC")
    if channel_last:
        x = _to_nc(x, n)
    if weight.shape[0] != x.shape[1]:
        raise InvalidArgumentError(
            f"[{name}] input channels {x.shape[1]} != weight in_channels "
            f"{weight.shape[0]} (weight shape {tuple(weight.shape)}, layout "
            "(in_c, out_c/groups, *k))")
    stride, dilation = P.tup(stride, n), P.tup(dilation, n)
    extents = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilation)]
    sp = P.spec(padding, n, data_format, full=True)
    if isinstance(sp, str):
        raise InvalidArgumentError(
            f"[{name}] a string padding ({padding!r}) is refused, as the "
            "reference's lax.conv_general_dilated refuses it for a "
            "transposed convolution; give the padding explicitly")
    opad = P.tup(output_padding, n)
    pads = [(e - 1 - lo, e - 1 - hi + op)
            for e, (lo, hi), op in zip(extents, sp, opad)]
    # crop (negative: extend) of the full transposed output per side
    crop = [(e - 1 - lo, e - 1 - hi) for e, (lo, hi) in zip(extents, pads)]
    tp = tuple(lo for lo, _ in crop)
    top = tuple(lo - hi for lo, hi in crop)
    if all(p >= 0 and 0 <= o < max(s, d)
           for p, o, s, d in zip(tp, top, stride, dilation)):
        out = _CONV_T[n](x, weight, bias, stride, tp, top, groups, dilation)
    else:
        out = _CONV_T[n](x, weight, None, stride, 0, 0, groups, dilation)
        out = P.pad_input(out, [(-lo, -hi) for lo, hi in crop])
        if bias is not None:
            out = out + bias.reshape((1, -1) + (1,) * n)
    return _from_nc(out, n) if channel_last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, 1, _nc_format(data_format))


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, 2, data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, 3, data_format)
