"""Pooling (counterpart of paddle_tpu/nn/functional/pooling.py): the
1-, 2- and 3-D max and average pools, their adaptive forms and
``return_mask``.

Plain torch pooling, as the reference's are ``lax.reduce_window``
outside any Pallas kernel; avg pooling counts exclusively (padding left
out of the divisor) by default, as Paddle's.  Channels-last memory flows
through; ``data_format="NHWC"`` takes (N, H, W, C) as a free permute.
Under O2 AMP the input is cast to the low type, under O1 not.

``padding`` takes the reference's forms (``_pad_spec``): an int, a list
per spatial axis, a 2n-list ``[lo, hi, ...]`` or ``"SAME"`` / ``"VALID"``.
Symmetric paddings within half the window go to torch's ``padding=``; any
other becomes one explicit pad before the pool: -inf for a max, zeros for
an average, whose exclusive divisor then counts the unpadded positions of
each window.  With a string padding the reference divides an average by
the whole window, exclusive or not, and so does the port.

``ceil_mode`` is taken and changes nothing, as in the reference (whose
``_pool`` never reads it): the output length is always floor division's.
``divisor_override`` is taken and read nowhere, as in the reference.
The 1-D pools take (N, C, L) only, as the reference's.

``return_mask=True`` gives the reference's mask: for each output, the flat
index of the window's first largest value within the spatial plane, as
int32.  It is computed over the last n axes of what it is given, whatever
``data_format`` says (the reference's ``_pool_indices``), so for an
explicit ``data_format="NHWC"`` the 2-D mask pools over (W, C).  The
adaptive max pools take ``return_mask`` and return the output alone, as
the reference's do.  An adaptive pool's window i spans [floor(i·in/out),
ceil((i + 1)·in/out)) on each axis, the reference's rule and torch's.
"""
from __future__ import annotations

import torch

from ...amp import amp_cast
from . import _padding as P

__all__ = ["avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d",
           "max_pool2d", "max_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d"]

_TF = torch.nn.functional
_MAX = {1: _TF.max_pool1d, 2: _TF.max_pool2d, 3: _TF.max_pool3d}
_AVG = {1: _TF.avg_pool1d, 2: _TF.avg_pool2d, 3: _TF.avg_pool3d}
_ADAPTIVE = {("avg", 1): _TF.adaptive_avg_pool1d,
             ("avg", 2): _TF.adaptive_avg_pool2d,
             ("avg", 3): _TF.adaptive_avg_pool3d,
             ("max", 1): _TF.adaptive_max_pool1d,
             ("max", 2): _TF.adaptive_max_pool2d,
             ("max", 3): _TF.adaptive_max_pool3d}


def _nc(x, n, data_format):
    """(N, C, *spatial) of x, a free permute for a channels-last format."""
    if data_format.startswith("NC"):
        return x
    return x.permute(0, n + 1, *range(1, n + 1))


def _back(y, n, data_format):
    if data_format.startswith("NC"):
        return y
    return y.permute(0, *range(2, n + 2), 1)


def _pool(x, kernel, stride, padding, n, data_format, kind,
          exclusive=True):
    (x,) = amp_cast(f"{kind}_pool{n}d", x)
    k = P.tup(kernel, n)
    s = P.tup(stride if stride is not None else kernel, n)
    sp = P.spec(padding, n)
    xc = _nc(x, n, data_format)
    prs = P.pairs(sp, xc.shape[2:], k, s)
    pad = P.torch_padding(prs, k)
    if kind == "max":
        if pad is None:
            xc, pad = P.pad_input(xc, prs, float("-inf")), 0
        y = _MAX[n](xc, k, s, pad)
    elif isinstance(sp, str) or not exclusive:
        # the whole window divides: zeros padded in, then counted
        y = _AVG[n](P.pad_input(xc, prs), k, s, 0)
    elif pad is not None:
        y = _AVG[n](xc, k, s, pad, count_include_pad=False)
    else:
        # exclusive over an asymmetric pad: the divisor is the count of
        # unpadded positions in each window
        ones = P.pad_input(torch.ones((1, 1) + tuple(xc.shape[2:]),
                                      dtype=xc.dtype, device=xc.device), prs)
        y = _AVG[n](P.pad_input(xc, prs), k, s, 0) / _AVG[n](ones, k, s, 0)
    return _back(y, n, data_format)


def _pool_mask(x, kernel, stride, padding, n):
    """The reference's ``_pool_indices``: over the last n axes of x as
    given, the flat index (int32) of each window's first largest value
    within that plane; padded positions are -inf with index -1."""
    k = P.tup(kernel, n)
    s = P.tup(stride if stride is not None else kernel, n)
    spatial = tuple(x.shape[2:])
    prs = P.pairs(P.spec(padding, n), spatial, k, s)
    idx = torch.arange(int(torch.tensor(spatial).prod()), dtype=torch.int32,
                       device=x.device).reshape(spatial).expand(x.shape)
    vals = P.pad_input(x.detach(), prs, float("-inf"))
    idx = P.pad_input(idx, prs, -1)
    for d in range(n):
        vals = vals.unfold(2 + d, k[d], s[d])
        idx = idx.unfold(2 + d, k[d], s[d])
    lead = vals.shape[:2 + n]
    pick = vals.reshape(lead + (-1,)).argmax(-1, keepdim=True)
    return idx.reshape(lead + (-1,)).gather(-1, pick.long())[..., 0]


def _max(x, kernel_size, stride, padding, return_mask, n, data_format):
    out = _pool(x, kernel_size, stride, padding, n, data_format, "max")
    if not return_mask:
        return out
    return out, _pool_mask(x, kernel_size, stride, padding, n)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool(x, kernel_size, stride, padding, 1, "NCL", "avg", exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, data_format, "avg",
                 exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, data_format, "avg",
                 exclusive)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _max(x, kernel_size, stride, padding, return_mask, 1, "NCL")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max(x, kernel_size, stride, padding, return_mask, 2,
                data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max(x, kernel_size, stride, padding, return_mask, 3,
                data_format)


def _adaptive(x, output_size, n, data_format, kind):
    (x,) = amp_cast(f"adaptive_{kind}_pool{n}d", x)
    y = _ADAPTIVE[(kind, n)](_nc(x, n, data_format), P.tup(output_size, n))
    if kind == "max":
        y = y[0] if isinstance(y, tuple) else y
    return _back(y, n, data_format)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "NCL", "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, data_format, "avg")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, data_format, "avg")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, "NCL", "max")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, "NCHW", "max")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, "NCDHW", "max")
