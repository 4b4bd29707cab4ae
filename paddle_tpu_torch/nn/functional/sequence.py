"""Sequence ops on padded tensors plus lengths (counterpart of
paddle_tpu/nn/functional/sequence.py).

A ragged batch is a padded (B, T, ...) tensor and a (B,) vector of
lengths; every op is a masked dense computation with the reference's
semantics: masked maxima and softmax use the finite -1e30 (an all-masked
row stays NaN-free forward and backward), an empty sequence pools to
``pad_value``, and ``sequence_unpad``'s data-dependent extent is worked
out on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.errors import InvalidArgumentError

__all__ = [
    "sequence_pad", "sequence_unpad", "sequence_pool", "sequence_softmax",
    "sequence_reverse", "sequence_concat", "sequence_enumerate",
    "sequence_expand_as", "sequence_first_step", "sequence_last_step",
]

_MASKED = -1e30


def _lengths(lengths, device) -> torch.Tensor:
    if not isinstance(lengths, torch.Tensor):
        lengths = torch.as_tensor(np.asarray(lengths))
    return lengths.to(device=device, dtype=torch.int64)


def _time_mask(lv, maxlen: int, ndim: int):
    """(B, T, 1, ...) bool mask of the valid positions of a (B, T, ...)
    value with ``ndim`` dims."""
    m = torch.arange(maxlen, device=lv.device)[None, :] < lv[:, None]
    return m.reshape(m.shape + (1,) * (ndim - 2))


def _bcast(v, ndim: int):
    return v.reshape((-1,) + (1,) * (ndim - 2))


def sequence_pad(x, lengths, maxlen=None, pad_value=0.0, name=None):
    """Packed (total, ...) plus lengths (B,) -> padded (B, maxlen, ...)."""
    lv = _lengths(lengths, x.device)
    if maxlen is None:
        maxlen = int(lv.max())
    offsets = torch.cumsum(lv, 0) - lv
    idx = torch.clamp(offsets[:, None] + torch.arange(maxlen, device=x.device)
                      [None, :], 0, x.shape[0] - 1)
    out = x[idx]
    return torch.where(_time_mask(lv, maxlen, out.dim()), out,
                       torch.as_tensor(pad_value, dtype=out.dtype,
                                       device=out.device))


def sequence_unpad(x, lengths, name=None):
    """Padded (B, T, ...) plus lengths -> packed (total, ...); the extent
    is read on the host."""
    lv = _lengths(lengths, "cpu").numpy()
    rows = np.repeat(np.arange(len(lv)), lv)
    cols = (np.concatenate([np.arange(n) for n in lv]) if len(lv)
            else np.zeros((0,), np.int64))
    return x[torch.from_numpy(rows).to(x.device),
             torch.from_numpy(cols).to(x.device)]


def sequence_pool(x, lengths, pool_type="average", pad_value=0.0,
                  name=None):
    """Masked pooling over the time axis, (B, T, ...) -> (B, ...): "sum",
    "average", "sqrt", "max", "min", "first" or "last"; an empty sequence
    gives ``pad_value`` in every mode."""
    pool_type = pool_type.lower()
    lv = _lengths(lengths, x.device)
    mask = _time_mask(lv, x.shape[1], x.dim())
    n = _bcast(torch.clamp_min(lv, 1), x.dim())
    empty = _bcast(lv == 0, x.dim())
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if pool_type == "sum":
        out = torch.where(mask, x, zero).sum(1)
    elif pool_type == "average":
        out = torch.where(mask, x, zero).sum(1) / n
    elif pool_type == "sqrt":
        out = torch.where(mask, x, zero).sum(1) / torch.sqrt(n.to(x.dtype))
    elif pool_type == "max":
        out = torch.where(mask, x, _MASKED).amax(1)
    elif pool_type == "min":
        out = torch.where(mask, x, -_MASKED).amin(1)
    elif pool_type == "first":
        out = x[:, 0]
    elif pool_type == "last":
        idx = torch.clamp_min(lv - 1, 0)
        out = torch.take_along_dim(
            x, idx.reshape((-1, 1) + (1,) * (x.dim() - 2)), dim=1)[:, 0]
    else:
        raise InvalidArgumentError(
            f"[sequence_pool] unknown pool_type {pool_type!r}")
    return torch.where(empty, torch.as_tensor(pad_value, dtype=out.dtype,
                                              device=out.device), out)


def sequence_first_step(x, lengths=None, name=None):
    if lengths is None:
        lengths = torch.full((x.shape[0],), x.shape[1], device=x.device)
    return sequence_pool(x, lengths, "first")


def sequence_last_step(x, lengths, name=None):
    return sequence_pool(x, lengths, "last")


def sequence_softmax(x, lengths, name=None):
    """Softmax over each row's valid positions (f32 inside); padding
    gives 0."""
    lv = _lengths(lengths, x.device)
    mask = _time_mask(lv, x.shape[1], x.dim())
    p = torch.softmax(torch.where(mask, x, _MASKED).to(torch.float32), dim=1)
    return torch.where(mask, p, 0.0).to(x.dtype)


def sequence_reverse(x, lengths, name=None):
    """Each row's valid prefix reversed, the padding left in place."""
    lv = _lengths(lengths, x.device)
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    idx = torch.where(t < lv[:, None], lv[:, None] - 1 - t, t)
    return torch.take_along_dim(
        x, idx.reshape(idx.shape + (1,) * (x.dim() - 2)), dim=1)


def sequence_concat(xs, lengths_list, maxlen=None, name=None):
    """Per-row concatenation of ragged sequences; returns (padded,
    lengths)."""
    dev = xs[0].device
    lvs = [_lengths(v, dev) for v in lengths_list]
    total = sum(lvs)
    if maxlen is None:
        maxlen = int(total.max())
    b = xs[0].shape[0]
    t = torch.arange(maxlen, device=dev)[None, :]
    out = xs[0].new_zeros((b, maxlen) + tuple(xs[0].shape[2:]))
    start = torch.zeros((b,), dtype=torch.int64, device=dev)
    for xi, li in zip(xs, lvs):
        src_t = t - start[:, None]
        valid = (src_t >= 0) & (src_t < li[:, None])
        src = torch.clamp(src_t, 0, xi.shape[1] - 1)
        tail = (1,) * (xi.dim() - 2)
        gathered = torch.take_along_dim(xi, src.reshape(src.shape + tail),
                                        dim=1)
        out = torch.where(valid.reshape(valid.shape + tail), gathered, out)
        start = start + li
    return out, total


def sequence_enumerate(x, win_size, lengths=None, pad_value=0, name=None):
    """Sliding windows over ids, (B, T) -> (B, T, win_size); a window
    reads past its row's length (or the end) as ``pad_value``."""
    t = (torch.arange(x.shape[1], device=x.device)[:, None]
         + torch.arange(win_size, device=x.device)[None, :])
    if lengths is not None:
        valid = t[None] < _lengths(lengths, x.device)[:, None, None]
    else:
        valid = (t < x.shape[1])[None]
    out = x[:, torch.clamp(t, 0, x.shape[1] - 1)]
    return torch.where(valid, out, torch.as_tensor(pad_value, dtype=x.dtype,
                                                   device=x.device))


def sequence_expand_as(x, lengths, maxlen=None, name=None):
    """Each row x[b] repeated over its positions, (B, ...) + lengths ->
    (B, maxlen, ...), zeros past each length."""
    lv = _lengths(lengths, x.device)
    if maxlen is None:
        maxlen = int(lv.max()) if lv.numel() else 0
    mask = _time_mask(lv, maxlen, x.dim() + 1)
    tiled = x[:, None].expand((x.shape[0], maxlen) + tuple(x.shape[1:]))
    return torch.where(mask, tiled, torch.zeros((), dtype=x.dtype,
                                                device=x.device))
