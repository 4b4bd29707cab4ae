"""Padding specs of the convolutions and pools (counterpart of the
reference's ``_padding`` in ``paddle_tpu/nn/functional/conv.py`` and
``_pad_spec`` in ``paddle_tpu/nn/functional/pooling.py``).

A spec is an int, an n-list (one symmetric padding per spatial axis), a
2n-list (``[lo0, hi0, lo1, hi1, ...]``), or ``"SAME"`` / ``"VALID"`` in
any case; a convolution also takes the (n + 2)-list of pairs that names
the batch and channel axes too.  ``pairs`` resolves a spec to one (lo, hi)
pair per spatial axis for given input sizes, kernel extents and strides;
``"SAME"`` is lax's: total = max((out - 1)·s + k − in, 0) with out =
ceil(in / s), low = total // 2, the rest high.  A nested list of length n
or 2n is refused with ``TypeError``, as the reference refuses it (it reads
each entry as an int).

``torch_padding`` says whether torch's own symmetric ``padding=`` can
express the pairs (pools also need each pad within half the kernel);
``pad_input`` applies them as one explicit pad before the op, the last
spatial axis first as ``torch.nn.functional.pad`` reads them.
"""
from __future__ import annotations

import numbers

import torch

from ...core.errors import InvalidArgumentError

__all__ = ["tup", "spec", "pairs", "torch_padding", "pad_input"]


def tup(v, n: int):
    """An int or a sequence as an n-tuple of ints."""
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def spec(padding, n: int, data_format: str = "NC", full: bool = False):
    """``"SAME"`` / ``"VALID"``, or a list of n (lo, hi) pairs.  ``full``:
    also take the (n + 2)-list of pairs over every axis (convolutions)."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode not in ("SAME", "VALID"):
            raise InvalidArgumentError(
                f"padding must be 'SAME', 'VALID', an int or a list, got "
                f"{padding!r}")
        return mode
    if isinstance(padding, numbers.Integral):
        return [(int(padding), int(padding))] * n
    p = list(padding)
    if len(p) == n:
        return [(int(q), int(q)) for q in p]
    if len(p) == 2 * n:
        return [(int(p[2 * i]), int(p[2 * i + 1])) for i in range(n)]
    if full and len(p) == n + 2:
        pads = [tuple(int(v) for v in q) for q in p]
        return pads[2:] if data_format.startswith("NC") else pads[1:-1]
    raise InvalidArgumentError(
        f"padding {padding!r} has {len(p)} entries; expected {n} or {2 * n}")


def same_pairs(sizes, extents, strides):
    """lax's "SAME": the output is ceil(in / stride) long."""
    out = []
    for size, k, s in zip(sizes, extents, strides):
        o = -(-size // s)
        total = max((o - 1) * s + k - size, 0)
        out.append((total // 2, total - total // 2))
    return out


def pairs(sp, sizes, extents, strides):
    """(lo, hi) per spatial axis of a resolved ``spec``."""
    if sp == "SAME":
        return same_pairs(sizes, extents, strides)
    if sp == "VALID":
        return [(0, 0)] * len(sizes)
    return list(sp)


def torch_padding(prs, kernel=None):
    """torch's symmetric ``padding=`` tuple for ``prs``, or None when the
    pairs are asymmetric (or, for a pool's ``kernel``, a pad exceeds half
    its window, which torch refuses)."""
    if any(lo != hi for lo, hi in prs):
        return None
    if kernel is not None and any(lo > k // 2 for (lo, _), k in
                                  zip(prs, kernel)):
        return None
    return tuple(lo for lo, _ in prs)


def pad_input(x, prs, value: float = 0.0):
    """x with its trailing len(prs) axes padded by ``prs``."""
    flat = []
    for lo, hi in reversed(prs):
        flat += [lo, hi]
    if not any(flat):
        return x
    return torch.nn.functional.pad(x, flat, value=value)
