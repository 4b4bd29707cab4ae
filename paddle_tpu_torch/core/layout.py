"""Internal-layout policy for conv nets (counterpart of
paddle_tpu/core/layout.py).

``layout_policy("NHWC")`` runs a conv net channels-last without changing
its API: the model stays logical NCHW (inputs, weights and ``state_dict``
unchanged) and ``conv2d`` hands cuDNN its input and weight in
``torch.channels_last`` memory.  The layout then flows on by itself:
convolutions, the fused BatchNorm kernels, the residual add and the pools
all keep channels-last memory, and a channels-last (N, C, H, W) tensor's
``(M, C) = (N*H*W, C)`` view is what the BatchNorm kernels read, with no
copy.  The reference needs a layout tag on its tensors and a dispatcher
that propagates it (its AWARE / AGNOSTIC op sets); PyTorch carries the
layout in the tensor's strides, so the port keeps only the policy.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["NHWC", "layout_policy", "policy"]

NHWC = "NHWC"
_POLICY: Optional[str] = None


class _PolicyGuard:
    """Returned by layout_policy(): the policy is set at once; as a
    context manager it restores the previous one on exit."""

    def __init__(self, prev):
        self._prev = prev

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global _POLICY
        _POLICY = self._prev
        return False


def layout_policy(fmt: Optional[str]):
    """Set the internal compute layout of conv-net ops: "NHWC" runs
    logical-NCHW convolutions channels-last; None or "NCHW" restores the
    default.  A plain call or a ``with`` block."""
    global _POLICY
    prev = _POLICY
    if fmt is not None and str(fmt).upper() not in (NHWC, "NCHW"):
        raise ValueError(f"layout_policy: unsupported layout {fmt!r} "
                         "(expected 'NHWC', 'NCHW', or None)")
    _POLICY = NHWC if (fmt is not None and str(fmt).upper() == NHWC) \
        else None
    return _PolicyGuard(prev)


def policy() -> Optional[str]:
    return _POLICY
