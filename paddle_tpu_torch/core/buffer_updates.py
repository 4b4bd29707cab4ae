"""Buffer updates inside a training step (counterpart of
paddle_tpu/core/buffer_updates.py).

A norm functional updates a running statistic with ``apply(buffer,
value)``.  Eagerly that is an in-place copy.  Inside ``jit.TrainStep``'s
``capture()`` scope the update is logged instead, so that the step can
apply it after the optimizer update and, under ``guard=True``, keep the
old value for a step that is not finite, as the reference folds its
captured updates into the new state before ``guard_select``.  Within one
scope ``current(buffer)`` is the buffer's latest logged value, so that a
step of several micro-batches compounds the updates from one micro-batch
to the next.  Inside ``dropped()`` updates are dropped: a recompute
region's recomputation (``core.recompute``) runs the region's forward a
second time, and its first forward's updates are already in the log.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch

__all__ = ["capture", "capturing", "dropped", "apply", "current",
           "resolve"]

_ACTIVE: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
_DROPPING = 0


@contextlib.contextmanager
def capture():
    """Log (buffer, new_value) updates instead of applying them; yields
    the log.  Nestable (the innermost scope logs)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = []
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


@contextlib.contextmanager
def dropped():
    """Drop every update made inside the block."""
    global _DROPPING
    _DROPPING += 1
    try:
        yield
    finally:
        _DROPPING -= 1


def capturing() -> bool:
    return _ACTIVE is not None


def current(buffer):
    """The buffer's value as the active scope sees it: its latest logged
    update, else the buffer itself."""
    if _ACTIVE:
        for buf, value in reversed(_ACTIVE):
            if buf is buffer:
                return value
    return buffer


def apply(buffer, raw) -> None:
    """Update a buffer: dropped inside ``dropped()``, logged under
    capture, else copied in place."""
    if _DROPPING:
        return
    raw = raw.detach()
    if _ACTIVE is not None:
        _ACTIVE.append((buffer, raw))
    else:
        with torch.no_grad():
            buffer.copy_(raw)


def resolve(log, state_dict) -> dict:
    """A log as {state_key: value}, matched by buffer identity; later
    records win."""
    by_id = {id(t): k for k, t in state_dict.items()}
    out = {}
    for buf, value in log:
        key = by_id.get(id(buf))
        if key is not None:
            out[key] = value
    return out
