"""flatten (counterpart of paddle_tpu/tensor/manipulation.py)."""
from __future__ import annotations

import torch

__all__ = ["flatten"]


def flatten(x, start_axis: int = 0, stop_axis: int = -1, name=None):
    """Merge axes start_axis..stop_axis into one (a view where the strides
    allow it)."""
    return torch.flatten(x, start_axis, stop_axis)
