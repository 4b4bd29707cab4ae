"""matmul (counterpart of paddle_tpu/tensor/linalg.py)."""
from __future__ import annotations

import torch

from ..amp import amp_cast, promote

__all__ = ["matmul"]


def matmul(x, y, transpose_x: bool = False, transpose_y: bool = False):
    """x @ y over the last two axes, with optional transposes; AMP
    white-listed as ``matmul``."""
    x, y = promote(*amp_cast("matmul", x, y))
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)
