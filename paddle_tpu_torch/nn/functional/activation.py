"""Activations (counterpart of paddle_tpu/nn/functional/activation.py)."""
from __future__ import annotations

import torch

from ...amp import amp_cast

__all__ = ["gelu", "relu", "relu6", "softmax"]


def gelu(x, approximate: bool = False):
    """GELU; exact erf form by default, as the reference's
    ``jax.nn.gelu(x, approximate=False)``."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def softmax(x, axis: int = -1):
    """Softmax along ``axis``; AMP black-listed (f32 under O1)."""
    (x,) = amp_cast("softmax", x)
    return torch.softmax(x, dim=axis)


def relu(x):
    (x,) = amp_cast("relu", x)
    return torch.relu(x)


def relu6(x):
    (x,) = amp_cast("relu6", x)
    return torch.clamp(x, 0.0, 6.0)
