"""Activations (counterpart of paddle_tpu/nn/functional/activation.py)."""
from __future__ import annotations

import torch

__all__ = ["gelu"]


def gelu(x, approximate: bool = False):
    """GELU; exact erf form by default, as the reference's
    ``jax.nn.gelu(x, approximate=False)``."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")
