"""Activations (counterpart of paddle_tpu/nn/functional/activation.py)."""
from __future__ import annotations

import torch

from ...amp import amp_cast

__all__ = ["gelu", "relu", "relu6", "softmax", "tanh"]


def gelu(x, approximate: bool = False, name=None):
    """GELU; exact erf form by default, as the reference's
    ``jax.nn.gelu(x, approximate=False)``."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def softmax(x, axis: int = -1, dtype=None, name=None):
    """Softmax along ``axis``; AMP black-listed (f32 under O1).  With
    ``dtype`` (a name or a torch dtype) ``x`` is cast to it first, as the
    reference casts before its softmax."""
    (x,) = amp_cast("softmax", x)
    if dtype is not None:
        x = x.to(_torch_dtype(dtype))
    return torch.softmax(x, dim=axis)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("paddle.", "").replace("torch.", "")
    got = getattr(torch, name, None)
    if not isinstance(got, torch.dtype):
        raise ValueError(f"softmax: unknown dtype {dtype!r}")
    return got


def relu(x, name=None):
    (x,) = amp_cast("relu", x)
    return torch.relu(x)


def relu6(x, name=None):
    (x,) = amp_cast("relu6", x)
    return torch.clamp(x, 0.0, 6.0)


def tanh(x, name=None):
    """On neither AMP list: cast under O2 only, as the reference's."""
    (x,) = amp_cast("tanh", x)
    return torch.tanh(x)
