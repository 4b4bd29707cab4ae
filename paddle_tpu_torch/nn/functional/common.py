"""linear and dropout (counterparts of paddle_tpu/nn/functional/common.py)."""
from __future__ import annotations

import torch

from ...amp import amp_cast, promote
from ...core import rng

__all__ = ["linear", "dropout"]


def linear(x, weight, bias=None):
    """y = x @ weight + bias with Paddle's (in, out) weight layout; AMP
    white-listed as ``linear`` with the bias cast too, so that under O1
    the output stays in the low type."""
    x, weight, bias = promote(*amp_cast("linear", x, weight, bias))
    y = x @ weight
    return y if bias is None else y + bias


def dropout(x, p: float = 0.5, training: bool = True):
    """Upscale-in-train dropout.  The keep mask is drawn with
    ``bernoulli_`` from the current generator of ``core.rng`` (never
    torch's global one), so the same generator seed gives the same
    mask."""
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.empty(x.shape, device=x.device).bernoulli_(
        keep, generator=rng.current_generator(x.device))
    return torch.where(mask.bool(), x / keep, 0.0).to(x.dtype)
