"""linear, dropout and embedding (counterparts of
paddle_tpu/nn/functional/common.py)."""
from __future__ import annotations

import torch

from ...amp import amp_cast, promote
from ...core import rng

__all__ = ["linear", "dropout", "embedding"]


def linear(x, weight, bias=None):
    """y = x @ weight + bias with Paddle's (in, out) weight layout; AMP
    white-listed as ``linear`` with the bias cast too, so that under O1
    the output stays in the low type."""
    x, weight, bias = promote(*amp_cast("linear", x, weight, bias))
    y = x @ weight
    return y if bias is None else y + bias


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Dropout with the reference's parameters.  The keep mask is drawn
    with ``bernoulli_`` from the current generator of ``core.rng`` (never
    torch's global one), so the same generator seed gives the same mask.
    ``axis`` (an int or a list) draws the mask over those axes only and
    broadcasts it over the others.  ``"upscale_in_train"`` scales the kept
    values by 1 / (1 - p); ``"downscale_in_infer"`` keeps them as they are.
    Out of training (or with p 0) either mode returns ``x``, as the
    reference does."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    if not training or p == 0.0:
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    keep = 1.0 - p
    mask = torch.empty(shape, device=x.device).bernoulli_(
        keep, generator=rng.current_generator(x.device))
    kept = x / keep if mode == "upscale_in_train" else x
    return torch.where(mask.bool(), kept, 0.0).to(x.dtype)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the integer ids ``x``; the output rows at
    ``padding_idx`` are zeros, so no gradient reaches that row (the
    reference's ``F.embedding``).  ``sparse=True`` (row-sparse gradients)
    is not ported yet."""
    if sparse:
        from ...core.errors import UnimplementedError
        raise UnimplementedError(
            "embedding(sparse=True): row-sparse gradients are not ported "
            "yet (ROADMAP section 1 item 4)")
    if x.is_floating_point() or x.is_complex():
        raise TypeError(f"embedding: ids must be an integer tensor, got "
                        f"{x.dtype}")
    if weight.dim() != 2:
        raise ValueError(f"embedding: weight must be 2-D (vocab, dim), got "
                         f"shape {tuple(weight.shape)}")
    out = weight[x]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0,
                          out).to(weight.dtype)
    return out
