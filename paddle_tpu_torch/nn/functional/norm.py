"""layer_norm (counterpart of paddle_tpu/nn/functional/norm.py)."""
from __future__ import annotations

import torch

from ...amp import amp_cast

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """Population-variance layer norm over the trailing
    ``normalized_shape``; AMP black-listed (f32 under O1)."""
    ns = ((normalized_shape,) if isinstance(normalized_shape, int)
          else tuple(normalized_shape))
    x, weight, bias = amp_cast("layer_norm", x, weight, bias)
    return torch.nn.functional.layer_norm(x, ns, weight, bias, epsilon)
