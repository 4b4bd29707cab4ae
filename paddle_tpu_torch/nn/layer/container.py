"""LayerList (counterpart of paddle_tpu/nn/layer/container.py): children
are named ``0, 1, ...`` as Paddle's are, so ``blocks.3.qkv.weight`` keys
line up with the reference."""
from __future__ import annotations

from torch import nn

__all__ = ["LayerList"]


class LayerList(nn.ModuleList):
    pass
