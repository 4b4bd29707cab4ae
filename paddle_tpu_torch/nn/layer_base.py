"""Layer base (counterpart of paddle_tpu/nn/layer_base.py).

A port layer is a plain ``torch.nn.Module``.  What the port keeps from
Paddle is the state naming: parameter and buffer names are the keys
``paddle_tpu.jit.state_arrays`` (and ``jit.save``'s ``*.pdiparams.npz``)
use, so a reference state dict loads one to one (``weights.py``).
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["Layer"]


class Layer(nn.Module):
    """``nn.Module`` with the device its state lives on."""

    @property
    def device(self) -> torch.device:
        for t in self.parameters():
            return t.device
        for t in self.buffers():
            return t.device
        return torch.device("cpu")
