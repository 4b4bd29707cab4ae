"""Layer base (counterpart of paddle_tpu/nn/layer_base.py).

A port layer is a plain ``torch.nn.Module``.  What the port keeps from
Paddle is the state naming: parameter and buffer names are the keys
``paddle_tpu.jit.state_arrays`` (and ``jit.save``'s ``*.pdiparams.npz``)
use, so a reference state dict loads one to one (``weights.py``).  And, as
the reference's ``Layer.__call__``, the call runs a layer that the active
``jit.recompute_policy`` matches as a checkpoint region inside a
``TrainStep`` forward (``core.recompute``); it costs one flag test while
no policy was ever set.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core import recompute as _recompute

__all__ = ["Layer"]


class Layer(nn.Module):
    """``nn.Module`` with the device its state lives on."""

    def __call__(self, *inputs, **kwargs):
        if _recompute._ENABLED_EVER and _recompute.should_wrap(self):
            return _recompute.run_wrapped(self, inputs, kwargs,
                                          super().__call__)
        return super().__call__(*inputs, **kwargs)

    @property
    def device(self) -> torch.device:
        for t in self.parameters():
            return t.device
        for t in self.buffers():
            return t.device
        return torch.device("cpu")
