"""Load the JAX package's parameters into a port model.

``load_paddle_state(model, state)`` takes the reference's parameters by
their ``paddle_tpu.jit.state_arrays`` names, the same keys
``paddle_tpu.jit.save`` writes to ``*.pdiparams.npz``
(``gpt.blocks.0.qkv.weight``, ``...w_int8``, ``...w_scale``).  Float and
int8-quantized models load alike.  The key sets must match exactly and
every shape must agree; an int8 buffer only takes int8 data and a float
tensor only float data.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.errors import InvalidArgumentError

__all__ = ["load_paddle_state"]


def load_paddle_state(model: torch.nn.Module, state: Mapping[str, np.ndarray]):
    """Copy ``state`` (name -> array) into ``model``'s parameters and
    buffers, in place, on the model's device.  Returns the model."""
    own = model.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise InvalidArgumentError(
            f"load_paddle_state: key mismatch — missing {missing[:4]}"
            f"{'...' if len(missing) > 4 else ''}, unexpected {extra[:4]}"
            f"{'...' if len(extra) > 4 else ''}")
    with torch.no_grad():
        for name, dst in own.items():
            src = np.asarray(state[name])
            if tuple(src.shape) != tuple(dst.shape):
                raise InvalidArgumentError(
                    f"load_paddle_state: {name} has shape "
                    f"{tuple(src.shape)}, the model expects "
                    f"{tuple(dst.shape)}")
            if (src.dtype == np.int8) != (dst.dtype == torch.int8):
                raise InvalidArgumentError(
                    f"load_paddle_state: {name} is {src.dtype}, the model "
                    f"holds {dst.dtype}")
            dst.copy_(torch.from_numpy(np.array(src)))
    return model
