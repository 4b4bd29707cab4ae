"""Load the JAX package's parameters into a port model.

``load_paddle_state(model, state)`` takes the reference's parameters by
their ``paddle_tpu.jit.state_arrays`` names, the same keys
``paddle_tpu.jit.save`` writes to ``*.pdiparams.npz``
(``gpt.blocks.0.qkv.weight``, ``...w_int8``, ``...w_scale``).  Float and
int8-quantized models load alike.  The key sets must match exactly and
every shape must agree; an int8 buffer only takes int8 data and a float
tensor only float data.  bfloat16 arrays (the reference's O2-decorated
models hold them as ml_dtypes' ``bfloat16``) load bit for bit.

``load_paddle_opt_state(step, opt_state)`` carries the reference's
``TrainStep`` optimizer state (``{name: {"moment1": ..., "moment2": ...}}``
for Adam, ``{name: {"velocity": ...}}`` for Momentum, as its
``init_opt_state`` builds it; arrays, or tensors as a checkpoint restore
gives them) into a port ``jit.TrainStep``, so a resumed comparison starts
from equal slots.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.errors import InvalidArgumentError

__all__ = ["load_paddle_state", "load_paddle_opt_state", "host_tensor"]


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
            dst.copy_(host_tensor(src))
    return model


def host_tensor(src: np.ndarray) -> torch.Tensor:
    """A CPU tensor of ``src``'s values; numpy has no bfloat16 of its own,
    so an ml_dtypes ``bfloat16`` array goes across as its 16-bit words."""
    if src.dtype.name == "bfloat16":
        bits = np.array(src).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(src))


def load_paddle_opt_state(train_step, opt_state: Mapping[str, Mapping],
                          step_count=None):
    """Set ``train_step``'s optimizer state from the reference's
    (``name -> {slot: array}``, one entry per trainable state name), each
    slot in the type and on the device the port's optimizer keeps it
    (``init_state``: f32 moments, Momentum's velocity in the parameter's
    type); with ``step_count``, also the optimizer's step counter (Adam's
    bias corrections read it).  Returns the train step."""
    state = train_step.model.state_dict(keep_vars=True)
    want = set(train_step._trainable)
    missing = sorted(want - set(opt_state))
    extra = sorted(set(opt_state) - want)
    if missing or extra:
        raise InvalidArgumentError(
            f"load_paddle_opt_state: key mismatch — missing {missing[:4]}, "
            f"unexpected {extra[:4]}")
    out = {}
    for name in train_step._trainable:
        p = state[name]
        like = train_step.optimizer.init_state(p.detach())
        if set(like) != set(opt_state[name]):
            raise InvalidArgumentError(
                f"load_paddle_opt_state: {name} has slots "
                f"{sorted(opt_state[name])}, the optimizer keeps "
                f"{sorted(like)}")
        slots = {}
        for slot, arr in opt_state[name].items():
            src = (arr.detach() if isinstance(arr, torch.Tensor)
                   else torch.from_numpy(np.array(arr, np.float32)))
            if tuple(src.shape) != tuple(p.shape):
                raise InvalidArgumentError(
                    f"load_paddle_opt_state: {name}.{slot} has shape "
                    f"{tuple(src.shape)}, the parameter {tuple(p.shape)}")
            slots[slot] = src.to(p.device, like[slot].dtype)
        out[name] = slots
    if train_step._opt_state is None:
        train_step._opt_state = out
    else:   # the step's programs read these tensors: write them in place
        with torch.no_grad():
            for name, slots in out.items():
                for slot, t in slots.items():
                    train_step._opt_state[name][slot].copy_(t)
    if step_count is not None:
        train_step.optimizer._step_count = int(step_count)
    return train_step
