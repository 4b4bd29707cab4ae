"""Int8 weight-only serving quantization (port of the serving half of
paddle_tpu/quantization/__init__.py, ``:276-355``).

``quantize_for_serving`` swaps every ``Linear`` for an
``Int8WeightOnlyLinear``: int8 weight + per-output-channel f32 scale,
dequantized at use by the dequant-matmul kernel (``ops.int8_matmul``).
Activations stay floating point, so the only error source is the ~1/127
per-channel weight grid.  Embeddings and the tied LM head stay float.
``torch.round`` and ``jnp.round`` both round half to even, so the int8
weights and scales are bit-equal to the reference's.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.layer.common import Linear
from ..nn.layer_base import Layer
from ..ops.int8_matmul import dequant_matmul

__all__ = ["quantize_weight_int8", "Int8WeightOnlyLinear",
           "quantize_for_serving"]


def quantize_weight_int8(w, per_channel: bool = True, axis: int = 1):
    """Symmetric abs-max int8 quantization: ``(w_int8, scale)`` with
    ``w ~= w_int8 * scale``; scale is absmax/127, per channel over
    ``axis`` (a (in, out) Linear weight with axis=1 -> scale (1, out)) or
    one scalar shaped (1,) * ndim."""
    w = torch.as_tensor(w)
    if per_channel:
        dims = tuple(i for i in range(w.dim()) if i != axis)
        absmax = w.abs().amax(dim=dims, keepdim=True)
    else:
        absmax = w.abs().amax().reshape((1,) * w.dim())
    absmax = absmax.clamp_min(1e-8)
    scale = (absmax / 127.0).to(torch.float32)
    w_int8 = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return w_int8, scale


class Int8WeightOnlyLinear(Layer):
    """Serving Linear with an int8 weight buffer and per-output-channel
    f32 scale (buffers ``w_int8``, ``w_scale``; the float ``bias`` stays a
    parameter), state names as the reference's."""

    def __init__(self, layer: Linear, per_channel: bool = True):
        super().__init__()
        self.in_features = layer.in_features
        self.out_features = layer.out_features
        with torch.no_grad():
            w_int8, scale = quantize_weight_int8(layer.weight.detach(),
                                                 per_channel=per_channel,
                                                 axis=1)
        self.register_buffer("w_int8", w_int8.contiguous())
        self.register_buffer("w_scale", scale.reshape(1, -1).contiguous())
        self.bias = layer.bias

    def forward(self, x):
        y = dequant_matmul(x, self.w_int8, self.w_scale)
        return y if self.bias is None else y + self.bias

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, int8 weight-only")


def _replace_linears(module: nn.Module, per_channel: bool):
    for name, child in module.named_children():
        if isinstance(child, Linear):
            setattr(module, name, Int8WeightOnlyLinear(child, per_channel))
        else:
            _replace_linears(child, per_channel)


def quantize_for_serving(model: nn.Module, quantize: str = "int8",
                         per_channel: bool = True) -> nn.Module:
    """Post-training int8 weight-only conversion for serving / generate:
    every Linear becomes an Int8WeightOnlyLinear, in place.  Returns the
    same model object."""
    if quantize != "int8":
        raise ValueError(
            f"quantize_for_serving supports 'int8', got {quantize!r}")
    _replace_linears(model, per_channel)
    return model
