"""Quantization (port of paddle_tpu/quantization/__init__.py): QAT
fake-quant training, post-training quantization and int8 weight-only
serving.

- **QAT.** ``fake_quantize_dequantize_abs_max`` (per tensor) and its
  channel-wise form quantize-dequantize with a straight-through gradient
  (``x + (qdq(x) - x).detach()``).  ``ImperativeQuantAware(...).quantize``
  swaps every ``Linear`` / ``Conv2D`` in place for ``QuantedLinear`` /
  ``QuantedConv2D``, which share the wrapped layer's parameters
  (``_layer.weight``), fake-quantize the weight per output channel (or
  per tensor) and the input against a moving-average abs-max
  ``act_scale`` buffer, updated in training through
  ``core.buffer_updates`` (in place eagerly, logged inside ``TrainStep``).
  A never-observed scale of 0 is the identity.
- **PTQ.** ``PostTrainingQuantization.prepare`` hooks abs-max observers
  on the inputs of every Linear / Conv2D; ``convert`` swaps them for
  ``Int8Linear`` / ``Int8Conv2D``: int8 weight and per-output-channel f32
  scale buffers, dequantized before ``F.linear`` / ``F.conv2d`` (with the
  wrapped layer's stride, padding, dilation and groups), as the reference
  does: not through K4.  The observed input scale is a static attribute
  (``_act_scale``), not state.
- **Serving** (``:276-355``): ``quantize_for_serving`` swaps every
  ``Linear`` for an ``Int8WeightOnlyLinear``: int8 weight + per-output-
  channel f32 scale, dequantized at use by the dequant-matmul kernel
  (``ops.int8_matmul``).  Activations stay floating point.  Embeddings and
  the tied LM head stay float.

State names equal the reference's, so a QAT or converted model's state
crosses the frameworks by name.  ``torch.round`` and ``jnp.round`` both
round half to even, so int8 weights and scales are bit-equal to the
reference's.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core import buffer_updates as _bufup
from ..nn import functional as F
from ..nn.layer.common import Linear
from ..nn.layer.conv import Conv2D
from ..nn.layer_base import Layer
from ..ops.int8_matmul import dequant_matmul

__all__ = [
    "fake_quantize_dequantize_abs_max",
    "fake_quantize_dequantize_channel_wise_abs_max",
    "QuantedLinear", "QuantedConv2D",
    "ImperativeQuantAware", "PostTrainingQuantization",
    "Int8Linear", "Int8Conv2D",
    "quantize_weight_int8", "Int8WeightOnlyLinear", "quantize_for_serving",
]


def _qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def _qdq(x, scale, qmax):
    """Quantize-dequantize x against a (broadcastable) scale tensor.  The
    divisions are tensor by tensor: on the card a division by a host
    scalar is a multiplication by its reciprocal, which can round a value
    at a quantization boundary to the other side than the reference's
    (and the CPU's) true division."""
    s = scale / torch.full_like(scale, qmax)
    return torch.clamp(torch.round(x / s), -qmax, qmax) * s


def fake_quantize_dequantize_abs_max(x, bits=8):
    """Per-tensor abs-max fake quant with a straight-through gradient."""
    scale = x.detach().abs().amax().clamp_min(1e-8)
    return x + (_qdq(x, scale, _qmax(bits)) - x).detach()


def fake_quantize_dequantize_channel_wise_abs_max(w, quant_axis=0, bits=8):
    """Per-channel (along ``quant_axis``) abs-max fake quant with a
    straight-through gradient."""
    dims = tuple(i for i in range(w.dim()) if i != quant_axis)
    scale = w.detach().abs().amax(dim=dims, keepdim=True).clamp_min(1e-8)
    return w + (_qdq(w, scale, _qmax(bits)) - w).detach()


def _qdq_with_scale(x, scale_value, bits):
    """Fake quant against an external scalar scale (the moving-average
    path).  A never-observed scale (0: eval before any training step) is
    the identity: the 1e-8 floor would crush every activation."""
    raw = torch.as_tensor(scale_value, dtype=torch.float32,
                          device=x.device).detach()
    q = _qdq(x, raw.clamp_min(1e-8), _qmax(bits))
    return x + (torch.where(raw > 0, q, x) - x).detach()


class _QuantedBase(Layer):
    """Channel-wise (or per-tensor) weight fake quant and a moving-average
    abs-max activation observer (the ``act_scale`` buffer)."""

    def _init_quant(self, weight_bits, activation_bits, moving_rate,
                    weight_quantize_type, device):
        self._weight_bits = weight_bits
        self._activation_bits = activation_bits
        self._moving_rate = moving_rate
        self._wq_type = weight_quantize_type
        self.register_buffer("act_scale", torch.zeros(
            (), dtype=torch.float32, device=device))

    def _quant_weight(self, w, channel_axis):
        if self._wq_type == "abs_max":
            return fake_quantize_dequantize_abs_max(w, self._weight_bits)
        return fake_quantize_dequantize_channel_wise_abs_max(
            w, quant_axis=channel_axis, bits=self._weight_bits)

    def _observe_and_quant_act(self, x):
        """In training, fold max|x| into the moving average (the first
        observation taken as it is); then fake-quantize x against it."""
        if self.training:
            cur = x.detach().abs().amax().float()
            r = self._moving_rate
            state = _bufup.current(self.act_scale)
            _bufup.apply(self.act_scale, torch.where(
                state > 0, state * r + cur * (1 - r), cur))
        return _qdq_with_scale(x, _bufup.current(self.act_scale),
                               self._activation_bits)


class QuantedLinear(_QuantedBase):
    """QAT wrapper of a Linear, sharing its parameters."""

    def __init__(self, layer: Linear, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, weight_quantize_type="channel_wise_abs_max"):
        super().__init__()
        self._layer = layer
        self._init_quant(weight_bits, activation_bits, moving_rate,
                         weight_quantize_type, layer.weight.device)

    def forward(self, x):
        x = self._observe_and_quant_act(x)
        # a Linear weight is (in, out): the output channel is axis 1
        w = self._quant_weight(self._layer.weight, channel_axis=1)
        return F.linear(x, w, self._layer.bias)


class QuantedConv2D(_QuantedBase):
    """QAT wrapper of a Conv2D, sharing its parameters."""

    def __init__(self, layer: Conv2D, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, weight_quantize_type="channel_wise_abs_max"):
        super().__init__()
        self._layer = layer
        self._init_quant(weight_bits, activation_bits, moving_rate,
                         weight_quantize_type, layer.weight.device)

    def forward(self, x):
        x = self._observe_and_quant_act(x)
        lay = self._layer
        w = self._quant_weight(lay.weight, channel_axis=0)
        return F.conv2d(x, w, lay.bias, lay.stride, lay.padding,
                        lay.dilation, lay.groups, lay.data_format)


def _replace_layers(model: nn.Module, factory):
    """Swap each sublayer for ``factory(child)`` where that is not None,
    else walk into it."""
    for name, child in list(model.named_children()):
        repl = factory(child)
        if repl is not None:
            setattr(model, name, repl)
        else:
            _replace_layers(child, factory)
    return model


class ImperativeQuantAware:
    """Dygraph QAT: ``quantize(model)`` swaps every Linear / Conv2D for
    its fake-quant wrapper in place; train as usual;
    ``save_quantized_model`` exports through ``jit.save``."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 weight_quantize_type="channel_wise_abs_max",
                 activation_quantize_type="moving_average_abs_max",
                 moving_rate=0.9, quantizable_layer_type=None):
        if weight_quantize_type not in ("abs_max", "channel_wise_abs_max"):
            raise ValueError(weight_quantize_type)
        if activation_quantize_type != "moving_average_abs_max":
            raise ValueError(activation_quantize_type)
        self._wbits = weight_bits
        self._abits = activation_bits
        self._rate = moving_rate
        self._wq_type = weight_quantize_type
        self._types = tuple(quantizable_layer_type or (Linear, Conv2D))

    def quantize(self, model: Layer) -> Layer:
        def factory(child):
            args = (self._wbits, self._abits, self._rate, self._wq_type)
            if isinstance(child, Linear) and Linear in self._types:
                return QuantedLinear(child, *args)
            if isinstance(child, Conv2D) and Conv2D in self._types:
                return QuantedConv2D(child, *args)
            return None
        return _replace_layers(model, factory)

    def save_quantized_model(self, layer, path, input_spec=None):
        from .. import jit
        layer.eval()
        jit.save(layer, path, input_spec=input_spec)


class Int8Linear(Layer):
    """Converted Linear: int8 weight (``w_int8``) and per-output-channel
    scale (``w_scale``, (1, out)), dequantized before ``F.linear``."""

    def __init__(self, layer: Linear, bits=8, act_scale=None, act_bits=8):
        super().__init__()
        if bits > 8:
            raise ValueError(
                f"int8 storage holds at most 8-bit weights, got bits={bits}")
        qmax = _qmax(bits)
        with torch.no_grad():
            w = layer.weight.detach()
            scale = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-8)
            self.register_buffer("w_int8", torch.clamp(
                torch.round(w / scale * qmax), -qmax, qmax).to(torch.int8))
            self.register_buffer("w_scale", (
                scale / torch.full_like(scale, qmax)).float())
        self.bias = layer.bias
        self._act_scale = act_scale
        self._act_bits = act_bits

    def forward(self, x):
        if self._act_scale is not None:   # static activation quant
            x = _qdq_with_scale(x, self._act_scale, self._act_bits)
        return F.linear(x, self.w_int8.float() * self.w_scale, self.bias)


class Int8Conv2D(Layer):
    """Converted Conv2D: int8 weight and per-output-channel scale
    ((out, 1, 1, 1)), dequantized before ``F.conv2d`` with the wrapped
    layer's stride, padding, dilation, groups and data format."""

    def __init__(self, layer: Conv2D, bits=8, act_scale=None, act_bits=8):
        super().__init__()
        if bits > 8:
            raise ValueError(
                f"int8 storage holds at most 8-bit weights, got bits={bits}")
        qmax = _qmax(bits)
        with torch.no_grad():
            w = layer.weight.detach()
            scale = w.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-8)
            self.register_buffer("w_int8", torch.clamp(
                torch.round(w / scale * qmax), -qmax, qmax).to(torch.int8))
            self.register_buffer("w_scale", (
                scale / torch.full_like(scale, qmax)).float())
        self.bias = layer.bias
        self._cfg = (layer.stride, layer.padding, layer.dilation,
                     layer.groups, layer.data_format)
        self._act_scale = act_scale
        self._act_bits = act_bits

    def forward(self, x):
        if self._act_scale is not None:
            x = _qdq_with_scale(x, self._act_scale, self._act_bits)
        stride, padding, dilation, groups, fmt = self._cfg
        return F.conv2d(x, self.w_int8.float() * self.w_scale, self.bias,
                        stride, padding, dilation, groups, fmt)


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


def quantize_for_serving(model: nn.Module, quantize: str = "int8",
                         per_channel: bool = True) -> nn.Module:
    """Post-training int8 weight-only conversion for serving / generate:
    every Linear becomes an Int8WeightOnlyLinear, in place.  Returns the
    same model object."""
    if quantize != "int8":
        raise ValueError(
            f"quantize_for_serving supports 'int8', got {quantize!r}")
    return _replace_layers(model, lambda child: Int8WeightOnlyLinear(
        child, per_channel) if isinstance(child, Linear) else None)


class PostTrainingQuantization:
    """PTQ: ``prepare(model)`` hooks abs-max observers on the inputs of
    every Linear / Conv2D; run calibration batches (eval mode); then
    ``convert(model)`` swaps them for Int8Linear / Int8Conv2D with the
    observed input scales (when ``quantize_activations``)."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 quantize_activations=True):
        self._wbits = weight_bits
        self._abits = activation_bits
        self._quant_act = quantize_activations
        self._observed = {}
        self._hooks = []

    def prepare(self, model: Layer) -> Layer:
        self._observed.clear()

        def make_hook(key):
            def hook(layer, inputs):
                if inputs and isinstance(inputs[0], torch.Tensor):
                    cur = float(inputs[0].detach().abs().amax())
                    self._observed[key] = max(self._observed.get(key, 0.0),
                                              cur)
            return hook

        for _, sub in model.named_sublayers():
            if isinstance(sub, (Linear, Conv2D)):
                self._hooks.append(
                    sub.register_forward_pre_hook(make_hook(id(sub))))
        return model

    def convert(self, model: Layer) -> Layer:
        for h in self._hooks:
            h.remove()
        self._hooks = []

        def factory(child):
            act = None
            if self._quant_act and id(child) in self._observed:
                act = float(self._observed[id(child)])
            if isinstance(child, Linear):
                return Int8Linear(child, self._wbits, act, self._abits)
            if isinstance(child, Conv2D):
                return Int8Conv2D(child, self._wbits, act, self._abits)
            return None
        return _replace_layers(model, factory)
