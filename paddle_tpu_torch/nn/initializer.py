"""Parameter initializers (counterpart of paddle_tpu/nn/initializer.py).

Each initializer is called with a shape and returns a tensor of that
shape: ``init(shape, dtype=torch.float32, device=None, generator=None)``.
Random ones draw in float32 and cast, through ``generator`` when one is
given, else through the current generator of ``core.rng`` on ``device``
(seeded from ``paddle_tpu_torch.seed``), never torch's global one.  Fans
follow the reference: a 2-D weight is Paddle's ``Linear`` (in, out), a
weight of rank 3 or more a conv's (out, in, *kernel).
``set_global_initializer`` overrides the defaults for every parameter
made without an initializer of its own (``Layer.create_parameter``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import rng as _rng

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal",
           "Uniform", "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "Assign", "Dirac", "Orthogonal", "Bilinear",
           "set_global_initializer", "default_weight_init",
           "default_bias_init", "calculate_gain"]


def _generator(device, generator):
    if generator is not None:
        return generator
    return _rng.current_generator(torch.device(device or "cpu"))


class Initializer:
    def _build(self, shape, dtype, device, generator):
        raise NotImplementedError

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        return self._build(tuple(int(s) for s in shape), dtype, device,
                           generator)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _build(self, shape, dtype, device, generator):
        return torch.full(shape, self.value, dtype=dtype, device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _build(self, shape, dtype, device, generator):
        t = torch.empty(shape, device=device)
        t.normal_(self.mean, self.std, generator=_generator(device,
                                                            generator))
        return t.to(dtype)


class TruncatedNormal(Initializer):
    """mean + std * z, z standard normal truncated to [-2, 2] (the
    reference's bounds), drawn by inverting the normal CDF."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _build(self, shape, dtype, device, generator):
        lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0)))
                  for b in (-2.0, 2.0))
        u = torch.empty(shape, device=device)
        u.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0,
                   generator=_generator(device, generator))
        z = torch.erfinv(u) * math.sqrt(2.0)
        return (self.mean + self.std * z.clamp_(-2.0, 2.0)).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _build(self, shape, dtype, device, generator):
        return _uniform(shape, self.low, self.high, dtype, device, generator)


def _uniform(shape, low, high, dtype, device, generator):
    t = torch.empty(shape, device=device)
    t.uniform_(low, high, generator=_generator(device, generator))
    return t.to(dtype)


def _fan_in_out(shape):
    """(fan_in, fan_out) as the reference counts them: (in, out) for a
    2-D Linear weight, (in * k, out * k) for a conv weight (out, in, *k)
    with k its receptive field."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class _Xavier(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fans(self, shape):
        fi, fo = _fan_in_out(shape)
        return (self.fan_in if self.fan_in is not None else fi,
                self.fan_out if self.fan_out is not None else fo)


class XavierNormal(_Xavier):
    def _build(self, shape, dtype, device, generator):
        fi, fo = self._fans(shape)
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)._build(shape, dtype, device, generator)


class XavierUniform(_Xavier):
    def _build(self, shape, dtype, device, generator):
        fi, fo = self._fans(shape)
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, -limit, limit, dtype, device, generator)


class _Kaiming(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def _gain_fan(self, shape):
        fi = self.fan_in if self.fan_in is not None else _fan_in_out(shape)[0]
        gain = (math.sqrt(2.0 / (1 + self.negative_slope ** 2))
                if self.nonlinearity in ("relu", "leaky_relu") else 1.0)
        return gain, fi


class KaimingNormal(_Kaiming):
    def _build(self, shape, dtype, device, generator):
        gain, fi = self._gain_fan(shape)
        return Normal(0.0, gain / math.sqrt(fi))._build(shape, dtype, device,
                                                        generator)


class KaimingUniform(_Kaiming):
    def _build(self, shape, dtype, device, generator):
        gain, fi = self._gain_fan(shape)
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(shape, -limit, limit, dtype, device, generator)


class Assign(Initializer):
    """The given values (a tensor, an array or a nested list), reshaped."""

    def __init__(self, value):
        self.value = value

    def _build(self, shape, dtype, device, generator):
        v = self.value
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return torch.as_tensor(np.asarray(v)).to(dtype).reshape(shape).to(
            device)


class Dirac(Initializer):
    """Identity conv kernels: out channel g * per + i passes in channel i
    through the kernel's centre, per group."""

    def __init__(self, groups=1):
        self.groups = groups

    def _build(self, shape, dtype, device, generator):
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        centre = tuple(s // 2 for s in shape[2:])
        per = oc // self.groups
        for g in range(self.groups):
            for i in range(min(per, ic)):
                out[(g * per + i, i) + centre] = 1.0
        return torch.from_numpy(out).to(dtype=dtype, device=device)


class Orthogonal(Initializer):
    """A (semi-)orthogonal matrix over (shape[0], prod(shape[1:])), from
    the QR factors of a normal draw, signs fixed by R's diagonal."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def _build(self, shape, dtype, device, generator):
        rows = shape[0]
        cols = int(np.prod(shape)) // rows
        flat = Normal()._build((max(rows, cols), min(rows, cols)),
                               torch.float32, device, generator)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols].reshape(shape)).to(dtype)


class Bilinear(Initializer):
    """Bilinear-upsample kernels for transposed convs: weight[..., y, x] =
    (1 - |x / f - c|)(1 - |y / f - c|) with f = ceil(K / 2) and
    c = (2f - 1 - f % 2) / (2f), the same for every channel pair."""

    def _build(self, shape, dtype, device, generator):
        def axis_weights(size):
            factor = float(np.ceil(size / 2.0))
            centre = (2 * factor - 1 - factor % 2) / (2.0 * factor)
            idx = np.arange(size, dtype=np.float64)
            return 1 - np.abs(idx / factor - centre)
        kernel = np.outer(axis_weights(shape[-2]), axis_weights(shape[-1]))
        out = np.ascontiguousarray(np.broadcast_to(kernel, shape))
        return torch.from_numpy(out).to(dtype=dtype, device=device)


# the framework's defaults (XavierNormal weights, zero biases), which
# set_global_initializer overrides for every parameter made without an
# initializer of its own
_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    """Default weight (and bias) initializer of every parameter made from
    now on without an initializer of its own; None resets."""
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def default_weight_init():
    if _global_weight_init is not None:
        return _global_weight_init
    return XavierNormal()


def default_bias_init():
    if _global_bias_init is not None:
        return _global_bias_init
    return Constant(0.0)


def calculate_gain(nonlinearity, param=None):
    if nonlinearity in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4.0
    raise ValueError(f"unknown nonlinearity {nonlinearity}")
