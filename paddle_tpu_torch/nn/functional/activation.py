"""Activations (counterpart of paddle_tpu/nn/functional/activation.py).

Every function takes the reference's parameters and goes through
``amp_cast`` under the reference's op name (``softmax`` and
``log_softmax`` are black-listed, f32 under O1; the rest are on neither
list and cast under O2 only).  ``rrelu`` and ``gumbel_softmax`` draw from
the current explicit generator of ``core.rng``, never torch's global one.
``softmax_`` / ``tanh_`` / ``relu_`` write the result into ``x`` (outside
autograd, as the reference swaps the tensor's data) and return it.
"""
from __future__ import annotations

import math

import torch

from ...amp import amp_cast
from ...core import rng

__all__ = ["gelu", "relu", "relu6", "softmax", "tanh", "sigmoid", "silu",
           "swish", "mish", "softsign", "tanhshrink", "hardswish",
           "hardsigmoid", "log_sigmoid", "leaky_relu", "elu", "selu",
           "celu", "prelu", "rrelu", "hardtanh", "hardshrink", "softshrink",
           "softplus", "thresholded_relu", "log_softmax", "gumbel_softmax",
           "maxout", "glu", "softmax_", "tanh_", "relu_"]


def _un(op_name, fn, doc):
    def op(x, name=None):
        (x,) = amp_cast(op_name, x)
        return fn(x)
    op.__name__ = op.__qualname__ = op_name
    op.__doc__ = doc
    return op


sigmoid = _un("sigmoid", torch.sigmoid, "1 / (1 + exp(-x)).")
silu = _un("silu", torch.nn.functional.silu, "x * sigmoid(x).")
swish = _un("swish", torch.nn.functional.silu, "x * sigmoid(x) (silu).")
mish = _un("mish", lambda x: x * torch.tanh(torch.nn.functional.softplus(x)),
           "x * tanh(softplus(x)).")
softsign = _un("softsign", lambda x: x / (1 + x.abs()), "x / (1 + |x|).")
tanhshrink = _un("tanhshrink", lambda x: x - torch.tanh(x), "x - tanh(x).")
hardswish = _un("hardswish",
                lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0,
                "x * clip(x + 3, 0, 6) / 6.")
hardsigmoid = _un("hardsigmoid",
                  lambda x: torch.clamp(x / 6.0 + 0.5, 0.0, 1.0),
                  "clip(x / 6 + 0.5, 0, 1).")
log_sigmoid = _un("log_sigmoid", torch.nn.functional.logsigmoid,
                  "log(sigmoid(x)), computed as -softplus(-x).")


def gelu(x, approximate: bool = False, name=None):
    """GELU; exact erf form by default, as the reference's
    ``jax.nn.gelu(x, approximate=False)``.  The tanh form is written out
    as jax writes it, x * 0.5 * (1 + tanh(sqrt(2 / pi) * (x + 0.044715
    x^3))), which keeps its far tail within f32 rounding of the
    reference's."""
    if not approximate:
        return torch.nn.functional.gelu(x)
    c = math.sqrt(2.0 / math.pi)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))


def softmax(x, axis: int = -1, dtype=None, name=None):
    """Softmax along ``axis``; AMP black-listed (f32 under O1).  With
    ``dtype`` (a name or a torch dtype) ``x`` is cast to it first, as the
    reference casts before its softmax."""
    (x,) = amp_cast("softmax", x)
    if dtype is not None:
        x = x.to(_torch_dtype(dtype))
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis: int = -1, dtype=None, name=None):
    """Log-softmax along ``axis``, cast to ``dtype`` first when given;
    AMP black-listed."""
    (x,) = amp_cast("log_softmax", x)
    if dtype is not None:
        x = x.to(_torch_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("paddle.", "").replace("torch.", "")
    got = getattr(torch, name, None)
    if not isinstance(got, torch.dtype):
        raise ValueError(f"softmax: unknown dtype {dtype!r}")
    return got


def relu(x, name=None):
    (x,) = amp_cast("relu", x)
    return torch.relu(x)


def relu6(x, name=None):
    (x,) = amp_cast("relu6", x)
    return torch.clamp(x, 0.0, 6.0)


def tanh(x, name=None):
    """On neither AMP list: cast under O2 only, as the reference's."""
    (x,) = amp_cast("tanh", x)
    return torch.tanh(x)


def leaky_relu(x, negative_slope=0.01, name=None):
    (x,) = amp_cast("leaky_relu", x)
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0, name=None):
    (x,) = amp_cast("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(torch.clamp_max(x, 0)))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    (x,) = amp_cast("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    (x,) = amp_cast("celu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


def prelu(x, weight, data_format="NCHW", name=None):
    """max(x, 0) + weight * min(x, 0): one weight for all, or one per
    channel (axis 1 for NC* layouts, the last axis otherwise)."""
    x, weight = amp_cast("prelu", x, weight)
    if weight.numel() == 1:
        return torch.where(x > 0, x, weight.reshape(()) * x)
    shape = [1] * x.dim()
    shape[1 if data_format.startswith("NC") else x.dim() - 1] = \
        weight.numel()
    return torch.where(x > 0, x, weight.reshape(shape) * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None):
    """Randomized leaky ReLU: in training each negative element's slope is
    drawn uniform in [lower, upper) from ``core.rng``'s current generator;
    out of training the slope is (lower + upper) / 2."""
    (x,) = amp_cast("rrelu", x)
    if training:
        a = torch.empty(x.shape, dtype=x.dtype, device=x.device).uniform_(
            lower, upper, generator=rng.current_generator(x.device))
    else:
        a = torch.tensor((lower + upper) / 2.0, dtype=x.dtype,
                         device=x.device)
    return torch.where(x >= 0, x, a * x)


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    (x,) = amp_cast("hardtanh", x)
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    (x,) = amp_cast("hardshrink", x)
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    (x,) = amp_cast("softshrink", x)
    return torch.sign(x) * torch.clamp_min(x.abs() - threshold, 0.0)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """log(1 + exp(beta x)) / beta, and x itself where beta x > threshold."""
    (x,) = amp_cast("softplus", x)
    bx = beta * x
    return torch.where(bx > threshold, x,
                       torch.nn.functional.softplus(bx) / beta)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    (x,) = amp_cast("thresholded_relu", x)
    return torch.where(x > threshold, x, torch.full_like(x, value))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) with Gumbel noise g drawn from
    ``core.rng``'s current generator; ``hard`` returns the one-hot of the
    argmax in the forward and the soft gradient (straight-through)."""
    (x,) = amp_cast("gumbel_softmax", x)
    tiny = torch.finfo(x.dtype).tiny
    u = torch.empty(x.shape, dtype=x.dtype, device=x.device).uniform_(
        tiny, 1.0, generator=rng.current_generator(x.device))
    y = torch.softmax((x - torch.log(-torch.log(u))) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        onehot = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = (onehot - y).detach() + y
    return y


def maxout(x, groups, axis=1, name=None):
    """The max over each run of ``groups`` consecutive channels of
    ``axis``."""
    (x,) = amp_cast("maxout", x)
    axis = axis % x.dim()
    c = x.shape[axis]
    shape = x.shape[:axis] + (c // groups, groups) + x.shape[axis + 1:]
    return torch.amax(x.reshape(shape), dim=axis + 1)


def glu(x, axis=-1, name=None):
    """a * sigmoid(b), a and b the halves of ``x`` along ``axis``."""
    (x,) = amp_cast("glu", x)
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def _into(x, out):
    with torch.no_grad():
        x.copy_(out)
    return x


def softmax_(x, axis=-1, dtype=None, name=None):
    return _into(x, softmax(x, axis, dtype))


def tanh_(x, name=None):
    return _into(x, tanh(x))


def relu_(x, name=None):
    return _into(x, relu(x))
