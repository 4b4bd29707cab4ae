"""Activation layers (counterpart of paddle_tpu/nn/layer/activation.py).

Each layer takes the reference's parameters and calls the functional of
``nn.functional.activation``.  ``PReLU`` holds its slopes as ``weight``,
of shape (num_parameters,), as the reference does; ``RReLU`` draws its
slopes only in training.
"""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer

__all__ = ["ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "LeakyReLU", "ELU",
           "CELU", "SELU", "Silu", "Swish", "Mish", "Hardswish",
           "Hardsigmoid", "Hardtanh", "Hardshrink", "Softshrink", "Softplus",
           "Softsign", "Tanhshrink", "ThresholdedReLU", "LogSigmoid",
           "Softmax", "LogSoftmax", "Maxout", "PReLU", "RReLU", "GLU"]


def _plain(cls_name, fname):
    """A layer without parameters of its own that calls ``F.<fname>``."""
    return type(cls_name, (Layer,), {
        "forward": lambda self, x: getattr(F, fname)(x),
        "__doc__": f"``F.{fname}`` as a layer.",
        "__module__": __name__})


ReLU = _plain("ReLU", "relu")
ReLU6 = _plain("ReLU6", "relu6")
Sigmoid = _plain("Sigmoid", "sigmoid")
Tanh = _plain("Tanh", "tanh")
Silu = _plain("Silu", "silu")
Swish = _plain("Swish", "swish")
Mish = _plain("Mish", "mish")
Hardswish = _plain("Hardswish", "hardswish")
Hardsigmoid = _plain("Hardsigmoid", "hardsigmoid")
Softsign = _plain("Softsign", "softsign")
Tanhshrink = _plain("Tanhshrink", "tanhshrink")
LogSigmoid = _plain("LogSigmoid", "log_sigmoid")


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.celu(x, self.alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self.scale, self.alpha = scale, alpha

    def forward(self, x):
        return F.selu(x, self.scale, self.alpha)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):  # noqa: A002
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return F.hardtanh(x, self.min, self.max)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self.threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self.threshold)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self.beta, self.threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self.beta, self.threshold)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, value=0.0, name=None):
        super().__init__()
        self.threshold, self.value = threshold, value

    def forward(self, x):
        return F.thresholded_relu(x, self.threshold, self.value)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, self.axis)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class PReLU(Layer):
    """Slopes ``weight`` of shape (num_parameters,), Constant(init) unless
    ``weight_attr`` names an initializer."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            (num_parameters,), attr=weight_attr,
            default_initializer=I.Constant(init), device=device)

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, self.training)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.glu(x, self.axis)

