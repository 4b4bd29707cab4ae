"""LayerNorm and BatchNorm2D (counterparts of paddle_tpu/nn/layer/norm.py).

Both take the reference's parameters in its order (``weight_attr`` /
``bias_attr`` honoured), then the port's ``device`` as a keyword.
``BatchNorm2D`` keeps the reference's state names (``weight``, ``bias``
and the buffers ``_mean`` / ``_variance``), ``momentum=0.9`` (the weight
of the old running value) and ``epsilon=1e-5``.  ``forward`` with an
activation, a residual or a pool spec, and ``forward_fused``, run the
fused kernels of ``ops.fused_bn_act`` through ``F.fused_bn_act``;
``dual_bn_act`` fuses a downsample shortcut's BatchNorm into the block's
last one, gated by ``supports_dual_bn``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer

__all__ = ["LayerNorm", "BatchNorm2D", "dual_bn_act", "supports_dual_bn"]


class LayerNorm(Layer):
    """The reference's ``LayerNorm(normalized_shape, epsilon, weight_attr,
    bias_attr)``: ``normalized_shape`` an int or a list of trailing dims;
    the weight (ones) and bias (zeros) are flat, of their product's
    length, as the reference keeps them; ``False`` drops either."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None):
        super().__init__()
        self.normalized_shape = (
            (int(normalized_shape),) if isinstance(normalized_shape, int)
            else tuple(int(d) for d in normalized_shape))
        self.epsilon = float(epsilon)
        n = int(np.prod(self.normalized_shape))
        self.weight = self.create_parameter(
            (n,), attr=weight_attr, default_initializer=I.Constant(1.0),
            device=device)
        self.bias = self.create_parameter((n,), attr=bias_attr,
                                          is_bias=True, device=device)

    def forward(self, x):
        # population variance, as the reference's layer_norm
        ns = self.normalized_shape
        w = None if self.weight is None else self.weight.view(ns)
        b = None if self.bias is None else self.bias.view(ns)
        return F.layer_norm(x, ns, w, b, self.epsilon)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None):
        super().__init__()
        self.num_features = num_features
        self.momentum, self.epsilon = momentum, epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            (num_features,), attr=weight_attr,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = self.create_parameter((num_features,), attr=bias_attr,
                                          is_bias=True, device=device)
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=device))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=device))

    def forward(self, x, activation=None, residual=None, pool=None):
        if activation is None and residual is None and pool is None:
            return F.batch_norm(x, self._mean, self._variance, self.weight,
                                self.bias, training=self.training,
                                momentum=self.momentum, epsilon=self.epsilon,
                                data_format=self.data_format,
                                use_global_stats=self.use_global_stats)
        return F.fused_bn_act(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self.momentum,
            epsilon=self.epsilon, data_format=self.data_format,
            activation=activation, residual=residual,
            use_global_stats=self.use_global_stats, pool=pool)

    def forward_fused(self, x, activation=None, residual=None, pool=None):
        """BN + residual-add + activation (+ a 2D pool epilogue, ``pool=
        (kind, kernel, stride, padding)``) as one fused op, through
        ``__call__`` so that hooks still see the layer run."""
        return self(x, activation=activation, residual=residual, pool=pool)

    def extra_repr(self):
        return f"num_features={self.num_features}"


class BatchNorm2D(_BatchNormBase):
    pass


def _dual_configs_agree(a, b) -> bool:
    return (a.epsilon == b.epsilon and a.momentum == b.momentum
            and a.data_format == b.data_format
            and a.use_global_stats == b.use_global_stats)


def supports_dual_bn(*norms) -> bool:
    """True when every layer is a stock BatchNorm (the default forward, no
    hooks: the fused path bypasses ``__call__``) and, for several, their
    training mode and epsilon / momentum / data_format /
    use_global_stats agree (one fused op applies one config)."""
    ok = all(isinstance(n, _BatchNormBase)
             and type(n).forward is _BatchNormBase.forward
             and not n._forward_pre_hooks and not n._forward_hooks
             for n in norms)
    if not ok:
        return False
    return all(n.training == norms[0].training
               and _dual_configs_agree(norms[0], n) for n in norms[1:])


def dual_bn_act(bn_x, x, bn_r, res, activation=None):
    """act(bn_x(x) + bn_r(res)) as one fused op, both running statistics
    updated."""
    if bn_x.training != bn_r.training:
        raise ValueError("dual_bn_act: the two BatchNorm layers disagree "
                         "on training mode")
    if not _dual_configs_agree(bn_x, bn_r):
        raise ValueError(
            "dual_bn_act: the two BatchNorm layers disagree on "
            "epsilon/momentum/data_format/use_global_stats — the fused op "
            "applies one config to both; use the composite instead")
    return F.fused_dual_bn_act(
        x, bn_x._mean, bn_x._variance, bn_x.weight, bn_x.bias,
        res, bn_r._mean, bn_r._variance, bn_r.weight, bn_r.bias,
        training=bn_x.training, momentum=bn_x.momentum,
        epsilon=bn_x.epsilon, data_format=bn_x.data_format,
        activation=activation, use_global_stats=bn_x.use_global_stats)
