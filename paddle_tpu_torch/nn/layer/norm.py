"""Norm layers (counterparts of paddle_tpu/nn/layer/norm.py): LayerNorm,
the BatchNorms (``BatchNorm``, 1D / 2D / 3D, ``SyncBatchNorm``), RMSNorm,
GroupNorm, InstanceNorm1D / 2D / 3D, LocalResponseNorm and SpectralNorm.

Each takes the reference's parameters in its order (``weight_attr`` /
``bias_attr`` honoured), then the port's ``device`` as a keyword.  The
BatchNorms keep the reference's state names (``weight``, ``bias`` and the
buffers ``_mean`` / ``_variance``), ``momentum=0.9`` (the weight of the
old running value) and ``epsilon=1e-5``; ``SpectralNorm`` its
``weight_u`` / ``weight_v`` (parameters that take no gradient).
``forward`` with an activation, a residual or a pool spec, and
``forward_fused``, run the fused kernels of ``ops.fused_bn_act`` through
``F.fused_bn_act``, or the composite tail for an activation the kernels
do not take; ``forward_fused`` goes through ``__call__`` (hooks see the
layer run) unless a subclass has a forward of its own, which it then
bypasses, as the reference's does.  ``dual_bn_act`` fuses a downsample
shortcut's BatchNorm into the block's last one, gated by
``supports_dual_bn``.

``SyncBatchNorm`` takes its batch statistics over the ranks of the data
parallel group (the mesh's ``dp`` group when a mesh is set, else every
rank of the started world), forward and backward, fused path and plain
(``ops.fused_bn_act.stats_group``); with no such group of more than one
rank it is ``BatchNorm2D``, as the reference's eager path is.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import functional as F
from .. import initializer as I
from ..functional.norm import _pool_composite
from ..layer_base import Layer

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "SyncBatchNorm", "RMSNorm", "GroupNorm",
           "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LocalResponseNorm", "SpectralNorm", "dual_bn_act",
           "supports_dual_bn"]


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
    _fused_forward = False   # a subclass forward that takes the fused args
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
        return self._fused_impl(x, activation, residual, pool)

    def _fused_impl(self, x, activation, residual, pool=None):
        from ...ops.fused_bn_act import _ACTS, _pool_norm
        if activation not in _ACTS:
            out = F.bn_act_composite(self.forward(x), activation, residual)
            if pool is not None:
                out = _pool_composite(out, _pool_norm(pool),
                                      self.data_format)
            return out
        return F.fused_bn_act(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self.momentum,
            epsilon=self.epsilon, data_format=self.data_format,
            activation=activation, residual=residual,
            use_global_stats=self.use_global_stats, pool=pool)

    def forward_fused(self, x, activation=None, residual=None, pool=None):
        """BN + residual-add + activation (+ a 2D pool epilogue, ``pool=
        (kind, kernel, stride, padding)``) as one fused op, through
        ``__call__`` so that hooks still see the layer run; a subclass with
        its own forward signature takes the functional path directly."""
        if type(self).forward is _BatchNormBase.forward or \
                type(self)._fused_forward:
            return self(x, activation=activation, residual=residual,
                        pool=pool)
        return self._fused_impl(x, activation, residual, pool)

    def extra_repr(self):
        return f"num_features={self.num_features}"


class BatchNorm(_BatchNormBase):
    """The fluid-style ``BatchNorm(num_channels, act=...)``: the
    activation (a functional's name) after the normalization."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, use_global_stats=False,
                 trainable_statistics=False, *, device=None):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None,
                         device=device)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """BatchNorm over the whole batch across the data parallel ranks (see
    the module docstring); ``BatchNorm2D`` without such ranks."""

    _fused_forward = True

    def _sync_group(self):
        import torch.distributed as dist
        from ...ops import fused_bn_act as _k
        if _k._STATS_GROUP is not None or not (
                dist.is_available() and dist.is_initialized()):
            return None   # inside a step that set the group, or one rank
        from ...parallel.mesh import get_mesh
        mesh = get_mesh()
        g = mesh.group("dp") if mesh is not None else dist.group.WORLD
        return g if g is not None and dist.get_world_size(g) > 1 else None

    def forward(self, x, activation=None, residual=None, pool=None):
        from ...ops import fused_bn_act as _k
        g = self._sync_group() if self.training else None
        if g is None:
            return super().forward(x, activation, residual, pool)
        with _k.stats_group(g):
            return super().forward(x, activation, residual, pool)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """Every BatchNorm under ``layer`` replaced, in place, by a
        SyncBatchNorm sharing its parameters and buffers (the same state
        names); returns ``layer``."""
        for name, sub in list(layer.named_children()):
            if isinstance(sub, _BatchNormBase) and \
                    not isinstance(sub, SyncBatchNorm):
                sync = SyncBatchNorm(sub.num_features, sub.momentum,
                                     sub.epsilon,
                                     data_format=sub.data_format,
                                     device=sub._mean.device)
                sync.weight, sync.bias = sub.weight, sub.bias
                sync._buffers = sub._buffers
                setattr(layer, name, sync)
            else:
                cls.convert_sync_batchnorm(sub)
        return layer


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            (hidden_size,), attr=weight_attr,
            default_initializer=I.Constant(1.0), device=device)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None):
        super().__init__()
        self.num_groups, self.epsilon = num_groups, epsilon
        self.data_format = data_format
        self.weight = self.create_parameter(
            (num_channels,), attr=weight_attr,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = self.create_parameter((num_channels,), attr=bias_attr,
                                          is_bias=True, device=device)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.epsilon, self.weight,
                            self.bias, self.data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None):
        super().__init__()
        self.epsilon = epsilon
        if weight_attr is False or bias_attr is False:
            self.weight = self.bias = None
        else:
            self.weight = self.create_parameter(
                (num_features,), attr=weight_attr,
                default_initializer=I.Constant(1.0), device=device)
            self.bias = self.create_parameter(
                (num_features,), attr=bias_attr, is_bias=True,
                device=device)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self.epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """``forward(weight)``: weight / sigma, sigma from ``power_iters``
    steps of power iteration from ``weight_u`` / ``weight_v`` (Normal(0,
    1) draws that take no gradient and that the iteration does not write
    back, as in the reference)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", *, device=None, generator=None):
        super().__init__(dtype=dtype)
        self.dim, self.power_iters, self.eps = dim, power_iters, eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        for name, n in (("weight_u", h), ("weight_v", w)):
            p = self.create_parameter((n,), default_initializer=I.Normal(
                0.0, 1.0), device=device, generator=generator)
            p.requires_grad_(False)
            setattr(self, name, p)

    def forward(self, weight):
        mat = weight.movedim(self.dim, 0).reshape(weight.shape[self.dim], -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self.power_iters):
            v = mat.t() @ u
            v = v / (torch.linalg.vector_norm(v) + self.eps)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + self.eps)
        return weight / (u @ mat @ v)


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
