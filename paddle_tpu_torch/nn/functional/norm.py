"""Normalization functionals (counterpart of
paddle_tpu/nn/functional/norm.py): layer_norm, batch_norm (any rank: the
channel axis is 1 for an ``"NC..."`` format, else the last), the fused
training BatchNorm entry points of the conv-net blocks, instance_norm,
group_norm, local_response_norm, normalize and rms_norm.

Inside ``ops.fused_bn_act.stats_group(group)`` every training-mode
BatchNorm here, plain or fused, takes its batch statistics over the
group's ranks (``nn.SyncBatchNorm``, ``parallel.ShardedTrainStep``); the
plain one then uses the one-pass variance of the fused path.

``fused_bn_act`` / ``fused_dual_bn_act`` in training mode run the fused
kernels of ``ops.fused_bn_act`` (K5-K9 on the card, their plain versions
on the CPU); in eval mode, the affine with the running statistics is plain
tensor code, as the reference's ``raw_eval``.  The running statistics are
updated as ``momentum * old + (1 - momentum) * batch`` through
``core.buffer_updates``: in place eagerly, logged inside ``TrainStep``.

The channel axis is logical: ``data_format="NCHW"`` means (N, C, ...)
whatever the memory format (channels-last memory is what the kernels
read without a copy), ``"NHWC"`` means (N, ..., C).

AMP: ``fused_bn_act`` is not black-listed.  Under O2 it casts x, gamma,
beta and the residual to the low type (gamma/beta are rounded to it
before the f32 coefficient math); under O1 it leaves them as they come.
``batch_norm``, ``instance_norm`` and ``group_norm`` stay black-listed
(f32).

``PDTPU_FUSED_BN=0`` (read at each call, as the reference reads it) sends
every ``fused_bn_act`` / ``fused_dual_bn_act`` call to ``batch_norm`` plus
the composite tail (and the pooling functional for a pool spec), so none
of K5-K9 launches; each such call counts on its entry's
``composite_calls`` (``bn_act_train``, ``bn_act_pool_train`` or
``bn2_act_train``).

The reference's quirks are kept: ``instance_norm`` normalizes over the
axes after the second whatever ``data_format`` says and reads neither
running statistics nor ``use_input_stats``; ``local_response_norm``
divides by (k + alpha * sum of squares) ** beta over the window of
``size`` channels, without dividing alpha by ``size``.
"""
from __future__ import annotations

import os

import torch

from ...amp import amp_cast, promote
from ...core import buffer_updates as _bufup

__all__ = ["layer_norm", "batch_norm", "fused_bn_act", "fused_dual_bn_act",
           "bn_act_composite", "instance_norm", "group_norm",
           "local_response_norm", "normalize", "rms_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5, name=None):
    """Population-variance layer norm over the trailing
    ``normalized_shape``; AMP black-listed (f32 under O1)."""
    ns = ((normalized_shape,) if isinstance(normalized_shape, int)
          else tuple(normalized_shape))
    x, weight, bias = promote(*amp_cast("layer_norm", x, weight, bias))
    return torch.nn.functional.layer_norm(x, ns, weight, bias, epsilon)


def _channel_axis(x, data_format):
    return 1 if data_format.startswith("NC") and x.dim() > 1 else x.dim() - 1


def _bshape(x, ch):
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    return shape


def _update_running_stats(running_mean, running_var, mean, var, momentum):
    """``momentum * old + (1 - momentum) * batch`` into both buffers."""
    if running_mean is None:
        return
    for buf, batch in ((running_mean, mean), (running_var, var)):
        old = _bufup.current(buf)
        _bufup.apply(buf, momentum * old + (1 - momentum) *
                     batch.detach().to(old.dtype))


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Plain BatchNorm; updates the running statistics when training with
    batch statistics.  AMP black-listed."""
    x, weight, bias = amp_cast("batch_norm", x, weight, bias)
    ch = _channel_axis(x, data_format)
    shape = _bshape(x, ch)
    if training and not use_global_stats:
        axes = tuple(i for i in range(x.dim()) if i != ch)
        from ...ops import fused_bn_act as _k
        if _k._STATS_GROUP is not None:   # the batch over the group's ranks
            mean, var = (t.to(x.dtype) for t in _k.group_stats(
                x.float(), axes, _k._STATS_GROUP))
        else:
            var, mean = torch.var_mean(x, dim=axes, correction=0)
        _update_running_stats(running_mean, running_var, mean, var,
                              momentum)
    else:
        mean, var = running_mean.to(x.dtype), running_var.to(x.dtype)
    inv = 1.0 / torch.sqrt(var.reshape(shape) + epsilon)
    out = (x - mean.reshape(shape)) * inv
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def bn_act_composite(out, activation=None, residual=None):
    """The unfused norm-output + residual-add + activation tail, for norm
    layers without a fused path."""
    if residual is not None:
        out = out + residual
    if activation is not None:
        from . import activation as A
        out = getattr(A, activation)(out)
    return out


def _pool_composite(out, pool, data_format):
    """A (kind, kernel, stride, padding) pool spec through the pooling
    functionals: the composite half of the pooled epilogue."""
    from . import pooling as P
    kind, k, s, p = pool
    fn = P.max_pool2d if kind == "max" else P.avg_pool2d
    return fn(out, k, s, p, data_format=data_format)


def _fused_on() -> bool:
    return os.environ.get("PDTPU_FUSED_BN", "1") != "0"


def _gamma_beta(w, b, nf, like):
    g = w if w is not None else torch.ones(nf, dtype=like.dtype,
                                           device=like.device)
    bb = b if b is not None else torch.zeros(nf, dtype=like.dtype,
                                             device=like.device)
    return g, bb


def fused_bn_act(x, running_mean, running_var, weight=None, bias=None,
                 training=True, momentum=0.9, epsilon=1e-5,
                 data_format="NCHW", activation=None, residual=None,
                 use_global_stats=None, pool=None, name=None):
    """BatchNorm + optional residual-add + activation (+ pool epilogue,
    ``pool=(kind, kernel, stride, padding)``) as one op."""
    from ...ops import fused_bn_act as _k

    if activation not in _k._ACTS:
        raise ValueError(
            f"fused_bn_act: unsupported activation {activation!r} "
            f"(expected one of {_k._ACTS}); apply it separately")
    if pool is not None:
        if residual is not None:
            raise ValueError("fused_bn_act: pool= composes with the plain "
                             "BN+act epilogue, not with residual=")
        pool = _k._pool_norm(pool)
    if not _fused_on():
        (_k.bn_act_pool_train if pool is not None
         else _k.bn_act_train).composite_calls += 1
        out = bn_act_composite(
            batch_norm(x, running_mean, running_var, weight, bias, training,
                       momentum, epsilon, data_format, use_global_stats),
            activation, residual)
        return out if pool is None else _pool_composite(out, pool,
                                                        data_format)
    x, weight, bias, residual = amp_cast("fused_bn_act", x, weight, bias,
                                         residual)
    ch = _channel_axis(x, data_format)
    channel_last = ch == x.dim() - 1
    g, b = _gamma_beta(weight, bias, x.shape[ch], x)
    if training and not use_global_stats:
        if pool is not None:
            out, mean, var = _k.bn_act_pool_train(
                x, g, b, epsilon, activation, pool, channel_last)
        else:
            out, mean, var = _k.bn_act_train(
                x, g, b, epsilon, activation, residual, channel_last)
        _update_running_stats(running_mean, running_var, mean, var,
                              momentum)
        return out
    # eval: the running-statistics affine, f32 elementwise and one cast
    shape = _bshape(x, ch)
    inv = torch.rsqrt(running_var.float() + epsilon)
    a = g.float() * inv
    bias_v = b.float() - running_mean.float() * a
    z = x.float() * a.reshape(shape) + bias_v.reshape(shape)
    if residual is not None:
        z = z + residual.float()
    z = _k._act_apply(z, activation)
    if pool is not None:
        kind, k, s, p = pool
        z = _k._pool2d(z, kind, k, s, p, channel_last)
    return z.to(x.dtype)


def fused_dual_bn_act(x, running_mean_x, running_var_x, weight_x, bias_x,
                      res, running_mean_r, running_var_r, weight_r, bias_r,
                      training=True, momentum=0.9, epsilon=1e-5,
                      data_format="NCHW", activation=None,
                      use_global_stats=None, name=None):
    """act(BN_x(x) + BN_r(res)) as one op: the downsample shortcut fused
    into the block's last BatchNorm.  Each BN keeps its own parameters and
    running statistics.  In eval mode, two plain BatchNorms and the
    composite tail."""
    from ...ops import fused_bn_act as _k

    if activation not in _k._ACTS:
        raise ValueError(
            f"fused_dual_bn_act: unsupported activation {activation!r} "
            f"(expected one of {_k._ACTS}); apply it separately")
    if not training or use_global_stats or not _fused_on():
        if not _fused_on():
            _k.bn2_act_train.composite_calls += 1
        out = batch_norm(x, running_mean_x, running_var_x, weight_x, bias_x,
                         training, momentum, epsilon, data_format,
                         use_global_stats)
        out_r = batch_norm(res, running_mean_r, running_var_r, weight_r,
                           bias_r, training, momentum, epsilon, data_format,
                           use_global_stats)
        return bn_act_composite(out, activation, residual=out_r)
    x, weight_x, bias_x, res, weight_r, bias_r = amp_cast(
        "fused_dual_bn_act", x, weight_x, bias_x, res, weight_r, bias_r)
    ch = _channel_axis(x, data_format)
    nf = x.shape[ch]
    gx, bx = _gamma_beta(weight_x, bias_x, nf, x)
    gr, br = _gamma_beta(weight_r, bias_r, nf, x)
    out, mean_x, var_x, mean_r, var_r = _k.bn2_act_train(
        x, gx, bx, res, gr, br, epsilon, activation, ch == x.dim() - 1)
    _update_running_stats(running_mean_x, running_var_x, mean_x, var_x,
                          momentum)
    _update_running_stats(running_mean_r, running_var_r, mean_r, var_r,
                          momentum)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Per-sample, per-channel normalization over the axes after the
    second (the reference's: running statistics, ``use_input_stats`` and
    ``data_format`` are not read).  AMP black-listed."""
    x, weight, bias = promote(*amp_cast("instance_norm", x, weight, bias))
    axes = tuple(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=axes, correction=0, keepdim=True)
    out = (x - mean) / torch.sqrt(var + eps)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Normalization over each sample's groups of channels (the channel
    axis 1 for an ``"NC..."`` format, else the last).  AMP black-listed."""
    x, weight, bias = promote(*amp_cast("group_norm", x, weight, bias))
    channel_last = not data_format.startswith("NC")
    xc = x.movedim(-1, 1) if channel_last else x
    out = torch.nn.functional.group_norm(xc, num_groups, weight, bias,
                                         epsilon)
    return out.movedim(1, -1) if channel_last else out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """x / (k + alpha * sum of x**2 over ``size`` channels) ** beta, the
    window [c - size // 2, c + size - size // 2 - 1] zero-padded."""
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    sq = (x * x).movedim(ch, -1)
    half = size // 2
    sq = torch.nn.functional.pad(sq, (half, size - half - 1))
    acc = sq.unfold(-1, size, 1).sum(-1).movedim(-1, ch)
    return x / (k + alpha * acc) ** beta


def normalize(x, p=2.0, axis=1, epsilon=1e-12, name=None):
    """x / max(||x||_p along ``axis``, epsilon)."""
    norm = (x.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(norm, epsilon)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """x / sqrt(mean(x**2) + epsilon) over the last axis, in f32 and cast
    back to x's type, then times ``weight``."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    out = (xf / torch.sqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight
