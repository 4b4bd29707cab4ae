"""MobileNetV1 / MobileNetV2 (port of paddle_tpu/vision/models/mobilenet.py),
state names as the reference's (``blocks.0.dw.conv.weight``,
``features.1.conv.2.bn._variance``, ...).

Every convolution's BatchNorm + activation runs the fused kernels of
``ops.fused_bn_act`` through ``BatchNorm2D.forward_fused`` (K5 + K6
forward, K7 + K8 backward): ``relu`` in V1, ``relu6`` in V2, and in each
of V2's inverted residuals with a shortcut the residual add fused into
the projection BatchNorm (``ConvBNLayer.forward_residual``).  The
depthwise convolutions are grouped convolutions (cuDNN).  Run
channels-last under ``jit.layout_policy("NHWC")``.

``MobileNetV1.forward(x, labels)`` returns the per-sample losses of the
fused classifier tail (``ops.fused_ce.fused_pool_linear_cross_entropy``),
as the reference's.  Constructors take the reference's parameters, then
``device`` (default ``"cuda"``; raises without a card) and ``seed`` for
the weight draw, as keywords.
"""
from __future__ import annotations

import torch

from ... import nn
from ...core.device import DEFAULT_DEVICE, resolve_device
from ...core.errors import UnimplementedError
from ...ops.fused_ce import fused_pool_linear_cross_entropy
from ...tensor.manipulation import flatten

__all__ = ["ConvBNLayer", "DepthwiseSeparable", "MobileNetV1",
           "InvertedResidual", "MobileNetV2", "mobilenet_v1",
           "mobilenet_v2"]


def _seeded(device, seed):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return dev, gen


class ConvBNLayer(nn.Layer):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0, groups=1,
                 act="relu", *, device=None, generator=None):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, kernel, stride=stride,
                              padding=padding, groups=groups,
                              bias_attr=False, device=device,
                              generator=generator)
        self.bn = nn.BatchNorm2D(out_c, device=device)
        self._act_name = act if act in ("relu", "relu6") else None

    def forward(self, x):
        return self.bn.forward_fused(self.conv(x), activation=self._act_name)

    def forward_residual(self, x, residual):
        """conv, then BatchNorm + the residual add (+ activation) as one
        fused op: the inverted residual's tail."""
        return self.bn.forward_fused(self.conv(x), activation=self._act_name,
                                     residual=residual)


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_c, out_c1, out_c2, stride, scale, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        c1, c2 = int(out_c1 * scale), int(out_c2 * scale)
        self.dw = ConvBNLayer(int(in_c * scale), c1, 3, stride=stride,
                              padding=1, groups=int(in_c * scale), **kw)
        self.pw = ConvBNLayer(c1, c2, 1, **kw)
        self._remat_stage = True  # jit.recompute_policy("stages") boundary

    def forward(self, x):
        return self.pw(self.dw(x))


_V1_CFG = [(32, 32, 64, 1), (64, 64, 128, 2), (128, 128, 128, 1),
           (128, 128, 256, 2), (256, 256, 256, 1), (256, 256, 512, 2),
           (512, 512, 512, 1), (512, 512, 512, 1), (512, 512, 512, 1),
           (512, 512, 512, 1), (512, 512, 512, 1), (512, 512, 1024, 2),
           (1024, 1024, 1024, 1)]


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=DEFAULT_DEVICE, seed: int = 0):
        super().__init__()
        dev, gen = _seeded(device, seed)
        kw = dict(device=dev, generator=gen)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = ConvBNLayer(3, int(32 * scale), 3, stride=2, padding=1,
                                 **kw)
        self.blocks = nn.Sequential(*[
            DepthwiseSeparable(i, o1, o2, s, scale, **kw)
            for i, o1, o2, s in _V1_CFG])
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(int(1024 * scale), num_classes, **kw)

    def forward(self, x, labels=None):
        if labels is not None and not (self.with_pool
                                       and self.num_classes > 0):
            raise ValueError(
                "MobileNetV1.forward(labels=...): the fused classifier "
                "tail needs with_pool=True and num_classes>0 (this model "
                f"has with_pool={self.with_pool}, "
                f"num_classes={self.num_classes})")
        x = self.blocks(self.conv1(x))
        if labels is not None:
            return fused_pool_linear_cross_entropy(
                x, self.fc.weight, labels, bias=self.fc.bias)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden, 1, act="relu6", **kw))
        layers += [
            ConvBNLayer(hidden, hidden, 3, stride=stride, padding=1,
                        groups=hidden, act="relu6", **kw),
            ConvBNLayer(hidden, oup, 1, act=None, **kw),
        ]
        self.conv = nn.Sequential(*layers)
        self._remat_stage = True  # jit.recompute_policy("stages") boundary

    def forward(self, x):
        if not self.use_res:
            return self.conv(x)
        proj = self.conv[len(self.conv) - 1]
        # the residual add fused into the projection BatchNorm, for the
        # stock layer without hooks only: the fused call bypasses the
        # projection's __call__ and the Sequential's
        if (type(proj) is not ConvBNLayer or proj._forward_pre_hooks
                or proj._forward_hooks or self.conv._forward_pre_hooks
                or self.conv._forward_hooks):
            return x + self.conv(x)
        out = x
        for layer in list(self.conv)[:-1]:
            out = layer(out)
        return proj.forward_residual(out, x)


_V2_CFG = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=DEFAULT_DEVICE, seed: int = 0):
        super().__init__()
        dev, gen = _seeded(device, seed)
        kw = dict(device=dev, generator=gen)
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_c = int(32 * scale)
        features = [ConvBNLayer(3, in_c, 3, stride=2, padding=1,
                                act="relu6", **kw)]
        for t, c, n, s in _V2_CFG:
            out_c = int(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    in_c, out_c, s if i == 0 else 1, t, **kw))
                in_c = out_c
        self.last_c = int(1280 * max(1.0, scale))
        features.append(ConvBNLayer(in_c, self.last_c, 1, act="relu6", **kw))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(self.last_c, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def _pretrained(pretrained):
    if pretrained:
        raise UnimplementedError(
            "pretrained weights are not bundled; load a state dict with "
            "load_paddle_state")


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    _pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    _pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
