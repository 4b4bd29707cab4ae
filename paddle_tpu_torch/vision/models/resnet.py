"""ResNet family (port of paddle_tpu/vision/models/resnet.py, training
path): BasicBlock / BottleneckBlock, resnet18-152, state names as the
reference's (``layer1.0.downsample.1._mean``, ...).

Every block's BatchNorm + ReLU (+ residual) tail runs the fused kernels
of ``ops.fused_bn_act`` through ``BatchNorm2D.forward_fused``: the stem's
BN + ReLU + max pool as one pooled epilogue (K5 + K9), each bn1 / bn2 and
each identity-residual bn3 through ``bn_act_train`` (K5 + K6 forward,
K7 + K8 backward), and each downsample block's bn3 with the shortcut's
own BatchNorm through the dual form ``bn2_act_train``.  Run channels-last
under ``jit.layout_policy("NHWC")`` (the model stays logical NCHW), or
with ``data_format="NHWC"`` on (N, H, W, C) inputs.

``forward(x)`` returns the logits; ``forward(x, labels)`` the per-sample
losses of the fused classifier tail (``ops.fused_ce``: the global average
pool, the classifier and the cross-entropy as one op, plain tensor code as
the reference's is plain jnp).

Constructors take ``device`` (default ``"cuda"``; raises without a card)
and ``seed`` for the weight draw.
"""
from __future__ import annotations

import torch

from ... import nn
from ...core.device import DEFAULT_DEVICE, resolve_device
from ...core.errors import UnimplementedError
from ...ops.fused_ce import fused_pool_linear_cross_entropy
from ...nn.functional.norm import _pool_composite, bn_act_composite
from ...nn.layer.norm import dual_bn_act, supports_dual_bn
from ...ops.fused_bn_act import _pool_norm, fusable_pool_spec
from ...tensor.manipulation import flatten

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152"]


def _bn_act(norm, x, activation=None, residual=None, pool=None):
    """A block's norm + residual + activation (+ pool) tail: the fused
    path when the norm layer has one, else the composite."""
    if hasattr(norm, "forward_fused"):
        return norm.forward_fused(x, activation=activation,
                                  residual=residual, pool=pool)
    out = bn_act_composite(norm(x), activation, residual)
    if pool is not None:
        out = _pool_composite(out, _pool_norm(pool),
                              getattr(norm, "data_format", "NCHW"))
    return out


def _bn_add_act(norm, x, norm_res, res_pre, activation=None):
    """act(norm(x) + norm_res(res_pre)): one dual-BN op when both norms
    are stock BatchNorms, else the composite."""
    if supports_dual_bn(norm, norm_res):
        return dual_bn_act(norm, x, norm_res, res_pre,
                           activation=activation)
    return _bn_act(norm, x, activation, residual=norm_res(res_pre))


def _split_downsample(downsample):
    """(conv, BatchNorm) halves of a downsample Sequential when the dual-BN
    fusion applies, else None."""
    if not isinstance(downsample, nn.Sequential) or len(downsample) != 2:
        return None
    conv, norm = downsample[0], downsample[1]
    if not (isinstance(conv, nn.Conv2D) and supports_dual_bn(norm)):
        return None
    return conv, norm


def _tail(block, out, x, norm):
    """The block's last BatchNorm with its shortcut and ReLU."""
    ds = _split_downsample(block.downsample)
    if ds is not None:
        return _bn_add_act(norm, out, ds[1], ds[0](x), "relu")
    identity = block.downsample(x) if block.downsample is not None else x
    return _bn_act(norm, out, "relu", residual=identity)


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", *, device=None, generator=None):
        super().__init__()
        self._remat_stage = True  # jit.recompute_policy("stages") boundary
        norm_layer = norm_layer or nn.BatchNorm2D
        kw = dict(data_format=data_format, device=device)
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, generator=generator, **kw)
        self.bn1 = norm_layer(planes, **kw)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               generator=generator, **kw)
        self.bn2 = norm_layer(planes, **kw)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        out = _bn_act(self.bn1, self.conv1(x), "relu")
        return _tail(self, self.conv2(out), x, self.bn2)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", *, device=None, generator=None):
        super().__init__()
        self._remat_stage = True  # jit.recompute_policy("stages") boundary
        norm_layer = norm_layer or nn.BatchNorm2D
        kw = dict(data_format=data_format, device=device)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False,
                               generator=generator, **kw)
        self.bn1 = norm_layer(width, **kw)
        self.conv2 = nn.Conv2D(width, width, 3, stride=stride,
                               padding=dilation, groups=groups,
                               dilation=dilation, bias_attr=False,
                               generator=generator, **kw)
        self.bn2 = norm_layer(width, **kw)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, generator=generator, **kw)
        self.bn3 = norm_layer(planes * self.expansion, **kw)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        out = _bn_act(self.bn1, self.conv1(x), "relu")
        out = _bn_act(self.bn2, self.conv2(out), "relu")
        return _tail(self, self.conv3(out), x, self.bn3)


class ResNet(nn.Layer):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW",
                 *, device=DEFAULT_DEVICE, seed: int = 0):
        super().__init__()
        layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        kw = dict(data_format=data_format, device=dev)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.groups = groups
        self.base_width = width
        self.data_format = data_format
        self.inplanes = 64
        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False, generator=gen, **kw)
        self.bn1 = nn.BatchNorm2D(self.inplanes, **kw)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1,
                                    data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0], 1, gen, kw)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, gen, kw)
        self.layer3 = self._make_layer(block, 256, layers[2], 2, gen, kw)
        self.layer4 = self._make_layer(block, 512, layers[3], 2, gen, kw)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1),
                                                data_format=data_format)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                device=dev, generator=gen)

    def _make_layer(self, block, planes, blocks, stride, gen, kw):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False, generator=gen,
                          **kw),
                nn.BatchNorm2D(planes * block.expansion, **kw))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, generator=gen, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, generator=gen,
                                **kw))
        return nn.Sequential(*layers)

    def forward(self, x, labels=None):
        """Logits, or with ``labels`` the per-sample CE losses of the fused
        classifier tail (drive a TrainStep with the batch (x, labels,
        labels) and a mean loss)."""
        if labels is not None and not (self.with_pool
                                       and self.num_classes > 0):
            raise ValueError(
                "ResNet.forward(labels=...): the fused classifier tail "
                "needs with_pool=True and num_classes>0 (this model has "
                f"with_pool={self.with_pool}, "
                f"num_classes={self.num_classes})")
        # stem: conv -> BN -> relu -> maxpool with the pool folded into the
        # fused BN/act epilogue (one op, pooled output only); a replaced
        # maxpool keeps its own forward
        pool = fusable_pool_spec(self.maxpool, self.data_format)
        if pool is not None:
            x = _bn_act(self.bn1, self.conv1(x), "relu", pool=pool)
        else:
            x = self.maxpool(_bn_act(self.bn1, self.conv1(x), "relu"))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if labels is not None:
            return fused_pool_linear_cross_entropy(
                x, self.fc.weight, labels, bias=self.fc.bias,
                data_format=self.data_format)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def _resnet(depth, block, pretrained=False, **kwargs):
    if pretrained:
        raise UnimplementedError(
            "pretrained weights are not bundled; load a state dict with "
            "load_paddle_state")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(18, BasicBlock, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(34, BasicBlock, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(50, BottleneckBlock, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(101, BottleneckBlock, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(152, BottleneckBlock, pretrained, **kwargs)
