"""VGG 11 / 13 / 16 / 19 (port of paddle_tpu/vision/models/vgg.py), state
names as the reference's (``features.1._mean``, ``classifier.6.weight``).

``_Features`` is a Sequential that runs each BatchNorm2D followed by a
ReLU as one fused BatchNorm + ReLU op (K5 + K6 forward, K7 + K8 backward)
and, where a stock MaxPool2D follows the ReLU, folds the pool into the
same op's epilogue (K5 + K9 forward, ``fusable_pool_spec`` decides; the
backward recomputes through plain tensor code, as the reference's).
Without batch norm the layers run one by one.  Constructors take the
reference's parameters, then ``device`` (default ``"cuda"``; raises
without a card) and ``seed`` for the weight draw, as keywords.
"""
from __future__ import annotations

import torch

from ... import nn
from ...core.device import DEFAULT_DEVICE, resolve_device
from ...core.errors import UnimplementedError
from ...ops.fused_bn_act import fusable_pool_spec
from ...tensor.manipulation import flatten

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


class _Features(nn.Sequential):
    """Sequential whose BatchNorm2D -> ReLU (-> MaxPool2D) runs are fused
    ops; the sublayers and state names are a plain Sequential's."""

    def __init__(self, *layers):
        super().__init__(*layers)
        self._remat_stage = True  # jit.recompute_policy("stages") boundary

    def forward(self, x):
        layers = list(self)
        i = 0
        while i < len(layers):
            layer = layers[i]
            nxt = layers[i + 1] if i + 1 < len(layers) else None
            if hasattr(layer, "forward_fused") and isinstance(nxt, nn.ReLU):
                pool = (fusable_pool_spec(
                            layers[i + 2],
                            getattr(layer, "data_format", "NCHW"))
                        if i + 2 < len(layers) else None)
                if pool is not None:
                    x = layer.forward_fused(x, activation="relu", pool=pool)
                    i += 3
                else:
                    x = layer.forward_fused(x, activation="relu")
                    i += 2
            else:
                x = layer(x)
                i += 1
        return x


def _make_layers(cfg, batch_norm=False, *, device=None, generator=None):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(in_c, v, 3, padding=1, device=device,
                                    generator=generator))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v, device=device))
            layers.append(nn.ReLU())
            in_c = v
    return _Features(*layers)


class VGG(nn.Layer):
    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 device=DEFAULT_DEVICE, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed) + 1)   # features draw from seed itself
        kw = dict(device=dev, generator=gen)
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096, **kw), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, 4096, **kw), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def _vgg(cfg, batch_norm, pretrained=False, device=DEFAULT_DEVICE, seed=0,
         **kwargs):
    if pretrained:
        raise UnimplementedError(
            "pretrained weights are not bundled; load a state dict with "
            "load_paddle_state")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    features = _make_layers(_CFGS[cfg], batch_norm, device=dev,
                            generator=gen)
    return VGG(features, device=dev, seed=seed, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
