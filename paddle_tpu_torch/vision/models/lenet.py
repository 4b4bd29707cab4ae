"""LeNet (port of paddle_tpu/vision/models/lenet.py): two convolutions
with ReLU and 2x2 max pools, then three Linears, on (N, 1, 28, 28)
images.  State names as the reference's (``features.0.weight``,
``fc.2.bias``).  ``device`` (default ``"cuda"``) and ``seed`` come after
the reference's parameters, as keywords."""
from __future__ import annotations

import torch

from ... import nn
from ...core.device import DEFAULT_DEVICE, resolve_device
from ...tensor.manipulation import flatten

__all__ = ["LeNet"]


class LeNet(nn.Layer):
    def __init__(self, num_classes=10, *, device=DEFAULT_DEVICE,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        kw = dict(device=dev, generator=gen)
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1, **kw), nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0, **kw), nn.ReLU(),
            nn.MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120, **kw), nn.Linear(120, 84, **kw),
                nn.Linear(84, num_classes, **kw))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x
