from . import functional  # noqa: F401
from .layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D,  # noqa: F401
                    Dropout, Embedding, LayerList, LayerNorm, Linear,
                    MaxPool2D, ReLU, Sequential)
from .layer_base import Layer  # noqa: F401
