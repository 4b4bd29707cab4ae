from .activation import ReLU  # noqa: F401
from .common import Dropout, Embedding, Linear  # noqa: F401
from .container import LayerList, Sequential  # noqa: F401
from .conv import Conv2D  # noqa: F401
from .norm import BatchNorm2D, LayerNorm  # noqa: F401
from .pooling import AdaptiveAvgPool2D, MaxPool2D  # noqa: F401
