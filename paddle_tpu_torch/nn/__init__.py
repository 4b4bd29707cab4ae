from . import functional  # noqa: F401
from .layer import (Dropout, Embedding, LayerList, LayerNorm,  # noqa: F401
                    Linear)
from .layer_base import Layer  # noqa: F401
