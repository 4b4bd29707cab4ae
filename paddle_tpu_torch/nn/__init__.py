from . import functional, initializer  # noqa: F401
from .layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D,  # noqa: F401
                    Dropout, Embedding, GRUCell, LayerList, LayerNorm,
                    Linear, LSTMCell, MaxPool2D, ReLU, RNNCellBase,
                    Sequential, SimpleRNNCell, Tanh, Upsample,
                    UpsamplingBilinear2D, UpsamplingNearest2D)
from .layer_base import Layer, ParamAttr  # noqa: F401
from .decode import (BeamSearchDecoder, Decoder, dynamic_decode,  # noqa: F401
                     gather_tree)
from . import decode  # noqa: F401,E402
from .layer import rnn  # noqa: F401,E402
