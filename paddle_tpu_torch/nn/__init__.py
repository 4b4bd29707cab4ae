from . import functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D,  # noqa: F401
                    Dropout, Embedding, GRUCell, LayerList, LayerNorm,
                    Linear, LSTMCell, MaxPool2D, ReLU, RNNCellBase,
                    Sequential, SimpleRNNCell, Tanh, Upsample,
                    UpsamplingBilinear2D, UpsamplingNearest2D)
from .layer.loss import (BCELoss, BCEWithLogitsLoss,  # noqa: F401
                         CosineEmbeddingLoss, CrossEntropyLoss, CTCLoss,
                         HingeEmbeddingLoss, KLDivLoss, L1Loss,
                         MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss,
                         TripletMarginLoss)
from .layer_base import Layer, ParamAttr  # noqa: F401
from .decode import (BeamSearchDecoder, Decoder, dynamic_decode,  # noqa: F401
                     gather_tree)
from . import decode  # noqa: F401,E402
from .layer import loss, rnn  # noqa: F401,E402
