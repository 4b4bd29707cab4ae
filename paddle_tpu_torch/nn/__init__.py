from . import functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,  # noqa: F401
                    AdaptiveAvgPool3D, AdaptiveMaxPool1D, AdaptiveMaxPool2D,
                    AdaptiveMaxPool3D, AvgPool1D, AvgPool2D, AvgPool3D,
                    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                    Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose,
                    Conv3D, Conv3DTranspose, Dropout, Embedding, GRUCell,
                    GroupNorm, InstanceNorm1D, InstanceNorm2D,
                    InstanceNorm3D, LayerList, LayerNorm, Linear,
                    LocalResponseNorm, LSTMCell, MaxPool1D, MaxPool2D,
                    MaxPool3D, ReLU, RMSNorm, RNNCellBase, Sequential,
                    SimpleRNNCell, SpectralNorm, SyncBatchNorm, Tanh,
                    Upsample, UpsamplingBilinear2D, UpsamplingNearest2D)
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
