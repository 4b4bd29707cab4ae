"""paddle_tpu_torch.nn (counterpart of paddle_tpu/nn/)."""
from . import functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_)
from .layer import *  # noqa: F401,F403
from .layer.loss import (BCELoss, BCEWithLogitsLoss,  # noqa: F401
                         CosineEmbeddingLoss, CrossEntropyLoss, CTCLoss,
                         HingeEmbeddingLoss, KLDivLoss, L1Loss,
                         MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss,
                         TripletMarginLoss)
from .layer_base import Layer, ParamAttr  # noqa: F401
from .decode import (BeamSearchDecoder, Decoder, dynamic_decode,  # noqa: F401
                     gather_tree)
from . import decode, utils  # noqa: F401,E402
from .layer import common, conv, loss, norm, rnn  # noqa: F401,E402
