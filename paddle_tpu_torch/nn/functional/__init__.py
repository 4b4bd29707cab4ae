"""paddle_tpu_torch.nn.functional (counterpart of
paddle_tpu/nn/functional/): activations, attention, the common ops,
convolutions, losses, norms, pools, the sequence ops, the CRF, MoE."""
from __future__ import annotations

from ...tensor.linalg import matmul  # noqa: F401
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _acts
from .attention import (scaled_dot_product_attention,  # noqa: F401
                        sequence_mask, set_flash_attention)
from .common import *  # noqa: F401,F403
from .common import __all__ as _commons
from .crf import crf_decoding, hsigmoid_loss, linear_chain_crf  # noqa: F401
from .moe import moe_ffn  # noqa: F401
from .sequence import *  # noqa: F401,F403
from .sequence import __all__ as _sequence
from .conv import (conv1d, conv1d_transpose, conv2d,  # noqa: F401
                   conv2d_transpose, conv3d, conv3d_transpose)
from .loss import (binary_cross_entropy,  # noqa: F401
                   binary_cross_entropy_with_logits, cosine_embedding_loss,
                   cross_entropy, ctc_loss, hinge_embedding_loss, kl_div,
                   l1_loss, log_loss, margin_ranking_loss, mse_loss,
                   nll_loss, npair_loss, sigmoid_focal_loss,
                   smooth_l1_loss, softmax_with_cross_entropy,
                   square_error_cost, triplet_margin_loss)
from .loss import __all__ as _losses
from .norm import (batch_norm, bn_act_composite, fused_bn_act,  # noqa: F401
                   fused_dual_bn_act, group_norm, instance_norm, layer_norm,
                   local_response_norm, normalize, rms_norm)
from .norm import __all__ as _norms
from .pooling import (adaptive_avg_pool1d,  # noqa: F401
                      adaptive_avg_pool2d, adaptive_avg_pool3d,
                      adaptive_max_pool1d, adaptive_max_pool2d,
                      adaptive_max_pool3d, avg_pool1d, avg_pool2d,
                      avg_pool3d, max_pool1d, max_pool2d, max_pool3d)
from .pooling import __all__ as _pools

from .conv import __all__ as _convs

__all__ = (["cross_entropy", "matmul", "scaled_dot_product_attention",
            "sequence_mask", "set_flash_attention", "linear_chain_crf",
            "crf_decoding", "hsigmoid_loss", "moe_ffn"]
           + _acts + _commons + _sequence
           + [n for n in _losses if n != "cross_entropy"] + _convs + _pools
           + _norms)
