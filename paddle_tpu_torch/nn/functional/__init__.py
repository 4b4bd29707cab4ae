"""Functional ops on the GPT serving and training paths and the BERT /
ERNIE and ResNet training paths."""
from __future__ import annotations

from ...tensor.linalg import matmul  # noqa: F401
from .activation import gelu, relu, relu6, softmax, tanh  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import (dropout, embedding, interpolate, linear,  # noqa: F401
                     upsample)
from .conv import conv2d  # noqa: F401
from .loss import (binary_cross_entropy,  # noqa: F401
                   binary_cross_entropy_with_logits, cosine_embedding_loss,
                   cross_entropy, ctc_loss, hinge_embedding_loss, kl_div,
                   l1_loss, log_loss, margin_ranking_loss, mse_loss,
                   nll_loss, npair_loss, sigmoid_focal_loss,
                   smooth_l1_loss, softmax_with_cross_entropy,
                   square_error_cost, triplet_margin_loss)
from .loss import __all__ as _losses
from .norm import (batch_norm, bn_act_composite, fused_bn_act,  # noqa: F401
                   fused_dual_bn_act, layer_norm)
from .pooling import (adaptive_avg_pool2d, avg_pool2d,  # noqa: F401
                      max_pool2d)

__all__ = ["adaptive_avg_pool2d", "avg_pool2d", "batch_norm",
           "bn_act_composite", "conv2d", "cross_entropy", "dropout",
           "embedding", "interpolate",
           "fused_bn_act", "fused_dual_bn_act", "gelu", "layer_norm",
           "linear", "matmul", "max_pool2d", "relu", "relu6",
           "scaled_dot_product_attention", "softmax", "tanh",
           "upsample"] + [n for n in _losses if n != "cross_entropy"]
