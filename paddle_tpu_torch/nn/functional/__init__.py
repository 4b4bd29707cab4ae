"""Functional ops on the GPT serving and training paths and the BERT /
ERNIE and ResNet training paths."""
from __future__ import annotations

from ...tensor.linalg import matmul  # noqa: F401
from .activation import gelu, relu, relu6, softmax, tanh  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import dropout, linear  # noqa: F401
from .conv import conv2d  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import (batch_norm, bn_act_composite, fused_bn_act,  # noqa: F401
                   fused_dual_bn_act, layer_norm)
from .pooling import (adaptive_avg_pool2d, avg_pool2d,  # noqa: F401
                      max_pool2d)

__all__ = ["adaptive_avg_pool2d", "avg_pool2d", "batch_norm",
           "bn_act_composite", "conv2d", "cross_entropy", "dropout",
           "fused_bn_act", "fused_dual_bn_act", "gelu", "layer_norm",
           "linear", "matmul", "max_pool2d", "relu", "relu6",
           "scaled_dot_product_attention", "softmax", "tanh"]
