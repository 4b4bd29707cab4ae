"""Functional ops on the GPT serving and training paths."""
from __future__ import annotations

from ...tensor.linalg import matmul  # noqa: F401
from .activation import gelu, softmax  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import dropout, linear  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import layer_norm  # noqa: F401

__all__ = ["cross_entropy", "dropout", "gelu", "layer_norm", "linear",
           "matmul", "scaled_dot_product_attention", "softmax"]
