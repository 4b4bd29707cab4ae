"""Functional ops on the GPT serving path."""
from __future__ import annotations

from .activation import gelu  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401

__all__ = ["gelu", "scaled_dot_product_attention"]
