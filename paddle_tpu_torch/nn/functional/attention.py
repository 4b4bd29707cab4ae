"""Attention functionals (counterpart of
paddle_tpu/nn/functional/attention.py).

``scaled_dot_product_attention`` is the reference's naive path
(``attention.py:74-94``): scores in the input dtype, -1e30 masking,
softmax in f32, causal mask ``tril(k=sk-sq)`` so that with a KV cache
query i attends keys <= past + i.  The reference swaps in its flash
kernel (K1) when shapes qualify; that port comes with the training slice.
"""
from __future__ import annotations

import math

import torch

__all__ = ["scaled_dot_product_attention"]


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True):
    """q/k/v: (batch, seq, heads, head_dim), the Paddle layout.
    ``attn_mask`` is boolean (True = attend) or additive, broadcast
    against (batch, heads, sq, sk)."""
    scale = 1.0 / math.sqrt(query.shape[-1])
    qt = query.transpose(1, 2)
    kt = key.transpose(1, 2)
    vt = value.transpose(1, 2)
    scores = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
    neg = torch.tensor(-1e30, dtype=scores.dtype, device=scores.device)
    if is_causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=scores.device).tril(sk - sq)
        scores = torch.where(causal, scores, neg)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask, scores, neg)
        else:
            scores = scores + attn_mask
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(query.dtype)
    if dropout_p > 0.0 and training:
        probs = torch.nn.functional.dropout(probs, dropout_p, training=True)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vt)
    return out.transpose(1, 2)
