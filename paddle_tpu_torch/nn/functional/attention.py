"""Attention functionals (counterpart of
paddle_tpu/nn/functional/attention.py).

``scaled_dot_product_attention`` takes the reference's dispatch rule
(``_sdpa_raw``): when the mask can be written as the flash kernels'
per-key bias (``_flash_kv_bias``) and ``ops.flash_attention``'s gate
accepts the shapes, attention runs on the flash kernels K1/K2 (a kernel
that fails to build or launch raises; it never turns into the naive
path).  Otherwise it takes the naive path: scores in the input type,
-1e30 masking, softmax in f32, causal mask ``tril(k=sk-sq)`` so that with
a KV cache query i attends keys <= past + i.  The serving prefill passes a
(b, 1, s, t) mask, so it stays on the naive path, as in the reference.

The attention-dropout seed is an int32 drawn from the current explicit
generator (``core.rng``), as the reference draws it from ``drop_key``;
the naive path draws its keep mask from the same generator.
"""
from __future__ import annotations

import math

import torch

from ...amp import amp_cast
from ...core import rng
from ...ops import flash_attention as fa

__all__ = ["scaled_dot_product_attention"]


def _flash_kv_bias(mask, batch: int, sk: int):
    """A mask as the flash kernels' (B, Sk) f32 additive per-key bias, or
    ValueError when its shape cannot be written so."""
    if mask.dim() == 4:
        if mask.shape[1] != 1 or mask.shape[2] != 1:
            raise ValueError("per-head/per-query mask")
        mask = mask[:, 0, 0, :]
    if mask.dim() != 2 or tuple(mask.shape) != (batch, sk):
        raise ValueError("unsupported mask shape")
    if mask.dtype == torch.bool:
        return torch.where(mask, 0.0, -1e30).to(torch.float32)
    return mask.to(torch.float32)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None):
    """q/k/v: (batch, seq, heads, head_dim), the Paddle layout.
    ``attn_mask`` is boolean (True = attend) or additive, broadcast
    against (batch, heads, sq, sk).  AMP white-listed."""
    query, key, value, attn_mask = amp_cast(
        "scaled_dot_product_attention", query, key, value, attn_mask)
    p = dropout_p if training else 0.0
    try:
        bias = None if attn_mask is None else _flash_kv_bias(
            attn_mask, query.shape[0], key.shape[1])
    except ValueError:
        bias = False   # inexpressible mask: the naive path
    if bias is not False:
        seed = rng.draw_seed(query.device) if p > 0.0 else None
        out = fa.flash_attention_bshd(query, key, value, causal=is_causal,
                                      bias=bias, dropout_p=p,
                                      dropout_seed=seed)
        if out is not None:
            return out
    return _naive(query, key, value, attn_mask, p, is_causal)


def _naive(query, key, value, attn_mask, dropout_p, is_causal):
    scale = 1.0 / math.sqrt(query.shape[-1])
    qt = query.transpose(1, 2)
    kt = key.transpose(1, 2)
    vt = value.transpose(1, 2)
    scores = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
    # a fill, not a host copy: this runs inside captured CUDA graphs.
    # -1e30 in the scores' type, as the reference's jnp.where casts it:
    # past float16's range that is -inf (torch.full refuses the overflow)
    fill = -1e30 if torch.finfo(scores.dtype).max >= 1e30 else -math.inf
    neg = torch.full((), fill, dtype=scores.dtype, device=scores.device)
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
    if dropout_p > 0.0:
        keep = rng.bernoulli(probs.shape, 1.0 - dropout_p, probs.device)
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vt)
    return out.transpose(1, 2)
