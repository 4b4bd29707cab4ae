"""Transformer layers (counterpart of paddle_tpu/nn/layer/transformer.py).

``MultiHeadAttention`` projects with four ``Linear`` s (``q_proj``,
``k_proj``, ``v_proj``, ``out_proj``, Paddle's (in, out) weights) and
attends through ``F.scaled_dot_product_attention`` in the (B, S, H, D)
layout, so it takes the flash kernels K1 / K2 whenever the reference's
rule does: the mask is None or a per-key bias ((B, Sk) or (B, 1, 1, Sk),
so also an (S, S) square mask at B == S), head_dim 64 / 128 / 256, both
lengths multiples of 128.  The encoder's self-attention and the decoder's
cross-attention with the (B, 1, 1, S) padding mask qualify; the decoder's
self-attention under its (S, S) causal mask, and every step of an
incremental decode (a cache that grows by one), take the naive path.

Incremental decoding: ``gen_cache`` starts each self-attention cache at
length 0, and ``forward(..., cache=)`` concatenates the step's keys and
values onto it and returns the new cache.  The decoder's cache holds the
self-attention only: cross-attention is recomputed from ``memory`` at
every step, as the reference does.

The stacks clone their first layer (``copy.deepcopy``): every layer of a
stack starts from the same weights, each with tensors of its own.  State
names are the reference's (``layers.N.self_attn.q_proj.weight``,
``linear1``, ``norm1``-``norm3``, ...), so ``load_paddle_state`` carries
a reference model across by name.  Constructors take the port's
``device`` and ``generator`` keywords after the reference's parameters.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch

from .. import functional as F
from ..layer_base import Layer
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


class MultiHeadAttention(Layer):
    Cache = tuple   # (k, v), each (B, S_past, H, D)
    StaticCache = tuple

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        assert self.head_dim * num_heads == embed_dim
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(device=device, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, weight_attr,
                             bias_attr, **kw)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, weight_attr,
                             bias_attr, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _shape(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        return out if cache is None else (out, (k, v))

    def gen_cache(self, key, value=None, type=None):  # noqa: A002
        """An empty (k, v) cache, (B, 0, H, D) f32 each, on ``key``'s
        device."""
        shape = (key.shape[0], 0, self.num_heads, self.head_dim)
        return (torch.zeros(shape, device=key.device),
                torch.zeros(shape, device=key.device))


def _get_activation(name):
    return getattr(F, name)


def _ffn(layer, x):
    act = _get_activation(layer.activation)
    return layer.linear2(layer.dropout_act(act(layer.linear1(x))))


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout)
        self.activation = activation

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is not None:
            src, new_cache = self.self_attn(src, src, src, src_mask, cache)
        else:
            src = self.self_attn(src, src, src, src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = residual + self.dropout2(_ffn(self, src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, new_cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            _clone_layer(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        out, new_caches = src, []
        for i, layer in enumerate(self.layers):
            if cache is not None:
                out, c = layer(out, src_mask, cache[i])
                new_caches.append(c)
            else:
                out = layer(out, src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout)
        self.activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is not None:
            tgt, new_self_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                 cache[0])
        else:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = residual + self.dropout3(_ffn(self, tgt))
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (new_self_cache,))

    def gen_cache(self, memory):
        return (self.self_attn.gen_cache(memory),)


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            _clone_layer(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        out, new_caches = tgt, []
        for i, layer in enumerate(self.layers):
            if cache is not None:
                out, c = layer(out, memory, tgt_mask, memory_mask, cache[i])
                new_caches.append(c)
            else:
                out = layer(out, memory, tgt_mask, memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)

    def gen_cache(self, memory):
        return [layer.gen_cache(memory) for layer in self.layers]


def _clone_layer(layer):
    """An independent copy of ``layer``: the same values, tensors of its
    own."""
    return copy.deepcopy(layer)


class Transformer(Layer):
    """The encoder-decoder at the reference's defaults: Transformer-base
    (d_model 512, 8 heads, 6 + 6 layers, d_ff 2048, dropout 0.1, relu,
    post-norm)."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        kw = dict(device=device, generator=generator)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            norm = (LayerNorm(d_model, device=device) if normalize_before
                    else None)
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            norm = (LayerNorm(d_model, device=device) if normalize_before
                    else None)
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, *, device=None):
        """(length, length) f32 additive causal mask: 0 on and below the
        diagonal, -1e9 above it."""
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=device).tril()
        return torch.where(keep, 0.0, -1e9).to(torch.float32)
