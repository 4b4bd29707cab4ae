"""BERT model family (port of paddle_tpu/models/bert.py).

Post-LN encoder layers (LayerNorm eps 1e-12) with a fused (H, 3H) QKV;
parameter names and state keys are the reference's, so
``load_paddle_state`` carries a reference model across by name.

Attention goes through ``F.scaled_dot_product_attention``: the padding
mask ``BertModel.make_attn_mask`` builds, (B, 1, 1, S) additive f32
(1 - m) * -1e4, is the flash kernels' per-key bias, so at head_dim
64/128/256 and S % 128 == 0 every layer runs K1 forward and K2 backward,
non-causal, with the bias and the attention dropout in the kernel.  Under
O1 the mask is cast with q, k and v (to bf16: -1e4 becomes -9984), as the
reference's dispatch casts every tensor argument of a white-listed op.

The MLM head's decoder weight is the word embedding's ``Parameter``
itself, tied, not a copy, and not registered a second time: the state
holds it once, under ``bert.embeddings.word_embeddings.weight``, as the
reference's ``state_arrays`` does, so it gets one gradient (the sum of
both uses), one optimizer state and one checkpoint entry.

Constructors take ``device`` (default ``"cuda"``; raises without a card)
and ``seed`` for the weight draw.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..nn import functional as F
from ..nn.layer.common import Dropout, Embedding, Linear
from ..nn.layer.container import LayerList
from ..nn.layer.norm import LayerNorm
from ..nn.layer_base import Layer
from ..tensor.linalg import matmul

__all__ = ["BertConfig", "bert_base_config", "bert_large_config",
           "BertEmbeddings", "BertSelfAttention", "BertLayer", "BertPooler",
           "BertModel", "BertLMHead", "BertForPretraining",
           "BertPretrainingCriterion", "BertForSequenceClassification"]


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 hidden_act="gelu", hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1, max_position_embeddings=512,
                 type_vocab_size=2, initializer_range=0.02, pad_token_id=0):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.pad_token_id = pad_token_id


def bert_base_config(**kw):
    return BertConfig(**kw)


def bert_large_config(**kw):
    base = dict(hidden_size=1024, num_hidden_layers=24,
                num_attention_heads=16, intermediate_size=4096)
    base.update(kw)
    return BertConfig(**base)


def _generator(device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


class BertEmbeddings(Layer):
    def __init__(self, cfg: BertConfig, device=None, generator=None):
        super().__init__()
        std = cfg.initializer_range
        kw = dict(std=std, device=device, generator=generator)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size, epsilon=1e-12,
                                    device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def _sum_embeddings(self, input_ids, token_type_ids=None,
                        position_ids=None):
        """word + position + token-type sum before the norm and dropout
        (a subclass hook)."""
        if position_ids is None:
            position_ids = torch.arange(
                input_ids.shape[-1], device=input_ids.device).expand(
                input_ids.shape)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        return (self.word_embeddings(input_ids)
                + self.position_embeddings(position_ids)
                + self.token_type_embeddings(token_type_ids))

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        emb = self._sum_embeddings(input_ids, token_type_ids, position_ids)
        return self.dropout(self.layer_norm(emb))


class BertSelfAttention(Layer):
    """Fused-QKV attention: one (H, 3H) matmul, then attention on q, k, v
    as strided views of its output (no copy)."""

    def __init__(self, cfg: BertConfig, device=None, generator=None):
        super().__init__()
        std = cfg.initializer_range
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.hidden_size = cfg.hidden_size
        self.qkv = Linear(cfg.hidden_size, 3 * cfg.hidden_size, std=std,
                          device=device, generator=generator)
        self.out = Linear(cfg.hidden_size, cfg.hidden_size, std=std,
                          device=device, generator=generator)
        self.attn_dropout = cfg.attention_probs_dropout_prob

    def forward(self, x, attn_mask=None):
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        ctx = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.attn_dropout,
            training=self.training)
        return self.out(ctx.reshape(b, s, self.hidden_size))


class BertLayer(Layer):
    def __init__(self, cfg: BertConfig, device=None, generator=None):
        super().__init__()
        self._remat_stage = True  # jit.recompute_policy("stages") boundary
        std = cfg.initializer_range
        self.attention = BertSelfAttention(cfg, device, generator)
        self.attn_norm = LayerNorm(cfg.hidden_size, epsilon=1e-12,
                                   device=device)
        self.ffn_in = Linear(cfg.hidden_size, cfg.intermediate_size, std=std,
                             device=device, generator=generator)
        self.ffn_out = Linear(cfg.intermediate_size, cfg.hidden_size,
                              std=std, device=device, generator=generator)
        self.ffn_norm = LayerNorm(cfg.hidden_size, epsilon=1e-12,
                                  device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.act = cfg.hidden_act

    def forward(self, x, attn_mask=None):
        x = self.attn_norm(x + self.dropout(self.attention(x, attn_mask)))
        h = self.ffn_out(getattr(F, self.act)(self.ffn_in(x)))
        return self.ffn_norm(x + self.dropout(h))


class BertPooler(Layer):
    def __init__(self, cfg: BertConfig, device=None, generator=None):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size,
                            std=cfg.initializer_range, device=device,
                            generator=generator)

    def forward(self, hidden):
        return F.tanh(self.dense(hidden[:, 0]))


class BertModel(Layer):
    def __init__(self, cfg: BertConfig = None, device=DEFAULT_DEVICE,
                 seed: int = 0, **kw):
        super().__init__()
        self.config = cfg or BertConfig(**kw)
        cfg = self.config
        dev = resolve_device(device)
        gen = _generator(dev, seed)
        self.embeddings = self._make_embeddings(cfg, dev, gen)
        self.layers = LayerList([BertLayer(cfg, dev, gen)
                                 for _ in range(cfg.num_hidden_layers)])
        self.pooler = BertPooler(cfg, dev, gen)

    def _make_embeddings(self, cfg, device, generator):
        return BertEmbeddings(cfg, device, generator)

    def make_attn_mask(self, input_ids, attention_mask=None):
        """(B, S) padding mask (1 = a real token) or None -> an additive
        (B, 1, 1, S) f32 mask, (1 - m) * -1e4, or None."""
        if attention_mask is None:
            return None
        m = attention_mask
        if m.dim() == 2:
            m = m[:, None, None, :]
        return (1.0 - m.to(torch.float32)) * -1e4

    def _encode(self, h, attention_mask, input_ids):
        mask = self.make_attn_mask(input_ids, attention_mask)
        for layer in self.layers:
            h = layer(h, mask)
        return h, self.pooler(h)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        h = self.embeddings(input_ids, token_type_ids, position_ids)
        return self._encode(h, attention_mask, input_ids)


class BertLMHead(Layer):
    """MLM head: transform, activation, layer norm, then logits against
    the tied (V, H) decoder weight (``transpose_y``) plus a bias of its
    own."""

    def __init__(self, cfg: BertConfig, embedding_weights=None, device=None,
                 generator=None):
        super().__init__()
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                std=cfg.initializer_range, device=device,
                                generator=generator)
        self.layer_norm = LayerNorm(cfg.hidden_size, epsilon=1e-12,
                                    device=device)
        self.act = cfg.hidden_act
        # the tie: held outside the module's registries, so the state keeps
        # the weight once (under the embedding's name)
        self._tied = (embedding_weights,)
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size,
                                                     device=device))

    @property
    def decoder_weight(self) -> torch.Tensor:
        return self._tied[0]

    def forward(self, hidden):
        h = self.layer_norm(getattr(F, self.act)(self.transform(hidden)))
        return (matmul(h, self.decoder_weight, transpose_y=True)
                + self.decoder_bias)


class BertForPretraining(Layer):
    """MLM + NSP pretraining model."""

    def __init__(self, cfg: BertConfig = None, device=DEFAULT_DEVICE,
                 seed: int = 0, **kw):
        super().__init__()
        self.bert = BertModel(cfg, device=device, seed=seed, **kw)
        cfg = self.bert.config
        dev = self.bert.device
        gen = _generator(dev, seed + 1)
        self.cls = BertLMHead(cfg, self.bert.embeddings.word_embeddings.weight,
                              dev, gen)
        self.nsp = Linear(cfg.hidden_size, 2, std=cfg.initializer_range,
                          device=dev, generator=gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq_out, pooled = self.bert(input_ids, token_type_ids, position_ids,
                                    attention_mask)
        return self.cls(seq_out), self.nsp(pooled)


class BertPretrainingCriterion(Layer):
    """Masked-LM loss (labels -100 are not predicted) plus, when NSP labels
    are given, the next-sentence loss."""

    def __init__(self, vocab_size=None):
        super().__init__()
        self.vocab_size = vocab_size

    def forward(self, prediction_scores, seq_relationship_score,
                masked_lm_labels, next_sentence_labels=None):
        mlm = F.cross_entropy(
            prediction_scores.reshape(-1, prediction_scores.shape[-1]),
            masked_lm_labels.reshape(-1), ignore_index=-100,
            reduction="mean")
        if next_sentence_labels is None:
            return mlm
        nsp = F.cross_entropy(seq_relationship_score,
                              next_sentence_labels.reshape(-1),
                              reduction="mean")
        return mlm + nsp


class BertForSequenceClassification(Layer):
    def __init__(self, cfg: BertConfig = None, num_classes=2, dropout=None,
                 device=DEFAULT_DEVICE, seed: int = 0, **kw):
        super().__init__()
        self.bert = BertModel(cfg, device=device, seed=seed, **kw)
        cfg = self.bert.config
        dev = self.bert.device
        self.dropout = Dropout(dropout if dropout is not None
                               else cfg.hidden_dropout_prob)
        self.classifier = Linear(cfg.hidden_size, num_classes,
                                 std=cfg.initializer_range, device=dev,
                                 generator=_generator(dev, seed + 1))

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        return self.classifier(self.dropout(pooled))
