"""ERNIE model family (port of paddle_tpu/models/ernie.py).

A BERT encoder with a task-type embedding (``use_task_id``) and relu as
its default activation; it shares the blocks of ``models.bert``, and its
state keys are the reference's.
"""
from __future__ import annotations

import torch

from ..core.device import DEFAULT_DEVICE
from ..nn.layer.common import Dropout, Embedding, Linear
from ..nn.layer_base import Layer
from .bert import (BertConfig, BertEmbeddings, BertLMHead, BertModel,
                   BertPretrainingCriterion, _generator)

__all__ = ["ErnieConfig", "ernie_base_config", "ernie_large_config",
           "ErnieEmbeddings", "ErnieModel", "ErnieForPretraining",
           "ErniePretrainingCriterion", "ErnieForSequenceClassification"]


class ErnieConfig(BertConfig):
    def __init__(self, vocab_size=18000, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 hidden_act="relu", task_type_vocab_size=3, use_task_id=True,
                 **kw):
        super().__init__(vocab_size=vocab_size, hidden_size=hidden_size,
                         num_hidden_layers=num_hidden_layers,
                         num_attention_heads=num_attention_heads,
                         intermediate_size=intermediate_size,
                         hidden_act=hidden_act, **kw)
        self.task_type_vocab_size = task_type_vocab_size
        self.use_task_id = use_task_id


def ernie_base_config(**kw):
    return ErnieConfig(**kw)


def ernie_large_config(**kw):
    base = dict(hidden_size=1024, num_hidden_layers=24,
                num_attention_heads=16, intermediate_size=4096)
    base.update(kw)
    return ErnieConfig(**base)


class ErnieEmbeddings(BertEmbeddings):
    def __init__(self, cfg: ErnieConfig, *, device=None, generator=None):
        super().__init__(cfg, device=device, generator=generator)
        if cfg.use_task_id:
            self.task_type_embeddings = Embedding(
                cfg.task_type_vocab_size, cfg.hidden_size,
                std=cfg.initializer_range, device=device, generator=generator)
        self.use_task_id = cfg.use_task_id

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                task_type_ids=None):
        emb = self._sum_embeddings(input_ids, token_type_ids, position_ids)
        if self.use_task_id:
            if task_type_ids is None:
                task_type_ids = torch.zeros_like(input_ids)
            emb = emb + self.task_type_embeddings(task_type_ids)
        return self.dropout(self.layer_norm(emb))


class ErnieModel(BertModel):
    def __init__(self, cfg: ErnieConfig = None, device=DEFAULT_DEVICE,
                 seed: int = 0, **kw):
        super().__init__(cfg or ErnieConfig(**kw), device=device, seed=seed)

    def _make_embeddings(self, cfg, device, generator):
        return ErnieEmbeddings(cfg, device=device, generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        h = self.embeddings(input_ids, token_type_ids, position_ids,
                            task_type_ids)
        return self._encode(h, attention_mask, input_ids)


class ErnieForPretraining(Layer):
    def __init__(self, cfg: ErnieConfig = None, device=DEFAULT_DEVICE,
                 seed: int = 0, **kw):
        super().__init__()
        self.ernie = ErnieModel(cfg, device=device, seed=seed, **kw)
        cfg = self.ernie.config
        dev = self.ernie.device
        gen = _generator(dev, seed + 1)
        self.cls = BertLMHead(cfg,
                              self.ernie.embeddings.word_embeddings.weight,
                              device=dev, generator=gen)
        # Linear's own default init, as the reference's
        self.nsp = Linear(cfg.hidden_size, 2, device=dev, generator=gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        seq_out, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                                     attention_mask, task_type_ids)
        return self.cls(seq_out), self.nsp(pooled)


ErniePretrainingCriterion = BertPretrainingCriterion


class ErnieForSequenceClassification(Layer):
    def __init__(self, cfg: ErnieConfig = None, num_classes=2,
                 device=DEFAULT_DEVICE, seed: int = 0, **kw):
        super().__init__()
        self.ernie = ErnieModel(cfg, device=device, seed=seed, **kw)
        cfg = self.ernie.config
        dev = self.ernie.device
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.classifier = Linear(cfg.hidden_size, num_classes, device=dev,
                                 generator=_generator(dev, seed + 1))

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                               attention_mask)
        return self.classifier(self.dropout(pooled))
