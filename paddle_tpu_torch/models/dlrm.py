"""DLRM-style click-through model (port of paddle_tpu/models/dlrm.py).

A dense bottom MLP, one embedding lookup per sparse feature, the pairwise
dot interaction and a top MLP (Naumov et al.).  One concatenated table
holds every feature's vocabulary (per-feature id offsets into it), the
reference's layout, so the table is one parameter of ``total_rows`` rows.

- ``embedding="sparse"``: ``Embedding(sparse=True)``, a single-device
  table with row-sparse gradients and the lazy row update (the
  reference's parity oracle);
- ``embedding="dense"``: ``Embedding(sparse=False)``, dense gradients
  (the only mode that composes with ``TrainStep(accum_steps>1)``);
- ``embedding="sharded"``: ``embedding.ShardedEmbedding``, the table's
  rows split over ``axis`` of ``mesh``, the lazy update on each rank's
  rows (``jit.TrainStep`` runs the whole batch on every rank);
- ``embedding="external"``: no table: ``forward(dense_x, rows)`` takes
  the pre-gathered (B, F, D) rows (``embedding.HostEmbeddingTable`` /
  ``HostPrefetchPipeline`` / ``HostTableTrainStep``, ``RecsysPredictor``).

State names are the reference's (``bottom.*``, ``table.weight``,
``top.*``), so ``load_paddle_state`` carries its weights across.  The constructor takes
``device`` (default ``"cuda"``; raises without a card) and ``seed`` for
the weight draw.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..nn import functional as F
from ..nn.layer.activation import ReLU
from ..nn.layer.common import Embedding, Linear
from ..nn.layer.container import Sequential
from ..nn.layer_base import Layer

__all__ = ["DLRMConfig", "DLRM", "DLRMCriterion", "dlrm_tiny_config"]


class DLRMConfig:
    def __init__(self, dense_dim: int = 4,
                 vocab_sizes: Sequence[int] = (64, 64, 64, 64),
                 embedding_dim: int = 8,
                 bottom_mlp: Sequence[int] = (16,),
                 top_mlp: Sequence[int] = (16,)):
        self.dense_dim = int(dense_dim)
        self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
        self.embedding_dim = int(embedding_dim)
        self.bottom_mlp = tuple(int(h) for h in bottom_mlp)
        self.top_mlp = tuple(int(h) for h in top_mlp)

    @property
    def num_features(self) -> int:
        return len(self.vocab_sizes)

    @property
    def total_rows(self) -> int:
        return sum(self.vocab_sizes)

    @property
    def offsets(self) -> np.ndarray:
        """Per-feature row offsets into the concatenated table."""
        return np.concatenate(
            [[0], np.cumsum(self.vocab_sizes[:-1])]).astype(np.int64)


def _mlp(sizes, device=None, generator=None):
    layers = []
    for i in range(len(sizes) - 1):
        layers.append(Linear(sizes[i], sizes[i + 1], device=device,
                             generator=generator))
        if i < len(sizes) - 2:
            layers.append(ReLU())
    return Sequential(*layers)


class DLRM(Layer):
    """forward(dense_x (B, dense_dim) float, sparse (B, F) int ids, or
    the (B, F, D) rows for ``embedding="external"``) -> logits (B, 1)."""

    def __init__(self, config: DLRMConfig, embedding: str = "sparse",
                 mesh=None, axis: str = "tp", *, device=DEFAULT_DEVICE,
                 seed: int = 0):
        super().__init__()
        if embedding not in ("sparse", "dense", "sharded", "external"):
            raise ValueError(
                f"DLRM: unknown embedding mode {embedding!r}; expected "
                "'sparse', 'dense', 'sharded' or 'external'")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        self.config = config
        self.embedding_mode = embedding
        d = config.embedding_dim
        self.bottom = _mlp((config.dense_dim,) + config.bottom_mlp + (d,),
                           dev, gen)
        if embedding == "external":
            self.table = None
        elif embedding == "sharded":
            from ..embedding import ShardedEmbedding
            self.table = ShardedEmbedding(config.total_rows, d, mesh=mesh,
                                          axis=axis, device=dev,
                                          generator=gen)
        else:
            self.table = Embedding(config.total_rows, d,
                                   sparse=(embedding == "sparse"),
                                   device=dev, generator=gen)
        # pairwise dots over the F embeddings and the bottom output; the
        # concatenated [bottom, upper-triangle dots] feeds the top
        self._n_vec = config.num_features + 1
        iu, ju = np.triu_indices(self._n_vec, k=1)
        self.register_buffer(
            "_pair_idx", torch.from_numpy(iu * self._n_vec + ju).to(dev),
            persistent=False)
        self.register_buffer(
            "_offsets", torch.from_numpy(config.offsets).to(dev)[None],
            persistent=False)
        self.top = _mlp((d + len(iu),) + config.top_mlp + (1,), dev, gen)

    def forward(self, dense_x, sparse):
        """``sparse``: (B, F) ids, or the (B, F, D) rows when external."""
        b = self.bottom(dense_x)                          # (B, D)
        if self.table is None:
            emb = sparse.to(b.dtype)                      # pre-gathered
        else:
            emb = self.table(sparse + self._offsets)      # (B, F, D)
        z = torch.cat([b[:, None], emb], dim=1)           # (B, F+1, D)
        dots = torch.bmm(z, z.transpose(1, 2))            # (B, F+1, F+1)
        inter = dots.reshape(-1, self._n_vec * self._n_vec)[:, self._pair_idx]
        return self.top(torch.cat([b, inter], dim=1))


class DLRMCriterion(Layer):
    """Click-through loss: mean sigmoid BCE over the (B, 1) logits."""

    def forward(self, logits, label):
        return F.binary_cross_entropy_with_logits(
            logits, label.to(logits.dtype).reshape(logits.shape))


def dlrm_tiny_config() -> DLRMConfig:
    """The reference's test config."""
    return DLRMConfig(dense_dim=4, vocab_sizes=(64, 64, 64, 64),
                      embedding_dim=8, bottom_mlp=(16,), top_mlp=(16,))
