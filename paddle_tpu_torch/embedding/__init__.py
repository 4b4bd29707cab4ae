"""paddle_tpu_torch.embedding: row-sharded and host-resident embedding
tables (counterpart of paddle_tpu/embedding/).

- ``functional``: the static-shape dedup (``dedup_ids`` / ``dedup_gather``),
  the row-sharded all-reduce gather (``psum_gather``) and the lazy row
  update of a rank's rows (``sharded_lazy_row_update``);
- ``sharded``: ``ShardedEmbedding``, a table whose rows are split over a
  mesh axis, its gradient row-sparse;
- ``host_table``: ``HostEmbeddingTable`` (rows and moments in host RAM),
  ``HostPrefetchPipeline`` (depth-1 async prefetch through pinned
  staging and a side stream, bit-identical to a synchronous fetch) and
  ``HostTableTrainStep`` (one captured step over the dense model and the
  working slab), with bit-exact resume;
- ``serving``: ``RecsysPredictor``, micro-batched deduped scoring behind
  ``inference.Config.enable_recsys_serving``.
"""
from .functional import (dedup_gather, dedup_ids, psum_gather,  # noqa: F401
                         sharded_lazy_row_update, sharded_lookup)
from .host_table import (HostEmbeddingTable, HostPrefetchPipeline,  # noqa: F401
                         HostTableTrainStep, PreparedBatch)
from .serving import RecsysPredictor, RecsysResponse  # noqa: F401
from .sharded import ShardedEmbedding  # noqa: F401

__all__ = [
    "dedup_ids", "dedup_gather", "psum_gather", "sharded_lazy_row_update",
    "sharded_lookup", "ShardedEmbedding", "HostEmbeddingTable",
    "HostPrefetchPipeline", "HostTableTrainStep", "PreparedBatch",
    "RecsysPredictor", "RecsysResponse",
]
