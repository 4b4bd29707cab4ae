"""Mesh-based parallelism on ``torch.distributed`` (counterpart of
paddle_tpu/parallel/).

**The model of execution.** The reference is single-controller: one
process sees every device, ``step(*batch)`` takes the global batch, and
GSPMD makes every op compute what the single-device op would.  The port
runs one process per rank (``distributed.spawn`` / ``launch``; NCCL on
the card, gloo on the CPU), and keeps the reference's meaning of a call:

- Every rank is handed the same global batch and keeps its own rows by
  its mesh coordinate: axis 0 over ``dp``.  Under sequence parallelism
  the ranks of one ``sp`` group compute on the whole sequence (the
  sequence is split by ``ops.ring_attention``, not by the step).
- Whatever a step returns is the global value: the loss is the mean over
  ``dp`` of the ranks' means.
- Gradients are averaged over ``dp``.  That is the reference's gradient
  for a loss that is a mean over equal shards; for a sum loss or a masked
  mean it differs by the shard counts, as the reference's explicit path
  (``fp16_allreduce``) does.
- Every training BatchNorm inside ``ShardedTrainStep`` takes its batch
  statistics over ``dp`` (the global batch's, as GSPMD computes them),
  fused kernels included; the running statistics stay frozen, as the
  reference's sharded step leaves them.
- A tensor whose spec shards it is held only as this rank's block between
  steps; the step gathers it whole where it is used (inside the step
  program: on the card the gathered copies live in the captured graph's
  memory pool) and reduce-scatters its gradient.  This keeps the
  reference's layouts and numerics but does not split the compute of a
  tensor-parallel matmul: every ``tp`` rank computes the whole layer.

``create_mesh`` lays the ranks over ``AXES`` with ``dp`` outermost and
keeps one process group per axis (``Mesh.group``).
"""
from .mesh import (AXES, Mesh, NamedSharding, P,  # noqa: F401
                   PartitionSpec, axis_size, create_mesh, get_mesh,
                   replicated, set_mesh, sharding)
from .strategy import (AMPConfig, DistributedStrategy,  # noqa: F401
                       GradientMergeConfig, HybridConfig, RecomputeConfig,
                       ShardingConfig)
from .sharding import (apply_fsdp, param_specs, shardings_of,  # noqa: F401
                       tp_spec)
from .train_step import ShardedTrainStep  # noqa: F401
from .localsgd import LocalSGDTrainStep  # noqa: F401

__all__ = ["create_mesh", "set_mesh", "get_mesh", "axis_size", "sharding",
           "replicated", "AXES", "Mesh", "NamedSharding", "PartitionSpec",
           "P", "DistributedStrategy", "HybridConfig", "ShardingConfig",
           "RecomputeConfig", "AMPConfig", "GradientMergeConfig", "tp_spec",
           "param_specs", "shardings_of", "apply_fsdp", "ShardedTrainStep",
           "LocalSGDTrainStep"]
