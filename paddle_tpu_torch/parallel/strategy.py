"""DistributedStrategy (a copy of paddle_tpu/parallel/strategy.py, which
imports no JAX): the feature flags of Paddle's distributed_strategy.proto
as plain dataclasses.  The flags select the mesh's axis sizes
(``mesh_axes``), the sharding rules and the step's options in
``parallel.train_step``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class HybridConfig:
    """hybrid_configs equivalent: degree per parallelism dimension."""
    dp_degree: int = -1      # -1: fill with remaining devices
    pp_degree: int = 1
    mp_degree: int = 1       # tensor/model parallel ("tp" axis)
    sp_degree: int = 1       # sequence/context parallel ("sp" axis)
    ep_degree: int = 1       # expert parallel ("ep" axis, MoE)


@dataclass
class ShardingConfig:
    """sharding_configs: ZeRO stage (reference sharding_optimizer.py:33)."""
    stage: int = 2           # 1: opt states, 2: +grads, 3: +params (FSDP)
    degree: int = -1         # defaults to dp degree


@dataclass
class RecomputeConfig:
    checkpoints: Optional[list] = None


@dataclass
class AMPConfig:
    dtype: str = "bfloat16"
    level: str = "O1"
    init_loss_scaling: float = 32768.0
    use_dynamic_loss_scaling: bool = True


@dataclass
class GradientMergeConfig:
    k_steps: int = 1
    avg: bool = True


@dataclass
class DistributedStrategy:
    """Reference: python/paddle/distributed/fleet/base/distributed_strategy.py."""
    amp: bool = False
    amp_configs: AMPConfig = field(default_factory=AMPConfig)
    recompute: bool = False
    recompute_configs: RecomputeConfig = field(default_factory=RecomputeConfig)
    sharding: bool = False
    sharding_configs: ShardingConfig = field(default_factory=ShardingConfig)
    pipeline: bool = False
    pp_micro_batches: int = 4
    gradient_merge: bool = False
    gradient_merge_configs: GradientMergeConfig = field(
        default_factory=GradientMergeConfig)
    hybrid_configs: HybridConfig = field(default_factory=HybridConfig)
    tensor_parallel: bool = False
    sequence_parallel: bool = False
    expert_parallel: bool = False
    localsgd: bool = False
    localsgd_configs: Optional[dict] = None
    lars: bool = False
    lamb: bool = False
    dgc: bool = False
    fp16_allreduce: bool = False
    find_unused_parameters: bool = False
    # custom param-sharding rule: fn(name, shape) -> PartitionSpec or None
    sharding_rule: Optional[Callable] = None

    def mesh_axes(self, n_devices: int) -> dict:
        """Resolve axis sizes for create_mesh given the device count."""
        h = self.hybrid_configs
        pp = h.pp_degree if self.pipeline else 1
        tp = h.mp_degree if self.tensor_parallel else 1
        sp = h.sp_degree if self.sequence_parallel else 1
        ep = h.ep_degree if self.expert_parallel else 1
        fixed = pp * tp * sp * ep
        if n_devices % fixed:
            raise ValueError(
                f"pp*ep*tp*sp={fixed} does not divide device count "
                f"{n_devices}")
        dp = h.dp_degree if h.dp_degree > 0 else n_devices // fixed
        if dp * fixed > n_devices:
            raise ValueError(
                f"dp*pp*ep*tp*sp={dp * fixed} exceeds device count "
                f"{n_devices}")
        return {"dp": dp, "pp": pp, "ep": ep, "tp": tp, "sp": sp}
