"""Parameter-sharding rules (counterpart of paddle_tpu/parallel/sharding.py):
Megatron-style tensor-parallel layouts, expert-parallel layouts and ZeRO /
FSDP, as ``PartitionSpec``s, with the reference's name patterns and the
same first-match order.

Linear weights are (in_features, out_features), Paddle's layout, so:
column-parallel (split output) is ``P(None, "tp")`` (qkv / ffn_in),
row-parallel (split input) ``P("tp", None)`` (out proj / ffn_out) and
embeddings ``P("tp", None)`` (vocabulary rows).

In the port a spec is a layout: ``parallel.ShardedTrainStep`` keeps each
rank's block of a sharded tensor between steps and gathers the whole
tensor where it is used (module docstring of ``parallel``).
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Optional

from .mesh import Mesh, NamedSharding, P

__all__ = ["row_spec", "ep_spec", "tp_spec", "apply_fsdp", "param_specs",
           "shardings_of", "state_sharding_like"]

_COL_W = re.compile(
    r"(qkv|ffn_in|linear1|q_proj|k_proj|v_proj)\.weight$")
_COL_B = re.compile(
    r"(qkv|ffn_in|linear1|q_proj|k_proj|v_proj)\.bias$")
_ROW_W = re.compile(
    r"(\bout\b|proj|ffn_out|linear2|out_proj)\.weight$")
_EMB_W = re.compile(r"(word|position|token_type|task_type)_embeddings\.weight$")
_EXPERT = re.compile(r"experts?_(w1|b1|w2|b2)$|\.experts\.")


def row_spec(axis: str, ndim: int = 2) -> P:
    """The leading dim over ``axis``, the rest replicated."""
    return P(*((axis,) + (None,) * (ndim - 1)))


def ep_spec(name: str, shape) -> Optional[P]:
    """Expert-parallel spec: the leading (expert) dim over ``ep``."""
    if _EXPERT.search(name) and len(shape) >= 1:
        return P(*(("ep",) + (None,) * (len(shape) - 1)))
    return None


def tp_spec(name: str, shape) -> Optional[P]:
    """Tensor-parallel spec for a parameter, or None (replicated)."""
    if _COL_W.search(name) and len(shape) == 2:
        return P(None, "tp")
    if _COL_B.search(name) and len(shape) == 1:
        return P("tp")
    if _ROW_W.search(name) and len(shape) == 2:
        return P("tp", None)
    if _EMB_W.search(name) and len(shape) == 2:
        return P("tp", None)
    return None


def _divisible(dim: int, mesh: Mesh, axis: str) -> bool:
    n = mesh.shape.get(axis, 1)
    return n > 1 and dim % n == 0


def apply_fsdp(spec: Optional[P], shape, mesh: Mesh, axis: str = "dp"
               ) -> Optional[P]:
    """Also shard the largest free dim that ``axis`` divides (ZeRO-3):
    ``P(None, "tp")`` on (H, 3H) gives ``P("dp", "tp")``, None on (V, H)
    ``P("dp", None)``; with no such dim, ``spec`` unchanged."""
    entries = list(spec) if spec is not None else [None] * len(shape)
    while len(entries) < len(shape):
        entries.append(None)
    best, best_dim = -1, -1
    for i, (e, d) in enumerate(zip(entries, shape)):
        if e is None and _divisible(d, mesh, axis) and d > best_dim:
            best, best_dim = i, d
    if best < 0:
        return spec
    entries[best] = axis
    return P(*entries)


def param_specs(names_shapes: Dict[str, tuple], mesh: Mesh,
                tensor_parallel: bool = False, fsdp: bool = False,
                custom_rule: Optional[Callable] = None,
                expert_parallel: bool = False) -> Dict[str, P]:
    """A spec per parameter name: the custom rule, then expert-parallel,
    then tensor-parallel (each only where its dims divide), then FSDP."""
    specs = {}
    for name, shape in names_shapes.items():
        spec = None
        if custom_rule is not None:
            spec = custom_rule(name, shape)
        if spec is None and expert_parallel and mesh.shape.get("ep", 1) > 1:
            spec = ep_spec(name, shape)
            if spec is not None and not _divisible(shape[0], mesh, "ep"):
                spec = None
        if spec is None and tensor_parallel and mesh.shape.get("tp", 1) > 1:
            spec = tp_spec(name, shape)
            if spec is not None:
                ok = all(e is None or _divisible(d, mesh, e)
                         for e, d in zip(tuple(spec) + (None,) * len(shape),
                                         shape))
                if not ok:
                    spec = None
        if fsdp:
            spec = apply_fsdp(spec, shape, mesh)
        specs[name] = spec if spec is not None else P()
    return specs


def shardings_of(specs: Dict[str, P], mesh: Mesh
                 ) -> Dict[str, NamedSharding]:
    return {k: NamedSharding(mesh, v) for k, v in specs.items()}


def state_sharding_like(param_shape, param_sharding: NamedSharding, leaf
                        ) -> NamedSharding:
    """An optimizer-state leaf takes its parameter's sharding when the
    shapes match (the moments), else it is replicated (0-dim counters)."""
    if hasattr(leaf, "shape") and tuple(leaf.shape) == tuple(param_shape):
        return param_sharding
    return NamedSharding(param_sharding.mesh, P())
