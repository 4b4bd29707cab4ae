"""Deduped gathers and the per-shard row update of giant embedding tables
(counterpart of paddle_tpu/embedding/functional.py).

Every shape is static and nothing is read on the host, so a training step
that runs these is captured as one CUDA graph: the dedup keeps full
lookup-count buffers with the out-of-range sentinel ``height`` in the
slots past the unique ids (``optimizer.sparse.merge_rows``' convention).

A row-sharded table (``embedding.ShardedEmbedding``) keeps on each rank of
the mesh axis only its rows ``[c * n, (c + 1) * n)`` (``c`` the rank's
coordinate): ``psum_gather`` has each rank gather the ids it owns, zero
the rest and all-reduce, which is bit-identical to a single-device gather
(one owner's row plus exact zeros); ``sharded_lazy_row_update`` rebases
the global ids into the rank's range (foreign ids become the local
sentinel, whose slots the lazy update drops) and runs the single-device
``lazy_row_update`` on the rank's rows and moments.  Rebasing is monotone
and the argsort stable, so each row's gradient is summed from the same
values in the same order as on one device.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.selected_rows import RowSparseGrad

__all__ = ["dedup_ids", "dedup_gather", "psum_gather",
           "sharded_lazy_row_update", "ctx_sharded_lookup",
           "sharded_lookup", "row_range", "local_grad"]


def dedup_ids(flat_ids, height: int):
    """Static-shape dedup of (n,) lookup ids: (uids, inv, n_unique) with
    uids (n,) int32 the unique ids ascending in the leading slots and
    ``height`` in the rest, inv (n,) int32 each lookup's slot, n_unique a
    0-dim tensor.  ``w[uids][inv] == w[flat_ids]`` exactly."""
    ids = flat_ids.reshape(-1).long()
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sr = ids[order]
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = sr[1:] != sr[:-1]
    seg = torch.cumsum(first, 0) - 1
    inv = torch.empty_like(seg).scatter_(0, order, seg)
    # every write into one slot carries the same id
    uids = torch.full((n,), height, dtype=torch.long,
                      device=ids.device).scatter_(0, seg, sr)
    n_unique = seg[-1] + 1 if n else torch.zeros((), dtype=torch.long)
    return uids.to(torch.int32), inv.to(torch.int32), n_unique


def dedup_gather(w, flat_ids):
    """``w[flat_ids]`` reading each live row once: (out (n, width), uids,
    inv)."""
    height = w.shape[0]
    uids, inv, _ = dedup_ids(flat_ids, height)
    rows = w[uids.long().clamp(0, height - 1)]
    return rows[inv.long()], uids, inv


def row_range(mesh, axis: str, local_rows: int):
    """(start, n) of this rank's rows of a table sharded over ``axis``."""
    c = mesh.coord(axis) if mesh is not None else 0
    return c * local_rows, local_rows


def _group(mesh, axis):
    """The axis's group (a started world of one has one), or None."""
    return None if mesh is None else mesh.group(axis)


def psum_gather(w, uids, axis: str, mesh):
    """Row-sharded gather: ``w`` is this rank's (n, width) block; each
    rank gathers the ids it owns, zeroes the rest, and an all-reduce over
    ``axis`` assembles (len(uids), width), bit-identical to a single-device
    gather.  The traffic is the lookups' rows, never the table."""
    n = w.shape[0]
    start, _ = row_range(mesh, axis, n)
    lids = uids.long() - start
    mine = (lids >= 0) & (lids < n)
    rows = w[lids.clamp(0, n - 1)]
    rows = torch.where(mine[:, None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    group = _group(mesh, axis)
    if group is not None:
        dist.all_reduce(rows, group=group)
    return rows


def local_grad(grad: RowSparseGrad, local_rows: int, axis: str, mesh
               ) -> RowSparseGrad:
    """The global-id gradient of a row-sharded table rebased to this
    rank's rows; foreign lookups get the local sentinel ``local_rows``."""
    start, _ = row_range(mesh, axis, local_rows)
    lids = grad.rows.long() - start
    mine = (lids >= 0) & (lids < local_rows)
    lids = torch.where(mine, lids, torch.full_like(lids, local_rows))
    return RowSparseGrad(lids.to(torch.int32), grad.values,
                         (local_rows,) + tuple(grad.shape[1:]))


def sharded_lazy_row_update(optimizer, p, grad: RowSparseGrad, state, lr,
                            step_no, axis: str, mesh,
                            decay_flag: bool = True, lr_mult: float = 1.0):
    """The lazy row update of this rank's block ``p`` (and its moments
    ``state``) from the global-id gradient ``grad``: (new_p, new_state),
    only the rank's looked-up rows moved."""
    from ..optimizer.sparse import lazy_row_update
    g = local_grad(grad, p.shape[0], axis, mesh)
    return lazy_row_update(optimizer, p, g, state, lr, step_no, decay_flag,
                           lr_mult)


# ---------------------------------------------------------------------------
# the lookup (TrainStep's sparse-gradient channel, eager, inference)


def _note_lookup_stats(flat):
    """Host-side dedup counters, for CPU ids only (a card's ids would
    cost a host read; the host-table pipeline counts its own)."""
    if flat.device.type != "cpu":
        return
    from ..utils.monitor import stat_add
    stat_add("STAT_embedding_rows_gathered", int(flat.numel()))
    stat_add("STAT_embedding_rows_unique", int(torch.unique(flat).numel()))


def _pad(out, ids, padding_idx):
    if padding_idx is None:
        return out
    return torch.where((ids == padding_idx)[..., None],
                       torch.zeros((), dtype=out.dtype, device=out.device),
                       out)


def _gather(weight, ids):
    """Deduped rows of the (global) ``ids``, shape ids.shape + (width,)."""
    mesh, axis = getattr(weight, "row_shard", (None, "tp"))
    height = weight.shape[0] * (mesh.shape.get(axis, 1) if mesh else 1)
    flat = ids.reshape(-1)
    uids, inv, _ = dedup_ids(flat, height)
    rows = psum_gather(weight.detach(), uids.long().clamp(0, height - 1),
                       axis, mesh)
    return rows[inv.long()].reshape(tuple(ids.shape) + (weight.shape[1],))


class _ShardedLookup(torch.autograd.Function):
    """Eager lookup: the weight's gradient is a sparse COO tensor of the
    rank's looked-up rows (local ids; foreign lookups dropped on the
    host, which an eager step may read)."""

    @staticmethod
    def forward(ctx, weight, ids, padding_idx):
        ctx.save_for_backward(ids)
        ctx.shape, ctx.pad = weight.shape, padding_idx
        ctx.shard = getattr(weight, "row_shard", (None, "tp"))
        return _pad(_gather(weight, ids), ids, padding_idx)

    @staticmethod
    def backward(ctx, ct):
        (ids,) = ctx.saved_tensors
        mesh, axis = ctx.shard
        n, width = ctx.shape
        start, _ = row_range(mesh, axis, n)
        flat = ids.reshape(-1).long()
        vals = _pad(ct.reshape(-1, width), flat, ctx.pad)
        keep = ((flat >= start) & (flat < start + n)).nonzero().reshape(-1)
        g = torch.sparse_coo_tensor((flat[keep] - start)[None], vals[keep],
                                    (n, width))
        return g, None, None


def ctx_sharded_lookup(ctx, x, weight, padding_idx=None):
    """The lookup inside a TrainStep collecting sparse gradients: the
    deduped (all-reduced) rows plus the lookup's zero leaf, whose gradient
    is the per-lookup gradient, as ``selected_rows.ctx_embedding``'s."""
    ids = x.long()
    key = ctx.key_for(ctx.name_of(weight))
    out = _gather(weight, ids)
    if ctx.mode == "record":
        ctx.specs[key] = (ids.numel(), weight.shape[1], weight.dtype)
    else:
        ctx.ids[key] = ids.reshape(-1)
        out = out + ctx.zeros[key].reshape(out.shape)
    return _pad(out, ids, padding_idx)


def sharded_lookup(x, weight, padding_idx=None):
    """``F.embedding`` for a ``ShardedEmbedding`` weight: through the
    TrainStep sparse-gradient context when one is active (the rows of the
    deduped, all-reduced gather plus the lookup's zero leaf, whose
    gradient is the per-lookup gradient), else the eager path (a sparse
    COO gradient of the rank's rows), else a plain deduped gather."""
    from ..core import selected_rows as sr
    from ..core.errors import InvalidArgumentError
    ids = x.long()
    ctx = sr.current_ctx()
    if ctx is not None:
        name = ctx.name_of(weight)
        if not ctx.wants(name):
            raise InvalidArgumentError(
                f"ShardedEmbedding weight {name!r} is consumed outside its "
                "lookup: a row-sharded table has no dense gradient")
        return ctx_sharded_lookup(ctx, ids, weight, padding_idx)
    _note_lookup_stats(ids.reshape(-1))
    if torch.is_grad_enabled() and weight.requires_grad:
        return _ShardedLookup.apply(weight, ids, padding_idx)
    return _pad(_gather(weight, ids), ids, padding_idx)
