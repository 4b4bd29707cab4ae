"""Collectives (counterpart of paddle_tpu/distributed/collective.py).

The reference's collectives are XLA ops inside an SPMD region over a mesh
axis, and the identity in its eager "world of one".  The port's run on a
``torch.distributed`` process group:

- ``group=`` when given; else, with a mesh set (``parallel.set_mesh``),
  the group of the mesh axis ``axis_name``; else the started world; with
  none of these (nothing started, or an axis of size 1 in a larger
  world), the call is the identity, as the reference's eager path.
- A group that is set up is used even when it has one rank: a one-card
  run launches the backend's collective (NCCL on the card).
- Ranks named by a collective (``src``, ``dst``, ``pairs``) are indices
  along the group, as the reference's are indices along the mesh axis.
- ``ReduceOp.PROD`` keeps the reference's sign parity and zero handling:
  ``exp(sum log|x|)`` with the sign from the count of negatives and zero
  where any rank holds a zero.
- ``all_reduce``, ``broadcast``, ``scatter`` and ``reduce_scatter`` write
  their result into ``tensor`` (in place, as Paddle's do) and return it;
  ``all_gather`` extends ``tensor_list`` and returns the parts concatenated
  on axis 0.  ``reduce`` leaves the result on every rank, as the
  reference's SPMD form does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["ReduceOp", "all_reduce", "all_gather", "broadcast", "reduce",
           "scatter", "reduce_scatter", "alltoall", "send", "recv", "p2p",
           "ppermute", "barrier", "get_rank_in_spmd", "get_world_size_in_spmd"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
              "min": dist.ReduceOp.MIN}


def _started() -> bool:
    return dist.is_available() and dist.is_initialized()


def _resolve(group=None, axis_name="dp"):
    """The process group a collective runs on, or None (identity)."""
    if group is not None:
        return group
    from ..parallel.mesh import get_mesh
    mesh = get_mesh()
    if mesh is not None:
        return mesh.group(axis_name)
    return dist.group.WORLD if _started() else None


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _global(group, i: int) -> int:
    return dist.get_global_rank(group, int(i))


def _sum(x, group):
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _reduce(x, op, group):
    """The reduction of ``x`` over ``group`` (a new tensor)."""
    op = str(op).lower()
    if op in _TORCH_OPS:
        out = x.clone()
        dist.all_reduce(out, op=_TORCH_OPS[op], group=group)
        return out
    if op == "avg":
        out = _sum(x.clone(), group)
        return out / _group_size(group) if out.is_floating_point() else \
            out // _group_size(group)
    if op == "prod":
        absx = x.abs()
        zero = absx == 0
        logsum = _sum(torch.where(zero, torch.zeros_like(absx), torch.log(
            torch.where(zero, torch.ones_like(absx), absx))).float(), group)
        n_neg = _sum((x < 0).to(torch.int32), group)
        any_zero = zero.to(torch.int32)
        dist.all_reduce(any_zero, op=dist.ReduceOp.MAX, group=group)
        sign = 1.0 - 2.0 * (n_neg % 2).to(logsum.dtype)
        return torch.where(any_zero > 0, torch.zeros_like(logsum),
                           sign * torch.exp(logsum)).to(x.dtype)
    raise ValueError(f"unknown reduce op {op!r}")


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               axis_name="dp"):
    """The reduction over the group, written into ``tensor``."""
    g = _resolve(group, axis_name)
    if g is None:
        return tensor
    with torch.no_grad():
        tensor.copy_(_reduce(tensor.detach(), op, g))
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True,
               axis_name="dp"):
    """Every rank's ``tensor``, in group order: appended to
    ``tensor_list`` and returned concatenated on axis 0."""
    g = _resolve(group, axis_name)
    if g is None:
        parts = [tensor]
    else:
        parts = [torch.empty_like(tensor) for _ in range(_group_size(g))]
        dist.all_gather(parts, tensor.contiguous(), group=g)
    if tensor_list is not None:
        tensor_list.extend(parts)
    return torch.cat([p.reshape((-1,) + tuple(p.shape[1:])) if p.dim()
                      else p.reshape(1) for p in parts], dim=0)


def broadcast(tensor, src=0, group=None, sync_op=True, axis_name="dp"):
    """``tensor`` of the group's rank ``src``, written into ``tensor``."""
    g = _resolve(group, axis_name)
    if g is not None:
        with torch.no_grad():
            buf = tensor.detach().contiguous()
            dist.broadcast(buf, src=_global(g, src), group=g)
            if buf.data_ptr() != tensor.data_ptr():
                tensor.copy_(buf)
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True,
           axis_name="dp"):
    """As the reference's SPMD form: every rank holds the result."""
    return all_reduce(tensor, op=op, group=group, axis_name=axis_name)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True,
            axis_name="dp"):
    """Rank i of the group gets ``tensor_list[i]`` of rank ``src``."""
    g = _resolve(group, axis_name)
    if g is None:
        src_t = tensor_list[0] if tensor_list else tensor
        with torch.no_grad():
            if tensor is not None and src_t is not tensor:
                tensor.copy_(src_t)
        return tensor if tensor is not None else src_t
    me = _group_rank(g)
    out = tensor if tensor is not None else torch.empty_like(tensor_list[0])
    buf = torch.empty_like(out).contiguous()
    dist.scatter(buf, [t.contiguous() for t in tensor_list]
                 if me == src else None, src=_global(g, src), group=g)
    with torch.no_grad():
        out.copy_(buf)
    return out


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group=None, sync_op=True, axis_name="dp"):
    """The sum over the group, split on axis 0: rank i keeps part i."""
    inp = tensor_or_tensor_list
    if isinstance(inp, (list, tuple)):
        inp = torch.cat(list(inp), dim=0)
    g = _resolve(group, axis_name)
    if g is None:
        out = inp
    else:
        n = _group_size(g)
        out = torch.empty((inp.shape[0] // n,) + tuple(inp.shape[1:]),
                          dtype=inp.dtype, device=inp.device)
        dist.reduce_scatter_tensor(out, inp.contiguous(),
                                   op=_TORCH_OPS[str(op).lower()], group=g)
    if tensor is not None:
        with torch.no_grad():
            tensor.copy_(out)
        return tensor
    return out


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True,
             axis_name="dp"):
    """Rank r sends ``in_tensor_list[i]`` to rank i and receives rank i's
    ``in_tensor_list[r]`` as its part i."""
    stacked = torch.stack(list(in_tensor_list))
    g = _resolve(group, axis_name)
    if g is None:
        out = stacked
    else:
        out = torch.empty_like(stacked)
        dist.all_to_all_single(out, stacked.contiguous(), group=g)
    parts = list(out.unbind(0))
    if out_tensor_list is not None:
        out_tensor_list.extend(parts)
    return parts


def send(tensor, dst=0, group=None, sync_op=True, axis_name="dp"):
    """Point-to-point send to the group's rank ``dst`` (one process per
    rank makes an absolute-rank send well defined, where the reference's
    SPMD region refuses it).  The identity without a group."""
    g = _resolve(group, axis_name)
    if g is not None:
        dist.send(tensor.contiguous(), dst=_global(g, dst), group=g)
    return tensor


def recv(tensor, src=0, group=None, sync_op=True, axis_name="dp"):
    """Point-to-point receive from the group's rank ``src`` into
    ``tensor``."""
    g = _resolve(group, axis_name)
    if g is not None:
        buf = tensor.detach().contiguous()
        dist.recv(buf, src=_global(g, src), group=g)
        if buf.data_ptr() != tensor.data_ptr():
            with torch.no_grad():
                tensor.copy_(buf)
    return tensor


def _exchange(tensor, pairs, g):
    """Each (src, dst): src's ``tensor`` lands on dst; a rank that is no
    dst gets zeros (``lax.ppermute`` semantics)."""
    me = _group_rank(g)
    x = tensor.detach().contiguous()
    out = torch.zeros_like(x)
    ops = []
    for s, d in pairs:
        if s == d:
            if me == s:
                out.copy_(x)
            continue
        if me == s:
            ops.append(dist.P2POp(dist.isend, x, _global(g, d), group=g))
        if me == d:
            ops.append(dist.P2POp(dist.irecv, out, _global(g, s), group=g))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out


def p2p(tensor, pairs, axis_name="dp"):
    """Explicit permutation: for every (src, dst) in ``pairs`` rank src's
    tensor goes to rank dst; ranks named as no dst receive zeros."""
    g = _resolve(None, axis_name)
    if g is None:
        return tensor
    return _exchange(tensor, list(pairs), g)


def ppermute(tensor, perm=None, shift=1, axis_name="dp"):
    """Ring shift: rank i -> rank (i + shift) % n (or ``perm``'s pairs)."""
    g = _resolve(None, axis_name)
    if g is None:
        return tensor
    n = _group_size(g)
    if perm is None:
        perm = [(i, (i + shift) % n) for i in range(n)]
    return _exchange(tensor, list(perm), g)


def barrier(group=None, axis_name="dp"):
    g = _resolve(group, axis_name)
    if g is not None:
        dist.barrier(group=g)


def get_rank_in_spmd(axis_name="dp"):
    """This rank's index along the mesh axis (0 without a mesh)."""
    from ..parallel.mesh import get_mesh
    mesh = get_mesh()
    return 0 if mesh is None else mesh.coord(axis_name)


def get_world_size_in_spmd(axis_name="dp"):
    from ..parallel.mesh import get_mesh
    mesh = get_mesh()
    return 1 if mesh is None else mesh.shape.get(axis_name, 1)
