"""Tensor-parallel collectives of a rank-local model (the serving engine
under ``mesh=``; counterpart of what GSPMD makes of the reference's
Megatron layout, ``parallel.sharding.tp_spec``).

A ``TensorParallel`` is this rank's line along the mesh's ``tp`` axis:
its group, size and coordinate.  ``all_reduce`` sums the row-parallel
partial products (out proj, ffn_out, the masked embedding rows);
``all_gather`` puts the column blocks back together (the vocabulary-
sharded logits, a replicated linear's input).  ``block`` cuts a whole
tensor to this rank's block of its spec: the contiguous block along the
sharded dimension, except the fused qkv (weight and bias), whose block
is this rank's heads of q, k and v (``qkv_heads``): the layout that lets
each rank attend over its own heads without a collective.  Without a
group (one rank outside a started world) every collective is the
identity.
"""
from __future__ import annotations

import re

import torch
import torch.distributed as dist

__all__ = ["TensorParallel", "QKV"]

QKV = re.compile(r"(^|\.)qkv\.(weight|bias)$")


class TensorParallel:
    def __init__(self, mesh, axis: str = "tp"):
        self.group = mesh.group(axis)
        self.n = int(mesh.shape.get(axis, 1))
        self.rank = int(mesh.coord(axis))

    def all_reduce(self, x):
        """The sum of ``x`` over the group (in place when ``x`` is
        contiguous)."""
        if self.group is None:
            return x
        x = x.contiguous()
        dist.all_reduce(x, group=self.group)
        return x

    def all_gather(self, x, dim: int = -1):
        """The ranks' ``x`` concatenated along ``dim`` in rank order."""
        if self.group is None:
            return x
        dim = dim % x.dim()
        xt = x.movedim(dim, 0).contiguous()
        out = torch.empty((self.n * xt.shape[0],) + tuple(xt.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, xt, group=self.group)
        return out.movedim(0, dim)

    def block(self, name: str, whole, spec, heads: int = 0):
        """This rank's block of the whole tensor ``whole`` under ``spec``
        (``heads``: the fused qkv's head count)."""
        if QKV.search(name):
            return qkv_heads(whole, heads, self.rank, self.n)
        for d, e in enumerate(tuple(spec)[:whole.dim()]):
            if e == "tp":
                size = whole.shape[d] // self.n
                whole = whole.narrow(d, self.rank * size, size)
        return whole.contiguous()

    def gather_qkv_bias(self, b, heads: int):
        """The whole fused qkv bias from the ranks' head blocks."""
        g = self.all_gather(b[None], dim=0)                  # (n, 3*hl*d)
        d = b.shape[0] // 3 // (heads // self.n)
        return g.reshape(self.n, 3, heads // self.n, d).transpose(
            0, 1).reshape(-1)


def qkv_heads(whole, heads: int, rank: int, n: int):
    """Rank ``rank``'s heads of q, k and v from the fused qkv weight
    (in, 3 * heads * d) or bias (3 * heads * d,): (in, 3 * heads/n * d)."""
    lead = tuple(whole.shape[:-1])
    d = whole.shape[-1] // 3 // heads
    hl = heads // n
    t = whole.reshape(lead + (3, heads, d))
    return t[..., rank * hl:(rank + 1) * hl, :].reshape(
        lead + (3 * hl * d,)).contiguous()
