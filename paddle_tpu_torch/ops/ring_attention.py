"""Ring attention: sequence parallelism over the ``sp`` mesh axis
(counterpart of paddle_tpu/ops/ring_attention.py).

``ring_attention(q, k, v, mesh)`` takes the global (batch, seq, heads,
head_dim) arrays, as the reference's does.  Each rank keeps its batch rows
(over ``batch_axis`` when that axis has more than one rank) and its
sequence block (over ``axis_name``); the k / v blocks go around the ring
of ``sp`` ranks by ``batch_isend_irecv`` while each rank accumulates its
queries' attention over the block it holds with the reference's online
softmax (f32, running max from -1e30, the causal mask by global position
at -1e30).  The output is all-gathered back to the global layout.

The backward is a ``torch.autograd.Function`` that runs the ring again:
every rank recomputes its queries' probabilities against each block from
the saved log-sum-exp, adds its dq, and accumulates the block's dk / dv,
which travel with the block and arrive home after the last rotation.
Every rank computes the same global loss from the gathered output, so
each takes its own block of the output's gradient, and the inputs'
gradients are all-gathered back to the global layout as the output is.

This is plain tensor code with collectives: the reference's function
reaches no Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["ring_attention"]


def _gather(x, dim: int, group, n: int):
    """``x``'s blocks from every rank of ``group``, concatenated on
    ``dim``."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _rotate(tensors, group, n: int):
    """Each tensor to the next rank of the ring, the previous rank's in."""
    if group is None or n == 1:
        return tensors
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group=group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, prv, group=group) for o in out]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


def _scores(q, k, me, src, s_local, causal):
    """(b, h, sq, sk) f32 scores of q's block against block ``src``."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k)
    if causal:
        qp = me * s_local + torch.arange(s_local, device=q.device)
        kp = src * s_local + torch.arange(s_local, device=q.device)
        s = torch.where((qp[:, None] >= kp[None, :])[None, None], s,
                        torch.full_like(s, -1e30))
    return s


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, cfg):
        sp_group, n_sp, me, causal, scale = cfg
        s_local = q.shape[1]
        qt = q.transpose(1, 2).float() * scale           # (b, h, sq, d)
        b, h, sq, d = qt.shape
        acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, sq, 1), -1e30, dtype=torch.float32,
                       device=q.device)
        lsum = torch.zeros((b, h, sq, 1), dtype=torch.float32,
                           device=q.device)
        kb, vb = k, v
        for j in range(n_sp):
            src = (me - j) % n_sp
            s = _scores(qt, kb.transpose(1, 2).float(), me, src, s_local,
                        causal)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            lsum = lsum * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bhqk,bhkd->bhqd", p, vb.transpose(1, 2).float())
            m = m_new
            kb, vb = _rotate([kb, vb], sp_group, n_sp)
        lsum = torch.clamp_min(lsum, 1e-30)
        out = acc / lsum
        ctx.save_for_backward(q, k, v, out, m + torch.log(lsum))
        ctx.cfg = cfg
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, gout):
        q, k, v, out, lse = ctx.saved_tensors
        sp_group, n_sp, me, causal, scale = ctx.cfg
        s_local = q.shape[1]
        qt = q.transpose(1, 2).float() * scale
        do = gout.transpose(1, 2).float()
        delta = (do * out).sum(-1, keepdim=True)
        dq = torch.zeros_like(qt)
        kb, vb = k, v
        dk = torch.zeros(k.transpose(1, 2).shape, dtype=torch.float32,
                         device=k.device)
        dv = torch.zeros_like(dk)
        for j in range(n_sp):
            src = (me - j) % n_sp
            kt, vt = kb.transpose(1, 2).float(), vb.transpose(1, 2).float()
            p = torch.exp(_scores(qt, kt, me, src, s_local, causal) - lse)
            dv = dv + torch.einsum("bhqk,bhqd->bhkd", p, do)
            ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, vt) - delta)
            dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kt)
            dk = dk + torch.einsum("bhqk,bhqd->bhkd", ds, qt)
            # the block and its gradients travel on together: after the
            # last rotation each block's dk / dv are back at its owner
            kb, vb, dk, dv = _rotate([kb, vb, dk, dv], sp_group, n_sp)
        dq = (dq * scale).transpose(1, 2).to(q.dtype)
        return (dq, dk.transpose(1, 2).to(k.dtype),
                dv.transpose(1, 2).to(v.dtype), None)


class _Gather(torch.autograd.Function):
    """All-gather on ``dim``; backward: this rank's block of the gradient
    (every rank holds the same global loss)."""

    @staticmethod
    def forward(ctx, x, dim, group, n, me):
        ctx.cfg = (dim, x.shape[dim], me)
        return _gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, size, me = ctx.cfg
        return g.narrow(dim, me * size, size), None, None, None, None


class _Split(torch.autograd.Function):
    """This rank's block on ``dim``; backward: every rank's block of the
    gradient gathered (the inverse of ``_Gather``)."""

    @staticmethod
    def forward(ctx, x, dim, group, n, me):
        ctx.cfg = (dim, group, n)
        size = x.shape[dim] // n
        return x.narrow(dim, me * size, size)

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.cfg
        return _gather(g, dim, group, n), None, None, None, None


def ring_attention(q, k, v, mesh, causal: bool = False,
                   axis_name: str = "sp", batch_axis: Optional[str] = "dp"):
    """Attention of global (batch, seq, heads, head_dim) q / k / v with the
    sequence over ``axis_name`` and the batch over ``batch_axis``; returns
    the global output.  The sequence must divide over the axis."""
    n_sp = mesh.shape[axis_name]
    s = q.shape[1]
    if s % n_sp:
        raise ValueError(f"seq len {s} not divisible by sp={n_sp}")
    sp_group = mesh.group(axis_name)
    me = mesh.coord(axis_name)
    n_b = mesh.shape.get(batch_axis, 1) if batch_axis else 1
    b_group = mesh.group(batch_axis) if n_b > 1 else None
    b_me = mesh.coord(batch_axis) if n_b > 1 else 0
    if q.shape[0] % n_b:
        raise ValueError(f"batch {q.shape[0]} not divisible by "
                         f"{batch_axis}={n_b}")
    ql, kl, vl = (_Split.apply(_Split.apply(t, 0, b_group, n_b, b_me), 1,
                               sp_group, n_sp, me) for t in (q, k, v))
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = _Ring.apply(ql, kl, vl, (sp_group, n_sp, me, bool(causal), scale))
    out = _Gather.apply(out, 1, sp_group, n_sp, me)
    if b_group is not None:
        out = _Gather.apply(out, 0, b_group, n_b, b_me)
    return out
