"""Fused tied-head softmax cross-entropy (port of paddle_tpu/ops/fused_ce.py).

Per-token CE of ``h @ W^T [+ b]`` against labels without keeping the
(tokens, vocab) logits between forward and backward.  The reference is a
``jax.custom_vjp`` over ``lax.scan``s of token chunks (no Pallas kernel):
each chunk's logits come from a bf16 product with f32 accumulation, the
softmax is f32, and the backward recomputes the chunk's logits from the
saved (h, W) and accumulates dW in f32.  The port is the same algorithm as
a ``torch.autograd.Function`` with a Python loop over chunks.  A product
"in bf16 with f32 accumulation" is written as an f32 product of
bf16-rounded operands, which gives the same sums on every device (torch's
bf16 matmul would round its output to bf16).
"""
from __future__ import annotations

import torch

__all__ = ["fused_linear_cross_entropy"]

DEFAULT_CHUNK = 2048


def _chunk_of(t: int, want: int) -> int:
    want = min(want, t)
    while t % want:
        want -= 1
    return want


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _chunk_logits(hc, wb, b):
    logits = _bf16(hc) @ wb.t()                   # (c, V) f32
    return logits if b is None else logits + b.float()


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, b, labels, valid, chunk):
        t = h.shape[0]
        c = _chunk_of(t, chunk)
        wb = _bf16(w)
        losses = []
        for s in range(0, t, c):
            logits = _chunk_logits(h[s:s + c], wb, b)
            lse = torch.logsumexp(logits, dim=-1)
            picked = logits.gather(-1, labels[s:s + c, None])[:, 0]
            losses.append(torch.where(valid[s:s + c], lse - picked, 0.0))
        ctx.save_for_backward(h, w, b, labels, valid)
        ctx.chunk = c
        return torch.cat(losses)

    @staticmethod
    def backward(ctx, ct):
        h, w, b, labels, valid = ctx.saved_tensors
        c = ctx.chunk
        wb = _bf16(w)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = (torch.zeros(w.shape[:1], dtype=torch.float32, device=w.device)
              if b is not None else None)
        dh = []
        for s in range(0, h.shape[0], c):
            hc = h[s:s + c]
            g = torch.softmax(_chunk_logits(hc, wb, b), dim=-1)
            g.scatter_add_(-1, labels[s:s + c, None],
                           torch.full_like(g[:, :1], -1.0))
            g = g * (ct[s:s + c] * valid[s:s + c].float())[:, None]
            gb = _bf16(g)
            dh.append(gb @ wb)                     # (c, H)
            dw += gb.t() @ _bf16(hc)               # (V, H)
            if db is not None:
                db += g.sum(0)
        return (torch.cat(dh).to(h.dtype), dw.to(w.dtype),
                None if b is None else db.to(b.dtype), None, None, None)


def fused_linear_cross_entropy(h, weight, labels, chunk_size=None,
                               bias=None, ignore_index=None):
    """Per-token CE of (h @ weight^T [+ bias]) vs labels.

    h (..., H) hidden states, weight (V, H) (the tied embedding layout),
    labels (...) int.  Returns per-token f32 losses shaped like labels;
    positions where labels == ignore_index get loss 0 and no gradient
    (divide by the valid count yourself for the mean)."""
    chunk = DEFAULT_CHUNK if chunk_size is None else int(chunk_size)
    lead = labels.shape
    flat = labels.reshape(-1).long()
    if ignore_index is not None:
        valid = flat != ignore_index
        flat = torch.where(valid, flat, 0)
    else:
        valid = torch.ones_like(flat, dtype=torch.bool)
    out = _FusedCE.apply(h.reshape(-1, h.shape[-1]), weight, bias, flat,
                         valid, chunk)
    return out.reshape(lead)
