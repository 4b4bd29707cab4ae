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

``fused_pool_linear_cross_entropy`` is the conv nets' classifier tail:
the global average pool (an f32 mean over the spatial axes, cast back to
the features' type), then the same chunked CE with the Paddle Linear
weight (C, classes) transposed, per-sample losses out; the features'
gradient is dh / (H * W), broadcast.
"""
from __future__ import annotations

import torch

from ..amp import amp_cast

__all__ = ["fused_linear_cross_entropy", "fused_pool_linear_cross_entropy"]

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
    """Forward and backward each in a profiler range ("fused_ce"): a
    step's profile reports the tail apart."""

    @staticmethod
    def forward(ctx, h, w, b, labels, valid, chunk):
        t = h.shape[0]
        c = _chunk_of(t, chunk)
        with torch.profiler.record_function("fused_ce"):
            wb = _bf16(w)
            losses = []
            for s in range(0, t, c):
                logits = _chunk_logits(h[s:s + c], wb, b)
                lse = torch.logsumexp(logits, dim=-1)
                picked = logits.gather(-1, labels[s:s + c, None])[:, 0]
                losses.append(torch.where(valid[s:s + c], lse - picked,
                                          0.0))
            out = torch.cat(losses)
        ctx.save_for_backward(h, w, b, labels, valid)
        ctx.chunk = c
        return out

    @staticmethod
    def backward(ctx, ct):
        with torch.profiler.record_function("fused_ce"):
            return _FusedCE._backward(ctx, ct)

    @staticmethod
    def _backward(ctx, ct):
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


class _GlobalAvgPool(torch.autograd.Function):
    """(N, C, H, W) -> (N, C) mean over H, W whose backward writes the
    dense gradient in the input's memory format: a mean's backward is a
    broadcast view, which the fused BatchNorm kernels before the tail
    would have to copy into channels-last rows."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        ctx.fmt = (torch.channels_last
                   if not x.is_contiguous()
                   and x.is_contiguous(memory_format=torch.channels_last)
                   else torch.contiguous_format)
        return x.mean((2, 3))

    @staticmethod
    def backward(ctx, g):
        n, c, h, w = ctx.shape
        return (g / (h * w))[:, :, None, None].expand(ctx.shape).contiguous(
            memory_format=ctx.fmt)


def fused_pool_linear_cross_entropy(features, weight, labels, bias=None,
                                    chunk_size=None, data_format="NCHW",
                                    name=None):
    """Global average pool -> linear -> softmax CE as one op: per-sample
    f32 losses (N,).

    features (N, C, H, W), or (N, H, W, C) with ``data_format="NHWC"``
    (a logical-NCHW map in channels-last memory, as ``layout_policy``
    runs it, is still NCHW); weight (C, classes), the Paddle Linear
    layout; labels (N,) int.  On neither AMP list: cast under O2 only."""
    features, weight, bias = amp_cast("fused_pool_linear_cross_entropy",
                                      features, weight, bias)
    chunk = DEFAULT_CHUNK if chunk_size is None else int(chunk_size)
    x = features.float()
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    h = _GlobalAvgPool.apply(x).to(features.dtype)
    flat = labels.reshape(-1).long()
    valid = torch.ones_like(flat, dtype=torch.bool)
    return _FusedCE.apply(h, weight.t(), bias, flat, valid, chunk)
