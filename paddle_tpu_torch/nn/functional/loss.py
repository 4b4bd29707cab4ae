"""cross_entropy (counterpart of paddle_tpu/nn/functional/loss.py).

The port carries the reference's hard-label fast path: per-token loss =
logsumexp - picked, computed in f32 from logits of any float type (bf16
logits under O1 are read as they are, as the reference's
``softmax_ce_fast`` does: no f32 copy is kept for the backward), with a
closed-form backward (softmax - onehot) cast back to the logits' type.
Soft labels, class weights and label smoothing come with a later slice of
the port.
"""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


class _SoftmaxCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, lbl, ignore_index):
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, 0)
        picked = lf.gather(-1, safe[..., None])[..., 0]
        loss = torch.where(valid, lse - picked, 0.0)
        ctx.save_for_backward(logits, safe, valid, lse)
        return loss

    @staticmethod
    def backward(ctx, ct):
        logits, safe, valid, lse = ctx.saved_tensors
        scale = (ct * valid.float())[..., None]
        p = torch.exp(logits.float() - lse[..., None])
        p.scatter_add_(-1, safe[..., None],
                       torch.full_like(p[..., :1], -1.0))
        return (p * scale).to(logits.dtype), None, None


def cross_entropy(input, label, ignore_index=-100,  # noqa: A002
                  reduction="mean"):
    """Softmax cross-entropy over the last axis of ``input`` logits
    against integer ``label`` (a trailing label axis of size 1 is
    squeezed).  ``reduction`` is "mean" (over labels != ignore_index),
    "sum" or "none"."""
    if label.is_floating_point():
        raise TypeError("cross_entropy takes integer labels")
    lbl = label.long()
    if lbl.dim() == input.dim() and lbl.shape[-1] == 1:
        lbl = lbl[..., 0]
    loss = _SoftmaxCE.apply(input, lbl, ignore_index)
    if reduction == "mean":
        denom = (lbl != ignore_index).float().sum().clamp_min(1.0)
        return loss.sum() / denom
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
