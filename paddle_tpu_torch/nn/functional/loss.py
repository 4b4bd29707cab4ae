"""Loss functions (counterpart of paddle_tpu/nn/functional/loss.py).

``cross_entropy`` keeps the reference's hard-label fast path: per-token
loss = logsumexp - picked, computed in f32 from logits of any float type
(bf16 logits under O1 are read as they are, as the reference's
``softmax_ce_fast`` does: no f32 copy is kept for the backward), with a
closed-form backward (softmax - onehot) cast back to the logits' type.
It serves the cases the reference's ``fast`` condition admits (softmax,
integer labels, no class weight, no smoothing, the last axis).  The other
paths (a class weight, soft labels and float labels of the logits' shape,
another axis, ``use_softmax=False``, label smoothing) compute the
reference's generic formula with autograd.  The other losses are the
reference's formulas, parameters and reductions, and each asks
``amp.amp_cast`` under the reference's dispatch name (the f32 black list
holds the log-based ones).  ``ctc_loss`` is the reference's
log-space forward recursion over time, differentiated by autograd.
"""
from __future__ import annotations

import torch

from ...amp import amp_cast

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "nll_loss",
           "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "mse_loss", "l1_loss", "smooth_l1_loss", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss",
           "square_error_cost", "log_loss", "sigmoid_focal_loss",
           "ctc_loss", "npair_loss"]


def _reduce(loss, reduction, weight_sum=None):
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction != "mean":
        raise ValueError(f"unknown reduction {reduction!r}")
    if weight_sum is not None:
        return loss.sum() / weight_sum
    return loss.mean()


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


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy with the reference's parameters.
    ``reduction`` "mean" divides by the labels that are not
    ``ignore_index`` (by the summed selected class weights with
    ``weight``), or "sum" or "none".  Float labels of the logits' shape are
    soft labels even without ``soft_label``, as in the reference."""
    nd = input.dim()
    if (use_softmax and not soft_label and weight is None
            and label_smoothing == 0.0 and axis in (-1, nd - 1)
            and not label.is_floating_point() and nd >= 1):
        lbl = label.long()
        if lbl.dim() == nd and lbl.shape[-1] == 1:
            lbl = lbl[..., 0]
        loss = _SoftmaxCE.apply(input, lbl, ignore_index)
        if reduction == "mean":
            denom = (lbl != ignore_index).float().sum().clamp_min(1.0)
            return loss.sum() / denom
        return _reduce(loss, reduction)
    logits, label, w = amp_cast("cross_entropy", input, label, weight)
    ax = axis % nd
    if use_softmax:
        logp = torch.log_softmax(logits, dim=ax)
    else:
        logp = torch.log(torch.clamp_min(logits, 1e-30))
    k = logits.shape[ax]
    if soft_label or (label.is_floating_point() and label.dim() == nd
                      and label.shape == logits.shape):
        if label_smoothing > 0.0:
            label = label * (1 - label_smoothing) + label_smoothing / k
        return _reduce(-(label * logp).sum(dim=ax), reduction)
    lbl = label.long()
    if lbl.dim() == nd and lbl.shape[ax] == 1:
        lbl = lbl.squeeze(ax)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    if label_smoothing > 0.0:
        classes = torch.arange(k, device=lbl.device)
        onehot = (lbl.unsqueeze(-1) == classes).to(logp.dtype)
        soft = onehot * (1 - label_smoothing) + label_smoothing / k
        loss = -(soft.movedim(-1, ax) * logp).sum(dim=ax)
    else:
        loss = -logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
    loss = torch.where(valid, loss, 0.0)
    if w is not None:
        wsel = torch.where(valid, w[safe], 0.0)
        loss = loss * wsel
        if reduction == "mean":
            return loss.sum() / wsel.sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / valid.to(loss.dtype).sum().clamp_min(1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-example cross-entropy keeping the class axis (size 1), and the
    softmax with ``return_softmax``."""
    out = cross_entropy(logits, label, soft_label=soft_label,
                        ignore_index=ignore_index, reduction="none",
                        axis=axis)
    if out.dim() < logits.dim():
        out = out.unsqueeze(axis)
    if return_softmax:
        from .activation import softmax
        return out, softmax(logits, axis=axis)
    return out


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    logp, w = amp_cast("nll_loss", input, weight)
    lbl = label.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    lp = logp.movedim(1, -1) if logp.dim() > 2 else logp
    loss = -lp.gather(-1, safe[..., None])[..., 0]
    loss = torch.where(valid, loss, 0.0)
    if w is not None:
        wsel = w[safe] * valid.to(loss.dtype)
        loss = loss * wsel
        if reduction == "mean":
            return loss.sum() / wsel.sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / valid.to(loss.dtype).sum().clamp_min(1.0)
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean", name=None):
    p, y, w = amp_cast("binary_cross_entropy", input, label, weight)
    eps = 1e-12
    loss = -(y * torch.log(torch.clamp_min(p, eps))
             + (1 - y) * torch.log(torch.clamp_min(1 - p, eps)))
    if w is not None:
        loss = loss * w
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    z, y, w, pw = amp_cast("bce_with_logits", logit, label, weight,
                           pos_weight)
    neg_abs = -z.abs()
    if pw is not None:
        log_w = (pw - 1) * y + 1
        loss = (1 - y) * z + log_w * (torch.log1p(torch.exp(neg_abs))
                                      + torch.clamp_min(-z, 0.0))
    else:
        loss = torch.clamp_min(z, 0.0) - z * y + torch.log1p(
            torch.exp(neg_abs))
    if w is not None:
        loss = loss * w
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    x, y = amp_cast("mse_loss", input, label)
    return _reduce(torch.square(x - y), reduction)


def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    x, y = amp_cast("l1_loss", input, label)
    return _reduce((x - y).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0,  # noqa: A002
                   name=None):
    x, y = amp_cast("smooth_l1_loss", input, label)
    d = (x - y).abs()
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False,  # noqa: A002
           name=None):
    logp, y = amp_cast("kl_div", input, label)
    if log_target:
        loss = torch.exp(y) * (y - logp)
    else:
        loss = torch.where(
            y > 0, y * (torch.log(torch.clamp_min(y, 1e-12)) - logp), 0.0)
    if reduction == "batchmean":
        return loss.sum() / logp.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean", name=None):
    x1, x2, y = amp_cast("margin_ranking_loss", input, other, label)
    return _reduce(torch.clamp_min(-y * (x1 - x2) + margin, 0.0), reduction)


def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean", name=None):
    x, y = amp_cast("hinge_embedding_loss", input, label)
    loss = torch.where(y == 1, x, torch.clamp_min(margin - x, 0.0))
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    a, b, y = amp_cast("cosine_embedding_loss", input1, input2, label)
    cos = (a * b).sum(-1) / torch.clamp_min(
        torch.linalg.vector_norm(a, dim=-1)
        * torch.linalg.vector_norm(b, dim=-1), 1e-12)
    loss = torch.where(y == 1, 1 - cos, torch.clamp_min(cos - margin, 0.0))
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative,  # noqa: A002
                        margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                        reduction="mean", name=None):
    a, pos, neg = amp_cast("triplet_margin_loss", input, positive, negative)

    def dist(u, v):
        return ((u - v + epsilon).abs() ** p).sum(-1) ** (1.0 / p)
    d_ap, d_an = dist(a, pos), dist(a, neg)
    if swap:
        d_an = torch.minimum(d_an, dist(pos, neg))
    return _reduce(torch.clamp_min(d_ap - d_an + margin, 0.0), reduction)


def square_error_cost(input, label):  # noqa: A002
    x, y = amp_cast("square_error_cost", input, label)
    return torch.square(x - y)


def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    p, y = amp_cast("log_loss", input, label)
    return -(y * torch.log(p + epsilon)
             + (1 - y) * torch.log(1 - p + epsilon))


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                       gamma=2.0, reduction="sum", name=None):
    z, y, norm = amp_cast("sigmoid_focal_loss", logit, label, normalizer)
    p = torch.sigmoid(z)
    ce = torch.clamp_min(z, 0.0) - z * y + torch.log1p(torch.exp(-z.abs()))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if norm is not None:
        loss = loss / norm
    return _reduce(loss, reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over (T, N, C) log-probabilities (reference: warpctc_op): the
    forward recursion in log space over the blank-extended labels, each
    sequence frozen past its input length.  ``reduction`` "mean" averages
    the per-sequence losses divided by their label lengths.  As in the
    reference, ``norm_by_times`` is taken and changes nothing."""
    (logp,) = amp_cast("ctc_loss", log_probs)
    t_len, n, _ = logp.shape
    s = labels.shape[1]
    dev = logp.device
    ext = torch.full((n, 2 * s + 1), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    ext_len = 2 * label_lengths.long() + 1
    in_len = input_lengths.long()
    neg_inf = torch.full((), -1e30, dtype=logp.dtype, device=dev)
    rows = torch.arange(n, device=dev)
    alpha = neg_inf.expand(n, 2 * s + 1).clone()
    alpha[:, 0] = logp[0, rows, ext[:, 0]]
    alpha[:, 1] = torch.where(ext_len > 1, logp[0, rows, ext[:, 1]],
                              neg_inf)
    same2 = torch.cat([torch.ones((n, 2), dtype=torch.bool, device=dev),
                       ext[:, 2:] == ext[:, :-2]], dim=1)
    pad1 = neg_inf.expand(n, 1)
    pad2 = neg_inf.expand(n, 2)
    for t in range(1, t_len):
        a1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a2 = torch.where(same2, neg_inf,
                         torch.cat([pad2, alpha[:, :-2]], dim=1))
        merged = torch.logaddexp(torch.logaddexp(alpha, a1), a2)
        new = merged + logp[t].gather(1, ext)
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    last = ext_len - 1
    ll = torch.logaddexp(
        alpha[rows, last],
        torch.where(last - 1 >= 0, alpha[rows, (last - 1).clamp_min(0)],
                    neg_inf))
    loss = -ll
    if reduction == "mean":
        return (loss / torch.clamp_min(label_lengths.to(loss.dtype),
                                       1.0)).mean()
    return _reduce(loss, reduction)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    a, p = amp_cast("npair_loss", anchor, positive)
    reg = l2_reg * ((a * a).mean(1).sum() + (p * p).mean(1).sum()) * 0.25
    logits = a @ p.T
    same = (labels[:, None] == labels[None, :]).to(logits.dtype)
    same = same / same.sum(1, keepdim=True)
    xe = -(same * torch.log_softmax(logits, dim=1)).sum(1)
    return xe.mean() + reg
