"""Linear-chain CRF loss, Viterbi decoding and the hierarchical sigmoid
loss (counterpart of paddle_tpu/nn/functional/crf.py).

Sequences are padded (B, T, n) emissions plus a (B,) length vector.  The
transition matrix is (n + 2, n): row 0 the start weights, row 1 the stop
weights, rows 2.. tag to tag.  The forward algorithm and Viterbi run in
f32 as a loop over time, each step masked past a row's length (the state
held), as the reference's scans; Viterbi's argmax takes the first of
equal scores, as ``jnp.argmax`` does.
"""
from __future__ import annotations

import math

import torch

__all__ = ["linear_chain_crf", "crf_decoding", "hsigmoid_loss"]


def _parts(input, transition, length):  # noqa: A002
    emit = input.to(torch.float32)
    trans = transition.to(torch.float32)
    lens = length.to(device=emit.device).long().reshape(-1)
    valid = (torch.arange(emit.shape[1], device=emit.device)[None, :]
             < lens[:, None])
    return emit, trans[0], trans[1], trans[2:], lens, valid


def linear_chain_crf(input, label, transition, length, name=None):  # noqa: A002
    """Negative log-likelihood of each row's tag path, (B, 1): log Z by
    the forward algorithm minus the gold path's score (start + emissions
    + transitions + stop)."""
    emit, start, stop, step_tr, lens, valid = _parts(input, transition,
                                                     length)
    lab = label.long()
    e_score = torch.take_along_dim(emit, lab[:, :, None], dim=2)[..., 0]
    path = torch.where(valid, e_score, 0.0).sum(1) + start[lab[:, 0]]
    tr_score = step_tr[lab[:, :-1], lab[:, 1:]]
    path = path + torch.where(valid[:, 1:], tr_score, 0.0).sum(1)
    last = torch.take_along_dim(lab, torch.clamp_min(lens - 1, 0)[:, None],
                                dim=1)[:, 0]
    path = path + stop[last]
    alpha = start[None] + emit[:, 0]
    for t in range(1, emit.shape[1]):
        nxt = torch.logsumexp(alpha[:, :, None] + step_tr[None], dim=1) \
            + emit[:, t]
        alpha = torch.where(valid[:, t, None], nxt, alpha)
    logz = torch.logsumexp(alpha + stop[None], dim=1)
    return (logz - path)[:, None]


def crf_decoding(input, transition, length, name=None):  # noqa: A002
    """The Viterbi path, (B, T) int64 tags, 0 past each length."""
    with torch.no_grad():
        emit, start, stop, step_tr, lens, valid = _parts(input, transition,
                                                         length)
        b, t, n = emit.shape
        ident = torch.arange(n, device=emit.device).expand(b, n)
        score = start[None] + emit[:, 0]
        ptrs = []
        for i in range(1, t):
            cand = score[:, :, None] + step_tr[None]
            keep = valid[:, i, None]
            score = torch.where(keep, cand.amax(dim=1) + emit[:, i], score)
            ptrs.append(torch.where(keep, cand.argmax(dim=1), ident))
        tag = torch.argmax(score + stop[None], dim=1)
        tags = [tag]
        for ptr in reversed(ptrs):
            tag = torch.take_along_dim(ptr, tag[:, None], dim=1)[:, 0]
            tags.append(tag)
        path = torch.stack(tags[::-1], dim=1)
        return torch.where(valid, path, 0)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss, (B, 1): the default complete binary tree
    over ``num_classes`` leaves (the reference's SimpleCode: node i of
    label c's path is (c + K) >> (len - i) - 1, its bit (c + K) >>
    (len - 1 - i) & 1, len = floor(log2(c + K)) in f32), or a custom tree
    from ``path_table`` / ``path_code`` (-1 ends a path).  Each node's
    loss is the BCE with logits of its bit; weight (K - 1, D), bias
    (K - 1,).  ``is_sparse`` is taken and changes nothing."""
    max_len = max(int(math.ceil(math.log2(max(num_classes, 2)))), 1)
    if path_table is not None:
        idx = path_table.to(input.device).long()
        code = path_code.to(input.device).to(torch.float32)
        active = idx >= 0
        idx = torch.clamp_min(idx, 0)
    else:
        c = label.long().reshape(-1) + num_classes
        ln = torch.floor(torch.log2(c.to(torch.float32))).long()
        i = torch.arange(max_len, device=c.device)[None, :]
        active = i < ln[:, None]
        idx = (c[:, None] >> torch.clamp_min(ln[:, None] - i, 0)) - 1
        code = ((c[:, None] >> torch.clamp_min(ln[:, None] - 1 - i, 0))
                & 1).to(torch.float32)
        idx = torch.where(active, idx, 0)   # past the path: masked
    pre = torch.einsum("bld,bd->bl", weight[idx].to(torch.float32),
                       input.to(torch.float32))
    if bias is not None:
        pre = pre + bias[idx]
    loss = (torch.clamp_min(pre, 0) - pre * code
            + torch.log1p(torch.exp(-pre.abs())))
    return torch.where(active, loss, 0.0).sum(1, keepdim=True)
