"""The lazy row update for row-sparse gradients (counterpart of
paddle_tpu/optimizer/sparse.py).

Reference: paddle/fluid/operators/optimizers/adam_op.h (lazy_mode: only
rows present in the SelectedRows gradient get their moments and parameter
updated) and operators/math/selected_rows_functor.cc (scatter::MergeAdd).

``merge_rows`` sums duplicate lookup ids into buffers of the lookup
count's static shape (slots past the unique rows hold the sentinel id
``height``); the update gathers the touched rows of the parameter and of
every state leaf of shape (height, ...), runs the optimizer's
``update_one`` on that (N, width) slab and writes the rows back.  Work is
O(lookups * width), not O(height * width).  Everything is device ops of
static shape with no host read (no ``unique``, ``coalesce``, ``nonzero``
or ``.item()``), so a step that runs it can be captured as a CUDA graph.
"""
from __future__ import annotations

import torch

from ..core.selected_rows import RowSparseGrad

__all__ = ["merge_rows", "lazy_row_update", "lazy_row_update_"]


def merge_rows(rows, values, height: int):
    """SelectedRows MergeAdd: sum duplicate row entries, in the
    lookups' order.

    Returns (uids, summed): uids (N,) int32 whose first k slots hold the
    unique row ids in ascending order and the rest the sentinel
    ``height``; summed (N, width) f32 holds each unique row's gradient
    sum in the matching slot (zeros past k)."""
    n = rows.shape[0]
    order = torch.argsort(rows, stable=True)
    sr = rows[order].long()
    sv = values[order].float()
    first = torch.ones(n, dtype=torch.bool, device=rows.device)
    first[1:] = sr[1:] != sr[:-1]
    seg = torch.cumsum(first, 0) - 1
    # an accumulating index_put_ adds each slot's values in their order
    # (on the card by a stable sort, not by atomics), so a row's sum is
    # the same bits on every run and on every rank that holds the row
    summed = torch.zeros_like(sv).index_put_((seg,), sv, accumulate=True)
    # every write into one slot carries the same id
    uids = torch.full((n,), height, dtype=torch.long,
                      device=rows.device).scatter_(0, seg, sr)
    return uids.to(torch.int32), summed


def _row_leaf(s, height: int) -> bool:
    return isinstance(s, torch.Tensor) and s.dim() >= 1 \
        and s.shape[0] == height


def _rows_update(optimizer, p, grad: RowSparseGrad, state, lr, step_no,
                 decay_flag, lr_mult):
    """(target rows, new parameter rows, new state) of the lazy update.

    torch has no dropping scatter, and ``index_put_`` with repeated
    indices is undefined unless every write carries the same bytes.  So
    each sentinel slot is pointed at the last unique row and computes
    that row's update from the same inputs (its merged gradient, its
    parameter and state rows): the slots past the unique rows write the
    identical bytes into that one row, and no other row is touched."""
    from .functional import _device_scalar
    height = p.shape[0]
    uids, g = merge_rows(grad.rows, grad.values, height)
    n = uids.shape[0]
    slot = torch.arange(n, device=p.device)
    valid = uids < height
    last = valid.sum().sub(1).clamp_min(0).reshape(1)
    src = torch.where(valid, slot, last)
    tgt = uids.long().gather(0, src)
    g = g[src]
    lr = _device_scalar(lr, torch.float32, p.device)
    step_no = _device_scalar(step_no, torch.int32, p.device)
    p_rows = p[tgt]
    state_rows = {k: (s[tgt] if _row_leaf(s, height) else s)
                  for k, s in state.items()}
    wd = getattr(optimizer, "_wd", 0.0)
    l1 = getattr(optimizer, "_wd_mode", "l2") == "l1"
    dwd = getattr(optimizer, "_decoupled_wd", 0.0)
    lr = lr * lr_mult if lr_mult != 1.0 else lr
    if wd and decay_flag:
        pr = p_rows.float()
        g = g + wd * (torch.sign(pr) if l1 else pr)
    new_rows, ns = optimizer.update_one(p_rows, g, state_rows, lr, step_no)
    if dwd and decay_flag:
        new_rows = (new_rows.float() - lr * dwd * p_rows.float()).to(p.dtype)
    return tgt, new_rows.to(p.dtype), ns


@torch.no_grad()
def lazy_row_update(optimizer, p, grad: RowSparseGrad, state, lr, step_no,
                    decay_flag: bool = True, lr_mult: float = 1.0):
    """Pure: (new_param, new_state) with only the gradient's rows moved."""
    height = p.shape[0]
    tgt, new_rows, ns = _rows_update(optimizer, p, grad, state, lr, step_no,
                                     decay_flag, lr_mult)
    new_p = p.clone()
    new_p[tgt] = new_rows
    new_state = {}
    for k, s in state.items():
        if _row_leaf(s, height):
            new_state[k] = s.clone()
            new_state[k][tgt] = ns[k].to(s.dtype)
        else:
            new_state[k] = ns[k]
    return new_p, new_state


@torch.no_grad()
def lazy_row_update_(optimizer, p, grad: RowSparseGrad, state, lr, step_no,
                     decay_flag: bool = True, lr_mult: float = 1.0,
                     ok=None):
    """``lazy_row_update`` written into ``p`` and ``state``'s tensors in
    place (a table is never copied whole).  With ``ok`` (a 0-dim bool
    tensor) the rows keep their old values where it is False."""
    height = p.shape[0]
    tgt, new_rows, ns = _rows_update(optimizer, p, grad, state, lr, step_no,
                                     decay_flag, lr_mult)
    pairs = [(p, new_rows)] + [(s, ns[k]) for k, s in state.items()]
    for dst, new in pairs:
        if _row_leaf(dst, height):
            new = new.to(dst.dtype)
            if ok is not None:
                new = torch.where(ok, new, dst[tgt])
            dst[tgt] = new
        else:
            if ok is not None:
                new = torch.where(ok, new, dst)
            dst.copy_(new)
