"""Deep Gradient Compression momentum (counterpart of
paddle_tpu/optimizer/dgc.py).

Momentum correction plus top-k sparsification of the applied velocity
with error feedback (Lin et al., DGC), with static shapes: the mask is
``|u| >= quantile(|u|, sparsity)`` per tensor, not a gather of the top k.
The quantile is the reference's ``jnp.quantile`` (linear interpolation,
its f32 position arithmetic) computed from ``torch.kthvalue``, which takes
tensors of any size (``torch.quantile`` refuses more than 2**24 elements,
and GPT-2 medium's embedding has 51.5 M).
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer, _cast_back, _f32s

__all__ = ["DGCMomentum"]


def quantile(x, q: float):
    """The linear-interpolated ``q`` quantile of the 1-d f32 tensor ``x``,
    with ``jnp.quantile``'s f32 arithmetic for the position and weights."""
    n = x.numel()
    pos = np.float32(q) * (np.float32(n) - np.float32(1))
    low, high = np.floor(pos), np.ceil(pos)
    w_high = np.float32(pos - low)
    w_low = np.float32(1) - w_high
    lo = int(min(max(low, 0), n - 1))
    hi = int(min(max(high, 0), n - 1))
    v_lo = torch.kthvalue(x, lo + 1).values
    v_hi = v_lo if hi == lo else torch.kthvalue(x, hi + 1).values
    return v_lo * float(w_low) + v_hi * float(w_high)


class DGCMomentum(Optimizer):
    """Momentum with top-k sparsified updates and error feedback; plain
    momentum until ``rampup_begin_step``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 sparsity=0.999, rampup_begin_step=0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)
        if isinstance(sparsity, (list, tuple)):
            sparsity = sparsity[-1]
        self._sparsity = float(sparsity)
        self._rampup_begin = int(rampup_begin_step)

    def init_state(self, p):
        return {"velocity": torch.zeros_like(p, dtype=torch.float32)}

    def update_many(self, ps, gs, states, lr, step):
        fe = torch
        g32 = _f32s(gs)
        u = fe._foreach_mul([s["velocity"] for s in states], self._momentum)
        fe._foreach_add_(u, g32)
        dense = (fe._foreach_add(g32, fe._foreach_mul(u, self._momentum))
                 if self._nesterov else u)
        rampup = step <= self._rampup_begin
        applied, new_u = [], []
        for p, ui, di in zip(ps, u, dense):
            if p.dim() == 0 or p.numel() < 2:
                # tiny parameters run plain momentum (velocity persists)
                applied.append(di)
                new_u.append(ui)
                continue
            mag = ui.abs()
            mask = (mag >= quantile(mag.reshape(-1), self._sparsity)) \
                | rampup
            applied.append(torch.where(mask, di, torch.zeros_like(di)))
            # DGC phase: the sent velocity is cleared (error feedback
            # keeps the rest); ramp-up: plain momentum
            new_u.append(torch.where(mask & ~rampup, torch.zeros_like(ui),
                                     ui))
        new = fe._foreach_sub(_f32s(ps), fe._foreach_mul(applied, lr))
        return _cast_back(new, ps), [{"velocity": t} for t in new_u]
