"""Mixture-of-experts feed-forward, capacity-based top-k routing
(counterpart of paddle_tpu/nn/functional/moe.py).

The reference's dense formulation with static shapes: router softmax in
f32; top-k as an iterated argmax (ties to the first index), each choice
masked out before the next; per-expert capacity C = ceil(k T / E *
factor); slots assigned in token order, a later choice queueing behind
every earlier choice of the same expert; tokens past capacity dropped;
a one-hot (T, E, C) dispatch, the experts' FFN as batched products, and
the combine weighted by each choice's renormalised gate.  The auxiliary
loss is Switch's E * sum_e density_e * mean gate_e, the density from the
top-1 choices.
"""
from __future__ import annotations

import math

import torch

__all__ = ["moe_ffn"]

# the reference's jax.nn.gelu: the tanh form by default
_ACTS = {
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "relu": torch.relu,
    "silu": torch.nn.functional.silu,
    "swish": torch.nn.functional.silu,
}


def moe_ffn(x, gate_w, w1, b1, w2, b2, top_k=2, capacity_factor=1.25,
            activation="gelu"):
    """(y, aux_loss).  x (..., d_model); gate_w (d_model, E); w1 (E,
    d_model, d_hidden); b1 (E, d_hidden); w2 (E, d_hidden, d_model); b2
    (E, d_model)."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    t = xt.shape[0]
    e = gate_w.shape[-1]
    act = _ACTS[activation]
    gates = torch.softmax((xt @ gate_w.to(xt.dtype)).to(torch.float32), -1)
    cap = max(1, int(math.ceil(top_k * t / e * capacity_factor)))
    rem, masks, probs = gates, [], []
    for _ in range(top_k):
        m = torch.nn.functional.one_hot(torch.argmax(rem, -1),
                                        e).to(gates.dtype)
        masks.append(m)
        probs.append(torch.sum(gates * m, -1))
        rem = rem * (1.0 - m)
    denom = sum(probs) + 1e-9
    combine = gates.new_zeros((t, e, cap))
    offset = torch.zeros((e,), dtype=torch.int64, device=x.device)
    for m, p in zip(masks, probs):
        mi = m.long()
        pos_in_e = torch.cumsum(mi, 0) - mi + offset[None, :]
        within = (pos_in_e < cap).to(gates.dtype) * m
        pos = torch.sum(pos_in_e * mi, -1)
        slot = (pos[:, None] == torch.arange(cap, device=x.device)).to(
            gates.dtype)
        combine = combine + ((p / denom)[:, None, None]
                             * within[:, :, None] * slot[:, None, :])
        offset = offset + mi.sum(0)
    dispatch = (combine > 0).to(xt.dtype)
    ein = torch.einsum("tec,td->ecd", dispatch, xt)
    h = act(torch.einsum("ecd,edf->ecf", ein, w1.to(ein.dtype))
            + b1[:, None, :].to(ein.dtype))
    out_e = (torch.einsum("ecf,efd->ecd", h, w2.to(h.dtype))
             + b2[:, None, :].to(h.dtype))
    y = torch.einsum("tec,ecd->td", combine.to(out_e.dtype), out_e)
    density = masks[0].mean(0)
    aux = torch.sum(density * gates.mean(0)) * e
    return y.reshape(shape), aux.to(torch.float32)
