"""Shared functional optimizer-update core (counterpart of
paddle_tpu/optimizer/functional.py), dense gradients only.

One rule (coupled decay, L2 ``g + wd * p`` or L1 ``g + wd * sign(p)``, the
optimizer's ``update_many``, decoupled AdamW decay, gated by
``apply_decay_param_fun``) used by the eager ``Optimizer.step`` and by
``jit.TrainStep``.  The eager step also passes each parameter's learning
rate multiplier and ``ParamAttr`` regularizer (``lr_mults``, ``regs``);
``TrainStep`` passes neither, as the reference's does not.  Parameters
are grouped by (decay flag, decay coefficient and mode, multiplier), and
each group is updated by multi-tensor launches.
The learning rate and the step number are 0-dim tensors on the
parameters' device (numbers are turned into such tensors), so that a step
captured as a CUDA graph reads the values written before each replay
instead of freezing its first step's.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["decay_flags", "apply_updates", "update_in_place"]

# elements per chunk of ``update_in_place``: its temporaries (a few f32
# copies of a chunk) stay far below a large model's state, and each chunk
# costs one more round of multi-tensor launches
_CHUNK = 1 << 26


def decay_flags(optimizer, names) -> Dict[str, bool]:
    """apply_decay_param_fun resolved per parameter name."""
    return {n: optimizer._decay_applies(n) for n in names}


def _device_scalar(x, dtype, device) -> torch.Tensor:
    """x as a 0-dim tensor of ``dtype`` on ``device`` (a fill, not a host
    copy)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


def _update_group(optimizer, ps, gs, states, lr, step, key):
    """(new_params, new_states) of one group of parameters that share the
    decay flag, the coupled decay (coefficient, L1?) and the learning
    rate multiplier; no in-place writes."""
    decay, (wd, l1), mult = key
    dwd = optimizer._decoupled_wd
    if mult != 1.0:
        lr = lr * mult                       # f32, as the reference's
    if wd and decay:
        pen = torch._foreach_sign(ps) if l1 else ps
        gs = torch._foreach_add(gs, torch._foreach_mul(pen, wd))
    new_p, new_s = optimizer.update_many(ps, gs, states, lr, step)
    if dwd and decay:
        coef = lr * dwd                      # f32, as the reference's
        p32 = [p.float() for p in ps]
        new_p = [n.to(p.dtype) for n, p in zip(torch._foreach_sub(
            [n.float() for n in new_p], torch._foreach_mul(p32, coef)), ps)]
    return new_p, new_s


def apply_updates(optimizer, params: dict, grads: dict, opt_state: dict,
                  lr, step_no, decay: Dict[str, bool],
                  lr_mults: Optional[Dict[str, float]] = None,
                  regs: Optional[Dict[str, tuple]] = None):
    """Returns (new_params, new_opt_state) for the keys in ``grads``;
    parameters without gradients pass through unchanged.  ``lr`` (f32) and
    ``step_no`` (the 1-based step, int32) are 0-dim tensors on the
    parameters' device, or numbers; decay applies to floating-point
    parameters only.  ``lr_mults`` maps a key to its learning-rate
    multiplier, ``regs`` to its own (coefficient, L1?) coupled decay in
    place of the optimizer's."""
    if grads:
        dev = params[next(iter(grads))].device
        lr = _device_scalar(lr, torch.float32, dev)
        step_no = _device_scalar(step_no, torch.int32, dev)
    own = (optimizer._wd, optimizer._wd_mode == "l1")
    groups: Dict[tuple, list] = {}
    for k in grads:
        dec = decay.get(k, True) and params[k].is_floating_point()
        key = (dec, (regs or {}).get(k, own), (lr_mults or {}).get(k, 1.0))
        groups.setdefault(key, []).append(k)
    new_params = dict(params)
    new_opt = dict(opt_state)
    for key, keys in groups.items():
        new_p, new_s = _update_group(
            optimizer, [params[k] for k in keys], [grads[k] for k in keys],
            [opt_state[k] for k in keys], lr, step_no, key)
        new_params.update(zip(keys, new_p))
        new_opt.update(zip(keys, new_s))
    return new_params, new_opt


def update_in_place(optimizer, params: dict, grads: dict, opt_state: dict,
                    lr, step_no, decay: Dict[str, bool], ok=None):
    """``apply_updates`` written into ``params``' and ``opt_state``'s
    tensors in place, one chunk of at most ``_CHUNK`` elements of
    parameters at a time (a larger parameter is a chunk of its own), so
    that the update's temporaries stay a few copies of one chunk, where
    the whole update would hold several copies of the entire state at
    once.  With ``ok`` (a 0-dim bool tensor), every value keeps its old
    value where ``ok`` is False (the step guard).  Element for element the
    same arithmetic as ``apply_updates``."""
    chunks, size = [[]], 0
    for k in grads:
        if chunks[-1] and size + grads[k].numel() > _CHUNK:
            chunks.append([])
            size = 0
        chunks[-1].append(k)
        size += grads[k].numel()
    for names in filter(None, chunks):
        new_p, new_s = apply_updates(
            optimizer, {n: params[n] for n in names},
            {n: grads[n] for n in names}, {n: opt_state[n] for n in names},
            lr, step_no, decay)
        dst = [params[n] for n in names] + [
            opt_state[n][slot] for n in names for slot in new_s[n]]
        src = [new_p[n] for n in names] + [
            t for n in names for t in new_s[n].values()]
        if ok is not None:
            src = [torch.where(ok, new, old) for new, old in zip(src, dst)]
        torch._foreach_copy_(dst, src)
