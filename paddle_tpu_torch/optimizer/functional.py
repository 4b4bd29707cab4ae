"""Shared functional optimizer-update core (counterpart of
paddle_tpu/optimizer/functional.py), dense gradients only.

One rule (coupled L2, the optimizer's ``update_many``, decoupled AdamW
decay, gated by ``apply_decay_param_fun``) used by the eager
``Optimizer.step`` and by ``jit.TrainStep``.  Parameters are grouped by
whether they decay, and each group is updated by multi-tensor launches.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["decay_flags", "apply_updates"]


def decay_flags(optimizer, names) -> Dict[str, bool]:
    """apply_decay_param_fun resolved per parameter name."""
    return {n: optimizer._decay_applies(n) for n in names}


def _update_group(optimizer, ps, gs, states, lr: float, step: int,
                  decay: bool):
    """(new_params, new_states) of one group of parameters that share the
    decay flag; no in-place writes."""
    wd = optimizer._wd
    dwd = optimizer._decoupled_wd
    if wd and decay:
        gs = torch._foreach_add(gs, torch._foreach_mul(ps, wd))
    new_p, new_s = optimizer.update_many(ps, gs, states, lr, step)
    if dwd and decay:
        coef = float(np.float32(lr) * np.float32(dwd))
        p32 = [p.float() for p in ps]
        new_p = [n.to(p.dtype) for n, p in zip(torch._foreach_sub(
            [n.float() for n in new_p], torch._foreach_mul(p32, coef)), ps)]
    return new_p, new_s


def apply_updates(optimizer, params: dict, grads: dict, opt_state: dict,
                  lr: float, step_no: int, decay: Dict[str, bool]):
    """Returns (new_params, new_opt_state) for the keys in ``grads``;
    parameters without gradients pass through unchanged.  ``lr`` is
    f32-exact; decay applies to floating-point parameters only."""
    groups: Dict[bool, list] = {}
    for k in grads:
        dec = decay.get(k, True) and params[k].is_floating_point()
        groups.setdefault(dec, []).append(k)
    new_params = dict(params)
    new_opt = dict(opt_state)
    for dec, keys in groups.items():
        new_p, new_s = _update_group(
            optimizer, [params[k] for k in keys], [grads[k] for k in keys],
            [opt_state[k] for k in keys], lr, step_no, dec)
        new_params.update(zip(keys, new_p))
        new_opt.update(zip(keys, new_s))
    return new_params, new_opt
