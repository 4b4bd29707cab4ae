"""Optimizers (counterpart of paddle_tpu/optimizer/optimizer.py).

Each optimizer defines a functional update over lists of tensors
(``init_state`` / ``update_many``; ``update_one`` is the one-parameter
case).  Like the reference, which applies its update to the whole
parameter tree in one compiled call, the port runs each arithmetic step
of the update as one multi-tensor (``torch._foreach_*``) launch over all
parameters, not one launch per parameter.  The eager ``step()`` applies
it to every parameter with a gradient (after the optimizer's
``grad_clip``), and ``jit.TrainStep`` applies the same core through
``optimizer.functional.apply_updates``.  The scalar arithmetic of the
update (learning rate, bias corrections, decay coefficients) is done in
float32 on the host, as the reference does it in f32 on the device, so the
two frameworks compute the same update from the same gradient.  Moments are
f32 whatever the parameter type.  Learning-rate schedulers come with a
later slice of the port.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.errors import UnimplementedError

__all__ = ["Optimizer", "Adam", "AdamW"]


def _f32(x) -> float:
    """x rounded to float32 (a host scalar the device reads exactly)."""
    return float(np.float32(x))


class Optimizer:
    """Base optimizer with Paddle's eager API (step / clear_grad)."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if not isinstance(learning_rate, (int, float)):
            raise UnimplementedError(
                "learning-rate schedulers come with a later slice of the "
                "port; pass a float learning_rate")
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._learning_rate = float(learning_rate)
        self._grad_clip = grad_clip
        # weight_decay: float -> coupled L2 coefficient added to grads;
        # AdamW overrides with decoupled decay
        self._wd = 0.0 if weight_decay is None else float(weight_decay)
        self._decoupled_wd = 0.0
        self._step_count = 0
        self._states: Dict[int, dict] = {}

    def _decay_applies(self, name) -> bool:
        """Whether weight decay applies to the parameter called ``name``
        (AdamW's apply_decay_param_fun hook; True for plain optimizers)."""
        return True

    # ---- functional core ---------------------------------------------------
    def init_state(self, p) -> dict:
        return {}

    def update_many(self, ps, gs, states, lr: float, step: int):
        """(new_params, new_states) lists from lists of parameters,
        gradients and states; ``lr`` an f32-exact float, ``step`` the
        1-based step number.  Pure: nothing is written in place."""
        raise NotImplementedError

    def update_one(self, p, g, state: dict, lr: float, step: int):
        (new_p,), (new_state,) = self.update_many([p], [g], [state], lr,
                                                  step)
        return new_p, new_state

    # ---- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    # ---- eager step ----------------------------------------------------------
    @torch.no_grad()
    def step(self):
        from .functional import apply_updates
        params = [p for p in self._parameter_list or []
                  if p.requires_grad and p.grad is not None]
        if not params:
            self._step_count += 1
            return
        grads = [p.grad for p in params]
        if self._grad_clip is not None:
            grads = [g for _, g in self._grad_clip(list(zip(params, grads)))]
        self._step_count += 1
        keys = [id(p) for p in params]
        states = {k: self._states.get(k) or self.init_state(p)
                  for k, p in zip(keys, params)}
        new_p, new_s = apply_updates(
            self, dict(zip(keys, params)), dict(zip(keys, grads)), states,
            _f32(self.get_lr()), self._step_count,
            {k: self._decay_applies(getattr(p, "name", None))
             for k, p in zip(keys, params)})
        torch._foreach_copy_(params, [new_p[k] for k in keys])
        self._states.update(new_s)

    def clear_grad(self):
        for p in self._parameter_list or []:
            p.grad = None


class Adam(Optimizer):
    """Adam with f32 moments (reference: operators/optimizers/adam_op)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_state(self, p):
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32)}

    def update_many(self, ps, gs, states, lr, step):
        fe = torch
        b1, b2 = np.float32(self._beta1), np.float32(self._beta2)
        t = np.float32(step)
        # f32 bias corrections, as the reference's `1 - beta ** t` on f32 t
        bc1 = float(np.float32(1) - b1 ** t)
        bc2 = float(np.float32(1) - b2 ** t)
        g32 = [g.float() for g in gs]
        # m = b1 m + (1 - b1) g ;  v = b2 v + (1 - b2) g^2
        m = fe._foreach_mul([s["moment1"] for s in states], self._beta1)
        fe._foreach_add_(m, fe._foreach_mul(g32, 1 - self._beta1))
        v = fe._foreach_mul([s["moment2"] for s in states], self._beta2)
        fe._foreach_add_(v, fe._foreach_mul(fe._foreach_mul(g32, g32),
                                            1 - self._beta2))
        # upd = lr * (m / bc1) / (sqrt(v / bc2) + eps)
        upd = fe._foreach_mul(fe._foreach_div(m, bc1), lr)
        den = fe._foreach_sqrt(fe._foreach_div(v, bc2))
        fe._foreach_add_(den, self._eps)
        fe._foreach_div_(upd, den)
        new = fe._foreach_sub([p.float() for p in ps], upd)
        return ([n.to(p.dtype) for n, p in zip(new, ps)],
                [{"moment1": a, "moment2": b} for a, b in zip(m, v)])


class AdamW(Adam):
    """Adam with decoupled weight decay (reference:
    python/paddle/optimizer/adamw.py); ``apply_decay_param_fun(name)``
    selects the parameters that decay, by state name in ``TrainStep``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        self._decoupled_wd = float(weight_decay) if weight_decay else 0.0
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_applies(self, name) -> bool:
        fn = self._apply_decay_param_fun
        if fn is None or not name:
            return True
        return bool(fn(name))
