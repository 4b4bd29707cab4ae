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
update (bias corrections, decay coefficients) is done in float32 on the
device from the 0-dim learning-rate and step tensors, as the reference
does it, so the two frameworks compute the same update from the same
gradient, and a step captured as a CUDA graph follows ``set_lr`` and the
step count.  Moments are
f32 whatever the parameter type (Adam); Momentum's velocity is in the
parameter's type, as the reference's.  ``learning_rate`` is a number or
an ``optimizer.lr.LRScheduler``, which ``get_lr`` calls at every step (the
caller steps the scheduler); ``state_dict`` / ``set_state_dict`` carry the
step count, the eager step's slots (``param{i}.{slot}``) and the
scheduler's state (``"LR_Scheduler"``) under the reference's keys.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .lr import LRScheduler

__all__ = ["Optimizer", "Momentum", "Adam", "AdamW"]


def _f32(x) -> float:
    """x rounded to float32 (a host scalar the device reads exactly)."""
    return float(np.float32(x))


def _refuse_param_attrs(params):
    """A parameter made with ``ParamAttr(regularizer=...)`` or a learning
    rate multiplier other than 1.0 is refused: the port's optimizers take
    one float ``weight_decay`` and one learning rate for all parameters,
    and ignoring either attribute would train another model."""
    from ..core.errors import UnimplementedError
    for p in params:
        p = p["params"] if isinstance(p, dict) else p
        for q in (p if isinstance(p, (list, tuple)) else [p]):
            lr = getattr(q, "optimize_attr", {}).get("learning_rate", 1.0)
            if getattr(q, "regularizer", None) is not None or lr != 1.0:
                raise UnimplementedError(
                    f"parameter {getattr(q, 'param_name', None)!r} carries a "
                    f"ParamAttr regularizer or learning-rate multiplier "
                    f"({lr}): per-parameter regularizers and multipliers "
                    "are not ported yet (ROADMAP section 1 item 4)")


class Optimizer:
    """Base optimizer with Paddle's eager API (step / clear_grad)."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        _refuse_param_attrs(self._parameter_list or ())
        self._learning_rate = (learning_rate
                               if isinstance(learning_rate, LRScheduler)
                               else float(learning_rate))
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

    def update_many(self, ps, gs, states, lr, step):
        """(new_params, new_states) lists from lists of parameters,
        gradients and states; ``lr`` a 0-dim f32 tensor, ``step`` the
        1-based step number as a 0-dim int32 tensor, both on the
        parameters' device.  Pure: nothing is written in place."""
        raise NotImplementedError

    def update_one(self, p, g, state: dict, lr: float, step: int):
        (new_p,), (new_state,) = self.update_many([p], [g], [state], lr,
                                                  step)
        return new_p, new_state

    # ---- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return self._learning_rate

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    @property
    def _lr_scheduler(self):
        return (self._learning_rate
                if isinstance(self._learning_rate, LRScheduler) else None)

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

    # ---- state dict --------------------------------------------------------
    def state_dict(self):
        """The step count, each listed parameter's slots of the eager step
        as ``param{i}.{slot}`` and the scheduler's state as
        ``"LR_Scheduler"``, the reference's keys."""
        out = {"_step_count": self._step_count}
        for i, p in enumerate(self._parameter_list or []):
            for k, v in (self._states.get(id(p)) or {}).items():
                out[f"param{i}.{k}"] = v
        sched = self._lr_scheduler
        if sched is not None:
            out["LR_Scheduler"] = sched.state_dict()
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        self._step_count = int(state_dict.get("_step_count", 0))
        if "LR_Scheduler" in state_dict and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state_dict["LR_Scheduler"])
        for i, p in enumerate(self._parameter_list or []):
            prefix = f"param{i}."
            st = {k[len(prefix):]: v for k, v in state_dict.items()
                  if isinstance(k, str) and k.startswith(prefix)}
            if not st:
                continue
            like = self.init_state(p.detach())
            self._states[id(p)] = {
                k: torch.as_tensor(v).to(p.device, like[k].dtype)
                for k, v in st.items()}


class Momentum(Optimizer):
    """Momentum SGD, with Nesterov's form as an option (reference:
    operators/optimizers/momentum_op): v = momentum * v + g;
    p -= lr * v, or p -= lr * (g + momentum * v) with nesterov."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def init_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    def update_many(self, ps, gs, states, lr, step):
        fe = torch
        gs = [g.to(p.dtype) for g, p in zip(gs, ps)]
        v = fe._foreach_mul([s["velocity"] for s in states], self._momentum)
        fe._foreach_add_(v, gs)
        upd = (fe._foreach_add(gs, fe._foreach_mul(v, self._momentum))
               if self._nesterov else v)
        new = fe._foreach_sub(ps, fe._foreach_mul(upd, lr))
        return new, [{"velocity": t} for t in v]


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
        t = step.to(torch.float32)
        # f32 bias corrections, as the reference's `1 - beta ** t` on f32 t
        bc1 = 1 - torch.pow(self._beta1, t)
        bc2 = 1 - torch.pow(self._beta2, t)
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
