"""Optimizers (counterpart of paddle_tpu/optimizer/optimizer.py).

Each optimizer defines a functional update over lists of tensors
(``init_state`` / ``update_many``; ``update_one`` is the one-parameter
case).  Like the reference, which applies its update to the whole
parameter tree in one compiled call, the port runs each arithmetic step
of the update as one multi-tensor (``torch._foreach_*``) launch over all
parameters, not one launch per parameter.  The eager ``step()`` applies
it to every parameter with a gradient (after the optimizer's
``grad_clip``), with each parameter's ``ParamAttr`` learning-rate
multiplier and regularizer, and ``jit.TrainStep`` applies the same core
through ``optimizer.functional.apply_updates`` (without them, as the
reference's does).  The scalar arithmetic of the
update (bias corrections, decay coefficients) is done in float32 on the
device from the 0-dim learning-rate and step tensors, as the reference
does it, so the two frameworks compute the same update from the same
gradient, and a step captured as a CUDA graph follows ``set_lr`` and the
step count.  Slots have the reference's names and dtypes (f32 moments
whatever the parameter type; Momentum's velocity in the parameter's
type).  ``weight_decay`` is a float (coupled L2) or a
``regularizer.L1Decay`` / ``L2Decay``.  ``learning_rate`` is a number or
an ``optimizer.lr.LRScheduler``, which ``get_lr`` calls at every step (the
caller steps the scheduler); ``state_dict`` / ``set_state_dict`` carry the
step count, the eager step's slots (``param{i}.{slot}``) and the
scheduler's state (``"LR_Scheduler"``) under the reference's keys.
Constructors take the reference's parameters in its order;
``multi_precision``, ``lazy_mode`` and AdamW's ``lr_ratio`` are taken and
change nothing for dense gradients, as in the reference.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "RMSProp", "Adadelta", "Lamb", "LarsMomentum",
           "DecayedAdagrad", "Dpsgd", "Ftrl"]


def _f32(x) -> float:
    """x rounded to float32 (a host scalar the device reads exactly)."""
    return float(np.float32(x))


def _decay_of(weight_decay):
    """(coefficient, mode) of a ``weight_decay`` argument: None, a number
    (L2) or an L1Decay / L2Decay object."""
    if weight_decay is None:
        return 0.0, "l2"
    if isinstance(weight_decay, (int, float)):
        return float(weight_decay), "l2"
    coeff = getattr(weight_decay, "_coeff", getattr(weight_decay, "coeff",
                                                    0.0))
    return float(coeff), getattr(weight_decay, "mode", "l2") or "l2"


def _param_name(p):
    """The name ``apply_decay_param_fun`` sees: the ``ParamAttr`` name
    (torch's tensors carry no ``name``)."""
    return getattr(p, "param_name", None) or getattr(p, "name", None)


def _lr_mult(p) -> float:
    attr = getattr(p, "optimize_attr", None)
    return float(attr.get("learning_rate", 1.0)) if attr else 1.0


def _own_decay(p):
    """A parameter's ``ParamAttr`` regularizer as (coefficient, L1?), or
    None."""
    reg = getattr(p, "regularizer", None)
    if reg is None:
        return None
    return (float(getattr(reg, "_coeff", 0.0)),
            getattr(reg, "mode", "l2") == "l1")


def _f32s(ts):
    return [t.float() for t in ts]


def _cast_back(new, ps):
    return [n.to(p.dtype) for n, p in zip(new, ps)]


def _per(ts, values):
    """``ts`` each times its own 0-dim entry of ``values`` (one launch)."""
    return torch._foreach_mul(ts, list(values.unbind()))


class Optimizer:
    """Base optimizer with Paddle's eager API (step / clear_grad /
    minimize)."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._learning_rate = (learning_rate
                               if isinstance(learning_rate, LRScheduler)
                               else float(learning_rate))
        self._grad_clip = grad_clip
        self._name = name
        # weight_decay: coupled decay added to grads, L2 (coeff * w) or L1
        # (coeff * sign(w)); AdamW overrides with decoupled decay
        self._wd, self._wd_mode = _decay_of(weight_decay)
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
        regs = {k: r for k, p in zip(keys, params)
                if (r := _own_decay(p)) is not None}
        new_p, new_s = apply_updates(
            self, dict(zip(keys, params)), dict(zip(keys, grads)), states,
            _f32(self.get_lr()), self._step_count,
            {k: self._decay_applies(_param_name(p))
             for k, p in zip(keys, params)},
            {k: _lr_mult(p) for k, p in zip(keys, params)}, regs)
        torch._foreach_copy_(params, [new_p[k] for k in keys])
        self._states.update(new_s)

    def clear_grad(self, set_to_zero=True):
        """Drop every listed parameter's gradient (``set_to_zero`` is
        taken and, as in the reference, the gradient is dropped either
        way)."""
        for p in self._parameter_list or []:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Backward and step, as dygraph ``minimize``: returns (None,
        [(param, grad), ...]) of the listed parameters."""
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameter_list or []]

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
                k: torch.as_tensor(v).to(p.device, like[k].dtype
                                         if k in like else None)
                for k, v in st.items()}

    set_dict = set_state_dict


class SGD(Optimizer):
    """p -= lr * g in the parameter's type (reference:
    operators/optimizers/sgd_op)."""

    def update_many(self, ps, gs, states, lr, step):
        gs = [g.to(p.dtype) for g, p in zip(gs, ps)]
        return torch._foreach_sub(ps, torch._foreach_mul(gs, lr)), states


class Momentum(Optimizer):
    """Momentum SGD, with Nesterov's form as an option (reference:
    operators/optimizers/momentum_op): v = momentum * v + g;
    p -= lr * v, or p -= lr * (g + momentum * v) with nesterov."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
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
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
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
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._decoupled_wd = float(weight_decay) if weight_decay else 0.0
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_applies(self, name) -> bool:
        fn = self._apply_decay_param_fun
        if fn is None or not name:
            return True
        return bool(fn(name))


def _bias_correction(beta, step):
    """1 - beta ** t in f32 from the 0-dim int32 step, as the reference's
    ``1 - beta ** t`` on an f32 t."""
    return 1 - torch.pow(beta, step.to(torch.float32))


class Adamax(Optimizer):
    """Adam with the infinity norm (reference:
    operators/optimizers/adamax_op)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_state(self, p):
        return {"moment": torch.zeros_like(p, dtype=torch.float32),
                "inf_norm": torch.zeros_like(p, dtype=torch.float32)}

    def update_many(self, ps, gs, states, lr, step):
        fe = torch
        g32 = _f32s(gs)
        m = fe._foreach_mul([s["moment"] for s in states], self._beta1)
        fe._foreach_add_(m, fe._foreach_mul(g32, 1 - self._beta1))
        u = fe._foreach_maximum(
            fe._foreach_mul([s["inf_norm"] for s in states], self._beta2),
            fe._foreach_abs(g32))
        # upd = lr / (1 - b1^t) * m / (u + eps)
        upd = fe._foreach_mul(m, lr / _bias_correction(self._beta1, step))
        fe._foreach_div_(upd, fe._foreach_add(u, self._eps))
        new = fe._foreach_sub(_f32s(ps), upd)
        return (_cast_back(new, ps),
                [{"moment": a, "inf_norm": b} for a, b in zip(m, u)])


class Adagrad(Optimizer):
    """Accumulated squared gradients (reference:
    operators/optimizers/adagrad_op)."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def init_state(self, p):
        return {"moment": torch.full_like(p, self._init_acc,
                                          dtype=torch.float32)}

    def update_many(self, ps, gs, states, lr, step):
        fe = torch
        g32 = _f32s(gs)
        acc = fe._foreach_add([s["moment"] for s in states],
                              fe._foreach_mul(g32, g32))
        # upd = lr * g / (sqrt(acc) + eps)
        upd = fe._foreach_mul(g32, lr)
        den = fe._foreach_sqrt(acc)
        fe._foreach_add_(den, self._eps)
        fe._foreach_div_(upd, den)
        new = fe._foreach_sub(_f32s(ps), upd)
        return _cast_back(new, ps), [{"moment": a} for a in acc]


class RMSProp(Optimizer):
    """Root-mean-square propagation, centered as an option (reference:
    operators/optimizers/rmsprop_op)."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def init_state(self, p):
        s = {"mean_square": torch.zeros_like(p, dtype=torch.float32),
             "momentum": torch.zeros_like(p, dtype=torch.float32)}
        if self._centered:
            s["mean_grad"] = torch.zeros_like(p, dtype=torch.float32)
        return s

    def update_many(self, ps, gs, states, lr, step):
        fe = torch
        rho = self._rho
        g32 = _f32s(gs)
        ms = fe._foreach_mul([s["mean_square"] for s in states], rho)
        fe._foreach_add_(ms, fe._foreach_mul(fe._foreach_mul(g32, g32),
                                             1 - rho))
        if self._centered:
            mg = fe._foreach_mul([s["mean_grad"] for s in states], rho)
            fe._foreach_add_(mg, fe._foreach_mul(g32, 1 - rho))
            den = fe._foreach_sub(ms, fe._foreach_mul(mg, mg))
        else:
            den = list(ms)
        den = fe._foreach_sqrt(fe._foreach_add(den, self._eps))
        # mom = momentum * mom + lr * g / den
        mom = fe._foreach_mul([s["momentum"] for s in states],
                              self._momentum)
        fe._foreach_add_(mom, fe._foreach_div(fe._foreach_mul(g32, lr), den))
        new = fe._foreach_sub(_f32s(ps), mom)
        out = [{"mean_square": a, "momentum": b} for a, b in zip(ms, mom)]
        if self._centered:
            for st, m in zip(out, mg):
                st["mean_grad"] = m
        return _cast_back(new, ps), out


class Adadelta(Optimizer):
    """reference: operators/optimizers/adadelta_op."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon

    def init_state(self, p):
        return {"avg_squared_grad": torch.zeros_like(p, dtype=torch.float32),
                "avg_squared_update": torch.zeros_like(p,
                                                       dtype=torch.float32)}

    def update_many(self, ps, gs, states, lr, step):
        fe = torch
        rho = self._rho
        g32 = _f32s(gs)
        asu0 = [s["avg_squared_update"] for s in states]
        asg = fe._foreach_mul([s["avg_squared_grad"] for s in states], rho)
        fe._foreach_add_(asg, fe._foreach_mul(fe._foreach_mul(g32, g32),
                                              1 - rho))
        # upd = sqrt(asu + eps) / sqrt(asg + eps) * g
        upd = fe._foreach_div(fe._foreach_sqrt(fe._foreach_add(asu0,
                                                               self._eps)),
                              fe._foreach_sqrt(fe._foreach_add(asg,
                                                               self._eps)))
        fe._foreach_mul_(upd, g32)
        asu = fe._foreach_mul(asu0, rho)
        fe._foreach_add_(asu, fe._foreach_mul(fe._foreach_mul(upd, upd),
                                              1 - rho))
        new = fe._foreach_sub(_f32s(ps), fe._foreach_mul(upd, lr))
        return (_cast_back(new, ps),
                [{"avg_squared_grad": a, "avg_squared_update": b}
                 for a, b in zip(asg, asu)])


class Lamb(Optimizer):
    """Layer-wise adaptive moments (reference:
    operators/optimizers/lamb_op): Adam's direction plus
    ``lamb_weight_decay * p``, scaled per tensor by ||p|| / ||r||.  As in
    the reference, ``exclude_from_weight_decay_fn`` is kept and not
    read."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lamb_wd = lamb_weight_decay
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def init_state(self, p):
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32)}

    def update_many(self, ps, gs, states, lr, step):
        fe = torch
        g32, p32 = _f32s(gs), _f32s(ps)
        m = fe._foreach_mul([s["moment1"] for s in states], self._beta1)
        fe._foreach_add_(m, fe._foreach_mul(g32, 1 - self._beta1))
        v = fe._foreach_mul([s["moment2"] for s in states], self._beta2)
        fe._foreach_add_(v, fe._foreach_mul(fe._foreach_mul(g32, g32),
                                            1 - self._beta2))
        # r = (m / bc1) / (sqrt(v / bc2) + eps) + wd * p
        r = fe._foreach_div(m, _bias_correction(self._beta1, step))
        den = fe._foreach_sqrt(fe._foreach_div(
            v, _bias_correction(self._beta2, step)))
        fe._foreach_add_(den, self._eps)
        fe._foreach_div_(r, den)
        fe._foreach_add_(r, fe._foreach_mul(p32, self._lamb_wd))
        w = torch.stack(fe._foreach_norm(p32))
        rn = torch.stack(fe._foreach_norm(r))
        trust = torch.where((w > 0) & (rn > 0), w / rn, torch.ones_like(w))
        new = fe._foreach_sub(p32, _per(r, lr * trust))
        return (_cast_back(new, ps),
                [{"moment1": a, "moment2": b} for a, b in zip(m, v)])


class LarsMomentum(Optimizer):
    """Momentum with a per-tensor local learning rate (reference:
    operators/optimizers/lars_momentum_op)."""

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay

    def init_state(self, p):
        return {"velocity": torch.zeros_like(p, dtype=torch.float32)}

    def update_many(self, ps, gs, states, lr, step):
        fe = torch
        g32, p32 = _f32s(gs), _f32s(ps)
        w = torch.stack(fe._foreach_norm(p32))
        g = torch.stack(fe._foreach_norm(g32))
        local = torch.where(
            (w > 0) & (g > 0),
            self._lars_coeff * w / (g + self._lars_wd * w + 1e-12),
            torch.ones_like(w))
        # v = momentum * v + lr * local * (g + wd * p)
        v = fe._foreach_mul([s["velocity"] for s in states], self._momentum)
        d = fe._foreach_add(g32, fe._foreach_mul(p32, self._lars_wd))
        fe._foreach_add_(v, _per(d, lr * local))
        new = fe._foreach_sub(p32, v)
        return _cast_back(new, ps), [{"velocity": t} for t in v]


class DecayedAdagrad(Optimizer):
    """reference: operators/optimizers/decayed_adagrad_op: moment = decay
    * moment + (1 - decay) * g^2; p -= lr * g / (sqrt(moment) + eps)."""

    def __init__(self, learning_rate=0.001, decay=0.95, epsilon=1e-6,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._decay, self._eps = decay, epsilon

    def init_state(self, p):
        return {"moment": torch.zeros_like(p, dtype=torch.float32)}

    def update_many(self, ps, gs, states, lr, step):
        fe = torch
        g32 = _f32s(gs)
        m = fe._foreach_mul([s["moment"] for s in states], self._decay)
        fe._foreach_add_(m, fe._foreach_mul(fe._foreach_mul(g32, g32),
                                            1 - self._decay))
        upd = fe._foreach_mul(g32, lr)
        den = fe._foreach_sqrt(m)
        fe._foreach_add_(den, self._eps)
        fe._foreach_div_(upd, den)
        new = fe._foreach_sub(_f32s(ps), upd)
        return _cast_back(new, ps), [{"moment": t} for t in m]


class Dpsgd(Optimizer):
    """Differentially private SGD (reference:
    operators/optimizers/dpsgd_op.h): each gradient clipped to l2 norm
    ``clip``, one Gaussian noise sample per tensor and step scaled by
    ``sigma / batch_size``; p -= lr * (g / scale + noise / batch_size).
    The noise comes from the port's explicit generators
    (``core.rng.current_generator``: the training step's generator inside
    ``jit.TrainStep``, else the device's default one, both seeded by
    ``paddle_tpu_torch.seed``); it is not the reference's stream."""

    def __init__(self, learning_rate=0.001, clip=0.9, batch_size=0.999,
                 sigma=0.9, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._clip, self._bs, self._sigma = clip, batch_size, sigma

    def update_many(self, ps, gs, states, lr, step):
        from ..core import rng
        fe = torch
        g32 = _f32s(gs)
        l2 = torch.stack(fe._foreach_norm(g32))
        scale = torch.clamp(l2 / self._clip, min=1.0)
        dev = ps[0].device
        noise = self._sigma * torch.randn(
            len(ps), device=dev, generator=rng.current_generator(dev))
        d = fe._foreach_div(g32, list(scale.unbind()))
        fe._foreach_add_(d, list((noise / self._bs).unbind()))
        new = fe._foreach_sub(_f32s(ps), fe._foreach_mul(d, lr))
        return _cast_back(new, ps), states


class Ftrl(Optimizer):
    """Follow the regularized leader (reference:
    operators/optimizers/ftrl_op)."""

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def init_state(self, p):
        return {"squared": torch.zeros_like(p, dtype=torch.float32),
                "linear": torch.zeros_like(p, dtype=torch.float32)}

    def update_many(self, ps, gs, states, lr, step):
        fe = torch
        g32, p32 = _f32s(gs), _f32s(ps)
        lp = -self._lr_power
        sq0 = [s["squared"] for s in states]
        sq = fe._foreach_add(sq0, fe._foreach_mul(g32, g32))
        pow_new = fe._foreach_pow(sq, lp)
        # sigma = (sq'^lp - sq^lp) / lr; lin' = lin + g - sigma * p
        sigma = fe._foreach_div(fe._foreach_sub(pow_new,
                                                fe._foreach_pow(sq0, lp)), lr)
        lin = fe._foreach_add([s["linear"] for s in states], g32)
        fe._foreach_sub_(lin, fe._foreach_mul(sigma, p32))
        den = fe._foreach_div(pow_new, lr)
        fe._foreach_add_(den, 2 * self._l2)
        new = [torch.where(ln.abs() > self._l1,
                           (torch.sign(ln) * self._l1 - ln) / dn,
                           torch.zeros_like(ln))
               for ln, dn in zip(lin, den)]
        return (_cast_back(new, ps),
                [{"squared": a, "linear": b} for a, b in zip(sq, lin)])
