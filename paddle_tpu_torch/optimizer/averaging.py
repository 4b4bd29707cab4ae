"""Parameter averaging: EMA, ModelAverage and Lookahead (counterpart of
paddle_tpu/optimizer/averaging.py).

Each keeps device-side f32 accumulators updated after every optimizer
step by multi-tensor launches, and ``apply()`` (a context manager that
restores on exit) / ``restore()`` swap the averaged weights into the
parameters in place for evaluation.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["ExponentialMovingAverage", "ModelAverage", "Lookahead"]


def _float_params(parameters):
    return [p for p in parameters if p.is_floating_point()]


class _Swap:
    """apply / restore of averaged values over ``self._params``."""

    _backup = None

    @torch.no_grad()
    def _swap_in(self, values):
        self._backup = [p.detach().clone() for p in self._params]
        torch._foreach_copy_([p.data for p in self._params],
                             [v.to(p.dtype) for v, p in
                              zip(values, self._params)])

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        torch._foreach_copy_([p.data for p in self._params], self._backup)
        self._backup = None


class ExponentialMovingAverage(_Swap):
    """shadow = decay * shadow + (1 - decay) * param in f32, with the
    reference's optional ramp ``thres_steps``: min(decay, (1 + t) / (10 +
    t))."""

    def __init__(self, decay: float = 0.999, thres_steps: bool = False,
                 parameters=None, name: Optional[str] = None):
        if parameters is None:
            raise ValueError("EMA needs the parameter list")
        self._decay = float(decay)
        self._thres = bool(thres_steps)
        self._params = _float_params(parameters)
        self._step = 0
        self._shadow = [p.detach().clone() for p in self._params]

    @torch.no_grad()
    def update(self):
        self._step += 1
        d = self._decay
        if self._thres:
            d = min(d, (1.0 + self._step) / (10.0 + self._step))
        d = np.float32(d)
        self._shadow = torch._foreach_add(
            torch._foreach_mul([s.float() for s in self._shadow], float(d)),
            torch._foreach_mul([p.detach().float() for p in self._params],
                               float(np.float32(1) - d)))

    @contextlib.contextmanager
    def apply(self, need_restore: bool = True):
        """The averaged weights in place of the parameters inside the
        block; restored on exit unless ``need_restore`` is False."""
        self._swap_in(self._shadow)
        try:
            yield self
        finally:
            if need_restore:
                self.restore()

    def state_dict(self) -> Dict[str, object]:
        return {"step": self._step,
                "shadow": [s.detach().cpu() for s in self._shadow]}

    def set_state_dict(self, state):
        self._step = int(state["step"])
        self._shadow = [torch.as_tensor(np.asarray(s)).to(p.device)
                        for s, p in zip(state["shadow"], self._params)]


class ModelAverage(_Swap):
    """Running sums over a sliding window (the reference's ModelAverage):
    sum_1 (the current block), sum_2 / sum_3 (older blocks); ``apply``
    puts (sum_1 + sum_2 + sum_3) / n in the parameters."""

    def __init__(self, average_window_rate: float, parameters=None,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000,
                 name: Optional[str] = None):
        if parameters is None:
            raise ValueError("ModelAverage needs the parameter list")
        self._rate = float(average_window_rate)
        self._min_w = int(min_average_window)
        self._max_w = int(max_average_window)
        self._params = _float_params(parameters)
        self._sum1 = self._zeros()
        self._sum2, self._sum3 = self._zeros(), self._zeros()
        self._n1 = self._n2 = self._n3 = 0

    def _zeros(self):
        return [torch.zeros_like(p, dtype=torch.float32)
                for p in self._params]

    @property
    def _window(self):
        total = self._n1 + self._n2 + self._n3
        return max(self._min_w, int(self._rate * total))

    @torch.no_grad()
    def step(self):
        """Accumulate the current parameters (once per optimizer step)."""
        self._sum1 = torch._foreach_add(
            self._sum1, [p.detach().float() for p in self._params])
        self._n1 += 1
        if self._n1 >= min(self._max_w, self._window):
            # rotate the blocks: sum_3 <- sum_2, sum_2 <- sum_1
            self._sum3, self._n3 = self._sum2, self._n2
            self._sum2, self._n2 = self._sum1, self._n1
            self._sum1, self._n1 = self._zeros(), 0

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore: bool = True):
        n = self._n1 + self._n2 + self._n3
        if n == 0:
            yield self
            return
        total = torch._foreach_add(torch._foreach_add(self._sum1,
                                                      self._sum2),
                                   self._sum3)
        self._swap_in(torch._foreach_div(total, float(n)))
        try:
            yield self
        finally:
            if need_restore:
                self.restore()


class Lookahead:
    """Lookahead (the reference's LookaheadOptimizer, arXiv:1907.08610):
    the inner ("fast") optimizer steps; every k steps the slow weights
    move slow += alpha * (fast - slow) and the fast weights take them."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        if inner_optimizer is None:
            raise ValueError("Lookahead needs an inner optimizer")
        self.inner_optimizer = inner_optimizer
        self.alpha, self.k = float(alpha), int(k)
        self._params = _float_params(inner_optimizer._parameter_list or [])
        self._slow = [p.detach().clone() for p in self._params]
        self._n = 0

    def step(self):
        self.inner_optimizer.step()
        self._n += 1
        if self._n % self.k == 0:
            with torch.no_grad():
                fast = [p.detach().to(s.dtype)
                        for p, s in zip(self._params, self._slow)]
                self._slow = torch._foreach_add(
                    self._slow, torch._foreach_mul(
                        torch._foreach_sub(fast, self._slow), self.alpha))
                torch._foreach_copy_([p.data for p in self._params],
                                     [s.to(p.dtype) for s, p in
                                      zip(self._slow, self._params)])

    def clear_grad(self, set_to_zero=True):
        self.inner_optimizer.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, [(p, p.grad)
                      for p in self.inner_optimizer._parameter_list or []]

    def get_lr(self):
        return self.inner_optimizer.get_lr()
