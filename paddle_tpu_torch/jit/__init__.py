"""Training step (counterpart of paddle_tpu/jit/__init__.py's TrainStep).

The reference compiles forward, backward and the optimizer update into
one XLA program per step.  The port runs the same step eagerly: forward
under the step's explicit generator and AMP policy, ``torch.autograd.grad``
for the trainable parameters, then ``optimizer.functional.apply_updates``,
written back in place.  Nothing in the step reads a device value on the
host: the loss is returned as a device tensor, and with ``guard=True`` the
finiteness verdict selects the old or the new state on the device.

Running statistics (BatchNorm's ``_mean`` / ``_variance``) are updated
as the reference's compiled step updates them: the forward logs each
update through ``core.buffer_updates.capture()``, the updates compound
from one micro-batch to the next under ``accum_steps``, and the step
writes them after the optimizer update, beside the parameters; under
``guard=True`` a step that is not finite keeps the old buffers too.
``layout_policy`` is re-exported here as in the reference
(``jit.layout_policy("NHWC")``).

As in the reference, ``TrainStep`` applies no ``grad_clip`` (its compiled
step never clips; only the eager ``Optimizer.step`` does).

Not in this slice of the port, and refused with ``UnimplementedError``:
``mesh`` / ``batch_sharding``, ``remat``, ``with_outputs``, ``run_steps``,
checkpoints, and sparse or row-sharded gradients (the port's ``Embedding``
has no sparse mode).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import amp as amp_mod
from ..core import buffer_updates as _bufup
from ..core import rng
from ..core.layout import layout_policy  # noqa: F401  (jit.layout_policy)
from ..core.errors import UnimplementedError
from ..optimizer.functional import apply_updates, decay_flags

__all__ = ["state_arrays", "forward_loss", "guard_select", "TrainStep",
           "layout_policy"]

_LATER = "comes with a later slice of the port"


def state_arrays(layer) -> Dict[str, torch.Tensor]:
    """Named parameter and buffer tensors (detached), the reference's
    state names."""
    return {k: v.detach()
            for k, v in layer.state_dict(keep_vars=True).items()}


@contextlib.contextmanager
def _training(model, training: bool = True):
    modes = [(m, m.training) for m in model.modules()]
    for m, _ in modes:
        m.training = training
    try:
        yield
    finally:
        for m, mode in modes:
            m.training = mode


def forward_loss(model, loss_fn, batch, generator=None, amp_level=None,
                 amp_dtype="bfloat16"):
    """Training-mode forward and loss: ``loss_fn(*outputs, batch[-1])`` of
    ``model(*batch[:-1])``, with dropout drawing from ``generator`` and,
    with ``amp_level``, under ``amp.auto_cast``."""
    gen_ctx = (rng.generator_scope(generator) if generator is not None
               else contextlib.nullcontext())
    amp_ctx = (amp_mod.auto_cast(level=amp_level, dtype=amp_dtype)
               if amp_level else contextlib.nullcontext())
    with _training(model), gen_ctx, amp_ctx:
        out = model(*batch[:-1])
        outs = out if isinstance(out, tuple) else (out,)
        return loss_fn(*outs, batch[-1])


def guard_select(params, opt_state, new_params, new_opt, loss, grads):
    """The device-side step guard: finiteness of the loss and of the
    global gradient norm, and the old state selected where the step is
    bad, all on the device (no host sync).  Returns (params, opt_state,
    grad_norm, ok)."""
    leaves = [g.float() for g in grads.values()]
    gnorm = (torch.sqrt(sum(torch.sum(g * g) for g in leaves)) if leaves
             else torch.zeros((), device=loss.device))
    ok = torch.isfinite(loss) & torch.isfinite(gnorm)

    def sel(new, old):
        return {k: ({s: torch.where(ok, v[s], old[k][s]) for s in v}
                    if isinstance(v, dict) else torch.where(ok, v, old[k]))
                for k, v in new.items()}
    return sel(new_params, params), sel(new_opt, opt_state), gnorm, ok


class TrainStep:
    """One training step: ``step(*batch) -> loss`` (a device scalar).

    ``loss_fn(*model_outputs, label)`` with ``label = batch[-1]`` and the
    model fed ``batch[:-1]``.  ``amp_level`` "O1"/"O2" runs the forward
    under ``amp.auto_cast``.  ``guard=True`` leaves parameters and
    optimizer moments unchanged for a step whose loss or gradient norm is
    not finite, and keeps (grad_norm, ok) on ``last_guard``.
    ``accum_steps=k`` splits the batch into k micro-batches along axis 0
    and averages their f32 gradients before one update."""

    def __init__(self, model, loss_fn: Callable, optimizer,
                 amp_level: Optional[str] = None, amp_dtype="bfloat16",
                 mesh=None, batch_sharding=None, remat: bool = False,
                 with_outputs: bool = False, guard: bool = False,
                 accum_steps: int = 1):
        for name, val in (("mesh", mesh), ("batch_sharding", batch_sharding),
                          ("remat", remat), ("with_outputs", with_outputs)):
            if val:
                raise UnimplementedError(f"TrainStep({name}=...) {_LATER}")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.amp_level = amp_level
        self.amp_dtype = amp_dtype
        self.accum_steps = int(accum_steps)
        if self.accum_steps < 1:
            raise ValueError("TrainStep: accum_steps must be >= 1")
        state = model.state_dict(keep_vars=True)
        self._trainable = [k for k, v in state.items()
                           if isinstance(v, torch.nn.Parameter)
                           and v.requires_grad]
        self._decay = decay_flags(optimizer, self._trainable)
        self._opt_state = None
        self._guard = bool(guard)
        self.last_guard = None

    def init_opt_state(self, state):
        return {k: self.optimizer.init_state(state[k])
                for k in self._trainable}

    def _grads(self, params, batch, gen):
        """(loss, {name: grad}, {buffer name: new value}) over
        ``accum_steps`` micro-batches; buffer updates are logged, not
        applied, and compound from one micro-batch to the next."""
        with _bufup.capture() as log:
            loss, grads = self._micro_grads(params, batch, gen)
        return loss, grads, _bufup.resolve(
            log, self.model.state_dict(keep_vars=True))

    def _micro_grads(self, params, batch, gen):
        args = [params[k] for k in self._trainable]

        def one(micro):
            loss = forward_loss(self.model, self.loss_fn, micro, gen,
                                self.amp_level, self.amp_dtype)
            return loss, torch.autograd.grad(loss, args, allow_unused=True)

        k = self.accum_steps
        if k == 1:
            loss, gs = one(batch)
        else:
            for b in batch:
                if b.shape[0] % k:
                    raise ValueError(
                        f"TrainStep(accum_steps={k}): batch dim "
                        f"{b.shape[0]} is not divisible by accum_steps")
            acc = [torch.zeros(a.shape, dtype=torch.float32,
                               device=a.device) for a in args]
            losses = []
            for micro in zip(*[b.chunk(k) for b in batch]):
                loss_i, gs = one(micro)
                losses.append(loss_i.detach())
                for a, g in zip(acc, gs):
                    if g is not None:
                        a += g.float()
            loss = torch.stack(losses).mean()
            gs = [(a / k).to(p.dtype) for a, p in zip(acc, args)]
        grads = {n: (g if g is not None else torch.zeros_like(p))
                 for n, g, p in zip(self._trainable, gs, args)}
        return loss.detach(), grads

    def __call__(self, *batch):
        state = self.model.state_dict(keep_vars=True)
        params = {k: state[k] for k in self._trainable}
        if self._opt_state is None:
            self._opt_state = self.init_opt_state(
                {k: p.detach() for k, p in params.items()})
        dev = next(iter(params.values())).device
        gen = rng.step_generator(dev)   # fresh per step: masks differ
        loss, grads, bufs = self._grads(params, batch, gen)
        opt = self.optimizer
        opt._step_count += 1
        lr = float(np.float32(opt.get_lr()))
        with torch.no_grad():
            cur = {k: p.detach() for k, p in params.items()}
            new_params, new_opt = apply_updates(
                opt, cur, grads, self._opt_state, lr, opt._step_count,
                self._decay)
            # running statistics ride the same step, after the update
            cur.update({k: state[k].detach() for k in bufs})
            new_params.update(bufs)
            if self._guard:
                new_params, new_opt, gnorm, ok = guard_select(
                    cur, self._opt_state, new_params, new_opt, loss, grads)
                self.last_guard = (gnorm, ok)
            torch._foreach_copy_([state[k] for k in new_params],
                                 list(new_params.values()))
            self._opt_state = new_opt
        return loss

    def run_steps(self, *stacked_batch):
        raise UnimplementedError(f"TrainStep.run_steps {_LATER}")

    def save_checkpoint(self, *args, **kwargs):
        raise UnimplementedError(f"TrainStep checkpoints {_LATER}")

    def load_checkpoint(self, *args, **kwargs):
        raise UnimplementedError(f"TrainStep checkpoints {_LATER}")
