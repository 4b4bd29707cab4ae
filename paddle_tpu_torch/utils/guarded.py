"""GuardedTrainStep: the host-side policy around a guarded training step
(counterpart of paddle_tpu/utils/guarded.py).

The device half is ``jit.TrainStep(guard=True)``: the step program checks
the loss and the global gradient norm for finiteness and keeps the old
parameters, moments and running statistics where they are not, with no
host read.  This wrapper adds the policy:

- one host read per step of (loss, grad_norm, ok) together;
- skip-and-decay: a non-finite step drives an attached ``GradScaler``'s
  state machine (``record_skip``), AMP or not;
- loss-spike detection against a rolling window of recent finite losses
  (a finite spike was applied; it counts toward the bad streak, and the
  rollback handles sustained divergence);
- after ``max_bad_steps`` bad steps in a row, a rollback to the last
  checkpoint inside a ``guarded_rollback`` span, and a record per bad step
  in ``<checkpoint_dir>/quarantine.jsonl`` with the reference's fields.

``STAT_guarded_bad_steps``, ``STAT_guarded_rollbacks`` and
``STAT_guarded_rollback_failures`` count them (the report's
``guard_bad_steps`` / ``guard_rollbacks``).

    step = jit.TrainStep(model, loss_fn, opt, guard=True)
    gstep = GuardedTrainStep(step, checkpoint_dir=ckpt, max_bad_steps=3)
    for batch in loader:
        loss = gstep(*batch)
        if gstep.last_skipped:
            continue
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Optional

import torch

__all__ = ["GuardedTrainStep"]


class GuardedTrainStep:
    """Policy wrapper over a ``TrainStep`` with ``guard=True``."""

    def __init__(self, step, checkpoint_dir: Optional[str] = None,
                 scaler=None, spike_window: int = 32,
                 spike_factor: float = 8.0, min_window: int = 8,
                 max_bad_steps: int = 3):
        if getattr(step, "_programs", None) and not step._guard:
            raise ValueError(
                "GuardedTrainStep needs the inner step built with "
                "guard=True (it already made programs without the guard)")
        step._guard = True
        self.step = step
        self.checkpoint_dir = checkpoint_dir
        self.scaler = scaler
        self.spike_factor = float(spike_factor)
        self.min_window = int(min_window)
        self.max_bad_steps = int(max_bad_steps)
        self._window: deque = deque(maxlen=int(spike_window))
        self.bad_streak = 0
        self.quarantine: list = []
        self.last_skipped = False
        self.last_reason: Optional[str] = None

    # passthroughs ----------------------------------------------------------
    @property
    def model(self):
        return self.step.model

    @property
    def optimizer(self):
        return self.step.optimizer

    def save_checkpoint(self, directory=None, step=None, extra_meta=None,
                        data_cursor=None):
        return self.step.save_checkpoint(
            directory or self.checkpoint_dir, step=step,
            extra_meta=extra_meta, scaler=self.scaler,
            data_cursor=data_cursor)

    def restore_checkpoint(self, directory=None):
        return self.step.restore_checkpoint(directory or self.checkpoint_dir,
                                            scaler=self.scaler)

    # the guarded call ------------------------------------------------------
    def __call__(self, *batch):
        loss_t = self.step(*batch)
        gnorm_d, ok_d = self.step.last_guard
        # one host read for the three
        loss, gnorm, ok = torch.stack(
            [loss_t.detach().float().reshape(()), gnorm_d.float(),
             ok_d.float()]).tolist()
        ok = bool(ok)
        reason = None
        if not ok:
            reason = "nonfinite"
        elif self._is_spike(loss):
            reason = "loss_spike"
        if reason is None:
            self._window.append(loss)
            self.bad_streak = 0
            self.last_skipped = False
            self.last_reason = None
        else:
            self._on_bad_step(reason, loss, gnorm)
        return loss_t

    def _is_spike(self, loss: float) -> bool:
        if len(self._window) < self.min_window:
            return False
        med = sorted(self._window)[len(self._window) // 2]
        return abs(loss) > self.spike_factor * max(abs(med), 1e-12)

    def _on_bad_step(self, reason: str, loss: float, gnorm: float):
        from .monitor import stat_add
        stat_add("STAT_guarded_bad_steps")
        self.bad_streak += 1
        self.last_skipped = reason == "nonfinite"   # spikes were applied
        self.last_reason = reason
        rec = {"step": int(self.step.optimizer._step_count),
               "reason": reason, "loss": loss, "grad_norm": gnorm,
               "bad_streak": self.bad_streak, "time": time.time(),
               "skipped_on_device": self.last_skipped}
        if reason == "nonfinite" and self.scaler is not None:
            self.scaler.record_skip()
            rec["loss_scale"] = self.scaler.get_init_loss_scaling()
        if (self.bad_streak >= self.max_bad_steps
                and self.checkpoint_dir is not None):
            from ..observability import span as _span
            with _span("guarded_rollback", args={"reason": reason}):
                meta = self.restore_checkpoint()
            if meta is not None:
                rec["rolled_back_to"] = meta["step"]
                stat_add("STAT_guarded_rollbacks")
                self.bad_streak = 0
                self._window.clear()
            else:
                # nothing was restored: the streak and the spike window
                # stay, so detection is not rebased on the diverged losses
                rec["rolled_back_to"] = None
                rec["rollback_failed"] = "no restorable checkpoint"
                stat_add("STAT_guarded_rollback_failures")
        self.quarantine.append(rec)
        self._append_quarantine(rec)

    def _append_quarantine(self, rec: dict):
        if self.checkpoint_dir is None:
            return
        try:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            with open(os.path.join(self.checkpoint_dir,
                                   "quarantine.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass   # the bookkeeping never ends the run
