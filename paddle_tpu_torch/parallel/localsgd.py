"""LocalSGD training step (counterpart of paddle_tpu/parallel/localsgd.py).

Every data-parallel rank applies its own gradients for ``k_steps`` steps
(no gradient reduction), then the ranks average their parameters.  With
SGD and k = 1 this is synchronous data parallelism.

The reference keeps every replica as one slice of a stacked (dp, ...)
array; the port keeps this rank's replica: a copy of every trainable
parameter (and its optimizer state) that the step's program swaps in as
the parameter's data while it runs (``jit.TrainStep``'s program, captured
on the card).  ``sync()`` (every ``k_steps`` calls) averages the replicas
over ``dp`` and writes the average, broadcast from rank 0, into the
model's tensors: ``model.state_dict()`` shows replica 0's weights as of
the last sync, as the reference's eval view.  A checkpoint holds the
stacked (dp, ...) arrays of the reference's layout, each rank writing its
own slice.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..core import buffer_updates as _bufup
from ..jit import TrainStep
from ..optimizer.functional import update_in_place
from .mesh import get_mesh

__all__ = ["LocalSGDTrainStep"]


class LocalSGDTrainStep(TrainStep):
    """``step(*batch) -> mean loss across replicas``; ``sync()`` averages
    the replicas (module docstring)."""

    def __init__(self, model, loss_fn, optimizer, k_steps: int = 4,
                 mesh=None, amp_level=None, amp_dtype="bfloat16"):
        super().__init__(model, loss_fn, optimizer, amp_level=amp_level,
                         amp_dtype=amp_dtype)
        self.k_steps = int(k_steps)
        self.mesh = mesh or get_mesh(create_default=True)
        self.dp = self.mesh.shape["dp"]
        self._group = self.mesh.group("dp")
        self._replica = None     # name -> this rank's replica
        self._since_sync = 0

    def _place(self):
        if self._replica is None:
            state = self.model.state_dict(keep_vars=True)
            with torch.no_grad():
                self._replica = {k: state[k].detach().clone()
                                 for k in self._trainable}

    def _setup(self):
        self._place()
        super()._setup()
        self._gen.manual_seed(self._gen.initial_seed()
                              + 1000003 * self.mesh.coord("dp"))

    def _state_tensors(self):
        return super()._state_tensors() + list(self._replica.values())

    def _local(self, batch):
        if self.dp == 1:
            return batch
        out = []
        for b in batch:
            n = b.shape[0] // self.dp
            out.append(b.narrow(0, self.mesh.coord("dp") * n, n))
        return tuple(out)

    def _step_program(self, lr, step_no, nan_window=None, **inputs):
        state = self.model.state_dict(keep_vars=True)
        params = {k: state[k] for k in self._trainable}
        batch = self._local(tuple(v for k, v in inputs.items()
                                  if k.startswith("b")))
        views = {k: p.data for k, p in params.items()}
        try:
            for k, p in params.items():
                p.data = self._replica[k]
            with _bufup.dropped():
                loss, grads, outs = self._micro_grads(params, batch)
        finally:
            for k, v in views.items():
                params[k].data = v
        with torch.no_grad():
            update_in_place(self.optimizer, self._replica, grads,
                            self._opt_state, lr, step_no, self._decay)
            if self._group is not None:
                loss = loss.float().clone()
                dist.all_reduce(loss, group=self._group)
                loss = loss / self.dp
        return (loss, *outs)

    def __call__(self, *batch):
        loss = super().__call__(*batch)
        self._since_sync += 1
        if self._since_sync >= self.k_steps:
            self.sync()
        return loss

    @torch.no_grad()
    def sync(self):
        """Average the replicas over ``dp`` (the LocalSGD all-reduce) and
        refresh the model's tensors with rank 0's average."""
        if self._replica is None:
            return
        state = self.model.state_dict(keep_vars=True)
        names = sorted(self._replica)
        if self._group is not None and names:
            flat = torch.cat([self._replica[k].reshape(-1).float()
                              for k in names])
            dist.all_reduce(flat, group=self._group)
            flat /= self.dp
            src = dist.get_global_rank(self._group, 0)
            dist.broadcast(flat, src=src, group=self._group)
            for k, part in zip(names, flat.split(
                    [self._replica[k].numel() for k in names])):
                self._replica[k].copy_(part.view(self._replica[k].shape))
        for k in names:
            state[k].detach().copy_(self._replica[k])
        self._since_sync = 0

    # -- checkpoints (the reference's stacked layout) ------------------------
    def _tree(self):
        from ..distributed.checkpoint import Shard
        if self._gen is None:
            self._setup()
        c, dp = self.mesh.coord("dp"), self.dp
        owner = all(self.mesh.coord(a) == 0 for a in self.mesh.shape
                    if a != "dp")

        def stacked(t):
            t = t.detach()
            return Shard(t.unsqueeze(0), (dp,) + tuple(t.shape),
                         (slice(c, c + 1),) + tuple(
                             slice(0, n) for n in t.shape), ["dp"], owner)
        state = self.model.state_dict(keep_vars=True)
        params = {k: stacked(self._replica.get(k, v)) for k, v in
                  state.items()}
        opt = {k: {s: stacked(t) for s, t in slots.items()}
               for k, slots in self._opt_state.items()}
        return {"params": params, "opt": opt}

    def save_checkpoint(self, directory: str, step=None, extra_meta=None):
        from ..distributed import checkpoint as dck
        tree = self._tree()
        return dck.save_train_state(
            directory, tree["params"], tree["opt"],
            step if step is not None else self.optimizer._step_count,
            extra_meta, optimizer=self.optimizer, generator=self._gen)

    @torch.no_grad()
    def restore_checkpoint(self, directory: str) -> Optional[dict]:
        from ..distributed import checkpoint as dck
        from .mesh import NamedSharding, P
        tree = self._tree()
        sh = NamedSharding(self.mesh, P("dp"))
        shardings = {"params": {k: sh for k in tree["params"]},
                     "opt": {k: {s: sh for s in slots}
                             for k, slots in tree["opt"].items()}}
        res = dck.restore_sharded(directory, mesh=self.mesh,
                                  shardings=shardings)
        if res is None:
            return None
        got, step, extra = res
        state = self.model.state_dict(keep_vars=True)
        for k, v in got["params"].items():
            dst = self._replica[k] if k in self._replica else \
                state[k].detach()
            dst.copy_(v[0].to(dst.dtype))
        for k, slots in got.get("opt", {}).items():
            for s, v in slots.items():
                if k in self._opt_state and s in self._opt_state[k]:
                    t = self._opt_state[k][s]
                    t.copy_(v[0].to(t.dtype))
        meta = dck.restore_train_extras(self.optimizer, step, extra,
                                        generator=self._gen)
        for k, r in self._replica.items():   # the eval view: rank 0's
            buf = r.clone()
            if self._group is not None:
                dist.broadcast(buf, src=dist.get_global_rank(self._group, 0),
                               group=self._group)
            state[k].detach().copy_(buf)
        return meta
