"""Exported training programs (port of paddle_tpu/jit/train_export.py).

Reference: paddle/fluid/train/demo/demo_trainer.cc (Python saves a train
program, a standalone process loads it and drives it per batch).  The
reference exports its whole fused step (forward, backward and the
optimizer update) as StableHLO.  The port writes the same three files
under one prefix, in its own forms:

- ``<path>.pdtrain``: a ``torch.export`` archive of the training-mode loss
  as a pure function of (trainable parameters, the other state, a
  dropout key, the sparse lookups' zero leaves, the batch) returning
  (loss, the lookups' ids).  Like the port's ``.pdmodel`` it holds no
  weights.  Dropout masks and attention-dropout seeds come from the key
  (``core.rng.keyed_scope``), the AMP casts are the traced ones, K1 is
  the operator node ``paddle_tpu_torch::flash_fwd``, whose registered
  backward is K2.
- ``<path>.pdstate.npz``: the reference's keys, ``s{i}`` for the state
  leaves and ``o{i}`` for the optimizer-state leaves, in the reference's
  leaf order (the state's names sorted; each trainable name's slots
  sorted), so its parameter arrays equal the reference's on the same
  weights.
- ``<path>.pdtrainmeta``: JSON (the reference pickles jax treedefs, which
  cannot be read without jax): the format, the state and optimizer-state
  names, the optimizer's class and hyperparameters, the decay flags, the
  lr, the seed, the batch specs, the AMP level, remat and the sparse
  lookups.

``TrainSession(path)`` loads the program and steps it: it differentiates
the loss with ``torch.autograd.grad`` (under ``remat`` the program call
is one checkpoint region), applies the port's functional update in place
(``optimizer.functional.update_in_place``; a sparse weight's gradient is
a ``RowSparseGrad`` and takes the lazy row update) and keeps the state.
Each batch signature is a ``core.programs.Program``: on the card it is
captured as a CUDA graph at its first step and replayed after that.  The
dropout key of step t is the seed's key folded in at t
(``generation.keyed.fold_in``), drawn on the device.

A reference artifact (a StableHLO ``.pdtrain`` or a pickled
``.pdtrainmeta``) is refused with ``ArtifactFormatError``.  The C ABI's
trainer (``PD_CreateTrainer``) is not ported.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
import zipfile
from typing import Sequence

import numpy as np
import torch

from .. import amp as amp_mod
from ..core import recompute as _recompute
from ..core import rng
from ..core import selected_rows as sr
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.programs import Program
from ..optimizer.functional import update_in_place
from ..weights import dtype_name, host_array, host_tensor
from .export import ArtifactFormatError, InputSpec

__all__ = ["save_train_program", "TrainSession"]

FORMAT = "paddle_tpu_torch.train/1"


class _TrainLoss(torch.nn.Module):
    """The training-mode loss as a function of its state and batch; the
    model stays outside the module tree, so nothing of it is lifted."""

    def __init__(self, model, loss_fn, amp_level, amp_dtype, deny):
        super().__init__()
        object.__setattr__(self, "_model", model)
        object.__setattr__(self, "_loss_fn", loss_fn)
        self._amp = (amp_level, amp_dtype)
        self._deny = tuple(deny)

    def forward(self, params, buffers, key, zeros, *batch):
        from . import _training
        state = dict(buffers)
        state.update(params)
        ctx = sr.SparseGradContext(
            "apply", zeros=zeros, deny=self._deny,
            names={id(v): k for k, v in state.items()})
        level, dtype = self._amp
        with rng.keyed_scope(key), _training(self._model), (
                sr.use_ctx(ctx) if zeros else contextlib.nullcontext()), (
                amp_mod.auto_cast(level=level, dtype=dtype) if level
                else contextlib.nullcontext()):
            out = torch.func.functional_call(self._model, state,
                                             tuple(batch[:-1]))
            outs = out if isinstance(out, tuple) else (out,)
            loss = self._loss_fn(*outs, batch[-1])
        return loss, {k: ctx.ids[k] for k in zeros}


def _spec(s):
    if isinstance(s, InputSpec):
        return s
    shape, dtype = s
    return InputSpec(tuple(shape), dtype)


def _hparams(optimizer) -> dict:
    """The optimizer's JSON-able settings (its private attributes)."""
    skip = {"_parameter_list", "_learning_rate", "_grad_clip", "_states",
            "_step_count", "_name"}
    return {k: v for k, v in vars(optimizer).items()
            if k.startswith("_") and k not in skip
            and isinstance(v, (int, float, str, bool, type(None)))}


def _opt_names(opt_state):
    return [[k, slot] for k in sorted(opt_state)
            for slot in sorted(opt_state[k])]


def save_train_program(model, loss_fn, optimizer, path: str,
                       input_specs: Sequence, amp_level=None,
                       amp_dtype="bfloat16", remat=False, seed: int = 0):
    """Write one training step's program and its initial state (module
    docstring).  ``input_specs``: InputSpec or (shape, dtype) per batch
    input (inputs..., label), concrete shapes.  Returns ``path``."""
    from . import TrainStep
    step = TrainStep(model, loss_fn, optimizer, amp_level=amp_level,
                     amp_dtype=amp_dtype, remat=remat)
    step._setup()
    state = {k: v.detach()
             for k, v in model.state_dict(keep_vars=True).items()}
    dev = next(iter(state.values())).device
    specs = [_spec(s) for s in input_specs]
    batch = tuple(torch.zeros(s.shape, dtype=s.dtype, device=dev)
                  for s in specs)
    sparse = step._sparse_specs(batch) if step._sparse else {}
    zeros = {k: torch.zeros((n, w), dtype=dt, device=dev)
             for k, (n, w, dt) in sparse.items()}
    trainable = step._trainable
    params = {k: state[k] for k in trainable}
    buffers = {k: v for k, v in state.items() if k not in params}
    key = torch.zeros(2, dtype=torch.int64, device=dev)
    prog = _TrainLoss(model, loss_fn, amp_level, amp_dtype,
                      step._sparse_deny)
    ep = torch.export.export(prog, (params, buffers, key, zeros) + batch)
    ep.example_inputs = None   # the weights stay in the npz only
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".pdtrain", "wb") as f:
        torch.export.save(ep, f)
    names = sorted(state)
    opt_state = step._opt_state
    np.savez(path + ".pdstate.npz",
             **{f"s{i}": host_array(state[k]) for i, k in enumerate(names)},
             **{f"o{i}": host_array(opt_state[k][slot])
                for i, (k, slot) in enumerate(_opt_names(opt_state))})
    meta = {
        "format": FORMAT, "state_names": names, "trainable": trainable,
        "opt_names": _opt_names(opt_state),
        "optimizer": {"class": type(optimizer).__name__,
                      "module": type(optimizer).__module__,
                      "hparams": _hparams(optimizer)},
        "decay": step._decay, "lr": float(optimizer.get_lr()),
        "seed": int(seed),
        "batch_specs": [[list(s.shape), dtype_name(s.dtype)] for s in specs],
        "amp_level": amp_level, "amp_dtype": str(amp_dtype),
        "remat": bool(remat),
        "sparse": {k: [n, w, dtype_name(dt)]
                   for k, (n, w, dt) in sparse.items()}}
    with open(path + ".pdtrainmeta", "w") as f:
        json.dump(meta, f)
    return path


def _optimizer(meta):
    import importlib
    spec = meta["optimizer"]
    cls = getattr(importlib.import_module(spec["module"]), spec["class"])
    opt = cls.__new__(cls)
    opt.__dict__.update(spec["hparams"])
    opt.__dict__.update(_parameter_list=None, _learning_rate=meta["lr"],
                        _grad_clip=None, _states={}, _step_count=0,
                        _name=None)
    return opt


class TrainSession:
    """Drive a saved train program: holds the state, steps per batch.
    ``device`` defaults to the card."""

    def __init__(self, path: str, device=DEFAULT_DEVICE):
        prog_file = path + ".pdtrain"
        if not zipfile.is_zipfile(prog_file):
            raise ArtifactFormatError(
                f"{prog_file} is not a torch.export archive (a StableHLO "
                "program of the JAX framework?): save the training program "
                "again with paddle_tpu_torch.jit.save_train_program")
        try:
            with open(path + ".pdtrainmeta") as f:
                meta = json.load(f)
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ArtifactFormatError(
                f"{path}.pdtrainmeta is not the port's JSON metadata ({e})")
        if meta.get("format") != FORMAT:
            raise ArtifactFormatError(
                f"{path}.pdtrainmeta: unknown format {meta.get('format')!r}")
        dev = resolve_device(device)
        from ..ops import flash_attention, int8_matmul  # noqa: F401 (ops)
        from torch.export.passes import move_to_device_pass
        with open(prog_file, "rb") as f:
            ep = torch.export.load(f)
        self._module = move_to_device_pass(ep, dev).module()
        self._meta = meta
        self.device = dev
        with np.load(path + ".pdstate.npz") as data:
            self._state = {k: host_tensor(data[f"s{i}"]).to(dev)
                           for i, k in enumerate(meta["state_names"])}
            self._opt_state = {}
            for i, (k, slot) in enumerate(meta["opt_names"]):
                self._opt_state.setdefault(k, {})[slot] = host_tensor(
                    data[f"o{i}"]).to(dev)
        self._trainable = list(meta["trainable"])
        for k in self._trainable:
            self._opt_state.setdefault(k, {})
        self._sparse = {k: (n, w, getattr(torch, dt))
                        for k, (n, w, dt) in meta["sparse"].items()}
        sparse_names = {sr.param_name(k) for k in self._sparse}
        self._dense = [k for k in self._trainable if k not in sparse_names]
        for k in self._dense:
            self._state[k].requires_grad_(True)
        self._optimizer = _optimizer(meta)
        self.lr = meta["lr"]
        self._step_no = 0
        self._lr_t = torch.zeros((), dtype=torch.float32, device=dev)
        self._step_t = torch.zeros((), dtype=torch.int32, device=dev)
        self._base_key = torch.tensor([[0, meta["seed"] & 0xFFFFFFFF]],
                                      dtype=torch.int64, device=dev)
        self._programs = {}
        self._pool = None

    @property
    def batch_specs(self):
        return [(tuple(s), d) for s, d in self._meta["batch_specs"]]

    def _program_fn(self, lr, step_no, **inputs):
        from ..generation.keyed import fold_in
        batch = tuple(v for k, v in inputs.items() if k.startswith("b"))
        zeros = {k[2:]: v for k, v in inputs.items() if k.startswith("z:")}
        key = fold_in(self._base_key, step_no.reshape(1))[0]
        params = {k: self._state[k] for k in self._trainable}
        buffers = {k: v for k, v in self._state.items() if k not in params}
        call = self._module
        if self._meta["remat"]:
            call = _recompute.checkpoint(call)
        loss, ids = call(params, buffers, key, zeros, *batch)
        zk = list(zeros)
        gs = torch.autograd.grad(loss, [params[k] for k in self._dense]
                                 + [zeros[k] for k in zk], allow_unused=True)
        from . import TrainStep
        grads = TrainStep._merge_sparse_grads(
            {k: (g if g is not None else torch.zeros_like(params[k]))
             for k, g in zip(self._dense, gs)},
            dict(zip(zk, gs[len(self._dense):])), zeros, ids, params)
        with torch.no_grad():
            update_in_place(self._optimizer,
                            {k: p.detach() for k, p in params.items()},
                            grads, self._opt_state, lr, step_no,
                            self._meta["decay"])
        return (loss.detach(),)

    def _program(self, batch):
        sig = tuple((tuple(b.shape), b.dtype) for b in batch)
        prog = self._programs.get(sig)
        if prog is None:
            dev = self.device
            inputs = {f"b{i}": torch.empty(b.shape, dtype=b.dtype, device=dev)
                      for i, b in enumerate(batch)}
            for k, (n, w, dt) in self._sparse.items():
                inputs[f"z:{k}"] = torch.zeros((n, w), dtype=dt, device=dev,
                                               requires_grad=True)
            inputs.update(lr=self._lr_t, step_no=self._step_t)
            from ..observability import track
            prog = self._programs[sig] = track(
                f"train_session:{self._meta['optimizer']['class']}",
                Program(self._program_fn, inputs))
        return prog

    @contextlib.contextmanager
    def _kept(self):
        """Put back every state tensor after the block (a capture's warm
        run is a real step)."""
        ts = [t.detach() for t in self._state.values()] + [
            t for s in self._opt_state.values() for t in s.values()]
        with torch.no_grad():
            saved = [t.clone() for t in ts]
        try:
            yield
        finally:
            with torch.no_grad():
                torch._foreach_copy_(ts, saved)

    def step(self, *batch) -> float:
        """One optimizer step on numpy arrays or tensors (inputs...,
        label); returns the loss."""
        batch = tuple(torch.as_tensor(b).to(self.device) for b in batch)
        prog = self._program(batch)
        for i, b in enumerate(batch):
            prog.inputs[f"b{i}"].copy_(b)
        self._step_no += 1
        self._lr_t.fill_(self.lr)
        self._step_t.fill_(self._step_no)
        captured = self.device.type == "cuda"
        if not prog.ready:
            t0 = time.perf_counter()
            if captured:
                with self._kept():
                    if self._pool is None:
                        self._pool = torch.cuda.graph_pool_handle()
                    prog.capture(self._pool)
            prog.made(time.perf_counter() - t0)
        return float(prog.run(captured=captured)[0])

    def state_dict(self):
        return {k: host_array(v) for k, v in self._state.items()}
