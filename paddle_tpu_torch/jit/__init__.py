"""Training step (counterpart of paddle_tpu/jit/__init__.py's TrainStep).

The reference compiles forward, backward, the optimizer update, the buffer
updates and the guard into one XLA program per batch signature (``jax.jit``
with donated state).  The port's ``TrainStep`` is the same program family:
one static-shape step program per batch signature (shapes and dtypes;
``core.programs.Program``) over static batch buffers and two 0-dim device
scalars, the learning rate and the step number, written before each run.
The program writes the parameters, the optimizer state, the running
statistics and the guard's verdict in place, into tensors that live as
long as the step.  On the card a program is captured as a CUDA graph by
``warmup()`` or by the first call of a cold signature, and each call
replays it; ``run_steps`` is K replays.  On the CPU the same program
function runs directly.  Nothing in a program reads a device value on the
host.

Inside a program: the training-mode forward under the step's generator
and AMP policy, ``torch.autograd.grad`` for the trainable parameters, then
``optimizer.functional.update_in_place`` (the update written in place a
chunk of parameters at a time, so that its temporaries do not set the
step's peak memory).  Running statistics (BatchNorm's
``_mean`` / ``_variance``) are updated as the reference's compiled step
updates them: the forward logs each update through
``core.buffer_updates.capture()``, the updates compound from one
micro-batch to the next under ``accum_steps``, and the step writes them
after the optimizer update, beside the parameters; under ``guard=True`` a
step whose loss or gradient norm is not finite keeps the old parameters,
moments and buffers, selected on the device.

- **RNG.** One generator per step object (``core.rng.step_generator``,
  seeded from the port's stream at the first step) feeds every dropout
  mask and attention-dropout seed.  A captured graph registers it, so each
  replay advances it as an eager step would: captured and uncaptured steps
  from the same seed draw the same masks.
- **Warm-up.** A capture first runs the program once (first-use set-up),
  which is a real step; the step puts the parameters, optimizer state,
  running statistics and generator back afterwards, so ``warmup()``, as
  the reference's, moves nothing.
- **Results.** Each call returns the loss as a device tensor of its own,
  and ``last_outputs`` / ``last_guard`` likewise (a graph overwrites its
  outputs at the next replay).
- **Recompute.** ``remat=True`` runs the whole loss as one checkpoint
  region (``core.recompute.checkpoint``), as the reference's ``loss_of``;
  ``recompute_policy(spec, policy)`` wraps the layers it matches.  A
  captured graph keeps the regions it was captured with.

``layout_policy`` and ``recompute_policy`` are re-exported here as in the
reference.  As in the reference, ``TrainStep`` applies no ``grad_clip``
(its compiled step never clips; only the eager ``Optimizer.step`` does).

- **Telemetry.** Each call runs inside a ``train_step`` span and is
  observed by the ``train_step_seconds`` histogram: host wall time per
  call (dispatch and any synchronous device wait; nothing is added to
  wait for the card).  Each step program is registered with the program
  registry as ``train_step:<model class>`` (its capture seconds, bytes
  and replays).
- **Faults.** ``PDTPU_FAULT_NAN_GRADS`` (``utils.faults.nan_grads``),
  armed when a step program is made, poisons the gradients at its window
  of step numbers inside the program, compared on the device.
- **Checkpoints.** ``save_checkpoint`` / ``restore_checkpoint`` read and
  write the reference's on-disk layout (``distributed.checkpoint``) in
  both directions, a GradScaler's state included (``scaler=``); a restore
  writes the state in place, so the captured programs replay on.  A learning-rate scheduler's value reaches each
  replay through the learning-rate scalar (``optimizer.get_lr()``).

- **Row-sparse gradients.** A weight of ``Embedding(sparse=True)``
  (``sparse_grad``) gets its gradient through the lookups' zero leaves
  (``core.selected_rows``): a record pass at a signature's first step
  sizes each lookup's leaf, a static buffer of the program like the
  batch, and the step merges the leaves' gradients with the lookup ids
  into a ``RowSparseGrad`` that takes the lazy row update
  (``optimizer.sparse``) inside the program.  A weight registered under
  two names (tied) or that the loss also consumes outside the lookup (a
  tied head; the first record pass finds it in the autograd graph) is
  demoted to a dense gradient with one ``UserWarning``.
  ``accum_steps`` > 1 with a sparse weight raises ``NotImplementedError``,
  as the reference's.

Inference artifacts: ``save`` / ``load`` / ``InputSpec`` /
``TranslatedLayer`` (``jit/export.py``: the reference's npz and metadata,
the program as a ``torch.export`` archive).  Training artifacts:
``save_train_program`` / ``TrainSession`` (``jit/train_export.py``).  The
to_static surface (``to_static``, ``StaticFunction``, ``functional_call``,
``TracedLayer`` and the rest): ``jit/static.py``.

``mesh`` / ``batch_sharding`` are taken and read nowhere, as in the
reference (whose step reads neither); the sharded step is
``parallel.ShardedTrainStep``.  Row-sharded tables are not in the port
yet.  As in the reference, the step applies neither a parameter's
``ParamAttr`` learning-rate multiplier nor its regularizer (only the eager
``Optimizer.step`` does).
"""
from __future__ import annotations

import contextlib
import functools
import time
import warnings
from typing import Callable, Dict, Optional

import torch

from .. import amp as amp_mod
from ..core import buffer_updates as _bufup
from ..core import recompute as _recompute
from ..core import rng
from ..core import selected_rows as sr
from ..core.layout import layout_policy  # noqa: F401  (jit.layout_policy)
from ..core.programs import Program
from ..core.recompute import recompute_policy  # noqa: F401
from ..optimizer.functional import decay_flags, update_in_place
from ..utils import faults as _faults
from .export import (ArtifactFormatError, InputSpec,  # noqa: F401
                     TranslatedLayer, load, save)

__all__ = ["state_arrays", "forward_loss", "guard_select", "TrainStep",
           "layout_policy", "recompute_policy", "InputSpec", "save", "load",
           "TranslatedLayer", "ArtifactFormatError", "save_train_program",
           "TrainSession", "functional_call", "StaticFunction", "to_static",
           "declarative", "not_to_static", "enable_to_static",
           "ProgramTranslator", "warm_step_program", "TracedLayer",
           "set_verbosity", "get_verbosity", "set_code_level",
           "get_code_level"]

_obs_step_hist = None


def _step_hist():
    """train_step_seconds histogram handle (created once; registry.reset()
    zeroes values in place so the cache stays valid)."""
    global _obs_step_hist
    if _obs_step_hist is None:
        from ..observability import metrics as _m
        _obs_step_hist = _m.histogram(
            "train_step_seconds",
            "host wall time per TrainStep/ShardedTrainStep call (dispatch "
            "+ any synchronous device wait)")
    return _obs_step_hist


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
                 amp_dtype="bfloat16", return_outputs=False):
    """Training-mode forward and loss: ``loss_fn(*outputs, batch[-1])`` of
    ``model(*batch[:-1])``, with dropout drawing from ``generator`` and,
    with ``amp_level``, under ``amp.auto_cast``.  With
    ``return_outputs``, (loss, the model's outputs as a tuple)."""
    gen_ctx = (rng.generator_scope(generator) if generator is not None
               else contextlib.nullcontext())
    amp_ctx = (amp_mod.auto_cast(level=amp_level, dtype=amp_dtype)
               if amp_level else contextlib.nullcontext())
    with _training(model), gen_ctx, amp_ctx:
        out = model(*batch[:-1])
        outs = out if isinstance(out, tuple) else (out,)
        loss = loss_fn(*outs, batch[-1])
    return (loss, outs) if return_outputs else loss


def _verdict(loss, grads):
    """(global gradient norm, whether it and the loss are finite), on the
    device."""
    leaves = [(g.values if isinstance(g, sr.RowSparseGrad) else g).float()
              for g in grads.values()]
    gnorm = (torch.sqrt(sum(torch.sum(g * g) for g in leaves)) if leaves
             else torch.zeros((), device=loss.device))
    return gnorm, torch.isfinite(loss) & torch.isfinite(gnorm)


def guard_select(params, opt_state, new_params, new_opt, loss, grads):
    """The device-side step guard: finiteness of the loss and of the
    global gradient norm, and the old state selected where the step is
    bad, all on the device (no host sync).  Returns (params, opt_state,
    grad_norm, ok)."""
    gnorm, ok = _verdict(loss, grads)

    def sel(new, old):
        return {k: ({s: torch.where(ok, v[s], old[k][s]) for s in v}
                    if isinstance(v, dict) else torch.where(ok, v, old[k]))
                for k, v in new.items()}
    return sel(new_params, params), sel(new_opt, opt_state), gnorm, ok


def _signature(batch):
    return tuple((tuple(b.shape), str(b.dtype).replace("torch.", ""))
                 for b in batch)


class TrainStep:
    """One training step: ``step(*batch) -> loss`` (a device scalar).

    ``loss_fn(*model_outputs, label)`` with ``label = batch[-1]`` and the
    model fed ``batch[:-1]``.  ``amp_level`` "O1"/"O2" runs the forward
    under ``amp.auto_cast``.  ``guard=True`` leaves parameters, optimizer
    moments and running statistics unchanged for a step whose loss or
    gradient norm is not finite, and keeps (grad_norm, ok) on
    ``last_guard``.  ``accum_steps=k`` splits the batch into k
    micro-batches along axis 0 and averages their f32 gradients before one
    update.  ``with_outputs=True`` keeps the forward's outputs on
    ``last_outputs``.  ``remat=True`` recomputes the forward in the
    backward."""

    def __init__(self, model, loss_fn: Callable, optimizer,
                 amp_level: Optional[str] = None, amp_dtype="bfloat16",
                 mesh=None, batch_sharding=None, remat: bool = False,
                 with_outputs: bool = False, guard: bool = False,
                 accum_steps: int = 1):
        # mesh / batch_sharding: taken and read nowhere, as in the reference
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.amp_level = amp_level
        self.amp_dtype = amp_dtype
        self.accum_steps = int(accum_steps)
        if self.accum_steps < 1:
            raise ValueError("TrainStep: accum_steps must be >= 1")
        if self.accum_steps > 1 and with_outputs:
            raise ValueError(
                "TrainStep: with_outputs does not compose with "
                "accum_steps>1 (per-micro-batch forward outputs would "
                "have to be stacked across the micro-batches; run the "
                "forward separately if metrics need it)")
        self._with_outputs = bool(with_outputs)
        self._remat = bool(remat)
        state = model.state_dict(keep_vars=True)
        self._trainable = [k for k, v in state.items()
                           if isinstance(v, torch.nn.Parameter)
                           and v.requires_grad]
        self._decay = decay_flags(optimizer, self._trainable)
        # weights flagged by Embedding(sparse=True): their gradients are
        # row-sparse, through the lookups' zero leaves (core.selected_rows)
        self._sparse = {k for k, v in state.items()
                        if getattr(v, "sparse_grad", False)}
        if self.accum_steps > 1 and self._sparse:
            raise NotImplementedError(
                f"TrainStep(accum_steps={self.accum_steps}) does not "
                f"compose with sparse-grad embedding weights "
                f"{sorted(self._sparse)}: per-micro-batch RowSparseGrads "
                "would need a row-union merge inside the accumulation "
                "loop.  Rebuild the offending Embedding layers with "
                "sparse=False (dense grads accumulate fine) or run "
                "accum_steps=1")
        # a weight's name in the lookups' context: its first state key
        self._names: Dict[int, str] = {}
        for k, v in state.items():
            self._names.setdefault(id(v), k)
        self._sparse_checked = False
        # weights demoted to DENSE gradients: tied (registered under more
        # than one name) or consumed outside the lookup; a row-sparse
        # gradient would drop the other uses' gradients
        self._sparse_deny = set()
        if self._sparse:
            by_obj: Dict[int, list] = {}
            for k, v in state.items():
                by_obj.setdefault(id(v), []).append(k)
            for names in by_obj.values():
                if len(names) > 1 and self._sparse.intersection(names):
                    warnings.warn(
                        f"Embedding(sparse=True) weight registered under "
                        f"multiple names {names} (tied weight) — falling "
                        "back to a dense gradient for it so the other "
                        "uses' gradients are kept", UserWarning)
                    self._sparse_deny.add(names[0])
        self._opt_state = None
        self._guard = bool(guard)
        self.last_guard = None
        self.last_outputs = None
        self._programs: Dict[tuple, Program] = {}  # batch signature ->
        self._made: Dict[tuple, int] = {}   # signature -> programs made
        self._gen = None       # the step generator (from the first step)
        self._lr = self._step_no = None     # the programs' scalar inputs
        self._gnorm = self._ok = None       # the guard's verdict
        self._pool = None      # the graphs' memory pool
        self._run_uncaptured = False   # private A/B: programs, no graphs

    def init_opt_state(self, state):
        return {k: self.optimizer.init_state(state[k])
                for k in self._trainable}

    # -- the step program ---------------------------------------------------
    def _setup(self):
        """Tensors every program of this step reads or writes, made at the
        first step: the optimizer state (unless loaded), the generator,
        the scalar inputs and the guard's verdict."""
        state = self.model.state_dict(keep_vars=True)
        dev = next(iter(state.values())).device
        if self._opt_state is None:
            self._opt_state = self.init_opt_state(
                {k: state[k].detach() for k in self._trainable})
        self._gen = rng.step_generator(dev)
        self._lr = torch.zeros((), dtype=torch.float32, device=dev)
        self._step_no = torch.zeros((), dtype=torch.int32, device=dev)
        self._gnorm = torch.zeros((), dtype=torch.float32, device=dev)
        self._ok = torch.ones((), dtype=torch.bool, device=dev)

    def _grads(self, params, batch, zeros=None):
        """(loss, {name: grad}, {buffer name: new value}, outputs) over
        ``accum_steps`` micro-batches; buffer updates are logged, not
        applied, and compound from one micro-batch to the next.  With
        ``zeros`` (the lookups' zero leaves) the sparse weights' gradients
        are ``RowSparseGrad``s."""
        with _bufup.capture() as log:
            loss, grads, outs = self._micro_grads(params, batch, zeros)
        return loss, grads, _bufup.resolve(
            log, self.model.state_dict(keep_vars=True)), outs

    def _micro_grads(self, params, batch, zeros=None):
        zeros = zeros or {}
        sparse_names = {sr.param_name(k) for k in zeros}
        dense = [k for k in self._trainable if k not in sparse_names]
        args = [params[k] for k in dense]
        zkeys = list(zeros)
        ids: Dict[str, torch.Tensor] = {}

        def loss_of(*micro):
            # a context per run: a recompute region's rerun keys its
            # lookups from 0 again and finds the same zero leaves
            ctx = sr.SparseGradContext("apply", zeros=zeros,
                                       deny=self._sparse_deny,
                                       names=self._names)
            with (sr.use_ctx(ctx) if zeros else contextlib.nullcontext()):
                out = forward_loss(self.model, self.loss_fn, micro,
                                   self._gen, self.amp_level, self.amp_dtype,
                                   return_outputs=True)
            if not ids:
                ids.update(ctx.ids)
            return out
        if self._remat:
            loss_of = _recompute.checkpoint(loss_of)

        def one(micro):
            with rng.generator_scope(self._gen), _recompute.step_forward():
                loss, outs = loss_of(*micro)
            grads = torch.autograd.grad(
                loss, args + [zeros[k] for k in zkeys], allow_unused=True)
            return loss, grads, outs

        k = self.accum_steps
        if k == 1:
            loss, gs, outs = one(batch)
            outs = (tuple(o.detach() for o in outs) if self._with_outputs
                    else ())
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
                loss_i, gs, _ = one(micro)
                losses.append(loss_i.detach())
                for a, g in zip(acc, gs):
                    if g is not None:
                        a += g.float()
            loss = torch.stack(losses).mean()
            gs = [(a / k).to(p.dtype) for a, p in zip(acc, args)]
            outs = ()
        grads = {n: (g if g is not None else torch.zeros_like(p))
                 for n, g, p in zip(dense, gs, args)}
        grads = self._merge_sparse_grads(
            grads, dict(zip(zkeys, gs[len(args):])), zeros, ids, params)
        return loss.detach(), grads, outs

    @staticmethod
    def _merge_sparse_grads(grads, zgrads, zeros, ids, params):
        """Fold the zero leaves' gradients (the lookups' row-sparse
        gradients, by context key) into the gradient dict as
        ``RowSparseGrad``s; several lookups of one weight concatenate."""
        grads = dict(grads)
        for zk, zg in zgrads.items():
            nm = sr.param_name(zk)
            if zg is None:
                zg = torch.zeros_like(zeros[zk])
            rsg = sr.RowSparseGrad(ids[zk], zg, params[nm].shape)
            shard = getattr(params[nm], "row_shard", None)
            if shard is not None and shard[0] is not None:
                # a row-sharded table (embedding.ShardedEmbedding): the
                # update moves this rank's rows only
                from ..embedding.functional import local_grad
                rsg = local_grad(rsg, params[nm].shape[0], shard[1],
                                 shard[0])
            grads[nm] = grads[nm] + rsg if nm in grads else rsg
        return grads

    def _step_program(self, lr, step_no, nan_window=None, **inputs):
        """One training step over the static inputs (the batch ``b<i>``,
        the lookups' zero leaves ``z:<key>``): every state tensor written
        in place; returns (loss, *forward outputs).
        ``nan_window`` (the nan_grads fault's, when it was armed as the
        program was made) poisons the gradients at those step numbers."""
        state = self.model.state_dict(keep_vars=True)
        params = {k: state[k] for k in self._trainable}
        batch = tuple(v for k, v in inputs.items() if k.startswith("b"))
        zeros = {k[2:]: v for k, v in inputs.items() if k.startswith("z:")}
        loss, grads, bufs, outs = self._grads(params, batch, zeros)
        if nan_window is not None:
            grads = _faults.poison_grads(grads, step_no, window=nan_window)
        with torch.no_grad():
            ok = None
            if self._guard:
                gnorm, ok = _verdict(loss, grads)
                self._gnorm.copy_(gnorm)
                self._ok.copy_(ok)
            update_in_place(self.optimizer,
                            {k: p.detach() for k, p in params.items()},
                            grads, self._opt_state, lr, step_no, self._decay,
                            ok)
            # running statistics ride the same step, after the update
            if bufs:
                old = [state[k].detach() for k in bufs]
                new = list(bufs.values())
                if ok is not None:
                    new = [torch.where(ok, n, o) for n, o in zip(new, old)]
                torch._foreach_copy_(old, new)
        return (loss, *outs)

    # -- programs: made, warmed, run -----------------------------------------
    def _state_tensors(self):
        """Every tensor a step program writes."""
        ts = [t.detach()
              for t in self.model.state_dict(keep_vars=True).values()]
        ts += [t for slots in self._opt_state.values()
               for t in slots.values()]
        return ts + [self._gnorm, self._ok]

    @contextlib.contextmanager
    def _state_kept(self):
        """Put back, after the block, everything a step moves: the state
        tensors and the generator."""
        ts = self._state_tensors()
        with torch.no_grad():
            saved = [t.clone() for t in ts]
        gen = self._gen.get_state()
        try:
            yield
        finally:
            with torch.no_grad():
                torch._foreach_copy_(ts, saved)
            self._gen.set_state(gen)

    def _staged(self, batch, lr, step_no):
        """The program of this batch's signature (new ones are not made
        yet), its inputs filled for a step ``step_no`` at ``lr``."""
        sig = _signature(batch)
        prog = self._programs.get(sig)
        if prog is None:
            if self._gen is None:
                self._setup()
            dev = self._lr.device
            inputs = {f"b{i}": torch.empty(b.shape, dtype=b.dtype, device=dev)
                      for i, b in enumerate(batch)}
            for i, b in enumerate(batch):
                inputs[f"b{i}"].copy_(b)
            if self._sparse:
                # the lookups' zero leaves: static buffers of the program
                for key, (n, w, dt) in self._sparse_specs(
                        tuple(inputs.values())).items():
                    inputs[f"z:{key}"] = torch.zeros(
                        (n, w), dtype=dt, device=dev, requires_grad=True)
            inputs.update(lr=self._lr, step_no=self._step_no)
            # nan_grads: presence decided now, as the program is made
            fn = functools.partial(self._step_program,
                                   nan_window=_faults.nan_grads_window())
            from ..observability import track
            prog = self._programs[sig] = track(
                f"train_step:{type(self.model).__name__}",
                Program(fn, inputs, self._gen))
        for i, b in enumerate(batch):
            prog.inputs[f"b{i}"].copy_(b)
        self._lr.fill_(lr)
        self._step_no.fill_(step_no)
        return sig, prog

    def _sparse_specs(self, batch):
        """The record pass: each sparse lookup's (count, width, dtype) on
        this batch, by context key.  The first one also demotes, with a
        warning, a sparse weight the loss consumes outside the lookup (a
        tied head): its gradient becomes dense.  Nothing of the step
        moves (the generator is put back, buffer updates are dropped)."""
        state = self.model.state_dict(keep_vars=True)
        while True:
            rec = sr.SparseGradContext("record", deny=self._sparse_deny,
                                       names=self._names)
            gen = self._gen.get_state()
            try:   # the graph is needed by the first pass's detector only
                with sr.use_ctx(rec), _bufup.capture(), (
                        torch.no_grad() if self._sparse_checked
                        else contextlib.nullcontext()):
                    loss = forward_loss(self.model, self.loss_fn, batch,
                                        self._gen, self.amp_level,
                                        self.amp_dtype)
            finally:
                self._gen.set_state(gen)
            names = {sr.param_name(k) for k in rec.specs}
            if self._sparse_checked or not names:
                break
            bad = sr.dense_consumed_keys(
                lambda _: loss, {k: state[k] for k in names})
            del loss
            if not bad:
                break
            warnings.warn(
                f"Embedding(sparse=True) weights {sorted(bad)} are also "
                "consumed densely (tied head) — falling back to dense "
                "gradients for them so those uses' gradients are kept",
                UserWarning)
            self._sparse_deny.update(bad)
        self._sparse_checked = True
        return rec.specs

    def _make(self, sig, prog, warm: bool):
        """Make ``prog`` ready.  On the card it is captured (its warm run,
        a real step, undone); elsewhere (or for the uncaptured A/B) it is
        run once with ``warm``, undone too, and else only marked made."""
        t0 = time.perf_counter()
        if self._lr.device.type == "cuda" and not self._run_uncaptured:
            with self._state_kept():
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                prog.capture(self._pool)
        elif warm:
            with self._state_kept():
                prog.run(captured=False)
        prog.made(time.perf_counter() - t0)
        self._made[sig] = self._made.get(sig, 0) + 1

    def _run(self, batch, lr):
        """One step on ``batch``: the program's outputs, which a replay
        overwrites."""
        opt = self.optimizer
        sig, prog = self._staged(batch, lr, opt._step_count + 1)
        if not prog.ready:
            self._make(sig, prog, warm=False)
        opt._step_count += 1
        return prog.run(captured=not self._run_uncaptured)

    def __call__(self, *batch):
        from ..observability import span as _span
        with _span("train_step"), _step_hist().time():
            return self._call_inner(*batch)

    def _call_inner(self, *batch):
        out = self._run(batch, self.optimizer.get_lr())
        if self._guard:
            self.last_guard = (self._gnorm.clone(), self._ok.clone())
        if self._with_outputs:
            self.last_outputs = tuple(o.clone() for o in out[1:])
        return out[0].clone()

    def run_steps(self, *stacked_batch):
        """K steps, one per slice along the leading axis of each stacked
        batch (ids (K, batch, seq), ...), at the learning rate of the call
        (as the reference's): K runs of the single step's program.
        Returns the (K,) losses."""
        if self._guard:
            raise NotImplementedError(
                "TrainStep(guard=True) does not support run_steps: the "
                "multi-step scan has no per-step skip/rollback point (a "
                "silent bypass would apply NaN updates the guard promised "
                "to block) — use per-call steps under the guard")
        if self.accum_steps > 1:
            raise NotImplementedError(
                "TrainStep(accum_steps>1) does not support run_steps: the "
                "accumulation window already scans in-program — stack "
                "whole windows as per-call batches instead")
        lr = self.optimizer.get_lr()
        return torch.stack([
            self._run(tuple(b[i] for b in stacked_batch), lr)[0].clone()
            for i in range(stacked_batch[0].shape[0])])

    def warmup(self, *batch) -> dict:
        """Make the step program of this sample batch's signature WITHOUT
        applying an update: parameters, optimizer state, running
        statistics and the generator are untouched (on the card the
        program is captured; on the CPU it is run once and undone).
        Returns {'seconds', 'compiled'}; compiled=False means the
        signature was already made."""
        t0 = time.perf_counter()
        sig, prog = self._staged(batch, self.optimizer.get_lr(),
                                 self.optimizer._step_count + 1)
        compiled = not prog.ready
        if compiled:
            self._make(sig, prog, warm=True)
        return {"seconds": time.perf_counter() - t0, "compiled": compiled}

    def compile_counts(self) -> dict:
        """Step programs made per batch signature, as the serving
        engine's ``compile_counts()``: on the card each count is one CUDA
        graph capture, on the CPU one program made.  A signature is made
        once."""
        return {"step": dict(self._made), "total": sum(self._made.values())}

    # -- checkpoints (the reference's single-device variant) -----------------
    def save_checkpoint(self, directory, step=None, extra_meta=None,
                        scaler=None, data_cursor=None):
        """Parameters and buffers, optimizer state, the step count, the
        scheduler's state, the data cursor and the step's generator, in
        the reference's layout (``distributed.checkpoint``), and
        ``scaler``'s state under ``__scaler__``; with ``accum_steps`` > 1
        the meta records it, as the reference's (a resumed run must feed
        the same windows).  Returns the step directory."""
        from ..distributed import checkpoint as dck
        state = state_arrays(self.model)
        if self._opt_state is None:
            self._opt_state = self.init_opt_state(state)
        if self.accum_steps > 1:
            extra_meta = dict(extra_meta or {})
            extra_meta.setdefault("accum_steps", self.accum_steps)
        return dck.save_train_state(
            directory, state, self._opt_state,
            step if step is not None else self.optimizer._step_count,
            extra_meta, optimizer=self.optimizer, scaler=scaler,
            data_cursor=data_cursor, generator=self._gen)

    def restore_checkpoint(self, directory, scaler=None):
        """Resume from the newest checkpoint under ``directory`` (the
        port's or the reference's): parameters, buffers and optimizer
        state are written IN PLACE into the tensors the step's programs
        read, so a captured step replays on with no new capture; a saved
        scaler state goes into ``scaler``.  Returns the meta (``{"step",
        ...}``), or None when there is none."""
        from ..distributed import checkpoint as dck
        from ..weights import load_paddle_opt_state
        res = dck.restore_sharded(directory)
        if res is None:
            return None
        if self._gen is None:
            self._setup()
        meta, restored_opt = dck.apply_train_state(
            self.model, self.optimizer, res, scaler=scaler,
            generator=self._gen)
        load_paddle_opt_state(self, dck.merge_opt_state(self._opt_state,
                                                        restored_opt))
        return meta


from .static import (ProgramTranslator, StaticFunction,  # noqa: E402
                     TracedLayer, declarative, enable_to_static,
                     functional_call, get_code_level, get_verbosity,
                     not_to_static, set_code_level, set_verbosity,
                     to_static, warm_step_program)
from .train_export import TrainSession, save_train_program  # noqa: E402
