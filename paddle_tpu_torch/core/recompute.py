"""Activation recompute (counterpart of paddle_tpu/core/recompute.py):
``torch.utils.checkpoint`` over tagged Layer subtrees.

    with jit.recompute_policy("stages"):
        step = TrainStep(model, loss_fn, opt, ...)
        step(x, y)   # tagged stages run as checkpoint regions

- ``"stages"`` wraps every Layer whose ``_remat_stage`` attribute is
  truthy (GPT blocks and the ResNet blocks ship tagged); a Layer class (or
  a tuple of them), a set of type names, or a predicate ``layer -> bool``
  select subtrees structurally.
- ``policy=`` picks what a region keeps for its backward:
  ``"dots_saveable"`` (default: the outputs of matrix products,
  ``aten.mm`` / ``addmm`` / ``bmm`` / ``baddbmm``, are saved by a
  selective-checkpoint context; everything else, the flash kernel K1 and
  the fused BatchNorm kernels included, runs again in the backward) or
  ``"nothing_saveable"`` (the whole region runs again).  An unknown name
  raises ``ValueError`` when the policy is set.

The wrap happens in ``Layer.__call__`` only inside a ``jit.TrainStep``
forward (``step_forward()``) with grad enabled, as the reference wraps
only while a step is traced: eager calls and the serving engine's no-grad
programs never pay it.  The policy must be active while a step program is
made; on the card a step's CUDA graph keeps the regions it was captured
with.

A recomputation runs in the backward, after the forward's scopes closed
(on the card, on the autograd engine's thread), so it is given what the
region's first forward saw:
- the step generator at the region's entry (``core.rng.mark`` /
  ``rewound``): dropout masks and attention-dropout seeds are drawn again
  from there and equal the first forward's, inside a captured step graph
  too (``core.rng.ProgramMarks``);
- the AMP policy, the layout policy and the region's layers' training
  flags as they were;
- no second running-statistic update: updates made inside a
  recomputation are dropped (``core.buffer_updates.dropped``), the first
  forward's stay in the step's log, as the reference re-exports them once
  through the checkpoint boundary.

Deliberate deviation: the reference drops its fused BatchNorm ops to
plain composites inside a region (``inside_checkpoint``), because a
``custom_vjp``'s residuals are opaque to ``jax.checkpoint``.  A
non-reentrant ``torch.utils.checkpoint`` frees an ``autograd.Function``'s
saved tensors like any other, so the port keeps K5-K8 inside regions.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from .. import amp as _amp
from . import buffer_updates as _bufup
from . import layout as _layout
from . import rng as _rng

__all__ = ["recompute_policy", "policy", "enabled", "inside_checkpoint",
           "checkpoint", "step_forward", "should_wrap", "run_wrapped"]

_POLICY = None          # (matcher spec, checkpoint-policy name or None)
_ENABLED_EVER = False   # fast gate for Layer.__call__
_DEPTH = 0              # > 0 inside a region's forward or recomputation
_IN_STEP = 0            # > 0 inside a TrainStep forward


class _PolicyGuard:
    """Returned by recompute_policy(): the policy is set at once; as a
    context manager it restores the previous one on exit."""

    def __init__(self, prev):
        self._prev = prev

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global _POLICY
        _POLICY = self._prev
        return False


def recompute_policy(spec, policy: Optional[str] = "dots_saveable"):
    """Set (or clear, with spec=None) the activation-recompute policy: a
    plain call or a ``with`` block, like ``jit.layout_policy``.  See the
    module docstring for the spec forms and policies."""
    global _POLICY, _ENABLED_EVER
    prev = _POLICY
    if spec is None:
        _POLICY = None
    else:
        _saved_ops(policy)       # validate now, not when a step runs
        _POLICY = (spec, policy)
        _ENABLED_EVER = True
    return _PolicyGuard(prev)


def policy():
    return _POLICY


def enabled() -> bool:
    """Cheap per-call gate: True once any recompute policy was ever set."""
    return _ENABLED_EVER


def inside_checkpoint() -> bool:
    """True inside a region's forward or its recomputation."""
    return _DEPTH > 0


@contextlib.contextmanager
def step_forward():
    """Mark a TrainStep forward: tagged layers inside are wrapped."""
    global _IN_STEP
    _IN_STEP += 1
    try:
        yield
    finally:
        _IN_STEP -= 1


def _saved_ops(name: Optional[str]):
    """The aten op packets whose outputs a region saves under the policy
    ``name`` (None: nothing is saved)."""
    if name in (None, "nothing_saveable"):
        return None
    if name == "dots_saveable":
        aten = torch.ops.aten
        return frozenset((aten.mm, aten.addmm, aten.bmm, aten.baddbmm))
    raise ValueError(
        f"recompute_policy: unknown checkpoint policy {name!r} (expected "
        "'dots_saveable' or 'nothing_saveable')")


def _matches(layer) -> bool:
    spec = _POLICY[0]
    if spec == "stages":
        return bool(getattr(layer, "_remat_stage", False))
    if isinstance(spec, type):
        return isinstance(layer, spec)
    if isinstance(spec, tuple) and all(isinstance(s, type) for s in spec):
        return isinstance(layer, spec)
    if callable(spec):
        return bool(spec(layer))
    if isinstance(spec, (set, frozenset, list)):
        return type(layer).__name__ in spec
    return False


def should_wrap(layer, inputs=None) -> bool:
    """Wrap iff a policy is set, this is a TrainStep forward with grad
    enabled, we are not inside a region already, and the layer matches."""
    return (_POLICY is not None and _IN_STEP > 0 and _DEPTH == 0
            and torch.is_grad_enabled() and _matches(layer))


class _Frame:
    """What a region's first forward saw, taken when the region is
    entered, and the scopes that give it back to the recomputation."""

    def __init__(self, layer):
        self.gen = _rng.scope_generator()
        self.token = None if self.gen is None else _rng.mark(self.gen)
        self.amp = _amp._snapshot()
        self.layout = _layout.policy()
        self.modes = ([] if layer is None
                      else [(m, m.training) for m in layer.modules()])

    @contextlib.contextmanager
    def forward(self):
        global _DEPTH
        _DEPTH += 1
        try:
            yield
        finally:
            _DEPTH -= 1

    @contextlib.contextmanager
    def recompute(self):
        global _DEPTH
        now = [(m, m.training) for m, _ in self.modes]
        with contextlib.ExitStack() as stack:
            stack.enter_context(_amp._restored(self.amp))
            stack.enter_context(_layout.layout_policy(self.layout))
            stack.enter_context(_bufup.dropped())
            if self.gen is not None:
                stack.enter_context(_rng.generator_scope(self.gen))
                stack.enter_context(_rng.rewound(self.gen, self.token))
            for m, mode in self.modes:
                m.training = mode
            _DEPTH += 1
            try:
                yield
            finally:
                _DEPTH -= 1
                for m, mode in now:
                    m.training = mode


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def _run(fn, args, policy_name, layer):
    """``fn(*args)`` as one non-reentrant checkpoint region."""
    from torch.utils import checkpoint as tc
    frame = _Frame(layer)
    saves = _saved_ops(policy_name)

    def context_fn():
        if saves is None:
            return frame.forward(), frame.recompute()

        def keep(ctx, func, *args, **kwargs):
            return (tc.CheckpointPolicy.MUST_SAVE
                    if func.overloadpacket in saves
                    else tc.CheckpointPolicy.PREFER_RECOMPUTE)
        sac_fwd, sac_rec = tc.create_selective_checkpoint_contexts(keep)
        return (_both(frame.forward(), sac_fwd),
                _both(frame.recompute(), sac_rec))

    return tc.checkpoint(fn, *args, use_reentrant=False,
                         preserve_rng_state=False, context_fn=context_fn)


def checkpoint(fn, policy: Optional[str] = None):
    """``fn`` as a checkpoint region: the TrainStep ``remat=True``
    spelling (the whole loss recomputed in the backward).  ``policy`` as
    ``recompute_policy``'s, None saving nothing."""
    _saved_ops(policy)

    def wrapped(*args, **kwargs):
        return _run(lambda *a: fn(*a, **kwargs), args, policy, None)
    return wrapped


def run_wrapped(layer, inputs, kwargs, runner):
    """``runner(*inputs, **kwargs)`` (the layer's ``nn.Module.__call__``) as
    a checkpoint region under the active policy."""
    return _run(lambda *a: runner(*a, **kwargs), inputs, _POLICY[1], layer)
