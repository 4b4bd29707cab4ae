"""``jit``'s to_static surface (port of paddle_tpu/jit/__init__.py's
``functional_call``, ``StaticFunction``, ``to_static`` / ``declarative`` /
``not_to_static``, ``enable_to_static``, ``ProgramTranslator``,
``warm_step_program``, ``TracedLayer`` and the dy2static verbosity
knobs).

The reference's static function is a ``jax.jit`` of the forward, one
compiled program per input signature.  The port's is the same program
family as ``TrainStep``'s: one static-shape ``core.programs.Program`` per
signature (each tensor argument's shape and dtype, the other arguments by
value), whose inputs are static buffers the call fills, run under
``no_grad`` with the layer's current parameters (read in place, so an
optimizer step or a ``set_state_dict`` between calls is seen).  On the
card a program is captured as a CUDA graph at its first call and
replayed after that; elsewhere its function runs directly.  Each call
returns tensors of its own (a replay overwrites the graph's outputs).
Programs are registered with the program registry as
``to_static:<label>`` (the layer's class or the function's name), as the
reference's ``track`` labels them.

``functional_call`` runs a layer with a state swapped in (by state name);
torch's autograd stays on (the port's functional derivative is autograd,
where the reference turns its tape off for ``jax.grad``).
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional

import torch
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils import _pytree as pytree

from ..core import buffer_updates as _bufup
from ..core.programs import Program
from .export import InputSpec, save

__all__ = ["functional_call", "StaticFunction", "to_static", "declarative",
           "not_to_static", "enable_to_static", "ProgramTranslator",
           "warm_step_program", "TracedLayer", "set_verbosity",
           "get_verbosity", "set_code_level", "get_code_level"]


def functional_call(layer, state: Dict[str, Any], *args,
                    training: Optional[bool] = None, method: str = None,
                    buffer_updates: Optional[Dict[str, Any]] = None,
                    **kwargs):
    """Run ``layer`` (or its ``method``) with ``state`` (name -> tensor)
    swapped in for its parameters and buffers of those names; the
    layer's own tensors are untouched.  ``training`` sets the layers'
    mode for the call.  With ``buffer_updates`` (a dict) running-statistic
    writes are captured instead of applied: the dict is filled with
    ``{state_key: new value}``."""
    modes = None
    if training is not None:
        modes = [(m, m.training) for m in layer.modules()]
        for m, _ in modes:
            m.training = training
    try:
        with _reparametrize_module(layer, state):
            entry = getattr(layer, method) if method else layer
            if buffer_updates is None:
                return entry(*args, **kwargs)
            with _bufup.capture() as log:
                out = entry(*args, **kwargs)
            buffer_updates.update(_bufup.resolve(
                log, layer.state_dict(keep_vars=True)))
            return out
    finally:
        if modes is not None:
            for m, mode in modes:
                m.training = mode


def _label(fn, layer) -> str:
    return (type(layer).__name__ if layer is not None
            else getattr(fn, "__name__", "fn"))


class StaticFunction:
    """Result of ``to_static``: one program per input signature (module
    docstring)."""

    def __init__(self, fn: Callable, layer=None, input_spec=None):
        self._fn = fn
        self._layer = layer
        self._input_spec = input_spec
        self._programs: Dict[tuple, Program] = {}
        self._treespec = {}
        self._pool = None

    @staticmethod
    def _signature(args, kwargs):
        def one(a):
            if isinstance(a, torch.Tensor):
                return ("t", tuple(a.shape), a.dtype, a.device)
            return ("v", a)
        return (tuple(one(a) for a in args),
                tuple(sorted((k, one(v)) for k, v in kwargs.items())))

    def _program(self, sig, args, kwargs):
        prog = self._programs.get(sig)
        if prog is not None:
            return prog

        def buf(a):
            return torch.empty_like(a, memory_format=torch.contiguous_format)
        inputs = {f"a{i}": buf(a) for i, a in enumerate(args)
                  if isinstance(a, torch.Tensor)}
        inputs.update({f"k:{k}": buf(v) for k, v in kwargs.items()
                       if isinstance(v, torch.Tensor)})
        fn = self._fn
        # the values of the other arguments are part of the signature
        consts = [None if isinstance(a, torch.Tensor) else a for a in args]
        kconsts = {k: None if isinstance(v, torch.Tensor) else v
                   for k, v in kwargs.items()}

        def run(**bufs):
            call = [bufs.get(f"a{i}", a) for i, a in enumerate(consts)]
            kw = {k: bufs.get(f"k:{k}", v) for k, v in kconsts.items()}
            with torch.no_grad():
                out = fn(*call, **kw)
            leaves, spec = pytree.tree_flatten(out)
            self._treespec[sig] = spec
            return tuple(leaves)
        from ..observability import track
        prog = self._programs[sig] = track(
            f"to_static:{_label(self._fn, self._layer)}", Program(run, inputs))
        return prog

    def __call__(self, *args, **kwargs):
        sig = self._signature(args, kwargs)
        prog = self._program(sig, args, kwargs)
        for i, a in enumerate(args):
            if isinstance(a, torch.Tensor):
                prog.inputs[f"a{i}"].copy_(a)
        for k, v in kwargs.items():
            if isinstance(v, torch.Tensor):
                prog.inputs[f"k:{k}"].copy_(v)
        captured = any(t.device.type == "cuda"
                       for t in prog.inputs.values())
        if not prog.ready:
            t0 = time.perf_counter()
            if captured:
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                prog.capture(self._pool)
            prog.made(time.perf_counter() - t0)
        out = prog.run(captured=captured)
        return pytree.tree_unflatten([t.clone() for t in out],
                                     self._treespec[sig])

    def compile_counts(self) -> dict:
        """Programs made (on the card: captures), as ``TrainStep``'s."""
        return {"total": sum(p.compiles for p in self._programs.values())}

    def concrete_program(self, *args):
        return self

    @property
    def forward(self):
        return self


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """``@paddle.jit.to_static``: a ``Layer`` (its forward), a bound
    method of a ``Layer`` or a function as a ``StaticFunction``."""
    def decorate(fn):
        if isinstance(fn, torch.nn.Module):
            return StaticFunction(fn.forward, layer=fn,
                                  input_spec=input_spec)
        owner = getattr(fn, "__self__", None)
        if isinstance(owner, torch.nn.Module):
            return StaticFunction(fn, layer=owner, input_spec=input_spec)
        return StaticFunction(fn, input_spec=input_spec)
    if function is not None:
        return decorate(function)
    return decorate


declarative = to_static


def not_to_static(fn):
    return fn


def enable_to_static(flag=True):
    """Taken and, as in the reference, changes nothing: a static function
    is always a program."""


class ProgramTranslator:
    """API-compatible stand-in for fluid's ProgramTranslator (as the
    reference's: ``enable`` changes nothing)."""
    _instance = None

    @classmethod
    def get_instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self, flag):
        pass


def warm_step_program(compiled_fn, state, opt_state, optimizer, raw_batch):
    """Make a step's program for ``raw_batch``'s signature WITHOUT a step
    (the shared half of ``TrainStep.warmup``): ``compiled_fn`` is the
    ``jit.TrainStep``; the state and optimizer state are the step's own,
    which the warm run puts back.  Returns whether a program was made."""
    return bool(compiled_fn.warmup(*raw_batch)["compiled"])


class TracedLayer:
    """A layer traced once into a static program (reference:
    fluid/dygraph/jit.py ``TracedLayer``): the program is a
    ``StaticFunction`` of the layer's forward sharing its parameters, and
    ``save_inference_model`` writes the ``jit.save`` artifact with the
    traced inputs' specs.  Use ``TracedLayer.trace(layer, inputs)``."""

    def __init__(self, layer, example_inputs, outputs):
        self._layer = layer
        self._static = StaticFunction(layer.forward, layer=layer)
        self._example = tuple(example_inputs)
        self._n_outputs = (len(outputs)
                           if isinstance(outputs, (list, tuple)) else 1)

    @staticmethod
    def trace(layer, inputs):
        """(the eager outputs, TracedLayer), as the reference returns."""
        ins = tuple(inputs)
        out = layer(*ins)
        return out, TracedLayer(layer, ins, out)

    def __call__(self, inputs):
        """Run the program on a LIST of inputs; the outputs as a list."""
        out = self._static(*inputs)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def set_strategy(self, build_strategy=None, exec_strategy=None):
        """Taken and not read (the program is the captured graph)."""

    def save_inference_model(self, path, feed=None, fetch=None, **config):
        specs = [InputSpec(tuple(a.shape), a.dtype) for a in self._example]
        if feed is not None and sorted(feed) != list(range(len(specs))):
            raise NotImplementedError(
                "TracedLayer.save_inference_model: feed must cover all "
                "traced inputs (input subsetting would change the traced "
                "program)")
        if fetch is not None and sorted(fetch) != list(
                range(self._n_outputs)):
            raise NotImplementedError(
                "TracedLayer.save_inference_model: fetch must cover all "
                "traced outputs")
        save(self._layer, path, input_spec=specs, **config)


# dy2static logging knobs (reference: dygraph_to_static/logging_utils.py,
# re-exported from paddle.jit).  There is no source transform (a program is
# the traced call), so the level gates how loudly torch reports its
# compile and graph work: level >= 1 sets the "torch" logger to DEBUG, and
# going back below 1 restores the level it had exactly.
_VERBOSITY = 0
_CODE_LEVEL = -1
_PREV_LOG_LEVEL = None


def set_verbosity(level=0, also_to_stdout=False):
    global _VERBOSITY, _PREV_LOG_LEVEL
    logger = logging.getLogger("torch")
    new = int(level)
    if new >= 1 and _VERBOSITY < 1:
        _PREV_LOG_LEVEL = logger.level
        logger.setLevel(logging.DEBUG)
    elif new < 1 and _VERBOSITY >= 1:
        # 0 (NOTSET) is a level too: test against None, not falsiness
        logger.setLevel(logging.WARNING if _PREV_LOG_LEVEL is None
                        else _PREV_LOG_LEVEL)
        _PREV_LOG_LEVEL = None
    _VERBOSITY = new


def get_verbosity():
    return _VERBOSITY


def set_code_level(level=100, also_to_stdout=False):
    global _CODE_LEVEL
    _CODE_LEVEL = int(level)


def get_code_level():
    return _CODE_LEVEL
