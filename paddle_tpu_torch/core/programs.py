"""Static-shape programs, captured as CUDA graphs on the card: the one
mechanism behind the serving engine's program family and
``jit.TrainStep``'s step programs, as the reference's ``jax.jit`` programs
are behind both.

A ``Program`` is ``fn(**inputs)`` over static input tensors, which the
caller refills before each run, returning a tuple of tensors.  On the card
``capture`` runs it once on a side stream (the warm run, where first-use
set-up happens: kernel libraries loaded, cuBLAS handles and that stream's
workspace made, cuDNN's algorithm picked), then records it as a CUDA
graph on the same stream; ``run`` replays it and returns the graph's
output tensors, which the next replay overwrites.  Elsewhere ``run`` calls
``fn``.  A capture that fails raises.

- **Launch counts.** The kernel wrappers count host calls (``counters()``:
  every wrapper's ``launches``, K9's launches by route, the fused-BN
  entries' layout copies, the BatchNorm statistics' all-reduces).  A capture's counts were recorded, not run:
  they are taken back, kept on ``launches`` and re-added at every replay.
- **The registry.** A program tagged by ``observability.track`` reports
  to the program registry: ``made(seconds)`` (after its capture, or when
  the CPU builds it) counts one compile with its input and output bytes,
  and every ``run`` one replay.  Nothing of it reads a device value.
- **Captures beside replays.** A fleet boots a replica (captures its
  programs) on one thread while another thread replays other engines'
  graphs.  So a capture runs in ``"thread_local"`` mode (the replaying
  thread's host reads and synchronizes stay legal during it), and the
  launch counters change only under one lock: a capture takes back what
  its own thread counted, never what a replay elsewhere added meanwhile.
  ``replays`` counts a program's replays (a replica's launches are
  ``replays`` times its graphs' counts).  Each thread captures on one
  side stream of its own.
- **Generators.** A program that draws from a generator (``generator=``)
  registers it with its graph, so that each replay advances the
  generator's Philox offset as an eager run would; its recompute regions'
  marks (``core.rng.ProgramMarks``) are recorded by the warm run and
  positioned before each replay.
"""
from __future__ import annotations

import contextlib
import gc
import threading
from typing import Dict, Optional

import torch

from . import rng as _rng

__all__ = ["Program", "counters", "counter_name"]


def counters():
    """(owner, key) of every launch counter the kernel wrappers keep."""
    from ..ops import fused_bn_act as fbn
    from ..ops.flash_attention import flash_bwd, flash_fwd
    from ..ops.int8_matmul import dequant_matmul
    from ..ops.paged_attention import paged_attention
    wrappers = (paged_attention, dequant_matmul, flash_fwd, flash_bwd,
                fbn.bn_stats, fbn.bn_apply, fbn.bn_bwd_reduce, fbn.bn_bwd_dx,
                fbn.bn_pool_apply)
    return ([(w, "launches") for w in wrappers]
            + [(fbn.bn_pool_apply.routes, r) for r in ("ring", "window")]
            + [(e, k) for e in (fbn.bn_act_train, fbn.bn2_act_train,
                                fbn.bn_act_pool_train)
               for k in ("relayouts", "composite_calls")]
            + [(fbn.stats_group, "all_reduces")])


def counter_name(owner, key) -> str:
    """A launch counter's name: ``<wrapper>.<key>``
    (``paged_attention.launches``), ``bn_pool_apply.routes.<route>`` for
    K9's routes."""
    name = getattr(owner, "__name__", None)
    return f"{name}.{key}" if name else f"bn_pool_apply.routes.{key}"


# guards the launch counters' read-modify-write by replays and captures;
# _ledgers holds, per capture underway, what replays added meanwhile
_count_lock = threading.Lock()
_ledgers = []
_tls = threading.local()   # per-thread capture streams


def _side_stream():
    """This thread's capture stream on the current device, made once: a
    library's per-stream state made by a warm run (cuBLAS's workspace) is
    then made once per thread, not once per capture."""
    streams = _tls.__dict__.setdefault("streams", {})
    dev = torch.cuda.current_device()
    if dev not in streams:
        streams[dev] = torch.cuda.Stream()
    return streams[dev]


def _get(owner, key) -> int:
    return owner[key] if isinstance(owner, dict) else getattr(owner, key)


def _add(owner, key, n: int):
    if isinstance(owner, dict):
        owner[key] += n
    else:
        setattr(owner, key, getattr(owner, key) + n)


class Program:
    """One static-shape program (see the module docstring)."""

    def __init__(self, fn, inputs: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None):
        self.fn = fn
        self.inputs = inputs
        self.ready = False   # made (on the card: captured)
        self.compiles = 0    # times made (captures on the card)
        self.graph = None
        self.outputs = None
        self.launches = []   # ((owner, key), counts per replay)
        self.replays = 0     # graph replays (captured runs)
        self.marks = (None if generator is None
                      else _rng.ProgramMarks(generator))
        self.tracked_as = None        # registry name (observability.track)
        self.registry = None
        self._replays = None          # the registry's run counter
        self._out_bytes_noted = False

    def capture(self, pool):
        """The warm run, then the capture into a CUDA graph in the memory
        pool ``pool``.  Whatever ``fn`` writes, the warm run writes for
        real; a caller that must not see it restores it."""
        marks = self.marks
        side = _side_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), (
                marks.recording() if marks else contextlib.nullcontext()):
            self.fn(**self.inputs)
        graph = torch.cuda.CUDAGraph()
        if marks:
            marks.register(graph)
        counted = counters()
        ledger = {(id(o), k): 0 for o, k in counted}
        with _count_lock:
            base = [_get(o, k) for o, k in counted]
            _ledgers.append(ledger)
        # an unreachable graph that the collector frees during the capture
        # (a step and its programs' bound methods are a cycle) would
        # destroy a graph mid-capture, which invalidates the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode="thread_local"), (
                    marks.capturing() if marks
                    else contextlib.nullcontext()):
                outputs = self.fn(**self.inputs)
        finally:
            if collecting:
                gc.enable()
            with _count_lock:
                _ledgers.remove(ledger)
                moved = [((o, k), _get(o, k) - b - ledger[(id(o), k)])
                         for (o, k), b in zip(counted, base)]
                for (o, k), n in moved:
                    _add(o, k, -n)
        self.launches = [(c, n) for c, n in moved if n]
        torch.cuda.current_stream().wait_stream(side)
        self.graph, self.outputs = graph, outputs

    def made(self, seconds: float):
        """Mark the program ready; a tracked one records its compile,
        which took ``seconds``, in the registry."""
        self.ready = True
        self.compiles += 1
        if self.tracked_as is None:
            return
        from ..observability.programs import XLA_ONLY, tensor_bytes
        self._replays = self.registry.replay_cell(self.tracked_as)
        cost = dict.fromkeys(XLA_ONLY)
        cost["argument_bytes"] = tensor_bytes(self.inputs.values())
        if self.outputs is not None:
            cost["output_bytes"] = tensor_bytes(self.outputs)
            self._out_bytes_noted = True
        self.registry.note_compile(self.tracked_as, seconds, cost,
                                   meta={"captured": self.graph is not None})

    def _note_run(self, outputs):
        self._replays[0] += 1
        if not self._out_bytes_noted:
            from ..observability.programs import tensor_bytes
            self.registry.note_cost(self.tracked_as,
                                    {"output_bytes": tensor_bytes(outputs)})
            self._out_bytes_noted = True

    def run(self, captured: bool = True):
        if self.graph is None or not captured:
            out = self.fn(**self.inputs)
        else:
            if self.marks:
                self.marks.position()
            self.graph.replay()
            with _count_lock:
                self.replays += 1
                for (owner, key), n in self.launches:
                    _add(owner, key, n)
                    for ledger in _ledgers:
                        ledger[(id(owner), key)] += n
            out = self.outputs
        if self._replays is not None:
            self._note_run(out)
        return out
