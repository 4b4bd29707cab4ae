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
  entries' layout copies).  A capture's counts were recorded, not run:
  they are taken back, kept on ``launches`` and re-added at every replay.
- **Generators.** A program that draws from a generator (``generator=``)
  registers it with its graph, so that each replay advances the
  generator's Philox offset as an eager run would; its recompute regions'
  marks (``core.rng.ProgramMarks``) are recorded by the warm run and
  positioned before each replay.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Dict, Optional

import torch

from . import rng as _rng

__all__ = ["Program", "counters"]


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
            + [(e, "relayouts") for e in (fbn.bn_act_train, fbn.bn2_act_train,
                                          fbn.bn_act_pool_train)])


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
        self.graph = None
        self.outputs = None
        self.launches = []   # ((owner, key), counts per replay)
        self.marks = (None if generator is None
                      else _rng.ProgramMarks(generator))

    def capture(self, pool):
        """The warm run, then the capture into a CUDA graph in the memory
        pool ``pool``.  Whatever ``fn`` writes, the warm run writes for
        real; a caller that must not see it restores it."""
        marks = self.marks
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), (
                marks.recording() if marks else contextlib.nullcontext()):
            self.fn(**self.inputs)
        graph = torch.cuda.CUDAGraph()
        if marks:
            marks.register(graph)
        counted = counters()
        base = [_get(o, k) for o, k in counted]
        # an unreachable graph that the collector frees during the capture
        # (a step and its programs' bound methods are a cycle) would
        # destroy a graph mid-capture, which invalidates the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=side), (
                    marks.capturing() if marks
                    else contextlib.nullcontext()):
                outputs = self.fn(**self.inputs)
            moved = [((o, k), _get(o, k) - b)
                     for (o, k), b in zip(counted, base)]
            self.launches = [(c, n) for c, n in moved if n]
        finally:
            if collecting:
                gc.enable()
            for (o, k), b in zip(counted, base):
                _add(o, k, b - _get(o, k))
        torch.cuda.current_stream().wait_stream(side)
        self.graph, self.outputs = graph, outputs

    def run(self, captured: bool = True):
        if self.graph is None or not captured:
            return self.fn(**self.inputs)
        if self.marks:
            self.marks.position()
        self.graph.replay()
        for (owner, key), n in self.launches:
            _add(owner, key, n)
        return self.outputs
