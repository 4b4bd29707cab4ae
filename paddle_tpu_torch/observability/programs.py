"""Program registry: every big program of the port, queryable by name
(port of paddle_tpu/observability/programs.py).

The reference records each XLA compile.  The port's big programs are
``core.programs.Program``s (the serving engine's prefills and decode
ticks, ``jit.TrainStep``'s step per batch signature), each captured as a
CUDA graph on the card, so a capture plays the part of a compile:

- ``track(name, program)`` tags a ``Program`` with its registry name and
  returns it.  When the program is made (``Program.made(seconds)``: on
  the card after its capture, the seconds covering the warm run and the
  capture; on the CPU when it is built) the registry counts one compile
  with those
  seconds, the input buffers' bytes (``argument_bytes``) and the outputs'
  bytes (``output_bytes``, once they are known); every later run counts
  one replay (``replays``, an integer add without a lock; on the CPU a
  direct run stands in for a replay).  The XLA-only fields stay None:
  ``flops`` and ``bytes_accessed`` (XLA's cost analysis) and
  ``peak_live_bytes`` (a jaxpr walk).  ``PDTPU_OBS_PROGRAMS=0`` leaves programs untagged.
- ``track(name, fn)`` of a plain callable wraps it in ``TrackedJit``,
  which records the first call of each input signature as its compile.
- ``note_compile(name, seconds, ...)`` records a compile observed
  elsewhere.

The port has no ahead-of-time path, so no program falls back from one and
``aot_fallbacks()`` is ``[]``.  Nothing here reads a device value: the
byte counts come from shapes and dtypes.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

__all__ = ["ProgramRegistry", "get_program_registry", "track",
           "note_compile", "TrackedJit", "aot_fallbacks"]

# fields the reference fills from XLA's cost and memory analysis or a
# jaxpr, which a CUDA graph does not expose
XLA_ONLY = ("flops", "bytes_accessed", "peak_live_bytes")


def _tracking_enabled() -> bool:
    return os.environ.get("PDTPU_OBS_PROGRAMS", "1").lower() not in (
        "0", "off", "false", "no")


def tensor_bytes(tensors) -> float:
    """Bytes of the tensors among ``tensors`` (shape x element size)."""
    return float(sum(t.numel() * t.element_size() for t in tensors
                     if hasattr(t, "element_size")))


def _new_record(name: str) -> dict:
    return {"name": name, "compiles": 0, "compile_seconds_total": 0.0,
            "last_compile_ms": None, "first_compiled_at": time.time()}


class ProgramRegistry:
    """name -> {compiles, compile_seconds_total, last_compile_ms,
    replays, cost...}"""

    def __init__(self):
        self._lock = threading.Lock()
        self._programs: Dict[str, dict] = {}
        # name -> [runs]: bumped by the programs without a lock (the hot
        # path pays one integer add), read into "replays" by snapshots
        self._replays: Dict[str, list] = {}

    def note_compile(self, name: str, seconds: float,
                     cost: Optional[dict] = None,
                     meta: Optional[dict] = None):
        with self._lock:
            rec = self._programs.get(name)
            if rec is None:
                rec = self._programs[name] = _new_record(name)
            rec["compiles"] += 1
            rec["compile_seconds_total"] += float(seconds)
            rec["last_compile_ms"] = float(seconds) * 1e3
            if cost:
                rec.update(cost)
            if meta:
                rec.setdefault("meta", {}).update(meta)

    def note_cost(self, name: str, cost: dict):
        """Attach cost fields learned after the compile (a program's
        output bytes, known at its first run on the CPU)."""
        with self._lock:
            rec = self._programs.get(name)
            if rec is not None:
                rec.update(cost)

    def replay_cell(self, name: str) -> list:
        """The one-element run counter of ``name``, which programs bump."""
        with self._lock:
            return self._replays.setdefault(name, [0])

    def _read(self, name: str, rec: dict) -> dict:
        out = dict(rec)
        out["replays"] = self._replays.get(name, [0])[0]
        return out

    def get(self, name: str) -> Optional[dict]:
        with self._lock:
            rec = self._programs.get(name)
            return self._read(name, rec) if rec is not None else None

    def names(self):
        with self._lock:
            return sorted(self._programs)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {k: self._read(k, v) for k, v in self._programs.items()}

    def clear(self):
        with self._lock:
            self._programs.clear()
            for cell in self._replays.values():
                cell[0] = 0


_default_programs = ProgramRegistry()


def get_program_registry() -> ProgramRegistry:
    return _default_programs


def note_compile(name: str, seconds: float, cost: Optional[dict] = None,
                 meta: Optional[dict] = None):
    _default_programs.note_compile(name, seconds, cost, meta)


def _sig_leaf(x):
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return (tuple(shape), str(dtype))
    return ("py", type(x).__name__)


class TrackedJit:
    """A plain callable whose first call per input signature (the shapes
    and dtypes of its tensor arguments) is recorded as a compile, with
    that call's wall seconds; every call passes straight through.
    Unknown attributes go to the wrapped callable."""

    def __init__(self, name: str, fn, registry: ProgramRegistry = None):
        self._name = name
        self._fn = fn
        self._registry = registry or _default_programs
        self._seen = set()

    def __call__(self, *args, **kwargs):
        sig = (tuple(_sig_leaf(a) for a in args),
               tuple(sorted((k, _sig_leaf(v)) for k, v in kwargs.items())))
        if sig in self._seen:
            return self._fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        self._seen.add(sig)
        self._registry.note_compile(self._name, time.perf_counter() - t0,
                                    dict.fromkeys(XLA_ONLY))
        return out

    def __getattr__(self, attr):
        return getattr(self._fn, attr)


def track(name: str, fn, registry: ProgramRegistry = None):
    """Register ``fn`` under ``name``: a ``core.programs.Program`` is
    tagged and returned (see the module docstring), any other callable is
    wrapped in ``TrackedJit``.  Identity when PDTPU_OBS_PROGRAMS=0."""
    if not _tracking_enabled():
        return fn
    from ..core.programs import Program
    if isinstance(fn, Program):
        fn.tracked_as = name
        fn.registry = registry or _default_programs
        return fn
    return TrackedJit(name, fn, registry)


def aot_fallbacks(registry: ProgramRegistry = None) -> list:
    """Names of programs that permanently fell back from the AOT path.
    The port has no AOT path, so this is empty unless a caller notes such
    metadata itself."""
    snap = (registry or _default_programs).snapshot()
    return sorted(n for n, rec in snap.items()
                  if (rec.get("meta") or {}).get("aot") is False)
