"""Host-side span tracer: nestable, thread-aware, ring-buffered (port of
paddle_tpu/observability/tracer.py).

Every span carries a thread id and an explicit parent (the innermost open
span on its thread unless overridden), so the chrome export nests
correctly even when the serving engine, the checkpoint writer and the
training loop all record concurrently.  ``utils.profiler`` is a shim over
this tracer.

The device half is ``torch.profiler``: ``span(..., annotate=True)`` also
opens a ``torch.profiler.record_function`` range of the span's name, so
in a ``torch.profiler`` trace the host span encloses the kernels it
launched (where the reference opens a ``jax.profiler.TraceAnnotation``).
A span reads no device value and synchronizes nothing.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer", "get_tracer", "span"]

DEFAULT_MAX_EVENTS = 200_000  # bounds host memory


class Span:
    """One open (then closed) host span.  Use as a context manager or call
    `end()` explicitly (the RecordEvent idiom)."""

    __slots__ = ("name", "tracer", "span_id", "parent_id", "tid", "t0",
                 "dur", "args", "_annotation", "_ended")

    def __init__(self, tracer: "Tracer", name: str,
                 parent: Optional["Span"] = None, annotate: bool = False,
                 args: Optional[dict] = None):
        self.tracer = tracer
        self.name = name
        self.span_id = next(tracer._ids)
        self.tid = threading.get_ident()
        self.args = args
        self.dur = None
        self._ended = False
        stack = tracer._stack()
        explicit = parent is not None
        if not explicit and stack:
            parent = stack[-1]
        self.parent_id = parent.span_id if parent is not None else None
        stack.append(self)
        self._annotation = None
        if annotate:
            try:  # torch optional here: the tracer itself is pure host
                from torch.profiler import record_function
                self._annotation = record_function(name)
                self._annotation.__enter__()
            except Exception:
                self._annotation = None
        self.t0 = time.perf_counter()

    def end(self):
        if self._ended:
            return
        self._ended = True
        now = time.perf_counter()
        self.dur = now - self.t0
        if self._annotation is not None:
            try:
                self._annotation.__exit__(None, None, None)
            except Exception:
                pass
        stack = self.tracer._stack()
        if self in stack:  # pop through abandoned children
            while stack and stack[-1] is not self:
                stack.pop()
            stack.pop()
        self.tracer._record(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False


class Tracer:
    """Bounded span recorder + per-name aggregates, all under one lock."""

    def __init__(self, max_events: int = DEFAULT_MAX_EVENTS):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(max_events))
        self._agg: Dict[str, list] = {}  # name -> [count, total_s]
        self._ids = itertools.count(1)
        self._tls = threading.local()

    def _stack(self) -> list:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def _record(self, sp: Span):
        with self._lock:
            rec = self._agg.get(sp.name)
            if rec is None:
                rec = self._agg[sp.name] = [0, 0.0]
            rec[0] += 1
            rec[1] += sp.dur
            self._ring.append((sp.name, sp.t0, sp.dur, sp.tid, sp.span_id,
                               sp.parent_id, sp.args))

    # -- recording -----------------------------------------------------------
    def span(self, name: str, parent: Optional[Span] = None,
             annotate: bool = False, args: Optional[dict] = None) -> Span:
        return Span(self, name, parent=parent, annotate=annotate, args=args)

    def current_span(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    # -- reading -------------------------------------------------------------
    def aggregates(self) -> Dict[str, list]:
        """{name: [count, total_seconds]} — the profiler.summary shape."""
        with self._lock:
            return {k: list(v) for k, v in self._agg.items()}

    def events(self) -> List[tuple]:
        """Snapshot of the ring: (name, t0, dur, tid, id, parent_id, args)."""
        with self._lock:
            return list(self._ring)

    def __len__(self):
        with self._lock:
            return len(self._ring)

    @property
    def max_events(self) -> int:
        return self._ring.maxlen

    def set_max_events(self, n: int):
        with self._lock:
            self._ring = deque(self._ring, maxlen=int(n))

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._agg.clear()

    # -- export --------------------------------------------------------------
    def chrome_trace(self) -> dict:
        """catapult JSON document (host side; the device timeline comes
        from torch.profiler)."""
        events = []
        for name, t0, dur, tid, sid, parent, args in self.events():
            ev = {"name": name, "ph": "X", "cat": "host",
                  "ts": t0 * 1e6, "dur": dur * 1e6,
                  "pid": os.getpid(), "tid": tid,
                  "args": dict(args or {}, span_id=sid,
                               parent_id=parent)}
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        doc = self.chrome_trace()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


_default_tracer = Tracer()


def get_tracer() -> Tracer:
    return _default_tracer


def span(name: str, parent: Optional[Span] = None, annotate: bool = False,
         args: Optional[dict] = None) -> Span:
    """Open a span on the default tracer (context manager)."""
    return _default_tracer.span(name, parent=parent, annotate=annotate,
                                args=args)
