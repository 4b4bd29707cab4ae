"""Profiler — a shim over ``observability.tracer`` (port of
paddle_tpu/utils/profiler.py).

Host spans live in the observability tracer (a bounded ring and per-name
aggregates under a lock).  ``start_profiler`` / ``stop_profiler`` /
``profiler`` report the spans recorded between them (the delta of the
tracer's aggregates); ``RecordEvent`` is a span that also opens a
``torch.profiler.record_function`` range, so that in a ``torch.profiler``
trace it encloses the kernels launched inside it; ``log_dir`` writes a
``torch.profiler`` trace of the window there (the reference writes a
``jax.profiler`` one).  The reference's per-op dispatch hook and its
dispatch-cache line have no counterpart: the port has no eager dispatch
layer of its own.
"""
from __future__ import annotations

import contextlib
import os

from ..observability.tracer import get_tracer

__all__ = ["RecordEvent", "start_profiler", "stop_profiler", "profiler",
           "summary", "export_chrome_tracing"]

# aggregates snapshot taken at start_profiler: the profiler reports the
# DELTA since then, so starting a profile does not wipe span history
# other subsystems accumulated in the shared tracer
_baseline: dict = {}
_trace = None   # (torch profiler, log_dir) of a window with log_dir


def _delta():
    agg = get_tracer().aggregates()
    out = {}
    for k, (c, t) in agg.items():
        bc, bt = _baseline.get(k, (0, 0.0))
        if c - bc > 0:
            out[k] = [c - bc, t - bt]
    return out


def __getattr__(name):
    # the reference's internals, as lock-safe snapshots of the tracer
    if name == "_records":
        return _delta()
    if name == "_events":
        return [(n, t0, dur) for n, t0, dur, *_ in get_tracer().events()]
    raise AttributeError(name)


def start_profiler(state="All", tracer_option="Default", log_dir=None):
    """reference: fluid.profiler.start_profiler"""
    global _baseline, _trace
    _baseline = get_tracer().aggregates()
    _trace = None
    if log_dir:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        _trace = (prof, log_dir)


def stop_profiler(sorted_key="total", profile_path=None):
    global _trace
    if _trace is not None:
        prof, log_dir = _trace
        _trace = None
        prof.__exit__(None, None, None)
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    agg = _delta()
    rows = sorted(agg.items(), key=lambda kv: -kv[1][1])
    lines = [f"{'op':<32}{'calls':>10}{'total_s':>14}{'avg_ms':>12}"]
    for name, (cnt, tot) in rows[:50]:
        lines.append(f"{name:<32}{cnt:>10}{tot:>14.4f}{tot / cnt * 1e3:>12.4f}")
    report = "\n".join(lines)
    if profile_path:
        with open(profile_path, "w") as f:
            f.write(report)
    else:
        print(report)
    return agg


@contextlib.contextmanager
def profiler(state="All", sorted_key="total", profile_path=None, log_dir=None):
    """``with paddle_tpu_torch.utils.profiler.profiler():`` context."""
    start_profiler(state, log_dir=log_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


class RecordEvent:
    """Host span (reference: platform/profiler.h:127) — an observability
    span with a ``torch.profiler.record_function`` range of its name."""

    def __init__(self, name):
        self.name = name
        self._span = None

    def __enter__(self):
        self._span = get_tracer().span(self.name, annotate=True)
        return self

    def __exit__(self, *exc):
        if self._span is not None:
            self._span.end()
            self._span = None
        return False

    def end(self):
        self.__exit__(None, None, None)


def summary():
    """Span records plus the monitor's STAT counters."""
    out = _delta()  # == full aggregates when no profile was ever started
    from .monitor import stats
    st = stats()
    if st:
        out["__stats__"] = st
    return out


def export_chrome_tracing(path: str) -> str:
    """Write the recorded host spans as a chrome://tracing (catapult) JSON,
    with thread ids and parent links; the device timeline comes from a
    ``torch.profiler`` trace."""
    return get_tracer().export_chrome_trace(path)
