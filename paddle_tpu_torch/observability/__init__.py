"""paddle_tpu_torch.observability — the unified telemetry subsystem (port
of paddle_tpu/observability/, under the reference's names and shapes):

- **metrics**  — typed Counter/Gauge/Histogram registry with label sets,
  per-metric locks and collector callbacks.  ``utils.monitor``'s STAT_*
  verbs are a shim over it.
- **tracer**   — nestable host spans with thread ids and explicit
  parents, a bounded ring buffer, chrome://tracing export, and
  ``torch.profiler.record_function`` ranges (``annotate=True``) so a host
  span encloses its kernels in a ``torch.profiler`` trace.
  ``utils.profiler`` is a shim over it.
- **programs** — the program registry: every captured program (a CUDA
  graph on the card) records its capture seconds, input and output bytes
  and replays, queryable by name.
- **exporters** — Prometheus text exposition over a stdlib HTTP endpoint,
  a JSONL file sink, and ``report()``.

Quick use:

    from paddle_tpu_torch import observability as obs
    with obs.span("load_batch"):
        ...
    obs.counter("my_events_total").inc()
    print(obs.prometheus_text())
    rep = obs.report()          # checkpoint, train, serving, programs
    srv = obs.serve_metrics(9464)   # GET /metrics, /report
"""
from __future__ import annotations

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa: F401
                      counter, gauge, get_registry, histogram)
from .tracer import Span, Tracer, get_tracer, span  # noqa: F401
from .programs import (ProgramRegistry, TrackedJit, aot_fallbacks,  # noqa: F401
                       get_program_registry, note_compile, track)
from .exporters import (JsonlSink, MetricsServer, prometheus_text,  # noqa: F401
                        render_endpoint, report, serve_metrics)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "counter", "gauge",
    "histogram", "get_registry",
    "Span", "Tracer", "get_tracer", "span",
    "ProgramRegistry", "TrackedJit", "get_program_registry", "note_compile",
    "track", "aot_fallbacks",
    "JsonlSink", "MetricsServer", "prometheus_text", "render_endpoint",
    "report", "serve_metrics",
    "export_chrome_trace", "reset",
]


def export_chrome_trace(path: str) -> str:
    """Write the default tracer's ring as a chrome://tracing JSON file."""
    return get_tracer().export_chrome_trace(path)


def reset():
    """Zero metrics, clear spans and the program registry."""
    get_registry().reset()
    get_tracer().clear()
    get_program_registry().clear()
