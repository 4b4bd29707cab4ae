"""Exporters: Prometheus text exposition, JSONL sink, the unified report
(port of paddle_tpu/observability/exporters.py).

- ``prometheus_text()`` renders the metrics registry (plus collector-fed
  series) in Prometheus text exposition format 0.0.4.
  ``serve_metrics(port)`` exposes it over a stdlib HTTP endpoint
  (``/metrics``, and ``/report`` as JSON); rendering is separated from
  the socket so tests exercise the exact handler payload without binding
  a port.
- ``JsonlSink`` appends periodic ``report()`` snapshots to a JSONL file
  from a daemon thread.
- ``report()`` is the unified report: one pass over the metrics registry,
  the tracer's aggregates and the program registry, with a section for
  each runtime subsystem, under the reference's keys.  The layers the
  port does not have yet (the eager dispatch cache, the DataLoader, the
  gateway, the fleet, embeddings, the program store) report what the
  reference reports for a layer that never ran: zero counts, None gauges
  and histograms, a dispatch cache and a program store that are off.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Optional

from .metrics import Histogram, get_registry
from .programs import get_program_registry
from .tracer import get_tracer

__all__ = ["prometheus_text", "serve_metrics", "MetricsServer",
           "JsonlSink", "report", "render_endpoint"]


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _esc(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n").replace(
        '"', '\\"')


def _labels_str(labelnames, values, extra=None) -> str:
    pairs = [f'{n}="{_esc(v)}"' for n, v in zip(labelnames, values)]
    if extra:
        pairs += [f'{n}="{_esc(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def prometheus_text(registry=None) -> str:
    """Render the registry in Prometheus text exposition format."""
    registry = registry or get_registry()
    lines = []
    snap = registry.snapshot()
    for name in sorted(snap):
        ent = snap[name]
        kind = ent["kind"]
        prom_kind = kind if kind in ("counter", "gauge", "histogram") \
            else "untyped"
        if ent.get("help"):
            lines.append(f"# HELP {name} {_esc(ent['help'])}")
        lines.append(f"# TYPE {name} {prom_kind}")
        labelnames = ent.get("labelnames", ())
        for values, v in ent["samples"]:
            if isinstance(v, dict) and "buckets" in v:  # histogram
                cum = 0
                for bound, c in zip(v["buckets"], v["counts"]):
                    cum += c
                    lines.append(
                        f"{name}_bucket"
                        f"{_labels_str(labelnames, values, [('le', _fmt(bound))])}"
                        f" {cum}")
                cum += v["counts"][-1]
                lines.append(
                    f"{name}_bucket"
                    f"{_labels_str(labelnames, values, [('le', '+Inf')])}"
                    f" {cum}")
                lines.append(f"{name}_sum"
                             f"{_labels_str(labelnames, values)} "
                             f"{_fmt(v['sum'])}")
                lines.append(f"{name}_count"
                             f"{_labels_str(labelnames, values)} {cum}")
            else:
                lines.append(f"{name}{_labels_str(labelnames, values)} "
                             f"{_fmt(v)}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# unified report
# ---------------------------------------------------------------------------

def _hist_summary(name: str) -> Optional[dict]:
    m = get_registry().get(name)
    if not isinstance(m, Histogram):
        return None
    snap = m.snapshot()
    if not snap["count"]:
        return {"count": 0}
    return {"count": snap["count"], "sum_s": snap["sum"],
            "mean_ms": snap["sum"] / snap["count"] * 1e3,
            "p50_ms": (m.quantile(0.5) or 0.0) * 1e3,
            "p90_ms": (m.quantile(0.9) or 0.0) * 1e3,
            "p99_ms": (m.quantile(0.99) or 0.0) * 1e3,
            "min_ms": (snap["min"] or 0.0) * 1e3,
            "max_ms": (snap["max"] or 0.0) * 1e3}


def _gauge_value(name: str):
    m = get_registry().get(name)
    try:
        return m.value() if m is not None else None
    except Exception:
        return None


def report() -> dict:
    """One report for the whole runtime: the profiler table,
    ``monitor.stats()``, the serving engine's and the training step's
    telemetry, the program registry (the reference's keys)."""
    from ..utils import monitor

    # the port has no eager dispatch cache: the reference's section for
    # one that holds nothing and is off
    dispatch = {"hits": 0, "misses": 0, "fallbacks": 0, "bypass": 0,
                "evictions": 0, "entries": 0, "enabled": False,
                "max_entries": 0, "hit_rate": None}

    stats = monitor.stats()
    train = {
        "step_seconds": _hist_summary("train_step_seconds"),
        "data_wait_seconds": _hist_summary("dataloader_data_wait_seconds"),
        "checkpoint_stall_seconds":
            _hist_summary("checkpoint_save_stall_seconds"),
        "guard_bad_steps": stats.get("STAT_guarded_bad_steps", 0),
        "guard_rollbacks": stats.get("STAT_guarded_rollbacks", 0),
    }
    dataloader = {
        "data_wait_seconds": _hist_summary("dataloader_data_wait_seconds"),
        "queue_depth": _gauge_value("dataloader_queue_depth"),
        "batches": stats.get("STAT_dataloader_batch_count", 0),
        "bytes": stats.get("STAT_dataloader_bytes", 0),
        "worker_respawns": stats.get("STAT_dataloader_worker_respawns", 0),
    }
    checkpoint = {
        "save_stall_seconds": _hist_summary("checkpoint_save_stall_seconds"),
        "async_in_flight": _gauge_value("checkpoint_async_in_flight"),
        "bytes_written": stats.get("STAT_checkpoint_bytes_written", 0),
        "saves": stats.get("STAT_checkpoint_saves", 0),
        "async_writes": stats.get("STAT_checkpoint_async_writes", 0),
    }
    pc_hits = _gauge_value("prefix_cache_hits_total") or 0
    pc_misses = _gauge_value("prefix_cache_misses_total") or 0
    pc_total = pc_hits + pc_misses
    serving = {
        "ttft_seconds": _hist_summary("serving_ttft_seconds"),
        "inter_token_seconds": _hist_summary("serving_inter_token_seconds"),
        "slot_occupancy": _gauge_value("serving_slot_occupancy"),
        "queue_depth": _gauge_value("serving_queue_depth"),
        "queue_full_rejections": stats.get("STAT_serving_rejects", 0),
        "tokens_out": stats.get("STAT_serving_tokens", 0),
        "requests": stats.get("STAT_serving_requests", 0),
        # prefix cache: block-level prompt reuse across admissions
        "prefix_cache_hits": pc_hits,
        "prefix_cache_misses": pc_misses,
        "prefix_cache_hit_rate": (pc_hits / pc_total if pc_total
                                  else None),
        "prefix_cache_evictions":
            _gauge_value("prefix_cache_evictions_total") or 0,
        "prefix_cache_cow_copies":
            _gauge_value("prefix_cache_cow_copies_total") or 0,
        # multi-tenant LoRA on the serving path: registry residency and
        # page-in/out churn (`adapter_active` mirrors the
        # lora_adapters_loaded gauge; ship_retries counts artifact
        # re-ships after a corrupt/failed transfer)
        "adapter_loads": stats.get("STAT_lora_adapter_loads", 0),
        "adapter_evictions": stats.get("STAT_lora_adapter_evictions", 0),
        "adapter_ship_retries": stats.get("STAT_lora_ship_reships", 0),
        "adapter_active": _gauge_value("lora_adapters_loaded") or 0,
    }
    fleet = {
        "replicas_up": _gauge_value("fleet_replicas_up"),
        "failovers": stats.get("STAT_fleet_failovers", 0),
        "migrated_runs": stats.get("STAT_fleet_migrated_runs", 0),
        "resubmits": stats.get("STAT_fleet_resubmits", 0),
        "lost_runs": stats.get("STAT_fleet_lost_runs", 0),
        "reroutes": stats.get("STAT_fleet_reroutes", 0),
        "drains": stats.get("STAT_fleet_drains", 0),
        # subprocess workers (process isolation): live worker processes,
        # heartbeat-age fences (wedges), supervised restarts and
        # budget exhaustions
        "worker_processes": _gauge_value("fleet_worker_processes"),
        "wedges": stats.get("STAT_fleet_wedges", 0),
        "worker_restarts": stats.get("STAT_fleet_worker_restarts", 0),
        "restarts_exhausted": stats.get("STAT_fleet_restarts_exhausted",
                                        0),
        # remote (network-attached) workers: boot-handshake artifact
        # shipping volume — which weights a replica serves is per-replica
        # in /healthz (weights_sha/epoch in each snapshot)
        "weight_bytes_shipped": stats.get(
            "STAT_fleet_weight_bytes_shipped", 0),
    }
    # train->serve loop: continuous weight refresh (canary-gated flips,
    # quarantining rollbacks) + SLO-driven elastic membership
    elastic = {
        "target_replicas": _gauge_value("fleet_target_replicas"),
        "weight_refreshes": stats.get("STAT_fleet_weight_refreshes", 0),
        "rollbacks": stats.get("STAT_fleet_rollbacks", 0),
        "scale_ups": stats.get("STAT_fleet_scale_up", 0),
        "scale_downs": stats.get("STAT_fleet_scale_down", 0),
    }
    gateway = {
        "ttft_hi_seconds": _hist_summary("gateway_ttft_hi_seconds"),
        "ttft_lo_seconds": _hist_summary("gateway_ttft_lo_seconds"),
        "lane_depth_hi": _gauge_value("gateway_lane_hi_depth"),
        "lane_depth_lo": _gauge_value("gateway_lane_lo_depth"),
        "paused_runs": _gauge_value("gateway_paused_runs"),
        "requests": stats.get("STAT_gateway_requests", 0),
        "admitted": stats.get("STAT_gateway_admitted", 0),
        "shed": stats.get("STAT_gateway_shed", 0),
        "rate_limited": stats.get("STAT_gateway_rate_limited", 0),
        "preemptions": stats.get("STAT_gateway_preemptions", 0),
        "resumes": stats.get("STAT_gateway_resumes", 0),
    }
    # multi-tenant LoRA: registry residency + artifact shipping volume
    lora = {
        "adapters_loaded": _gauge_value("lora_adapters_loaded"),
        "adapter_loads": stats.get("STAT_lora_adapter_loads", 0),
        "adapter_evictions": stats.get("STAT_lora_adapter_evictions", 0),
        "rejects": stats.get("STAT_lora_rejects", 0),
        "ship_bytes": stats.get("STAT_lora_ship_bytes", 0),
        "ship_reattaches": stats.get("STAT_lora_ship_reattaches", 0),
        "ship_retries": stats.get("STAT_lora_ship_reships", 0),
    }
    gathered = stats.get("STAT_embedding_rows_gathered", 0)
    unique = stats.get("STAT_embedding_rows_unique", 0)
    pf_hits = stats.get("STAT_embedding_prefetch_hits", 0)
    pf_misses = stats.get("STAT_embedding_prefetch_misses", 0)
    embedding = {
        "prefetch_wait_seconds":
            _hist_summary("embedding_prefetch_wait_seconds"),
        "device_table_bytes": _gauge_value("embedding_device_table_bytes"),
        "rows_gathered": gathered,
        "rows_unique": unique,
        "dedup_ratio": (gathered / unique) if unique else None,
        "prefetch_hits": pf_hits,
        "prefetch_misses": pf_misses,
        "prefetch_hit_rate": (pf_hits / (pf_hits + pf_misses)
                              if (pf_hits + pf_misses) else None),
        "host_to_device_bytes":
            stats.get("STAT_embedding_host_to_device_bytes", 0),
        "device_to_host_bytes":
            stats.get("STAT_embedding_device_to_host_bytes", 0),
        "corrupt_rows_detected":
            stats.get("STAT_embedding_corrupt_rows_detected", 0),
        "serving_rejects": stats.get("STAT_embedding_serving_rejects", 0),
    }
    # no persistent program store in the port (a CUDA graph is not
    # saved): the reference's section for a store that is off; and no AOT
    # path to fall back from
    program_store = {"enabled": False, "dir": None, "fingerprint": None,
                     "entries": 0, "bytes": 0, "hits": 0, "misses": 0,
                     "requests": 0}
    from .programs import aot_fallbacks as _aot_fallbacks
    fallbacks = _aot_fallbacks()

    return {
        "generated_at": time.time(),
        "dispatch_cache": dispatch,
        "dataloader": dataloader,
        "checkpoint": checkpoint,
        "train": train,
        "serving": serving,
        "gateway": gateway,
        "fleet": fleet,
        "elastic": elastic,
        "lora": lora,
        "embedding": embedding,
        "programs": get_program_registry().snapshot(),
        "program_store": program_store,
        "programs_aot_fallbacks": fallbacks,
        "spans": get_tracer().aggregates(),
        "stats": stats,
        "metrics": get_registry().snapshot(),
    }


# ---------------------------------------------------------------------------
# HTTP endpoint (stdlib only)
# ---------------------------------------------------------------------------

def render_endpoint(path: str):
    """(status, content_type, body) for a metrics-endpoint path — the
    handler body, callable without a socket (tier-1 stays port-free)."""
    if path.split("?")[0] in ("/metrics", "/"):
        return (200, "text/plain; version=0.0.4; charset=utf-8",
                prometheus_text().encode())
    if path.split("?")[0] == "/report":
        return (200, "application/json",
                json.dumps(report(), default=str).encode())
    return 404, "text/plain", b"not found\n"


class MetricsServer:
    """`/metrics` (Prometheus) + `/report` (JSON) over http.server."""

    def __init__(self, port: int = 0, addr: str = "127.0.0.1"):
        import http.server

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib naming)
                status, ctype, body = render_endpoint(self.path)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-scrape stderr noise
                pass

        self._httpd = http.server.ThreadingHTTPServer((addr, port), Handler)
        self.port = self._httpd.server_address[1]
        self.addr = addr
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="paddle_tpu_torch-metrics",
                                        daemon=True)
        self._thread.start()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def serve_metrics(port: int = 9464, addr: str = "127.0.0.1") -> MetricsServer:
    """Start the metrics endpoint; returns the server (`.close()` stops)."""
    return MetricsServer(port=port, addr=addr)


# ---------------------------------------------------------------------------
# JSONL sink
# ---------------------------------------------------------------------------

class JsonlSink:
    """Periodic `report()` snapshots appended to a JSONL file.

    flush() writes one line now; a daemon thread writes every
    `interval_seconds` (None = manual-only).  Lines are self-contained
    JSON objects, so a crashed run's file is readable up to the last
    complete line."""

    def __init__(self, path: str, interval_seconds: Optional[float] = 30.0,
                 full_metrics: bool = False):
        self.path = path
        self.interval = interval_seconds
        self._full = full_metrics
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        if interval_seconds is not None:
            self._thread = threading.Thread(target=self._loop,
                                            name="paddle_tpu_torch-jsonl-sink",
                                            daemon=True)
            self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.flush()
            except Exception:
                pass  # a full disk must not kill the run

    def flush(self) -> str:
        rec = report()
        if not self._full:  # keep lines compact: drop the raw dumps
            rec.pop("metrics", None)
            rec.pop("spans", None)
        line = json.dumps(rec, default=str)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        return self.path

    def close(self, final_flush: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if final_flush:
            try:
                self.flush()
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
