"""Typed metrics registry: Counter / Gauge / Histogram with label sets
(port of paddle_tpu/observability/metrics.py, the same buckets, snapshot
shapes and text).

Typed metrics with label sets, per-metric locks (the serving engine
increments from its loop thread while callers scrape from theirs),
histogram quantiles, and collector callbacks, so counters that live
elsewhere surface in snapshots without paying a registry lock per bump.
``utils.monitor``'s STAT_* verbs are a shim over this registry.

Stdlib only: nothing here touches a tensor, so no call reads a device
value or synchronizes.
"""
from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, Iterable, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "counter", "gauge", "histogram",
           "DEFAULT_BUCKETS"]

# Prometheus-style latency buckets (seconds), wide enough for both a ~µs
# host span and a multi-second checkpoint publish.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _label_key(labelnames: Tuple[str, ...], labels: dict) -> Tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"metric expects labels {labelnames}, got {tuple(labels)}")
    return tuple(str(labels[n]) for n in labelnames)


class _Metric:
    """Shared label-child plumbing.  Each metric owns its lock (the
    registry-level sharding: two threads bumping different metrics never
    contend)."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        # RLock: samples() reads children under the lock and Histogram._read
        # re-enters it for a consistent per-child snapshot
        self._lock = threading.RLock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def labels(self, **labels):
        key = _label_key(self.labelnames, labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                self._children[key] = child
        return _BoundMetric(self, key, child)

    def _child(self, key: Tuple[str, ...] = ()):
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                self._children[key] = child
            return child

    def clear(self):
        """Drop every child (value reset)."""
        with self._lock:
            self._children.clear()

    def samples(self):
        """[(label_values_tuple, value_or_histdict)] snapshot."""
        with self._lock:
            return [(k, self._read(c)) for k, c in
                    sorted(self._children.items())]


class _BoundMetric:
    """A metric bound to one label-value tuple (result of .labels())."""

    __slots__ = ("_metric", "_key", "_child")

    def __init__(self, metric, key, child):
        self._metric = metric
        self._key = key
        self._child = child

    def __getattr__(self, name):
        fn = getattr(type(self._metric), "_" + name, None)
        if fn is None:
            raise AttributeError(name)
        metric, child = self._metric, self._child
        return lambda *a, **k: fn(metric, child, *a, **k)


class Counter(_Metric):
    """Monotone counter.  inc() with a negative amount raises — use a Gauge
    for up/down values (the STAT compat shim does)."""

    kind = "counter"

    def _new_child(self):
        return [0.0]

    def _read(self, child):
        return child[0]

    def _inc(self, child, amount=1.0):
        if amount < 0:
            raise ValueError(f"Counter {self.name} cannot decrease "
                             f"(inc {amount}); use a Gauge")
        with self._lock:
            child[0] += amount

    def inc(self, amount: float = 1.0):
        self._inc(self._child(), amount)

    def value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels) if labels else ()
        return self._read(self._child(key))


class Gauge(_Metric):
    """Up/down instantaneous value."""

    kind = "gauge"

    def _new_child(self):
        return [0.0]

    def _read(self, child):
        return child[0]

    def _inc(self, child, amount=1.0):
        with self._lock:
            child[0] += amount

    def _dec(self, child, amount=1.0):
        with self._lock:
            child[0] -= amount

    def _set(self, child, value):
        with self._lock:
            child[0] = float(value)

    def inc(self, amount: float = 1.0):
        self._inc(self._child(), amount)

    def dec(self, amount: float = 1.0):
        self._dec(self._child(), amount)

    def set(self, value: float):
        self._set(self._child(), value)

    def value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels) if labels else ()
        return self._read(self._child(key))


class _HistChild:
    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self, n_buckets):
        self.counts = [0] * (n_buckets + 1)  # +1 = +Inf overflow
        self.sum = 0.0
        self.count = 0
        self.min = None
        self.max = None


class Histogram(_Metric):
    """Fixed-bucket histogram with cumulative-bucket export and quantile
    estimation (linear interpolation inside the landing bucket)."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=None):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))

    def _new_child(self):
        return _HistChild(len(self.buckets))

    def _read(self, child):
        with self._lock:
            counts = list(child.counts)
            s, n = child.sum, child.count
            mn, mx = child.min, child.max
        return {"buckets": self.buckets, "counts": counts, "sum": s,
                "count": n, "min": mn, "max": mx}

    def _observe(self, child, value):
        value = float(value)
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            child.counts[i] += 1
            child.sum += value
            child.count += 1
            if child.min is None or value < child.min:
                child.min = value
            if child.max is None or value > child.max:
                child.max = value

    def observe(self, value: float):
        self._observe(self._child(), value)

    def time(self):
        """Context manager observing the block's wall time in seconds."""
        return _HistTimer(self)

    def snapshot(self, **labels) -> dict:
        key = _label_key(self.labelnames, labels) if labels else ()
        return self._read(self._child(key))

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Estimated q-quantile (0..1) from the bucket counts, or None when
        empty.  Linear interpolation inside the landing bucket, whose lower
        edge is the PREVIOUS bucket bound (advanced across empty buckets
        too — a stale edge would bias bimodal tails low), clamped to the
        recorded min/max."""
        snap = self.snapshot(**labels)
        n = snap["count"]
        if not n:
            return None
        if q <= 0:
            return snap["min"]
        if q >= 1:
            return snap["max"]
        rank = q * n
        cum = 0.0
        mn = snap["min"] if snap["min"] is not None else 0.0
        mx = snap["max"] if snap["max"] is not None else mn
        lower = None  # lower edge of the current bucket
        for i, c in enumerate(snap["counts"]):
            upper = self.buckets[i] if i < len(self.buckets) else mx
            if c and cum + c >= rank:
                lo = max(lower, mn) if lower is not None else mn
                hi = min(upper, mx)
                if hi < lo:
                    return lo
                frac = (rank - cum) / c
                return lo + (hi - lo) * frac
            cum += c
            lower = upper
        return mx


class _HistTimer:
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist):
        self._hist = hist

    def __enter__(self):
        import time
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time
        self._hist.observe(time.perf_counter() - self._t0)
        return False


class MetricsRegistry:
    """Name -> metric registry.  get-or-create constructors are
    type-checked: asking for an existing name with a different kind or
    label set raises instead of silently splitting the series."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: list = []

    # -- constructors --------------------------------------------------------
    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or (tuple(labelnames)
                                              != m.labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind} "
                        f"with labels {m.labelnames}")
                return m
            m = cls(name, help, tuple(labelnames), **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    # -- collectors ----------------------------------------------------------
    def register_collector(self, fn: Callable[[], Iterable[dict]]):
        """Register a zero-arg callable returning sample dicts
        ({name, kind, help?, value, labels?}) evaluated at snapshot/export
        time — how hot-path counters that must not pay a lock per bump
        surface here."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn):
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def _collected(self):
        with self._lock:
            collectors = list(self._collectors)
        out = []
        for fn in collectors:
            try:
                out.extend(fn())
            except Exception:
                continue  # a broken collector must not break the scrape
        return out

    # -- access / export -----------------------------------------------------
    def get(self, name) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def remove(self, name):
        with self._lock:
            self._metrics.pop(name, None)

    def snapshot(self) -> dict:
        """{name: {kind, help, labelnames, samples: [(labels, value)]}} +
        collector-supplied series."""
        with self._lock:
            metrics = list(self._metrics.values())
        out = {}
        for m in metrics:
            out[m.name] = {"kind": m.kind, "help": m.help,
                           "labelnames": m.labelnames,
                           "samples": m.samples()}
        for s in self._collected():
            name = s["name"]
            ent = out.setdefault(name, {"kind": s.get("kind", "gauge"),
                                        "help": s.get("help", ""),
                                        "labelnames": (), "samples": []})
            labels = tuple(str(v) for v in (s.get("labels") or ()))
            ent["samples"].append((labels, s["value"]))
        return out

    def reset(self):
        """Zero every metric's children (registrations and collector hooks
        survive; cached metric handles stay valid)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.clear()


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default_registry


def counter(name, help="", labelnames=()) -> Counter:
    return _default_registry.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()) -> Gauge:
    return _default_registry.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=None) -> Histogram:
    return _default_registry.histogram(name, help, labelnames, buckets)
