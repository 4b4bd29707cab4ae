"""Monitor: cheap always-on global STAT counters (port of
paddle_tpu/utils/monitor.py, a shim over the observability registry).

The STAT values live in ``observability``'s typed metrics registry as
Gauges (the verbs go both ways: ``stat_sub`` is real usage), so the same
names show up in ``observability.report()``, the Prometheus endpoint and
``stats()`` here.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from ..observability.metrics import get_registry

__all__ = ["stat_add", "stat_sub", "stat_get", "stat_reset", "stats",
           "STAT_ADD", "STAT_SUB", "STAT_RESET"]

# names created through the STAT verbs: stats() reports exactly these (the
# registry also holds non-STAT metrics that must not leak into the legacy
# view)
_names_lock = threading.Lock()
_names: set = set()
# handle memo: hot call sites (serving per token burst) pay one dict hit
# instead of registry get-or-create locks per bump; invalidated by
# stat_reset (which removes the gauges)
_gauge_memo: Dict[str, object] = {}


def _gauge(name: str):
    g = _gauge_memo.get(name)
    if g is None:
        g = get_registry().gauge(
            name, help="legacy STAT counter (utils.monitor shim)")
        with _names_lock:
            _names.add(name)
            _gauge_memo[name] = g
    return g


def stat_add(name: str, value: int = 1) -> None:
    _gauge(name).inc(int(value))


def stat_sub(name: str, value: int = 1) -> None:
    stat_add(name, -int(value))


def stat_get(name: str) -> int:
    m = get_registry().get(name)
    if m is None:
        return 0
    try:
        return int(m.value())
    except Exception:
        return 0


def stat_reset(name: Optional[str] = None) -> None:
    reg = get_registry()
    with _names_lock:
        if name is None:
            targets = sorted(_names)
            _names.clear()
            _gauge_memo.clear()
        else:
            targets = [name] if name in _names else []
            _names.discard(name)
            _gauge_memo.pop(name, None)
    for n in targets:
        reg.remove(n)


def stats(prefix: Optional[str] = None) -> Dict[str, int]:
    """Snapshot of the STAT counters.  `prefix` filters by name; for
    convenience it matches either the full name or the part after the
    conventional `STAT_` prefix, so `stats(prefix="serving_")` returns the
    `STAT_serving_*` family."""
    with _names_lock:
        names = sorted(_names)
    out = {}
    for n in names:
        if prefix is not None and not (
                n.startswith(prefix)
                or (n.startswith("STAT_")
                    and n[len("STAT_"):].startswith(prefix))):
            continue
        out[n] = stat_get(n)
    return out


# macro-style aliases matching the reference's spelling
STAT_ADD = stat_add
STAT_SUB = stat_sub
STAT_RESET = stat_reset
