"""Cheap always-on STAT counters (the ``stat_add`` surface of
paddle_tpu/utils/monitor.py).  The reference backs them with its
observability registry, which the port does not carry yet: here they are
a locked dict of integers."""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["stat_add", "stats"]

_lock = threading.Lock()
_stats: Dict[str, int] = {}


def stat_add(name: str, value: int = 1) -> None:
    with _lock:
        _stats[name] = _stats.get(name, 0) + int(value)


def stats(prefix: Optional[str] = None) -> Dict[str, int]:
    """Snapshot; ``prefix`` matches the full name or the part after
    ``STAT_`` (``stats("serving_")`` returns the STAT_serving_* family)."""
    with _lock:
        items = sorted(_stats.items())
    return {n: v for n, v in items
            if prefix is None or n.startswith(prefix)
            or (n.startswith("STAT_") and n[5:].startswith(prefix))}
