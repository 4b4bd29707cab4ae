"""Wall-clock deadline (the ``Deadline`` of paddle_tpu/utils/retry.py).

The serving scheduler's per-request deadlines count down against it,
from submission, so queue wait burns budget like a retry loop's backoff.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

__all__ = ["Deadline"]


class Deadline:
    """A wall-clock budget anchored at creation time; ``seconds=None``
    means unbounded (never expires)."""

    __slots__ = ("seconds", "_t0", "_clock")

    def __init__(self, seconds: Optional[float] = None,
                 _clock: Callable[[], float] = time.monotonic):
        self.seconds = None if seconds is None else float(seconds)
        self._clock = _clock
        self._t0 = _clock()

    def elapsed(self) -> float:
        return self._clock() - self._t0

    def remaining(self) -> Optional[float]:
        """Seconds left, or None when unbounded.  Never negative."""
        if self.seconds is None:
            return None
        return max(0.0, self.seconds - self.elapsed())

    def expired(self) -> bool:
        return self.seconds is not None and self.elapsed() >= self.seconds

    def __repr__(self):
        if self.seconds is None:
            return "Deadline(unbounded)"
        return f"Deadline({self.seconds}s, remaining={self.remaining():.3f}s)"
