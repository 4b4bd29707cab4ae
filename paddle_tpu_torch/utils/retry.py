"""Retry policy and wall-clock deadline (paddle_tpu/utils/retry.py).

``RetryPolicy`` owns one backoff schedule (exponential, full jitter, an
optional wall deadline, retry / give-up filters) so every host service
that talks to something flaky degrades the same way; the fleet's
``RestartBackoff`` inverts its schedule into restart times.  The serving
scheduler's per-request deadlines count down against ``Deadline``, from
submission, so queue wait burns budget like a retry loop's backoff.
"""
from __future__ import annotations

import functools
import random
import time
from typing import Callable, Iterable, Optional, Tuple, Type

__all__ = ["RetryPolicy", "retry_call", "RetriesExhausted", "Deadline"]


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


class RetriesExhausted(Exception):
    """All attempts failed.  `.last` carries the final attempt's exception
    (also chained as __cause__); `.attempts` the number made."""

    def __init__(self, msg, last: BaseException, attempts: int):
        super().__init__(msg)
        self.last = last
        self.attempts = attempts


class RetryPolicy:
    """Exponential backoff with full jitter and an optional wall deadline.

    retries:     additional attempts after the first (retries=3 -> up to 4
                 calls)
    base_delay:  sleep before the first retry; doubles each retry
    max_delay:   cap on a single sleep
    jitter:      fraction of the delay drawn uniformly at random and added
                 (0.5 -> sleep in [d, 1.5d]); decorrelates thundering herds
    deadline:    total wall-clock budget in seconds across all attempts;
                 exceeded -> RetriesExhausted even with retries left
    retry_on:    exception classes that trigger a retry
    giveup_on:   exception classes re-raised immediately even if they match
                 retry_on (checked first)
    """

    def __init__(self, retries: int = 3, base_delay: float = 0.1,
                 max_delay: float = 5.0, jitter: float = 0.5,
                 deadline: Optional[float] = None,
                 retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                 giveup_on: Tuple[Type[BaseException], ...] = (),
                 on_retry: Optional[Callable] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.retries = max(0, int(retries))
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.deadline = deadline
        self.retry_on = tuple(retry_on)
        self.giveup_on = tuple(giveup_on)
        self.on_retry = on_retry  # on_retry(attempt_no, exc, next_delay)
        self._sleep = sleep

    def delays(self) -> Iterable[float]:
        """The backoff schedule (pre-jitter), one entry per retry."""
        d = self.base_delay
        for _ in range(self.retries):
            yield min(d, self.max_delay)
            d *= 2.0

    def call(self, fn: Callable, *args, **kwargs):
        """Run fn until it succeeds, a non-retryable error escapes, the
        attempt budget empties, or the deadline passes."""
        dl = Deadline(self.deadline)
        attempt = 0
        delays = iter(self.delays())
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except self.giveup_on:
                raise
            except self.retry_on as e:
                try:
                    delay = next(delays)
                except StopIteration:
                    raise RetriesExhausted(
                        f"{getattr(fn, '__name__', fn)!s} failed after "
                        f"{attempt} attempts: {type(e).__name__}: {e}",
                        e, attempt) from e
                if self.jitter:
                    delay += random.uniform(0.0, self.jitter * delay)
                remaining = dl.remaining()
                if remaining is not None and (dl.expired()
                                              or delay > remaining):
                    raise RetriesExhausted(
                        f"{getattr(fn, '__name__', fn)!s} exceeded the "
                        f"{self.deadline}s retry deadline after {attempt} "
                        f"attempts: {type(e).__name__}: {e}", e, attempt) from e
                if self.on_retry is not None:
                    self.on_retry(attempt, e, delay)
                self._sleep(delay)

    def wraps(self, fn: Callable) -> Callable:
        """Decorator form."""
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return self.call(fn, *args, **kwargs)
        return wrapper


def retry_call(fn: Callable, *args, retries: int = 3, base_delay: float = 0.1,
               max_delay: float = 5.0, jitter: float = 0.5,
               deadline: Optional[float] = None,
               retry_on: Tuple[Type[BaseException], ...] = (Exception,),
               giveup_on: Tuple[Type[BaseException], ...] = (),
               on_retry: Optional[Callable] = None, **kwargs):
    """One-shot convenience over RetryPolicy.call."""
    return RetryPolicy(retries=retries, base_delay=base_delay,
                       max_delay=max_delay, jitter=jitter, deadline=deadline,
                       retry_on=retry_on, giveup_on=giveup_on,
                       on_retry=on_retry).call(fn, *args, **kwargs)
