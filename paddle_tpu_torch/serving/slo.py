"""SLO-aware admission policy objects for the serving gateway (port of
paddle_tpu/serving/slo.py, host code copied as it is).

Pure host-side policy — no device work, no engine state.  The gateway feeds these
objects live signals (its lane depths, the engine's slot occupancy, the
TTFT samples it observes) and they answer the two admission questions:

- **May this tenant send right now?**  `TokenBucket` per tenant: classic
  rate/burst limiting, consulted at submit time so a rate-limited request
  is rejected before it costs a queue entry, a prefill, or a slot.
- **Should this arrival be shed?**  `ShedPolicy.decide` — reject
  cheap-to-reject work EARLY (at submit, with a typed terminal response)
  instead of letting it time out expensively late (after queue residence
  + prefill + partial decode).  Driven by live signals: lane depth, slot
  occupancy, the recent TTFT tail, and a queue-wait estimate derived from
  the measured per-request service time.

A front door with only thread-pool/queue knobs per predictor degrades
every caller equally under overload; these objects add per-tenant
isolation and an explicit, observable shedding decision.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

__all__ = ["TokenBucket", "TenantConfig", "SLOTracker", "Signals",
           "ShedPolicy"]


class TokenBucket:
    """Classic token bucket: `rate` tokens/sec refill up to `burst`
    capacity; `try_take(cost)` is all-or-nothing.  Thread-safe (submit
    runs on caller threads).  rate=inf means unlimited."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 _clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(1.0, rate))
        self._level = self.burst
        self._clock = _clock
        self._t = _clock()
        self._lock = threading.Lock()

    def _refill(self):
        now = self._clock()
        self._level = min(self.burst,
                          self._level + (now - self._t) * self.rate)
        self._t = now

    def try_take(self, cost: float = 1.0) -> bool:
        if self.rate == float("inf"):
            return True
        with self._lock:
            self._refill()
            if self._level >= cost:
                self._level -= cost
                return True
            return False

    def level(self) -> float:
        with self._lock:
            self._refill()
            return self._level


class TenantConfig:
    """Per-tenant admission parameters.

    rate / burst    token-bucket rate limit in requests/sec (rate=inf
                    disables limiting; burst defaults to max(1, rate))
    weight          share of admission bandwidth relative to other tenants
                    with queued work (stride scheduling: a weight-2 tenant
                    is admitted twice as often as a weight-1 tenant while
                    both have requests waiting)
    max_priority    highest priority lane this tenant may use (requests
                    asking for more are clamped — priority is a tenant
                    entitlement, not a caller free-for-all)
    kv_share_group  prefix-cache share partition.  None (default) keeps
                    the tenant's cached KV blocks private to it; tenants
                    naming the same group share each other's cached
                    prefixes.  Cross-group reuse is impossible by
                    construction (serving/prefix_cache.py).
    adapter         LoRA adapter registry NAME this tenant decodes under
                    (``lora``).  None (default) serves the base
                    model.  The gateway stamps it on every request the
                    tenant submits; an adapter that is not loaded on the
                    engine fails the request typed
                    (AdapterNotFoundError) through the normal admission
                    path — never a hung consumer.
    """

    __slots__ = ("rate", "burst", "weight", "max_priority",
                 "kv_share_group", "adapter")

    def __init__(self, rate: float = float("inf"),
                 burst: Optional[float] = None, weight: float = 1.0,
                 max_priority: int = 1,
                 kv_share_group: Optional[str] = None,
                 adapter: Optional[str] = None):
        self.rate = float(rate)
        self.burst = burst
        self.weight = float(weight)
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be positive, got {weight}")
        self.max_priority = int(max_priority)
        self.kv_share_group = kv_share_group
        self.adapter = adapter

    def make_bucket(self) -> TokenBucket:
        return TokenBucket(self.rate, self.burst)


class SLOTracker:
    """Sliding-window latency tracker feeding the shed decision.

    - `note_ttft(lane, seconds)`: TTFT samples per lane, windowed by
      count AND age (stale burst samples must not shed an idle system);
      `ttft_p99(lane)` is the live tail the policy checks against the
      SLO target.
    - `note_service(seconds)`: completed-request service time (first
      token -> terminal — queue wait excluded so congestion cannot feed
      back into the estimate), EWMA-smoothed; `est_wait(depth, slots)`
      turns a lane depth into an expected queue wait — the
      cheap-to-compute signal that lets the gateway reject a request
      that would time out anyway.
    """

    def __init__(self, window: int = 256, ewma_alpha: float = 0.2,
                 max_age: float = 30.0,
                 _clock: Callable[[], float] = time.monotonic):
        self._window = int(window)
        self._alpha = float(ewma_alpha)
        # samples older than max_age drop out of the tail: without time
        # decay, a burst's over-SLO p99 would keep slo_pressure shedding
        # the low lane forever after the system went idle (the window
        # only turns over when NEW high-lane requests complete)
        self._max_age = float(max_age)
        self._clock = _clock
        self._ttft: Dict[str, deque] = {}
        self._service_ewma: Optional[float] = None
        self._lock = threading.Lock()

    def _prune(self, dq: deque):
        horizon = self._clock() - self._max_age
        while dq and dq[0][0] < horizon:
            dq.popleft()

    def note_ttft(self, lane: str, seconds: float):
        with self._lock:
            dq = self._ttft.setdefault(lane, deque(maxlen=self._window))
            self._prune(dq)
            dq.append((self._clock(), float(seconds)))

    def note_service(self, seconds: float):
        with self._lock:
            if self._service_ewma is None:
                self._service_ewma = float(seconds)
            else:
                self._service_ewma += self._alpha * (
                    float(seconds) - self._service_ewma)

    def ttft_p99(self, lane: str) -> Optional[float]:
        with self._lock:
            dq = self._ttft.get(lane)
            if dq is None:
                return None
            self._prune(dq)
            if not dq:
                return None
            xs = sorted(v for _, v in dq)
            return xs[min(len(xs) - 1, int(0.99 * len(xs)))]

    def service_ewma(self) -> Optional[float]:
        with self._lock:
            return self._service_ewma

    def est_wait(self, queue_depth: int, slots: int) -> Optional[float]:
        """Expected wait for a request arriving behind `queue_depth`
        others on a `slots`-wide engine, from the service-time EWMA.
        None until at least one request has completed."""
        s = self.service_ewma()
        if s is None or slots <= 0:
            return None
        return queue_depth * s / slots


class Signals:
    """Live admission signals, assembled by the gateway per decision."""

    __slots__ = ("lane_depth", "total_depth", "occupancy", "free_slots",
                 "max_slots", "ttft_p99_hi", "est_wait", "paused")

    def __init__(self, lane_depth=0, total_depth=0, occupancy=0,
                 free_slots=0, max_slots=0, ttft_p99_hi=None, est_wait=None,
                 paused=0):
        self.lane_depth = lane_depth      # waiting in THIS request's lane
        self.total_depth = total_depth    # waiting across all lanes
        self.occupancy = occupancy
        self.free_slots = free_slots
        self.max_slots = max_slots
        self.ttft_p99_hi = ttft_p99_hi    # seconds, high lane, or None
        self.est_wait = est_wait          # seconds, this lane, or None
        self.paused = paused              # preempted runs awaiting restore


class ShedPolicy:
    """Early-rejection rules, checked in order at submit time.

    max_lane_depth      lane depth cap; an arrival past it is shed
                        ("queue_depth") — bounded queues are the
                        backpressure primitive
    max_est_wait        shed ("est_wait") when the measured service rate
                        says the request would wait longer than this
                        before even starting; None disables
    ttft_slo            high-lane TTFT target in seconds; while the live
                        p99 is above it, LOW-priority arrivals are shed
                        ("slo_pressure") so the high lane recovers —
                        shedding the cheap lane early is what keeps the
                        expensive lane's tail inside the SLO
    shed_priority_below requests with priority >= this value are exempt
                        from est_wait/slo_pressure shedding (they may
                        still hit the hard lane-depth cap)
    """

    def __init__(self, max_lane_depth: int = 64,
                 max_est_wait: Optional[float] = None,
                 ttft_slo: Optional[float] = None,
                 shed_priority_below: int = 1):
        self.max_lane_depth = int(max_lane_depth)
        self.max_est_wait = max_est_wait
        self.ttft_slo = ttft_slo
        self.shed_priority_below = int(shed_priority_below)

    def decide(self, sig: Signals, priority: int) -> Optional[str]:
        """Shed reason, or None to admit."""
        if sig.lane_depth >= self.max_lane_depth:
            return "queue_depth"
        if priority >= self.shed_priority_below:
            return None
        if (self.max_est_wait is not None and sig.est_wait is not None
                and sig.est_wait > self.max_est_wait):
            return "est_wait"
        if (self.ttft_slo is not None and sig.ttft_p99_hi is not None
                and sig.ttft_p99_hi > self.ttft_slo):
            return "slo_pressure"
        return None
