"""Request admission + slot bookkeeping for the serving engine (port of
paddle_tpu/serving/scheduler.py without its observability gauges).

The scheduler is pure host-side state: a bounded FIFO admission queue with
backpressure (submit blocks or rejects once `max_queue_depth` requests are
waiting) and a free-list of KV-cache slots.  The engine drives it: each
engine step first sweeps deadlines/cancellations, then admits as many
queued requests as there are free slots (each admission is one bucketed
prefill), then runs one decode step over every occupied slot.

Deadlines use `utils.retry.Deadline` — the same wall-clock-budget object
RetryPolicy enforces — counted from submission, so queue wait burns budget
exactly like a retry loop's backoff does.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Optional, Tuple

from ..core.errors import ResourceExhaustedError, ExecutionTimeoutError
from ..utils.monitor import stat_add
from .request import Request, Response, RequestCancelled

__all__ = ["RequestScheduler", "QueueFullError", "DeadlineExceededError"]

class QueueFullError(ResourceExhaustedError):
    """Admission queue at max_queue_depth: the request was rejected.  The
    backpressure signal — callers shed load or retry with backoff."""
    code = "ResourceExhausted"


class DeadlineExceededError(ExecutionTimeoutError):
    """The request's wall-clock deadline passed before it finished."""
    code = "ExecutionTimeout"


class RequestScheduler:
    """Admission queue + slot free-list.  Thread-safe: `submit` is called
    from caller threads, everything else from the engine loop."""

    def __init__(self, max_slots: int, max_queue_depth: int = 64):
        self.max_slots = int(max_slots)
        self.max_queue_depth = int(max_queue_depth)
        self._pending: "deque[Tuple[Request, Response]]" = deque()
        self._free = list(range(self.max_slots - 1, -1, -1))
        self._active = {}  # slot -> (Request, Response)
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)

    # -- caller side --------------------------------------------------------
    def submit(self, req: Request, resp: Response, block: bool = False,
               timeout: Optional[float] = None):
        """Enqueue.  At max_queue_depth: raises QueueFullError (default) or,
        with block=True, waits up to `timeout` for space."""
        with self._space:
            if len(self._pending) >= self.max_queue_depth and block:
                self._space.wait_for(
                    lambda: len(self._pending) < self.max_queue_depth,
                    timeout=timeout)
            if len(self._pending) >= self.max_queue_depth:
                stat_add("STAT_serving_rejects")
                raise QueueFullError(
                    f"serving queue full ({self.max_queue_depth} waiting); "
                    "request rejected")
            self._pending.append((req, resp))
            stat_add("STAT_serving_queue_depth")

    # -- engine side --------------------------------------------------------
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def occupancy(self) -> int:
        with self._lock:
            return len(self._active)

    def free_slot_count(self) -> int:
        with self._lock:
            return len(self._free)

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._pending or self._active)

    def next_admission(self, gate=None):
        """Pop the next admissible (request, response, slot), failing
        cancelled/expired queued requests in passing.  None when the queue
        is empty or no slot is free (the popped-but-unadmittable case does
        not exist: a slot is acquired before the pop commits).  `gate`
        (optional, `gate(req) -> bool`) adds a resource check on the HEAD
        request before it pops — the paged engine's block-aware admission:
        a False keeps FIFO order and leaves the head queued
        (backpressure), it does not skip past it."""
        with self._space:
            while self._pending:
                if not self._free:
                    return None
                req, resp = self._pending[0]
                disposable = (resp.cancelled
                              or (req.deadline is not None
                                  and req.deadline.expired()))
                if not disposable and gate is not None and not gate(req):
                    return None
                self._pending.popleft()
                self._space.notify()
                stat_add("STAT_serving_queue_depth", -1)
                if resp.cancelled:
                    stat_add("STAT_serving_cancelled")
                    resp._fail(RequestCancelled(
                        f"request {req.id} cancelled before prefill"))
                    continue
                if req.deadline is not None and req.deadline.expired():
                    stat_add("STAT_serving_deadline_expired")
                    resp._fail(DeadlineExceededError(
                        f"request {req.id} deadline "
                        f"({req.deadline.seconds}s) expired while queued"))
                    continue
                slot = self._free.pop()
                self._active[slot] = (req, resp)
                stat_add("STAT_serving_slots_active")
                return req, resp, slot
            return None

    def acquire(self, req: Request, resp: Response) -> Optional[int]:
        """Claim a free slot for a request that bypasses the FIFO queue
        (``ServingEngine.try_admit`` and the restore of a preempted run).
        Returns the slot, or None when every slot is occupied."""
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            self._active[slot] = (req, resp)
            stat_add("STAT_serving_slots_active")
            return slot

    def release(self, slot: int):
        """Recycle a slot (completion, cancellation, deadline, or fault).
        The KV content is left as-is: the next prefill into this slot
        overwrites the full [0, max_len) range."""
        with self._lock:
            if slot in self._active:
                del self._active[slot]
                self._free.append(slot)
                stat_add("STAT_serving_slots_active", -1)

    def drain_pending(self):
        """Remove and return every queued (request, response) — engine
        shutdown/death path; the caller fails the responses."""
        with self._space:
            drained = list(self._pending)
            if drained:
                stat_add("STAT_serving_queue_depth", -len(drained))
            self._pending = deque()
            self._space.notify_all()
            return drained

    def sweep_pending(self, drop=None) -> int:
        """Fail queued requests whose deadline expired or that were
        cancelled, without waiting for a free slot.  ``drop`` (optional) is
        a ``(pred, make_exc)`` pair: requests with ``pred(req)`` fail with
        ``make_exc(req)`` (the paged engine's can-never-admit check).
        Returns how many ``drop`` failed; ``pred`` and ``make_exc`` run
        under the scheduler's lock and must take no lock held around
        scheduler reads (the caller does its own accounting)."""
        dropped = 0
        with self._space:
            keep = deque()
            for req, resp in self._pending:
                if resp.cancelled:
                    stat_add("STAT_serving_cancelled")
                    resp._fail(RequestCancelled(
                        f"request {req.id} cancelled before prefill"))
                elif req.deadline is not None and req.deadline.expired():
                    stat_add("STAT_serving_deadline_expired")
                    resp._fail(DeadlineExceededError(
                        f"request {req.id} deadline "
                        f"({req.deadline.seconds}s) expired while queued"))
                elif drop is not None and drop[0](req):
                    resp._fail(drop[1](req))
                    dropped += 1
                else:
                    keep.append((req, resp))
                    continue
                stat_add("STAT_serving_queue_depth", -1)
                self._space.notify()
            self._pending = keep
        return dropped
