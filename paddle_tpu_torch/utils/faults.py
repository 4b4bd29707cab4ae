"""Fault injection for the serving engine (the two paged-KV knobs and
the speculative draft's of paddle_tpu/utils/faults.py).

A knob is armed by ``enable(point, value)`` or by its environment
variable.  The KV knobs are read live at every use (host-side bookkeeping
only; no program ever sees them), so arming or disarming takes effect at
the allocator's or the cache's next call on a running engine:

  kv_exhaust    the paged KV block allocator pretends the pool holds only
                N blocks (``PagedKVPool.capacity``), forcing admission
                backpressure, mid-decode preemption of the newest
                low-priority run and the typed ``KVPoolExhaustedError``
                terminal state on the CPU without a big pool.
                Env: PDTPU_FAULT_KV_EXHAUST="N".
  prefix_evict  the prefix cache keeps at most N resident refcount-0
                cached blocks (``PrefixCache.enforce_cap``), forcing LRU
                eviction and copy-on-write churn; N=0 keeps nothing once
                its last reference drops.  Env: PDTPU_FAULT_PREFIX_EVICT="N".

The draft knob's presence is read when a speculative engine is built (a
clean engine's verify programs carry no fault branch); which tick it
hits is a program input the engine fills per tick:

  draft_diverge the verify programs negate the DRAFT model's logits every
                N-th speculative tick (0-based: ticks 0, N, 2N, ...): the
                draft proposes its least likely token, which the target
                all but always rejects.  A finite corruption: streams stay
                right, the accept rate collapses.
                Env: PDTPU_FAULT_DRAFT_DIVERGE="N".

``enable`` mirrors the value into ``os.environ`` (subprocesses inherit
it); ``get`` reads this module's registry first, then the environment.
"""
from __future__ import annotations

import os
import threading
from typing import Optional

import torch

__all__ = ["enable", "disable", "reset", "get", "kv_exhaust_cap",
           "prefix_evict_cap", "draft_diverge_every", "poison_draft_logits"]

_ENV = {"kv_exhaust": "PDTPU_FAULT_KV_EXHAUST",
        "prefix_evict": "PDTPU_FAULT_PREFIX_EVICT",
        "draft_diverge": "PDTPU_FAULT_DRAFT_DIVERGE"}

_lock = threading.Lock()
_registry = {}   # point -> raw config string


def enable(point: str, value="1"):
    """Arm a fault (and mirror it into the environment)."""
    if point not in _ENV:
        raise ValueError(f"unknown fault point {point!r}; "
                         f"known: {sorted(_ENV)}")
    with _lock:
        _registry[point] = str(value)
        os.environ[_ENV[point]] = str(value)


def disable(point: str):
    with _lock:
        _registry.pop(point, None)
        os.environ.pop(_ENV[point], None)


def reset():
    """Disarm every fault."""
    for point in _ENV:
        disable(point)


def get(point: str) -> Optional[str]:
    """Live config string of a point, or None when disarmed."""
    with _lock:
        v = _registry.get(point)
    return v if v is not None else os.environ.get(_ENV[point])


def _cap(point: str) -> Optional[int]:
    raw = get(point)
    return None if not raw else max(0, int(raw))


def kv_exhaust_cap() -> Optional[int]:
    """Forced block-pool capacity, or None when disarmed."""
    return _cap("kv_exhaust")


def prefix_evict_cap() -> Optional[int]:
    """Forced cap on resident refcount-0 prefix-cache blocks, or None."""
    return _cap("prefix_evict")


def draft_diverge_every() -> Optional[int]:
    """Tick stride N of the draft_diverge fault, or None when disarmed."""
    raw = get("draft_diverge")
    return None if not raw else max(1, int(raw))


def poison_draft_logits(logits, diverge):
    """(S, V) draft logits negated where the (1,) bool tensor ``diverge``
    is set (inside the verify programs, only when the fault is armed)."""
    return torch.where(diverge, -logits, logits)
