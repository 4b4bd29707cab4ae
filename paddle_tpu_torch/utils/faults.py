"""Fault injection for the serving engine, the training step, the LoRA
artifacts, the serving fleet, its worker processes, its weight refresh and
the checkpoint writer (the paged-KV, speculative, poisoned-logits,
slow-decode, adapter, poisoned-gradient, replica, network, publish and
kill-mid-save knobs of paddle_tpu/utils/faults.py).

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

The poisoned-logits knob's presence is read when an engine is built (a
clean engine's decode programs carry no fault branch); which slot it
hits is a program input:

  nan_logits    the decode (and verify) programs multiply the logits of
                the request with submission number N (0-based, per
                engine) by NaN: that request fails with
                ``NonFiniteLogitsError`` and frees its slot while the
                others decode on.  Env: PDTPU_FAULT_NAN_LOGITS="N".

Two host-side knobs are read live at every use:

  slow_decode   the engine sleeps ``ms`` milliseconds before every
                ``every_n``-th decode call (default every call), counted
                over the engine's life.  Env:
                PDTPU_FAULT_SLOW_DECODE="ms[:every_n]".
  adapter_corrupt the n-th LoRA adapter artifact read by this process
                (1-based, counted per process) has one byte of its raw
                bytes flipped in memory before any check, so
                ``lora.read_adapter`` raises ``AdapterIntegrityError``;
                the file is untouched and a retry reads clean bytes.
                Env: PDTPU_FAULT_ADAPTER_CORRUPT="n".

The poisoned-gradient knob's presence is read when a ``TrainStep`` makes
(on the card: captures) a step program; its window bounds are constants
of the program, and the comparison with the step number runs on the
device, on the step-number scalar the program already reads, so a
captured step with the window armed replays with no host read:

  nan_grads     the step programs multiply every gradient by NaN at
                step k, or at each step of [a, b) (step numbers count
                from 1, as the optimizer's): under ``TrainStep(guard=
                True)`` that step is skipped on the device.
                Env: PDTPU_FAULT_NAN_GRADS="k" or "a:b".

The fleet's and the weight refresh's knobs are host-side and read live
(``serving/fleet.py``, ``serving/refresh.py``):

  replica_crash the fleet's replica ``replica`` dies abruptly at its step
                ``tick`` (0-based, counted per replica): the manager
                raises before the engine steps, as a SIGKILL would leave
                it.  Env: PDTPU_FAULT_REPLICA_CRASH="replica:tick".
  replica_slow  the manager sleeps ``ms`` before every ``every_n``-th
                step of replica ``replica`` (of every replica when no
                index is given): a brownout that the step-time health
                sees.  Env: PDTPU_FAULT_REPLICA_SLOW="ms[:every_n[:replica]]".
  publish_corrupt the n-th weight publish of this process (1-based) is
                truncated and bit-flipped on disk AFTER its atomic rename;
                its manifest keeps the good sha, so the refresher's
                artifact gate must catch it.
                Env: PDTPU_FAULT_PUBLISH_CORRUPT="n".
  canary_diverge while armed, the refresher's canary comparison fails
                whatever the streams: the rollback drill.
                Env: PDTPU_FAULT_CANARY_DIVERGE="1".

The worker knobs are read live in the worker process (``serving/
worker.py``; a manager arms them there by the ``fault`` verb,
``WorkerClient.set_fault``):

  replica_wedge worker ``replica``'s drive loop blocks for good at its
                step ``tick`` or any later one (a hang, not a crash): the
                socket stays connected and only the heartbeat's age shows
                it.  Env: PDTPU_FAULT_REPLICA_WEDGE="replica:tick".
  net_delay     every ``every_n``-th frame sent by this process trickles
                out in 64-byte pieces with ``ms`` between them, so the
                peer's frame-assembly deadline trips.
                Env: PDTPU_FAULT_NET_DELAY="ms[:every_n]".
  net_drop      the n-th frame sent by this process (1-based, counted
                over every connection, once until ``reset``) is cut after
                half its bytes and its socket closed.
                Env: PDTPU_FAULT_NET_DROP="n".
  net_partition the connections of replica ``replica`` drop everything
                both ways, sockets up, for ``seconds`` from the first
                check after arming, then heal.
                Env: PDTPU_FAULT_NET_PARTITION="replica:seconds".

The checkpoint writer's knob is read live at every publish
(``distributed/checkpoint.py``, inside ``_publish_snapshot_inner``):

  kill_mid_save the checkpoint writer SIGKILLs its own process after the
                shard and manifest files of its N-th save (1-based,
                counted per process) are on disk and before the rename
                that publishes them: the previous checkpoint must stay
                ``latest`` and restorable.
                Env: PDTPU_FAULT_KILL_MID_SAVE="N".

``enable`` mirrors the value into ``os.environ`` (subprocesses inherit
it); ``get`` reads this module's registry first, then the environment.
"""
from __future__ import annotations

import os
import signal
import threading
import time
from typing import Optional, Tuple

import torch

__all__ = ["enable", "disable", "reset", "get", "kv_exhaust_cap",
           "prefix_evict_cap", "draft_diverge_every", "poison_draft_logits",
           "nan_logits_request", "poison_logits", "slow_decode_config",
           "maybe_slow_decode", "adapter_corrupt_n",
           "maybe_corrupt_adapter_read", "nan_grads_window",
           "poison_grads", "replica_crash_config", "replica_slow_config",
           "maybe_slow_replica", "publish_corrupt_n",
           "maybe_corrupt_publish", "canary_diverge",
           "replica_wedge_config", "maybe_wedge_replica",
           "net_delay_config", "net_drop_frame", "maybe_net_drop",
           "net_partition_config", "net_partition_active",
           "maybe_kill_mid_save"]

_ENV = {"kv_exhaust": "PDTPU_FAULT_KV_EXHAUST",
        "prefix_evict": "PDTPU_FAULT_PREFIX_EVICT",
        "draft_diverge": "PDTPU_FAULT_DRAFT_DIVERGE",
        "nan_logits": "PDTPU_FAULT_NAN_LOGITS",
        "slow_decode": "PDTPU_FAULT_SLOW_DECODE",
        "adapter_corrupt": "PDTPU_FAULT_ADAPTER_CORRUPT",
        "nan_grads": "PDTPU_FAULT_NAN_GRADS",
        "replica_crash": "PDTPU_FAULT_REPLICA_CRASH",
        "replica_slow": "PDTPU_FAULT_REPLICA_SLOW",
        "publish_corrupt": "PDTPU_FAULT_PUBLISH_CORRUPT",
        "canary_diverge": "PDTPU_FAULT_CANARY_DIVERGE",
        "replica_wedge": "PDTPU_FAULT_REPLICA_WEDGE",
        "net_delay": "PDTPU_FAULT_NET_DELAY",
        "net_drop": "PDTPU_FAULT_NET_DROP",
        "net_partition": "PDTPU_FAULT_NET_PARTITION",
        "kill_mid_save": "PDTPU_FAULT_KILL_MID_SAVE"}

_lock = threading.Lock()
_registry = {}   # point -> raw config string
_adapter_counter = {"n": 0}   # adapter_corrupt counts reads per process
_publish_counter = {"n": 0}   # publish_corrupt counts publishes per process
_save_counter = {"n": 0}      # kill_mid_save counts saves per process
# net_drop counts frames per process; net_partition keeps each armed
# window's start
_net_state = {"frames": 0, "drop_fired": False, "partitions": {}}


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
    """Disarm every fault and zero the per-process counters."""
    for point in _ENV:
        disable(point)
    with _lock:
        _adapter_counter["n"] = 0
        _publish_counter["n"] = 0
        _save_counter["n"] = 0
        _net_state["frames"] = 0
        _net_state["drop_fired"] = False
        _net_state["partitions"] = {}


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


def nan_logits_request() -> Optional[int]:
    """Submission number (0-based) of the request whose decode logits are
    poisoned, or None when disarmed."""
    raw = get("nan_logits")
    return None if not raw else int(raw)


def poison_logits(logits, poison_mask):
    """(S, ...) logits with every row of a set (S,) bool ``poison_mask`` mask
    NaN (inside the decode programs, only when nan_logits was armed at the
    engine's construction)."""
    return logits.masked_fill(
        poison_mask.reshape((-1,) + (1,) * (logits.dim() - 1)), float("nan"))


def slow_decode_config() -> Optional[Tuple[float, int]]:
    """(sleep ms, every_n) of slow_decode, or None when disarmed."""
    raw = get("slow_decode")
    if not raw:
        return None
    parts = raw.split(":", 1)
    every = int(parts[1]) if len(parts) == 2 else 1
    return float(parts[0]), max(1, every)


def maybe_slow_decode(call_no: int) -> float:
    """Sleep before decode call ``call_no`` (0-based) when slow_decode is
    armed and the call is on its stride; returns the seconds slept."""
    cfg = slow_decode_config()
    if cfg is None or call_no % cfg[1]:
        return 0.0
    secs = cfg[0] / 1000.0
    time.sleep(secs)
    return secs


def adapter_corrupt_n() -> Optional[int]:
    """Which adapter artifact read (1-based, per process) to poison, or
    None when disarmed."""
    raw = get("adapter_corrupt")
    return None if not raw else int(raw)


def maybe_corrupt_adapter_read(raw: bytes, path: str = "") -> bytes:
    """``raw`` (an adapter artifact's bytes, before any check) with its
    middle byte flipped when this is the armed read; counts the reads
    while armed."""
    n = adapter_corrupt_n()
    if n is None:
        return raw
    with _lock:
        _adapter_counter["n"] += 1
        cnt = _adapter_counter["n"]
    if cnt != n:
        return raw
    if not raw:
        return b"\xff"
    buf = bytearray(raw)
    buf[len(buf) // 2] ^= 0xFF
    return bytes(buf)


def nan_grads_window() -> Optional[Tuple[int, int]]:
    """[a, b) step window to poison, or None when disarmed (read when a
    step program is made)."""
    raw = get("nan_grads")
    if not raw:
        return None
    if ":" in raw:
        a, b = raw.split(":", 1)
        return int(a), int(b)
    k = int(raw)
    return k, k + 1


def poison_grads(grads, step_no, *, window: Tuple[int, int]):
    """Every gradient times NaN where the 0-dim device step number
    ``step_no`` lies in ``window`` (times 1 elsewhere): device ops only,
    no host read."""
    from ..core.selected_rows import RowSparseGrad
    a, b = window
    bad = (step_no >= a) & (step_no < b)

    def leaf(g):
        if isinstance(g, RowSparseGrad):   # poisoned through its values
            return RowSparseGrad(g.rows, leaf(g.values), g.dense_shape)
        factor = torch.where(bad, torch.full((), float("nan"), dtype=g.dtype,
                                             device=g.device),
                             torch.ones((), dtype=g.dtype, device=g.device))
        return g * factor
    return {k: leaf(g) for k, g in grads.items()}


def replica_crash_config() -> Optional[Tuple[int, int]]:
    """(replica index, tick) at which that fleet replica dies, or None
    when disarmed (read live at every replica step)."""
    raw = get("replica_crash")
    if not raw:
        return None
    replica, tick = raw.split(":", 1)
    return int(replica), int(tick)


def replica_slow_config() -> Optional[Tuple[float, int, Optional[int]]]:
    """(sleep ms, every_n, replica or None: every replica), or None when
    disarmed (read live at every replica step)."""
    raw = get("replica_slow")
    if not raw:
        return None
    parts = raw.split(":", 2)
    every = int(parts[1]) if len(parts) >= 2 else 1
    replica = int(parts[2]) if len(parts) == 3 else None
    return float(parts[0]), max(1, every), replica


def maybe_slow_replica(replica_idx: int, step_no: int) -> float:
    """Sleep before step ``step_no`` (0-based) of replica ``replica_idx``
    when replica_slow is armed, targets it (or every replica) and the step
    is on its stride; returns the seconds slept."""
    cfg = replica_slow_config()
    if cfg is None:
        return 0.0
    ms, every, target = cfg
    if (target is not None and target != replica_idx) or step_no % every:
        return 0.0
    secs = ms / 1000.0
    time.sleep(secs)
    return secs


def publish_corrupt_n() -> Optional[int]:
    """Which weight publish (1-based, per process) to corrupt, or None."""
    raw = get("publish_corrupt")
    return None if not raw else int(raw)


def maybe_corrupt_publish(path: str) -> bool:
    """Called by ``WeightPublisher`` after the atomic rename made the
    artifact at ``path`` visible: counts publishes while armed and, on the
    armed one, truncates the file to 70% and flips its middle byte in
    place.  Returns whether it fired."""
    n = publish_corrupt_n()
    if n is None:
        return False
    with _lock:
        _publish_counter["n"] += 1
        cnt = _publish_counter["n"]
    if cnt != n:
        return False
    try:
        keep = max(1, int(os.path.getsize(path) * 0.7))
        with open(path, "r+b") as f:
            f.truncate(keep)
            pos = max(0, keep // 2)
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
    except OSError:
        pass  # a vanished file is corrupt too
    return True


def canary_diverge() -> bool:
    """True while armed: the refresher's canary gate reports a mismatch
    whatever the streams."""
    return bool(get("canary_diverge"))


def replica_wedge_config() -> Optional[Tuple[int, int]]:
    """(replica index, tick) at which that worker's drive loop blocks for
    good, or None when disarmed."""
    raw = get("replica_wedge")
    if not raw:
        return None
    replica, tick = raw.split(":", 1)
    return int(replica), int(tick)


def maybe_wedge_replica(replica_idx: int, step_no: int):
    """Block for good when replica_wedge is armed for ``replica_idx`` and
    ``step_no`` reached its tick (at or after it: a knob armed over the
    wire against a worker that steps fast must not slip past).  Only a
    kill ends it."""
    cfg = replica_wedge_config()
    if cfg is None or cfg[0] != replica_idx or step_no < cfg[1]:
        return
    while True:  # pragma: no cover - ends by SIGKILL only
        time.sleep(3600)


def net_delay_config() -> Optional[Tuple[float, int]]:
    """(ms between 64-byte pieces, every_n) or None when disarmed."""
    raw = get("net_delay")
    if not raw:
        return None
    parts = raw.split(":", 1)
    every = int(parts[1]) if len(parts) == 2 else 1
    return float(parts[0]), max(1, every)


def net_drop_frame() -> Optional[int]:
    """1-based frame number (over every connection of this process) to
    cut mid-frame, or None when disarmed."""
    raw = get("net_drop")
    return None if not raw else int(raw)


def maybe_net_drop() -> bool:
    """Count one frame send; True once, on the armed frame number (the
    caller sends half the frame and closes the socket)."""
    target = net_drop_frame()
    if target is None:
        return False
    with _lock:
        _net_state["frames"] += 1
        if _net_state["drop_fired"] or _net_state["frames"] != target:
            return False
        _net_state["drop_fired"] = True
    return True


def net_partition_config() -> Optional[Tuple[int, float]]:
    """(replica index, seconds) or None when disarmed."""
    raw = get("net_partition")
    if not raw:
        return None
    replica, secs = raw.split(":", 1)
    return int(replica), float(secs)


def net_partition_active(replica_idx: Optional[int]) -> bool:
    """True while the partition window against ``replica_idx`` is open.
    Each process starts the window at its first check after arming (arm
    both sides at about the same time: the manager by ``enable``, the
    worker by its ``fault`` verb); it closes ``seconds`` later with both
    processes alive."""
    cfg = net_partition_config()
    if cfg is None or replica_idx is None or cfg[0] != int(replica_idx):
        return False
    raw = get("net_partition")
    now = time.monotonic()
    with _lock:
        start = _net_state["partitions"].setdefault(raw, now)
    return (now - start) < cfg[1]


# -- kill_mid_save -----------------------------------------------------------

def maybe_kill_mid_save():
    """Called by the checkpoint writer after a save's files are on disk and
    before the rename that publishes them: SIGKILL (not ``sys.exit``, so no
    ``finally`` or ``atexit`` softens it) at the armed save number."""
    raw = get("kill_mid_save")
    if not raw:
        return
    with _lock:
        _save_counter["n"] += 1
        n = _save_counter["n"]
    if n >= int(raw):
        os.kill(os.getpid(), signal.SIGKILL)
