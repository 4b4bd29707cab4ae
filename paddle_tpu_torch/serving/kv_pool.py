"""Paged KV-cache pool: block-granular KV allocation for the serving engine
(port of paddle_tpu/serving/kv_pool.py).

One device-resident block pool per layer — ``[num_blocks, block_size,
heads, head_dim]`` — and, per slot, a table of block ids covering exactly
the rows it has written (vLLM's PagedAttention layout, Kwon et al. 2023).
Long and short requests share the pool, so the resident-slot count is
bounded by aggregate live tokens, not ``slots * max_len``.

``PagedKVPool`` is the host-side allocator: a LIFO free list, slot ->
block-table indirection, per-block reference counts, alloc/ensure/free,
capacity accounting under the live ``PDTPU_FAULT_KV_EXHAUST`` cap, and the
device pools built from any model speaking the ``gen_fixed_cache``
protocol.  ``table_array`` renders a table as the fixed-width int32 row
the programs take, with the ``num_blocks`` sentinel in unallocated
entries (reads clip into masked rows, writes drop).

Sharing (the prefix cache, ``serving/prefix_cache.py``): ``adopt`` maps
cached blocks into an empty slot's table and bumps their counts,
``cow_last`` swaps a table's shared last block for a private copy, and a
block the cache owns (``register_cached``) stays resident at count 0,
evictable, until the cache hands it back (``release_cached``).  When the
free list runs short, ``ensure`` asks the cache to evict (the reclaim
hook).  Cached refcount-0 blocks count as free for admission.

Scrub-on-recycle: a prefill overwrites every block it claims end to end
(the cached-suffix prefill: every block its window enters), and a decode
step zeroes a block the moment a slot's write position first enters it
(offset 0), before writing the row — so a re-served block holds nothing
of its previous tenant.  Exhaustion is backpressure: admission waits for
free blocks, a run whose next step cannot be backed is preempted and
parked by the engine, and ``KVPoolExhaustedError`` is the terminal state
of a run that can no longer fit at all.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List

import numpy as np
import torch

from ..core.errors import InvalidArgumentError, ResourceExhaustedError
from ..utils import faults

__all__ = ["PagedKVPool", "KVPoolExhaustedError"]


class KVPoolExhaustedError(ResourceExhaustedError):
    """The paged KV block pool cannot hold this run: every block is in use
    (or the pool is capped by PDTPU_FAULT_KV_EXHAUST) and no lower-priority
    run can be preempted to make room.  The request is terminal — resubmit
    when the pool drains, or raise num_blocks."""
    code = "ResourceExhausted"


_obs_handles: Dict[str, tuple] = {}


def _obs(pool: str):
    """(blocks_used_gauge, blocks_free_gauge) bound to this pool's
    ``pool=`` label — cached handles (registry.reset() zeroes values in
    place).  The label keeps two allocators in one process from
    overwriting each other."""
    handles = _obs_handles.get(pool)
    if handles is None:
        from ..observability import metrics as _m
        used = _m.gauge("serving_kv_blocks_used",
                        "paged KV pool blocks currently allocated",
                        labelnames=("pool",))
        free = _m.gauge("serving_kv_blocks_free",
                        "paged KV pool blocks free (after any fault cap)",
                        labelnames=("pool",))
        handles = _obs_handles[pool] = (used.labels(pool=pool),
                                        free.labels(pool=pool))
    return handles


class PagedKVPool:
    """Host-side block allocator over a device-resident block pool.  All
    mutation happens on the engine loop thread; the lock guards the
    snapshots other threads read."""

    def __init__(self, num_blocks: int, block_size: int, pool_len: int):
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.pool_len = int(pool_len)
        # the gauges' pool= label (one allocator per engine: the draft's
        # KV pages with the target's tables)
        self.name = "target"
        if self.block_size < 1:
            raise InvalidArgumentError(
                f"block_size must be >= 1, got {self.block_size}")
        if self.num_blocks < 1:
            raise InvalidArgumentError(
                f"num_blocks must be >= 1, got {self.num_blocks}")
        # max blocks one slot can ever hold (its table's static width)
        self.max_blocks_per_slot = -(-self.pool_len // self.block_size)
        self._lock = threading.Lock()
        # LIFO free-list: the most recently freed block is re-served first
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._tables: Dict[int, List[int]] = {}
        # block id -> number of slot tables referencing it; `free` recycles
        # a block only when its last reference drops
        self._refs: Dict[int, int] = {}
        self._live = 0          # distinct blocks with ref > 0
        # blocks the prefix cache owns: at ref 0 they stay resident
        # (evictable, not free-listed) until the cache evicts them
        self._cached: set = set()
        # prefix-cache hooks: reclaim(n) asks the cache to evict >= n
        # blocks to the free list; unref(ids) says these cached blocks
        # just dropped to ref 0
        self._on_reclaim = None
        self._on_cached_unref = None
        # the most recent block ids handed out, in order: the scrub proof
        # reads which blocks were RE-served
        self.served_log: "deque[int]" = deque(maxlen=512)
        # bumped on every table mutation: the engine caches its device
        # tables against it
        self.version = 0

    def set_cache_hooks(self, reclaim, unref):
        """Attach a prefix cache (serving/prefix_cache.py)."""
        self._on_reclaim = reclaim
        self._on_cached_unref = unref

    # -- capacity ------------------------------------------------------------
    def capacity(self) -> int:
        """Usable blocks now: num_blocks, unless PDTPU_FAULT_KV_EXHAUST
        caps it lower (read live)."""
        cap = faults.kv_exhaust_cap()
        return self.num_blocks if cap is None else min(self.num_blocks, cap)

    def used_blocks(self) -> int:
        """Distinct blocks with at least one table reference (cached
        refcount-0 blocks are evictable, so they count as free)."""
        with self._lock:
            return self._live

    def free_blocks(self) -> int:
        return max(0, self.capacity() - self.used_blocks())

    def block_ref(self, block: int) -> int:
        """Live reference count of one block (0 = unreferenced)."""
        with self._lock:
            return self._refs.get(block, 0)

    def cached_blocks(self) -> int:
        """Blocks the prefix cache owns (any refcount)."""
        with self._lock:
            return len(self._cached)

    def blocks_for(self, rows: int) -> int:
        """Blocks needed to hold `rows` KV rows."""
        return -(-max(0, int(rows)) // self.block_size)

    def can_ever_fit(self, rows: int) -> bool:
        """Whether a run holding `rows` rows could occupy the pool alone
        under the live capacity: False means it can never resume."""
        return self.blocks_for(rows) <= min(self.capacity(),
                                            self.max_blocks_per_slot)

    # -- alloc/free ----------------------------------------------------------
    def ensure(self, slot: int, rows: int) -> bool:
        """Grow slot's table to cover `rows` rows (clamped to the per-slot
        maximum).  Returns False — nothing allocated — when the capacity
        cannot supply the growth.  A short free list first asks the prefix
        cache, if any, to evict refcount-0 blocks (LRU order)."""
        rows = min(int(rows), self.pool_len)
        with self._lock:
            table = self._tables.setdefault(slot, [])
            need = min(self.blocks_for(rows),
                       self.max_blocks_per_slot) - len(table)
            if need <= 0:
                return True
            if self._live + need > self.capacity():
                return False
        if need > len(self._free):
            self._reclaim(need - len(self._free))
        with self._lock:
            if need > len(self._free):
                return False
            for _ in range(need):
                b = self._free.pop()
                table.append(b)
                self._refs[b] = 1
                self._live += 1
                self.served_log.append(b)
            self.version += 1
        self._note_gauges()
        return True

    def _reclaim(self, shortfall: int):
        """Ask the prefix cache to evict at least `shortfall` blocks
        (outside the lock: the cache calls back into release_cached)."""
        if self._on_reclaim is not None and shortfall > 0:
            self._on_reclaim(shortfall)

    def alloc(self, slot: int, rows: int) -> bool:
        """Fresh allocation for a slot that must not already hold blocks
        (admission).  Same return contract as ensure."""
        with self._lock:
            if self._tables.get(slot):
                raise InvalidArgumentError(
                    f"slot {slot} already holds "
                    f"{len(self._tables[slot])} blocks")
        return self.ensure(slot, rows)

    # -- prefix-cache sharing ------------------------------------------------
    def adopt(self, slot: int, block_ids: List[int]) -> bool:
        """Map resident (cached) blocks into an empty slot's table, bumping
        their counts (a warm admission).  Returns False, mapping nothing,
        when reviving the refcount-0 ones would pass the live capacity."""
        with self._lock:
            if self._tables.get(slot):
                raise InvalidArgumentError(
                    f"slot {slot} already holds "
                    f"{len(self._tables[slot])} blocks")
            revive = sum(1 for b in block_ids if self._refs.get(b, 0) == 0)
            if self._live + revive > self.capacity():
                return False
            table = self._tables[slot] = []
            for b in block_ids:
                r = self._refs.get(b, 0)
                if r == 0:
                    self._live += 1
                self._refs[b] = r + 1
                table.append(b)
            if table:
                self.version += 1
        if block_ids:
            self._note_gauges()
        return True

    def cow_last(self, slot: int):
        """Copy-on-write: replace the LAST block of the slot's table (a
        shared cached block about to be written) with a fresh private one.
        Returns (src, dst) — the caller copies the device content src ->
        dst before any program writes through the table — or None when no
        block is available.  src's content stays intact until a later
        allocation re-serves it."""
        with self._lock:
            table = self._tables.get(slot)
            if not table:
                raise InvalidArgumentError(f"slot {slot} holds no blocks")
            src = table[-1]
            short = self.capacity() < self._live + 1
        if short:
            return None
        if not self._free:
            self._reclaim(1)
        with self._lock:
            if not self._free:
                return None
            dst = self._free.pop()
            self._refs[dst] = 1
            self._live += 1
            self.served_log.append(dst)
            unref = []
            r = self._refs.get(src, 1) - 1
            if r > 0:
                self._refs[src] = r
            else:
                self._refs.pop(src, None)
                self._live -= 1
                if src in self._cached:
                    unref.append(src)
                else:
                    self._free.append(src)
            table[-1] = dst
            self.version += 1
        if unref and self._on_cached_unref is not None:
            self._on_cached_unref(unref)
        self._note_gauges()
        return src, dst

    def register_cached(self, block: int):
        """The prefix cache takes ownership of a block: at ref 0 it stays
        resident (evictable) instead of returning to the free list."""
        with self._lock:
            self._cached.add(block)

    def release_cached(self, block_ids: List[int]):
        """The prefix cache evicted these blocks: recycle the unreferenced
        ones to the free list (LIFO: re-served first)."""
        with self._lock:
            for b in block_ids:
                self._cached.discard(b)
                if self._refs.get(b, 0) == 0:
                    self._free.append(b)
        self._note_gauges()

    def free(self, slot: int) -> int:
        """Drop the slot's reference on every block it holds; returns how
        many table entries were released.  A block whose last reference
        drops returns to the free list — unless the prefix cache owns it:
        then it stays resident (evictable) and the cache is told.  Block
        content is scrubbed when the block is re-served, so free is pure
        bookkeeping."""
        with self._lock:
            table = self._tables.pop(slot, [])
            unref = []
            for b in table:
                r = self._refs.get(b, 1) - 1
                if r > 0:
                    self._refs[b] = r
                    continue
                self._refs.pop(b, None)
                self._live -= 1
                if b in self._cached:
                    unref.append(b)
                else:
                    self._free.append(b)
            if table:
                self.version += 1
        if unref and self._on_cached_unref is not None:
            self._on_cached_unref(unref)
        if table:
            self._note_gauges()
        return len(table)

    # -- views ---------------------------------------------------------------
    def block_ids(self, slot: int) -> List[int]:
        with self._lock:
            return list(self._tables.get(slot, ()))

    def table_array(self, slot: int) -> np.ndarray:
        """(max_blocks_per_slot,) int32 table; unallocated tail entries
        hold the `num_blocks` sentinel."""
        out = self.sentinel_table()
        with self._lock:
            t = self._tables.get(slot, ())
            out[:len(t)] = t
        return out

    def sentinel_table(self) -> np.ndarray:
        """An all-sentinel table: every write through it is dropped."""
        return np.full((self.max_blocks_per_slot,), self.num_blocks,
                       np.int32)

    def stats(self) -> Dict:
        used = self.used_blocks()
        with self._lock:
            shared = sum(1 for r in self._refs.values() if r > 1)
            cached = len(self._cached)
        return {"pool": self.name,
                "num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "capacity": self.capacity(),
                "used_blocks": used,
                "free_blocks": self.free_blocks(),
                "shared_blocks": shared,
                "cached_blocks": cached,
                "max_blocks_per_slot": self.max_blocks_per_slot}

    def _note_gauges(self):
        used_g, free_g = _obs(self.name)
        used_g.set(self.used_blocks())
        free_g.set(self.free_blocks())

    # -- device pool construction -------------------------------------------
    def build_pools(self, model, dtype=None, trash: int = 0):
        """The device-resident block pool: for each model KV leaf of shape
        (B, T, *rest) from ``model.gen_fixed_cache(1, 1, dtype)``, one zero
        pool of shape (num_blocks + trash, block_size, *rest) on the
        leaf's device.  The ``trash`` blocks past num_blocks are never
        handed out: static-shape writes drop into them
        (``ops.paged_attention.SlotRowWrites``)."""
        pools = []
        for k, v in model.gen_fixed_cache(1, 1, dtype):
            pools.append(tuple(
                torch.zeros((self.num_blocks + int(trash), self.block_size)
                            + tuple(t.shape[2:]), dtype=t.dtype,
                            device=t.device)
                for t in (k, v)))
        return pools
