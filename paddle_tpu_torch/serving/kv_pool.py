"""Paged KV-cache pool: block-granular KV allocation for the serving engine
(port of paddle_tpu/serving/kv_pool.py).

One device-resident block pool per layer — ``[num_blocks, block_size,
heads, head_dim]`` — and, per slot, a table of block ids covering exactly
the rows it has written (vLLM's PagedAttention layout, Kwon et al. 2023).
Long and short requests share the pool, so the resident-slot count is
bounded by aggregate live tokens, not ``slots * max_len``.

``PagedKVPool`` is the host-side allocator: a LIFO free list, slot ->
block-table indirection, alloc/ensure/free, capacity accounting, and the
device pools built from any model speaking the ``gen_fixed_cache``
protocol.  ``table_array`` renders a table as the fixed-width int32 row
the decode step takes, with the ``num_blocks`` sentinel in unallocated
entries (reads clip into masked rows, writes drop).

Scrub-on-recycle: a prefill overwrites every block it claims end to end,
and a decode step zeroes a block the moment a slot's write position first
enters it (offset 0), before writing the row — so a re-served block holds
nothing of its previous tenant.  Exhaustion is backpressure: admission
waits for free blocks, and a run whose next step cannot be backed fails
with the typed ``KVPoolExhaustedError``.  The reference's prefix-cache
hooks and its forced-exhaustion fault cap are not ported yet.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List

import numpy as np
import torch

from ..core.errors import InvalidArgumentError, ResourceExhaustedError

__all__ = ["PagedKVPool", "KVPoolExhaustedError"]


class KVPoolExhaustedError(ResourceExhaustedError):
    """The paged KV block pool cannot hold this run: every block is in
    use.  The request is terminal — resubmit when the pool drains, or
    raise num_blocks."""
    code = "ResourceExhausted"


class PagedKVPool:
    """Host-side block allocator over a device-resident block pool.  All
    mutation happens on the engine loop thread; the lock guards the
    snapshots other threads read."""

    def __init__(self, num_blocks: int, block_size: int, pool_len: int):
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.pool_len = int(pool_len)
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
        # the most recent block ids handed out, in order: the scrub proof
        # reads which blocks were RE-served
        self.served_log: "deque[int]" = deque(maxlen=512)
        # bumped on every table mutation: the engine caches its device
        # tables against it
        self.version = 0

    # -- capacity ------------------------------------------------------------
    def capacity(self) -> int:
        return self.num_blocks

    def used_blocks(self) -> int:
        with self._lock:
            return self.num_blocks - len(self._free)

    def free_blocks(self) -> int:
        return max(0, self.capacity() - self.used_blocks())

    def blocks_for(self, rows: int) -> int:
        """Blocks needed to hold `rows` KV rows."""
        return -(-max(0, int(rows)) // self.block_size)

    # -- alloc/free ----------------------------------------------------------
    def ensure(self, slot: int, rows: int) -> bool:
        """Grow slot's table to cover `rows` rows (clamped to the per-slot
        maximum).  Returns False — nothing allocated — when the free list
        cannot supply the growth."""
        rows = min(int(rows), self.pool_len)
        with self._lock:
            table = self._tables.setdefault(slot, [])
            need = min(self.blocks_for(rows),
                       self.max_blocks_per_slot) - len(table)
            if need <= 0:
                return True
            if need > len(self._free):
                return False
            for _ in range(need):
                b = self._free.pop()
                table.append(b)
                self.served_log.append(b)
            self.version += 1
        return True

    def alloc(self, slot: int, rows: int) -> bool:
        """Fresh allocation for a slot that must not already hold blocks
        (admission).  Same return contract as ensure."""
        with self._lock:
            if self._tables.get(slot):
                raise InvalidArgumentError(
                    f"slot {slot} already holds "
                    f"{len(self._tables[slot])} blocks")
        return self.ensure(slot, rows)

    def free(self, slot: int) -> int:
        """Recycle every block the slot holds; returns how many.  Block
        content is scrubbed when the block is re-served, so free is pure
        bookkeeping."""
        with self._lock:
            table = self._tables.pop(slot, [])
            self._free.extend(table)
            if table:
                self.version += 1
        return len(table)

    # -- views ---------------------------------------------------------------
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
        return {"num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "capacity": self.capacity(),
                "used_blocks": used,
                "free_blocks": self.capacity() - used,
                "max_blocks_per_slot": self.max_blocks_per_slot}

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
