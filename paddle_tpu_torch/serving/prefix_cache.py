"""Prefix-aware KV reuse: a radix index over cached paged-KV blocks (port of
paddle_tpu/serving/prefix_cache.py).

Prompts of a service share long prefixes — system prompts, few-shot
templates, multi-turn history.  With the cache, a block of prompt KV
computed once serves every later request that starts with the same
tokens (vLLM's PagedAttention, Kwon et al. 2023; SGLang's RadixAttention,
Zheng et al. 2023):

- **Refcounted blocks** (``kv_pool.py``): a block stays resident while
  any slot references it and, once this cache owns it, at refcount 0
  until LRU eviction hands it back to the free list.
- **Radix index** (here): a trie over FULL prompt blocks.  Each node is
  one block of token ids, keyed by (share key, parent node, exact token
  bytes).  ``match`` walks the longest resident prefix; ``insert``
  registers a freshly prefilled prompt's full blocks.  A cached block is
  never written while resident (decode writes land at positions >=
  prompt_len, past every full prompt block), so a chain maps into any
  later slot.
- **Share key**: partitions the index (tenant-private by default, opt-in
  groups through ``ServingEngine.set_share_groups``).  A block cached
  under one key is invisible to every other key; an evicted block is
  scrubbed when it is served again, like any recycled block.
- **LRU eviction of refcount-0 leaves only**: referenced blocks and
  nodes with resident children are never evicted, so a resident chain
  is reachable root-first.  ``PDTPU_FAULT_PREFIX_EVICT=N`` caps the
  resident refcount-0 blocks (read live) to force eviction and
  copy-on-write churn on the CPU.
- **Copy-on-write** (engine policy, ``PagedKVPool.cow_last``): a prompt
  cached to its last full block recomputes its last token's row inside
  that block, so the engine gives the slot a private copy first.

Pure host bookkeeping on the engine loop thread.  Its counters are also
the reference's ``prefix_cache_{hits,misses,evictions,cow_copies}_total``
observability counters.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np

from ..utils import faults

__all__ = ["PrefixCache"]

_obs_handles = None


def _obs():
    """(hits, misses, evictions, cow_copies) counter handles — cached
    (registry.reset() zeroes values in place)."""
    global _obs_handles
    if _obs_handles is None:
        from ..observability import metrics as _m
        _obs_handles = (
            _m.counter("prefix_cache_hits_total",
                       "prompt blocks served from the prefix cache"),
            _m.counter("prefix_cache_misses_total",
                       "prompt blocks prefilled cold (no cached prefix)"),
            _m.counter("prefix_cache_evictions_total",
                       "cached blocks LRU-evicted back to the free list"),
            _m.counter("prefix_cache_cow_copies_total",
                       "copy-on-write private copies of shared blocks"))
    return _obs_handles


class _Node:
    """One full block of token ids resident in the cache."""

    __slots__ = ("parent", "key", "block", "children")

    def __init__(self, parent: int, key, block: int):
        self.parent = parent      # parent node id (0 = share-key root)
        self.key = key            # index key, kept for O(1) removal
        self.block = block        # pool block id holding this KV
        self.children = 0


class PrefixCache:
    """Host-side radix index over a ``PagedKVPool``'s cached blocks.  The
    engine calls ``match`` at admission (and from the admission gate,
    without counting), ``insert`` after a prefill; the pool's hooks fire
    on release and under allocation pressure."""

    def __init__(self, pool):
        self.pool = pool
        self.block_size = pool.block_size
        self._nodes: Dict[int, _Node] = {}
        self._index: Dict[Tuple[str, int, bytes], int] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._next_id = 1
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.cow_copies = 0
        pool.set_cache_hooks(reclaim=self._reclaim, unref=self._on_unref)

    # -- lookup --------------------------------------------------------------
    def match(self, share_key: str, tokens: np.ndarray,
              record: bool = False) -> List[int]:
        """Longest resident prefix of `tokens` under `share_key`, as the
        chain of pool block ids (root-first, one per FULL block).  Touches
        the chain's LRU position; with `record`, counts block hits and
        misses."""
        bs = self.block_size
        chain: List[int] = []
        parent = 0
        nb = len(tokens) // bs
        for i in range(nb):
            key = (share_key, parent,
                   np.asarray(tokens[i * bs:(i + 1) * bs],
                              np.int32).tobytes())
            nid = self._index.get(key)
            if nid is None:
                break
            self._lru.move_to_end(nid)
            chain.append(self._nodes[nid].block)
            parent = nid
        if record:
            h, m = len(chain), nb - len(chain)
            self.hits += h
            self.misses += m
            hits_c, miss_c, _, _ = _obs()
            if h:
                hits_c.inc(h)
            if m:
                miss_c.inc(m)
        return chain

    # -- insertion -----------------------------------------------------------
    def insert(self, share_key: str, tokens: np.ndarray,
               block_ids: List[int]):
        """Register a freshly prefilled prompt's FULL blocks (`block_ids`:
        the owning slot's table prefix, one id per full block).  Existing
        nodes win: a duplicate block stays slot-private and recycles
        normally on free."""
        bs = self.block_size
        parent = 0
        for i in range(min(len(tokens) // bs, len(block_ids))):
            key = (share_key, parent,
                   np.asarray(tokens[i * bs:(i + 1) * bs],
                              np.int32).tobytes())
            nid = self._index.get(key)
            if nid is None:
                nid = self._next_id
                self._next_id += 1
                node = _Node(parent, key, int(block_ids[i]))
                self._nodes[nid] = node
                self._index[key] = nid
                if parent:
                    self._nodes[parent].children += 1
                self.pool.register_cached(node.block)
            if nid in self._lru:
                self._lru.move_to_end(nid)
            else:
                self._lru[nid] = None
            parent = nid

    def note_cow(self):
        self.cow_copies += 1
        _obs()[3].inc()

    # -- eviction ------------------------------------------------------------
    def _evictable(self, node: _Node) -> bool:
        return node.children == 0 and self.pool.block_ref(node.block) == 0

    def evict(self, n: int) -> List[int]:
        """Evict up to `n` blocks, oldest evictable leaves first (a leaf's
        eviction can make its parent evictable, so chains drain
        child-before-parent).  Returns the freed block ids after handing
        them back to the pool's free list."""
        freed: List[int] = []
        while len(freed) < n:
            victim = None
            for nid in self._lru:                 # oldest first
                if self._evictable(self._nodes[nid]):
                    victim = nid
                    break
            if victim is None:
                break
            freed.append(self._remove(victim))
        if freed:
            self.evictions += len(freed)
            _obs()[2].inc(len(freed))
            self.pool.release_cached(freed)
        return freed

    def _remove(self, nid: int) -> int:
        node = self._nodes.pop(nid)
        del self._index[node.key]
        self._lru.pop(nid, None)
        if node.parent:
            parent = self._nodes.get(node.parent)
            if parent is not None:
                parent.children -= 1
        return node.block

    # -- pool hooks ----------------------------------------------------------
    def _reclaim(self, shortfall: int) -> int:
        """Allocation pressure: free at least `shortfall` blocks if
        evictable ones exist."""
        return len(self.evict(shortfall))

    def _on_unref(self, block_ids: List[int]):
        """Cached blocks just dropped to refcount 0 (still resident)."""
        self.enforce_cap()

    def enforce_cap(self):
        """Evict down to the live PDTPU_FAULT_PREFIX_EVICT cap."""
        cap = faults.prefix_evict_cap()
        if cap is None:
            return
        while True:
            resident0 = sum(1 for node in self._nodes.values()
                            if self.pool.block_ref(node.block) == 0)
            if resident0 <= cap or not self.evict(resident0 - cap):
                break

    # -- views ---------------------------------------------------------------
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> Dict:
        return {"nodes": len(self._nodes),
                "resident_blocks": self.pool.cached_blocks(),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "cow_copies": self.cow_copies,
                "hit_rate": self.hit_rate()}
