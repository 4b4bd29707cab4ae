"""AdapterRegistry (port of paddle_tpu/lora/registry.py): adapter slots
paged in and out of FIXED device stacks, the way the paged KV pool
manages blocks.

Per wrapped layer key the registry holds two stacks on the engine's
device,

    A[max_adapters + 1, in_features, rank]
    B[max_adapters + 1, rank, out_features]

and one ``scales[max_adapters + 1]``.  Row 0 is the base model: zero
factors, scale 0.  Rows 1..max_adapters hold loaded adapters; when all are
taken a new ``register()`` evicts the least recently used row that no
request pins (requests pin their adapter from admission to release), and
when every row is pinned it raises the typed ``AdapterExhaustedError``.

The stacks are allocated once.  The serving engine's programs, captured
as CUDA graphs, read them by address, so a page-in writes its row IN
PLACE (``copy_``); the reference rebinds functional arrays, which here
would leave every graph reading the old stacks.  A page-in captures
nothing and is safe while the engine loop serves: no running request
reads a row that is free or unpinned.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.errors import (InvalidArgumentError, NotFoundError,
                           ResourceExhaustedError)
from ..utils.monitor import stat_add
from .layers import DEFAULT_TARGETS
from .train import AdapterIntegrityError, read_adapter

__all__ = ["LoRAConfig", "AdapterRegistry", "AdapterNotFoundError",
           "AdapterExhaustedError", "AdapterIntegrityError"]


class AdapterNotFoundError(NotFoundError):
    """No adapter of that name is loaded in the registry (a terminal typed
    rejection: a consumer never hangs on an unknown adapter)."""
    code = "NotFound"


class AdapterExhaustedError(ResourceExhaustedError):
    """Every adapter slot is pinned by in-flight requests: typed
    backpressure, retry after traffic drains."""
    code = "ResourceExhausted"


class LoRAConfig:
    """Serve-side LoRA configuration for ``ServingEngine(lora=...)``.

    rank             the rank every loadable adapter must have
    max_adapters     loadable slots (the stacks hold max_adapters + 1 rows;
                     row 0 is the base model)
    targets          attribute names of the hooked linears
    check_base_hash  check each artifact's recorded base-weights hash
                     against the served base
    base_sha         the expected base hash (default: the engine's model's
                     at construction)
    """

    __slots__ = ("rank", "max_adapters", "targets", "check_base_hash",
                 "base_sha")

    def __init__(self, rank: int = 8, max_adapters: int = 8,
                 targets: Sequence[str] = DEFAULT_TARGETS,
                 check_base_hash: bool = True,
                 base_sha: Optional[str] = None):
        if rank <= 0:
            raise InvalidArgumentError(f"LoRA rank must be positive, "
                                       f"got {rank}")
        if max_adapters <= 0:
            raise InvalidArgumentError(
                f"max_adapters must be positive, got {max_adapters}")
        self.rank = int(rank)
        self.max_adapters = int(max_adapters)
        self.targets = tuple(targets)
        self.check_base_hash = bool(check_base_hash)
        self.base_sha = base_sha

    def spec(self) -> dict:
        """json-portable form."""
        return {"rank": self.rank, "max_adapters": self.max_adapters,
                "targets": list(self.targets),
                "check_base_hash": self.check_base_hash,
                "base_sha": self.base_sha}

    @classmethod
    def from_spec(cls, spec: dict) -> "LoRAConfig":
        return cls(rank=spec.get("rank", 8),
                   max_adapters=spec.get("max_adapters", 8),
                   targets=tuple(spec.get("targets", DEFAULT_TARGETS)),
                   check_base_hash=spec.get("check_base_hash", True),
                   base_sha=spec.get("base_sha"))


class _Slot:
    __slots__ = ("name", "refs", "tick", "file_sha")

    def __init__(self):
        self.name = None
        self.refs = 0
        self.tick = 0
        self.file_sha = None


class AdapterRegistry:
    """Thread-safe adapter slot manager over device factor stacks."""

    def __init__(self, cfg: LoRAConfig, shapes: Dict[str, Tuple[int, int]],
                 base_sha: Optional[str] = None, *,
                 device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.keys = tuple(sorted(shapes))
        self.base_sha = cfg.base_sha or base_sha
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._tick = 0
        m = cfg.max_adapters + 1
        self.stacks = {}
        for k in self.keys:
            in_f, out_f = shapes[k]
            self.stacks[k] = (
                torch.zeros((m, in_f, cfg.rank), device=self.device),
                torch.zeros((m, cfg.rank, out_f), device=self.device))
        self.scales = torch.zeros((m,), device=self.device)
        self._slots = [_Slot() for _ in range(m)]
        self._slots[0].name = "<base>"
        self._slots[0].refs = 1  # the base slot is never evictable
        self._by_name: Dict[str, int] = {}
        self._evictions = 0
        self._loads = 0
        self._publish_gauge()

    # -- lifecycle ---------------------------------------------------------
    def register(self, name: str, path: str) -> int:
        """Load an artifact into a slot under ``name``; returns the slot
        index (the adapter id).  The same artifact bytes again reuse the
        slot.  Typed errors: ``AdapterIntegrityError`` (corrupt artifact,
        wrong base), ``InvalidArgumentError`` (rank, targets or shapes),
        ``AdapterExhaustedError`` (every slot pinned)."""
        if not name or name == "<base>":
            raise InvalidArgumentError(f"invalid adapter name {name!r}")
        header, factors, file_sha = read_adapter(path)
        if header["rank"] != self.cfg.rank:
            raise InvalidArgumentError(
                f"adapter {name!r} has rank {header['rank']}, engine "
                f"was built with LoRAConfig(rank={self.cfg.rank}) — "
                "ranks are baked into the captured programs")
        if sorted(header["keys"]) != list(self.keys):
            raise InvalidArgumentError(
                f"adapter {name!r} wraps {sorted(header['keys'])} but "
                f"the engine wraps {list(self.keys)} "
                f"(LoRAConfig(targets={list(self.cfg.targets)}))")
        if (self.cfg.check_base_hash and self.base_sha is not None
                and header.get("base_sha") != self.base_sha):
            raise AdapterIntegrityError(
                f"adapter {name!r} was trained against base weights "
                f"{header.get('base_sha', '?')[:12]}..., this engine "
                f"serves base {self.base_sha[:12]}... — refusing to "
                "apply a mismatched adapter (pass LoRAConfig("
                "check_base_hash=False) only for deliberate base "
                "transforms like int8 quantization)")
        for k in self.keys:
            a, b = factors[k]
            stack_a, stack_b = self.stacks[k]
            if (a.shape != tuple(stack_a.shape[1:])
                    or b.shape != tuple(stack_b.shape[1:])):
                raise InvalidArgumentError(
                    f"adapter {name!r} factor shapes for {k} "
                    f"({a.shape}/{b.shape}) do not match the engine "
                    f"({tuple(stack_a.shape[1:])}/"
                    f"{tuple(stack_b.shape[1:])})")
        with self._lock:
            idx = self._by_name.get(name)
            if idx is not None and self._slots[idx].file_sha == file_sha:
                self._slots[idx].tick = self._bump()
                return idx
            if idx is None:
                idx = self._alloc(name)
            slot = self._slots[idx]
            slot.name = name
            slot.file_sha = file_sha
            slot.tick = self._bump()
            self._by_name[name] = idx
            with torch.no_grad():
                for k in self.keys:
                    a, b = factors[k]
                    stack_a, stack_b = self.stacks[k]
                    stack_a[idx].copy_(torch.from_numpy(a))
                    stack_b[idx].copy_(torch.from_numpy(b))
                self.scales[idx:idx + 1].copy_(torch.tensor(
                    [header["scaling"]], dtype=torch.float32))
            self._loads += 1
            stat_add("STAT_lora_adapter_loads")
            self._publish_gauge()
            return idx

    def _alloc(self, name: str) -> int:
        for i in range(1, len(self._slots)):
            if self._slots[i].name is None:
                return i
        victim, oldest = None, None
        for i in range(1, len(self._slots)):
            s = self._slots[i]
            if s.refs == 0 and (oldest is None or s.tick < oldest):
                victim, oldest = i, s.tick
        if victim is None:
            raise AdapterExhaustedError(
                f"all {self.cfg.max_adapters} adapter slots are pinned "
                f"by in-flight requests; cannot load {name!r} — retry "
                "after traffic drains or raise LoRAConfig(max_adapters=)")
        old = self._slots[victim]
        self._by_name.pop(old.name, None)
        old.file_sha = None
        self._evictions += 1
        stat_add("STAT_lora_adapter_evictions")
        return victim

    def _publish_gauge(self):
        from ..observability import gauge
        gauge("lora_adapters_loaded",
              help="adapters resident in the registry").set(
                  len(self._by_name))

    def _bump(self) -> int:
        self._tick += 1
        return self._tick

    # -- request pinning ---------------------------------------------------
    def resolve(self, name: Optional[str]) -> int:
        """Name -> adapter id without pinning; None or '' is the base."""
        if not name:
            return 0
        with self._lock:
            idx = self._by_name.get(name)
            if idx is None:
                raise AdapterNotFoundError(
                    f"adapter {name!r} is not loaded on this engine "
                    f"(loaded: {sorted(self._by_name) or 'none'}) — "
                    "register it first (engine.load_adapter)")
            return idx

    def acquire(self, name: Optional[str]) -> int:
        """resolve + pin: the slot is not evicted until ``release``."""
        if not name:
            return 0
        with self._lock:
            idx = self.resolve(name)
            self._slots[idx].refs += 1
            self._slots[idx].tick = self._bump()
            return idx

    def release(self, idx: int):
        if idx <= 0:
            return
        with self._lock:
            s = self._slots[idx]
            if s.refs > 0:
                s.refs -= 1

    # -- introspection -----------------------------------------------------
    def loaded(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._by_name)

    def file_sha(self, idx: int) -> Optional[str]:
        """sha256 of the artifact resident in slot ``idx``."""
        with self._lock:
            return self._slots[idx].file_sha

    def shas(self) -> Dict[str, str]:
        """name -> artifact sha256 of every resident adapter."""
        with self._lock:
            return {n: self._slots[i].file_sha
                    for n, i in sorted(self._by_name.items())}

    def stats(self) -> dict:
        with self._lock:
            return {
                "rank": self.cfg.rank,
                "max_adapters": self.cfg.max_adapters,
                "loaded": len(self._by_name),
                "pinned": sum(1 for s in self._slots[1:] if s.refs > 0),
                "loads": self._loads,
                "evictions": self._evictions,
                "adapters": sorted(self._by_name),
                "shas": {n: self._slots[i].file_sha
                         for n, i in sorted(self._by_name.items())},
            }
