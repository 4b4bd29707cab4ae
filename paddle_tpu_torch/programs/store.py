"""The program store: where the port's compiled programs live across
processes (counterpart of paddle_tpu/programs/store.py).

What the port compiles, and can keep, is its kernel libraries: each
``csrc/<name>.cu`` built by ``nvcc`` into ``lib<name>_<digest>.so``, named
by a hash of its source and flags (``ops/_build.py``).  Without the store
they go to ``build/kernels/`` of the checkout.  With it they go under
``<dir>/v-<fingerprint>/kernels/``, a directory that processes, workers
and machines may share: the fingerprint folds in the port's version, the
full ``utils/op_version`` snapshot, the torch version, the CUDA runtime
version and ``_build.NVCC_FLAGS``, so a library built under other
semantics or another toolchain lands in another subdirectory and is
never reused.  A hit is a library found built, a miss an ``nvcc`` build;
a library that fails to load is a warning, a miss and a rebuild, never a
crash.  CUDA graphs, the port's other compiled form, cannot be saved:
they are captured again in every process.

Knobs (environment, read at ``ensure_enabled()`` and at import):

- ``PDTPU_PROGRAM_CACHE_DIR``        base directory; unset = off
- ``PDTPU_PROGRAM_CACHE_MAX_BYTES``  size cap: past it the least recently
  written libraries that this process has not loaded are deleted

``stats()`` has the reference's keys and feeds ``observability.report()
["program_store"]``, the ``program_store_*`` metric series and the
gateway's ``/healthz``.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Optional

__all__ = ["ProgramStore", "get_program_store", "enable", "disable",
           "ensure_enabled", "cache_fingerprint", "store_stats"]

_ENV_DIR = "PDTPU_PROGRAM_CACHE_DIR"
_ENV_MAX_BYTES = "PDTPU_PROGRAM_CACHE_MAX_BYTES"


def cache_fingerprint(port_version: Optional[str] = None,
                      op_versions: Optional[dict] = None,
                      torch_version: Optional[str] = None,
                      cuda_version: Optional[str] = None,
                      nvcc_flags=None) -> str:
    """Content address of the store's namespace: a change to any axis
    gives another fingerprint, so another subdirectory, so a miss.  The
    arguments exist for tests; callers use the live values."""
    if port_version is None:
        from ..version import full_version as port_version
    if op_versions is None:
        from ..utils import op_version
        op_versions = op_version.snapshot()
    if torch_version is None or cuda_version is None:
        import torch
        torch_version = torch_version or torch.__version__
        cuda_version = cuda_version or torch.version.cuda
    if nvcc_flags is None:
        from ..ops._build import NVCC_FLAGS as nvcc_flags
    payload = json.dumps(
        {"paddle_tpu_torch": port_version, "torch": torch_version,
         "cuda": cuda_version, "nvcc_flags": list(nvcc_flags),
         "op_versions": dict(sorted(op_versions.items()))},
        sort_keys=True).encode()
    return hashlib.sha256(payload).hexdigest()[:16]


class ProgramStore:
    """The process's store (``get_program_store()``; the module's
    functions proxy to it)."""

    _DISK_TTL_S = 2.0

    def __init__(self):
        self._lock = threading.RLock()
        self._enabled = False
        self._base_dir: Optional[str] = None
        self._dir: Optional[str] = None
        self._fingerprint: Optional[str] = None
        self._hits = 0
        self._misses = 0
        self._requests = 0
        self._collector_registered = False
        # stats() feeds /healthz and every scrape: the directory scan is
        # memoised for a couple of seconds
        self._disk_cache = (0.0, 0, 0)

    # -- lifecycle -------------------------------------------------------
    def enable(self, cache_dir: Optional[str] = None) -> Optional[str]:
        """Build and load kernel libraries under ``cache_dir`` (or
        ``PDTPU_PROGRAM_CACHE_DIR``) from now on.  Returns the
        fingerprinted directory, or None when no directory is set.
        Libraries this process has loaded already stay loaded."""
        with self._lock:
            base = cache_dir or os.environ.get(_ENV_DIR)
            if not base:
                return None
            fp = cache_fingerprint()
            target = os.path.join(os.path.abspath(base), f"v-{fp}")
            if self._enabled and self._dir == target:
                return self._dir
            os.makedirs(os.path.join(target, "kernels"), exist_ok=True)
            self._base_dir = base
            self._dir = target
            self._fingerprint = fp
            self._enabled = True
            self._disk_cache = (0.0, 0, 0)
            self._register_collector()
            self.trim()
            return self._dir

    def disable(self):
        with self._lock:
            self._enabled = False
            self._dir = None
            self._fingerprint = None

    def ensure_enabled(self) -> bool:
        """Enable from the environment: a cheap no-op when
        ``PDTPU_PROGRAM_CACHE_DIR`` is unset."""
        with self._lock:
            if self._enabled:
                return True
            if not os.environ.get(_ENV_DIR):
                return False
            return self.enable() is not None

    def kernels_dir(self) -> Optional[str]:
        """Where kernel libraries are built and loaded while the store is
        on; None while it is off."""
        d = self._dir
        return None if d is None else os.path.join(d, "kernels")

    # -- accounting --------------------------------------------------------
    def note(self, kind: str):
        """Count a hit ("hits") or a miss ("misses") while enabled."""
        with self._lock:
            if not self._enabled:
                return
            self._requests += 1
            if kind == "hits":
                self._hits += 1
            else:
                self._misses += 1
                self._disk_cache = (0.0, 0, 0)

    def trim(self):
        """Delete the least recently written libraries that this process
        has not loaded, until the store holds at most
        ``PDTPU_PROGRAM_CACHE_MAX_BYTES``."""
        cap = os.environ.get(_ENV_MAX_BYTES)
        kdir = self.kernels_dir()
        if not cap or kdir is None:
            return
        from ..ops import _build
        protect = _build.loaded_paths()
        try:
            libs = [e for e in os.scandir(kdir) if e.name.endswith(".so")]
        except OSError:
            return
        libs.sort(key=lambda e: e.stat().st_mtime)
        total = sum(e.stat().st_size for e in libs)
        for e in libs:
            if total <= int(cap):
                break
            if os.path.abspath(e.path) in protect:
                continue
            try:
                size = e.stat().st_size
                os.unlink(e.path)
                total -= size
            except OSError:
                pass
        self._disk_cache = (0.0, 0, 0)

    def _register_collector(self):
        if self._collector_registered:
            return
        from ..observability.metrics import get_registry

        def _collect():
            s = self.stats()
            return [
                {"name": "program_store_enabled", "kind": "gauge",
                 "value": 1.0 if s["enabled"] else 0.0,
                 "help": "persistent program store active"},
                {"name": "program_store_hits_total", "kind": "counter",
                 "value": s["hits"],
                 "help": "kernel libraries found built in the store"},
                {"name": "program_store_misses_total", "kind": "counter",
                 "value": s["misses"],
                 "help": "kernel libraries built by nvcc into the store"},
                {"name": "program_store_entries", "kind": "gauge",
                 "value": s["entries"],
                 "help": "kernel libraries in the store"},
                {"name": "program_store_bytes", "kind": "gauge",
                 "value": s["bytes"], "help": "bytes on disk in the store"},
            ]

        get_registry().register_collector(_collect)
        self._collector_registered = True

    def stats(self) -> dict:
        """Config, hit / miss counters and disk use, under the
        reference's keys."""
        with self._lock:
            at, entries, size = self._disk_cache
            now = time.monotonic()
            kdir = self.kernels_dir()
            if kdir and (at == 0.0 or now - at > self._DISK_TTL_S):
                entries = size = 0
                try:
                    with os.scandir(kdir) as it:
                        for e in it:
                            if e.name.endswith(".so"):
                                entries += 1
                                try:
                                    size += e.stat().st_size
                                except OSError:
                                    pass
                except OSError:
                    pass
                self._disk_cache = (now, entries, size)
            elif not kdir:
                entries = size = 0
            return {"enabled": self._enabled, "dir": self._dir,
                    "fingerprint": self._fingerprint,
                    "entries": entries, "bytes": size,
                    "hits": self._hits, "misses": self._misses,
                    "requests": self._requests}


_store = ProgramStore()


def get_program_store() -> ProgramStore:
    return _store


def enable(cache_dir: Optional[str] = None) -> Optional[str]:
    return _store.enable(cache_dir)


def disable():
    _store.disable()


def ensure_enabled() -> bool:
    return _store.ensure_enabled()


def store_stats() -> dict:
    return _store.stats()
