"""paddle_tpu_torch.programs — compiled programs across processes
(counterpart of paddle_tpu/programs/).

- **store** (``store.py``): where the kernel libraries that ``nvcc``
  builds live, under a content-addressed directory that processes and
  machines may share.  ``store.enable(dir)``, or the
  ``PDTPU_PROGRAM_CACHE_DIR`` knob read at import; ``store_stats()``.
- **program sets** (``program_set.py``): a serving engine's program
  family as one artifact: its manifest, a record per program and the
  kernel libraries the programs launch.  ``ServingEngine(...,
  program_set=path)`` / ``Config.enable_serving(..., program_set=path)`` /
  a worker spec's ``"program_set"`` boot from it with no ``nvcc`` run;
  the CUDA graphs are captured fresh and held against the records.  A
  mismatch or a corrupt artifact is a typed ``ProgramSetError``.

Quick use::

    export PDTPU_PROGRAM_CACHE_DIR=/var/cache/paddle_tpu   # fleet knob

    predictor.save_program_set("gpt.pdprograms")        # once, anywhere
    cfg.enable_serving(model_provider=build,
                       program_set="gpt.pdprograms")    # every replica
"""
from __future__ import annotations

from .program_set import (ProgramSetError, load_program_set,  # noqa: F401
                          read_manifest, save_program_set)
from .store import (ProgramStore, cache_fingerprint, disable,  # noqa: F401
                    enable, ensure_enabled, get_program_store, store_stats)

__all__ = [
    "ProgramStore", "enable", "disable", "ensure_enabled",
    "get_program_store", "cache_fingerprint", "store_stats",
    "ProgramSetError", "save_program_set", "load_program_set",
    "read_manifest", "bootstrap",
]


def bootstrap():
    """Import-time hook (``paddle_tpu_torch/__init__``): enable the store
    when ``PDTPU_PROGRAM_CACHE_DIR`` is set, else nothing."""
    try:
        ensure_enabled()
    except Exception:  # the store must never break import
        pass
