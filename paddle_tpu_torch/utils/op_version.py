"""Op-version registry — saved-artifact compatibility tracking (port of
paddle_tpu/utils/op_version.py, with the reference's entries and versions,
so that a ``.pdmeta`` written by either framework checks the same way).

Reference: paddle/fluid/framework/op_version_registry.h:1 — every op whose
serialized semantics change bumps a registered version; saved programs
embed the version map and loaders check compatibility.

The registry versions the SEMANTIC surfaces that affect a serialized
artifact (an exported program + weights): op families whose
numerics/layout changed across framework revisions.  `jit.save` embeds
`snapshot()` in the artifact metadata; `jit.load` calls `check_compat` —
an artifact carrying a NEWER version than this runtime errors (it may
rely on semantics this build doesn't have); an older one loads.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional

__all__ = ["register_op_version", "get_op_version", "snapshot",
           "check_compat", "OpVersionError"]


class OpVersionError(RuntimeError):
    pass


_REGISTRY: Dict[str, int] = {}
_NOTES: Dict[str, list] = {}


def register_op_version(op: str, version: int, note: str = ""):
    """Declare `op`'s current serialized-semantics version (monotone)."""
    cur = _REGISTRY.get(op, 0)
    if version < cur:
        raise ValueError(f"{op}: version {version} < registered {cur}")
    _REGISTRY[op] = version
    if note:
        _NOTES.setdefault(op, []).append((version, note))


def get_op_version(op: str) -> Optional[int]:
    return _REGISTRY.get(op)


def snapshot() -> Dict[str, int]:
    return dict(_REGISTRY)


def check_compat(saved: Dict[str, int], strict: bool = False):
    """Validate an artifact's embedded version map against this runtime.

    - saved newer than runtime -> OpVersionError (can't honor semantics)
    - saved older -> ok (forward-compatible interchange format)
    - op unknown to this runtime -> warning (strict=True -> error)
    """
    for op, ver in (saved or {}).items():
        cur = _REGISTRY.get(op)
        if cur is None:
            msg = (f"artifact references op {op!r} (v{ver}) unknown to "
                   "this runtime")
            if strict:
                raise OpVersionError(msg)
            warnings.warn(msg)
        elif ver > cur:
            raise OpVersionError(
                f"artifact op {op!r} v{ver} is newer than this runtime's "
                f"v{cur}; upgrade the framework to load it")


# -- current semantic versions ----------------------------------------------
# r1 -> r2 changes that altered serialized numerics/layout:
register_op_version("flash_attention", 2,
                    "natural-layout head-folded kernels; in-kernel "
                    "dropout/mask (r1 was transpose-layout, fwd-only)")
register_op_version("scaled_dot_product_attention", 2,
                    "routes masks/dropout through the flash kernel")
register_op_version("fake_quantize", 1, "QAT/PTQ fake-quant family")
register_op_version("sequence_ops", 1, "padded+lengths ragged toolkit")
register_op_version("detection_ops", 1, "vision.ops box/NMS/RoI family")
register_op_version("exported_program", 1,
                    "an exported program + npz weights")
# the fused conv-net epilogue family grew pooled (bn+act+pool) and dual-BN
# (downsample-add) variants, and the fallback paths switched to recompute
# backwards
register_op_version("fused_bn_act", 2,
                    "pooled + dual-BN epilogues; recompute-backward "
                    "fallbacks (v1: bn/act/residual only)")
register_op_version("fused_ce", 2,
                    "fused_pool_linear_cross_entropy classifier tail "
                    "(v1: token-chunked tied-head CE only)")
