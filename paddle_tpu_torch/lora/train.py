"""Adapter artifacts (port of paddle_tpu/lora/train.py): export a trained
LoRA model's factors as one standalone npz, and read it back with
integrity checks.  The format is the reference's, byte for byte in every
array and in the header's json:

    __header__        uint8 json (sorted keys): {version, rank, alpha,
                      scaling, targets, keys, base_sha, tensor_sha}
    {key}.A           f32 [in_features, rank]     per wrapped layer
    {key}.B           f32 [rank, out_features]

``tensor_sha`` holds sha256(numpy dtype name + shape + bytes) of every
factor; the read side hashes again and raises a typed
``AdapterIntegrityError`` on any mismatch.  ``base_sha`` hashes the
frozen base weights the adapter was trained against the same way (numpy
dtype names, not torch's: ``float32``, ``int8``, ``bfloat16``), so an
artifact of either framework checks against a base of the other.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.errors import EnforceNotMet, InvalidArgumentError
from .layers import LoRALinear

__all__ = ["export_adapter", "read_adapter", "load_adapter",
           "base_weights_hash", "state_hash", "AdapterIntegrityError",
           "ADAPTER_VERSION"]

ADAPTER_VERSION = 1


class AdapterIntegrityError(EnforceNotMet, IOError):
    """Adapter artifact failed an integrity check (corrupt bytes, tensor
    sha mismatch, or base-weights-hash mismatch)."""
    code = "DataLoss"


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _host_bytes(v) -> Tuple[str, tuple, bytes]:
    """(numpy dtype name, shape, raw bytes) of a tensor or an array."""
    if isinstance(v, torch.Tensor):
        t = v.detach().contiguous().cpu()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:   # numpy has no bfloat16 of its own
            t = t.view(torch.int16)
        return name, tuple(t.shape), t.numpy().tobytes()
    a = np.ascontiguousarray(v)
    return str(a.dtype), tuple(a.shape), a.tobytes()


def _arr_sha(a) -> str:
    name, shape, raw = _host_bytes(a)
    return _sha(name.encode() + str(shape).encode() + raw)


def state_hash(state: Dict[str, object]) -> str:
    """sha256 over a {key: tensor or array} state, without the adapter
    factors and with the ``.base.`` hop of a LoRA wrapper taken out: equal
    to ``base_weights_hash`` of a model holding those values, in either
    framework."""
    items = []
    for k, v in state.items():
        if k.rsplit(".", 1)[-1] in ("lora_A", "lora_B"):
            continue
        items.append((k.replace(".base.", "."), v))
    h = hashlib.sha256()
    for k, v in sorted(items, key=lambda kv: kv[0]):
        h.update(k.encode())
        h.update(_arr_sha(v).encode())
    return h.hexdigest()


def base_weights_hash(model) -> str:
    """sha256 over the model's non-adapter parameters and buffers (its
    ``state_dict``); a LoRA-wrapped model hashes as the base it wraps."""
    return state_hash(model.state_dict())


def _wrapped(model) -> Dict[str, LoRALinear]:
    """{dotted path: LoRALinear} of a model, in module-tree order."""
    out = {}

    def walk(module, prefix=""):
        for name, child in module.named_children():
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(child, LoRALinear):
                out[path] = child
            else:
                walk(child, path)
    walk(model)
    return out


def _factors(model) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    return {k: (lyr.lora_A.detach().float().cpu().numpy(),
                lyr.lora_B.detach().float().cpu().numpy())
            for k, lyr in _wrapped(model).items()}


def export_adapter(model, path: str, alpha=None) -> str:
    """Write the adapter factors of a LoRA-wrapped ``model`` to ``path``
    (an atomic publish) and return the file's sha256."""
    wrapped = _wrapped(model)
    if not wrapped:
        raise InvalidArgumentError(
            "export_adapter: model has no LoRALinear layers — call "
            "lora.apply_lora(model, ...) and train first")
    factors = _factors(model)
    ranks = {a.shape[1] for a, _ in factors.values()}
    if len(ranks) != 1:
        raise InvalidArgumentError(
            f"export_adapter: mixed ranks {sorted(ranks)} in one model")
    first = next(m for m in model.modules() if isinstance(m, LoRALinear))
    header = {
        "version": ADAPTER_VERSION,
        "rank": int(first.rank),
        "alpha": float(first.alpha if alpha is None else alpha),
        "scaling": float(first.scaling),
        "targets": sorted({k.rsplit(".", 1)[-1] for k in factors}),
        "keys": sorted(factors),
        "base_sha": base_weights_hash(model),
        "tensor_sha": {},
    }
    payload = {}
    for k in sorted(factors):
        a, b = factors[k]
        payload[f"{k}.A"] = a
        payload[f"{k}.B"] = b
        header["tensor_sha"][f"{k}.A"] = _arr_sha(a)
        header["tensor_sha"][f"{k}.B"] = _arr_sha(b)
    payload["__header__"] = np.frombuffer(
        json.dumps(header, sort_keys=True).encode(), dtype=np.uint8).copy()
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    with open(path, "rb") as f:
        return _sha(f.read())


def load_adapter(model, path: str):
    """Train-side restore: a verified artifact's factors copied in place
    into the matching ``LoRALinear`` layers of a wrapped ``model``.  The
    wrapped key set must equal the artifact's and the ranks and shapes
    must match (typed ``InvalidArgumentError``s, never a partial load).
    Returns the artifact header."""
    header, factors, _ = read_adapter(path)
    wrapped = _wrapped(model)
    if not wrapped:
        raise InvalidArgumentError(
            "load_adapter: model has no LoRALinear layers — call "
            "lora.apply_lora(model, rank=...) first")
    if sorted(wrapped) != header["keys"]:
        raise InvalidArgumentError(
            f"load_adapter: model wraps {sorted(wrapped)} but artifact "
            f"{path!r} carries {header['keys']}")
    for k, lyr in wrapped.items():
        a, b = factors[k]
        if a.shape[1] != lyr.rank:
            raise InvalidArgumentError(
                f"load_adapter: artifact rank {a.shape[1]} != model rank "
                f"{lyr.rank} at {k}")
        if (a.shape[0], b.shape[1]) != (lyr.in_features, lyr.out_features):
            raise InvalidArgumentError(
                f"load_adapter: factor shapes {a.shape}x{b.shape} do not "
                f"fit {k} ({lyr.in_features}->{lyr.out_features})")
    with torch.no_grad():
        for k, lyr in wrapped.items():
            a, b = factors[k]
            lyr.lora_A.copy_(torch.from_numpy(a))
            lyr.lora_B.copy_(torch.from_numpy(b))
    return header


def read_adapter(path: str):
    """Load and verify an adapter artifact: ``(header, factors,
    file_sha)`` with ``factors = {key: (A, B)}`` f32 numpy arrays.  The
    raw bytes pass the ``adapter_corrupt`` fault point before any check,
    so an injected corruption is caught where a real one would be."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise AdapterIntegrityError(
            f"adapter artifact {path!r} unreadable: {e}") from e
    from ..utils import faults
    raw = faults.maybe_corrupt_adapter_read(raw, path)
    file_sha = _sha(raw)
    try:
        z = np.load(io.BytesIO(raw), allow_pickle=False)
        header = json.loads(bytes(z["__header__"].tobytes()).decode())
        factors = {k: (np.asarray(z[f"{k}.A"], np.float32),
                       np.asarray(z[f"{k}.B"], np.float32))
                   for k in header["keys"]}
    except Exception as e:
        raise AdapterIntegrityError(
            f"adapter artifact {path!r} corrupt or malformed: "
            f"{type(e).__name__}: {e}") from e
    if header.get("version") != ADAPTER_VERSION:
        raise AdapterIntegrityError(
            f"adapter artifact {path!r}: version "
            f"{header.get('version')!r} != supported {ADAPTER_VERSION}")
    for k in header["keys"]:
        for suffix, arr in zip((f"{k}.A", f"{k}.B"), factors[k]):
            want = header["tensor_sha"].get(suffix)
            got = _arr_sha(arr)
            if want != got:
                raise AdapterIntegrityError(
                    f"adapter artifact {path!r}: tensor {suffix} sha256 "
                    f"mismatch (recorded {want}, recomputed {got}) — "
                    "refusing to load garbage factors; re-ship the "
                    "artifact")
    return header, factors, file_sha
