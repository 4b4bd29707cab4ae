"""Program sets: a serving engine's program family as one on-disk
artifact (counterpart of paddle_tpu/programs/program_set.py).

The reference stores each program as a serialized XLA executable and as
StableHLO.  The port's programs are CUDA graphs, which cannot be saved:
a process captures them again.  What it compiles, and a set carries, is
the kernel libraries the family launches (``ops/_build``), so a replica
booted from a set runs no ``nvcc``.  A set holds:

- **the manifest**: every engine axis that shapes a program (the
  reference's keys: weights' names, shapes and dtypes as ``state_sig``,
  buckets, slots, lengths, decode chunk, speculation, KV layout, dtype,
  LoRA), the port's version and ``op_version`` snapshot, and the runtime
  axes in place of the reference's jax version / backend / device count:
  the torch and CUDA runtime versions, the device's kind, name and
  compute capability, and each kernel source's digest.  A mismatch on an
  engine axis refuses the set; the runtime axes alone disqualify only the
  libraries (they are then built, as without a set);
- **one record per program**, named as the reference's family
  (``prefill_b<bucket>``, ``decode``) plus the port's all-greedy graph
  (``decode_greedy``): its static input buffers' shapes and dtypes, its
  outputs' and, when it was captured, the kernel launches one replay
  makes;
- **the libraries**, keyed by kernel, each with the digest of the source
  and flags it was built from and its bytes' sha256.

Loading checks the manifest and that no program is missing, installs the
libraries into the build directory (the store's while it is on) when the
runtime axes match, then the engine captures every program fresh and
holds its buffers and launches against the record.  Any mismatch or
corruption is a ``ProgramSetError``; the file is sha256-checked before
its body is read.  A set of the JAX package (XLA executables) is refused
without importing jax.  ``inference.ServingPredictor`` catches the error,
warns, counts ``program_set_fallback_total`` and boots fresh.
"""
from __future__ import annotations

import hashlib
import os
import pickle
from typing import Dict, Optional

__all__ = ["ProgramSetError", "save_program_set", "load_program_set",
           "read_manifest", "LoadedProgram", "engine_manifest",
           "PROGRAM_SET_SUFFIX"]

PROGRAM_SET_FORMAT = "paddle_tpu_torch/1"
PROGRAM_SET_SUFFIX = ".pdprograms"
_JAX_FORMAT = 1            # the JAX package's sets: XLA executables
_KEY_WIDTH = 2             # words of a sampling key (generation.keyed)
_RUNTIME_KEYS = ("torch_version", "cuda_version", "device_kind",
                 "device_name", "compute_capability", "kernel_digests")


class ProgramSetError(RuntimeError):
    """A program set that does not match the engine or the runtime, or
    is corrupt.  Callers may boot fresh instead; they never reuse it."""


class LoadedProgram:
    """One program of a set: its record, and once the engine captured it
    fresh and held it against the record, the engine's ``Program``
    (calling this runs it).  ``kind`` is ``"recaptured"``."""

    __slots__ = ("name", "kind", "record", "program")

    def __init__(self, name: str, record: dict):
        self.name = name
        self.kind = "recaptured"
        self.record = record
        self.program = None

    def __call__(self, *args, **kwargs):
        return self.program.run()


def program_name(key) -> str:
    """The reference's name of an engine program (``prefill_b<bucket>``
    for a bucket's prefill)."""
    return f"prefill_b{key}" if isinstance(key, int) else str(key)


def family_names(engine) -> list:
    return ([program_name(b) for b in engine.buckets]
            + ["decode", "decode_greedy"])


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _state_sig(state: Dict) -> str:
    """Hash of the state's names, shapes and dtypes, spelled as the
    reference spells them, so the same weights hash equal in both."""
    items = sorted((k, tuple(int(d) for d in v.shape), _dtype_name(v.dtype))
                   for k, v in state.items())
    return hashlib.sha256(repr(items).encode()).hexdigest()[:16]


def runtime_axes(device) -> dict:
    import torch

    from ..ops import _build
    cuda = device.type == "cuda"
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_kind": device.type,
        "device_name": torch.cuda.get_device_name(device) if cuda else None,
        "compute_capability": (list(torch.cuda.get_device_capability(
            device)) if cuda else None),
        "kernel_digests": {n: _build.digest(n) for n in _build.SOURCES},
    }


def engine_manifest(engine) -> dict:
    """Every axis that shapes the engine's programs, then the runtime's.
    Two engines with equal engine axes capture the same programs."""
    from ..utils import op_version
    from ..version import full_version
    lora = getattr(engine, "lora", None)
    out = {
        "paddle_tpu_torch_version": full_version,
        "op_versions": op_version.snapshot(),
        "model_class": type(engine.model).__name__,
        "state_sig": _state_sig(engine.model.state_dict()),
        "draft_state_sig": (_state_sig(engine.draft_model.state_dict())
                            if engine.draft_model is not None else None),
        "max_slots": engine.max_slots,
        "max_len": engine.max_len,
        "pool_len": engine._pool_len,
        "buckets": tuple(engine.buckets),
        "decode_chunk": engine.decode_chunk,
        "pad_token_id": engine.pad_token_id,
        "spec_tokens": (engine.spec_tokens
                        if engine.draft_model is not None else None),
        "kv": engine.kv,
        "block_size": engine.block_size if engine.kv == "paged" else None,
        "num_blocks": (engine.kv_pool.num_blocks
                       if engine.kv == "paged" else None),
        "prefix_cache": engine.prefix_cache is not None,
        "mesh": None,
        "dtype": (_dtype_name(engine._dtype) if engine._dtype is not None
                  else None),
        "key_width": _KEY_WIDTH,
        "lora": (None if lora is None else {
            "rank": lora.rank, "max_adapters": lora.max_adapters,
            "targets": list(lora.targets)}),
    }
    out.update(runtime_axes(engine.device))
    return out


def _mismatches(saved: dict, live: dict, runtime: bool) -> list:
    keys = [k for k in sorted(set(saved) | set(live))
            if (k in _RUNTIME_KEYS) == runtime]
    return [f"{k}: artifact={saved.get(k)!r} != engine={live.get(k)!r}"
            for k in keys if saved.get(k) != live.get(k)]


def _library_of(counter: str) -> str:
    """The kernel library a launch counter's wrapper lives in."""
    head = counter.split(".")[0]
    return {"paged_attention": "paged_attention",
            "dequant_matmul": "int8_matmul",
            "flash_fwd": "flash_attention",
            "flash_bwd": "flash_attention"}.get(head, "fused_bn_act")


def _record(prog) -> dict:
    from ..core.programs import counter_name
    outputs = None
    if prog.outputs is not None:
        outputs = [[list(t.shape), _dtype_name(t.dtype)]
                   for t in prog.outputs if hasattr(t, "shape")]
    return {
        "inputs": {k: [list(t.shape), _dtype_name(t.dtype)]
                   for k, t in prog.inputs.items()},
        "outputs": outputs,
        "captured": prog.graph is not None,
        "launches": {counter_name(o, k): int(n)
                     for (o, k), n in prog.launches},
    }


def _publish(path: str, body: bytes) -> str:
    if not path.endswith(PROGRAM_SET_SUFFIX):
        path = path + PROGRAM_SET_SUFFIX
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump({"format": PROGRAM_SET_FORMAT,
                     "sha256": hashlib.sha256(body).hexdigest(),
                     "body": body}, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)  # atomic publish
    return path


def save_program_set(engine, path: str,
                     extra_meta: Optional[dict] = None) -> str:
    """Write the engine's program family to ``path + '.pdprograms'``:
    its manifest, a record per program and the kernel libraries its
    programs launch.  A cold engine makes (on the card: captures) its
    programs first, as ``warmup()`` would.  An engine booted from a set
    is refused.  Returns the artifact's path."""
    from ..ops import _build
    if engine.program_set_info is not None:
        raise ProgramSetError(
            "this engine was booted from a program set; re-saving a "
            "loaded set is not supported: save from an engine booted "
            "fresh")
    engine._make_all()
    records = {program_name(k): _record(p)
               for k, p in engine._programs.items()}
    libs = sorted({_library_of(c) for r in records.values()
                   for c in r["launches"]})
    libraries = {}
    for name in libs:
        data = _build.library_bytes(name)
        libraries[name] = {"digest": _build.digest(name),
                           "sha256": hashlib.sha256(data).hexdigest(),
                           "bytes": data}
    body = pickle.dumps(
        {"manifest": engine_manifest(engine),
         "extra_meta": dict(extra_meta or {}),
         "programs": records, "libraries": libraries},
        protocol=pickle.HIGHEST_PROTOCOL)
    return _publish(path, body)


def _read_body(path: str) -> dict:
    if not path.endswith(PROGRAM_SET_SUFFIX) and not os.path.exists(path):
        path = path + PROGRAM_SET_SUFFIX
    try:
        with open(path, "rb") as f:
            envelope = pickle.load(f)
    except Exception as e:
        raise ProgramSetError(
            f"program set {path!r} unreadable: "
            f"{type(e).__name__}: {e}") from e
    if not isinstance(envelope, dict) or "body" not in envelope:
        raise ProgramSetError(f"program set {path!r}: not a program-set "
                              "artifact")
    fmt = envelope.get("format")
    if fmt == _JAX_FORMAT:
        raise ProgramSetError(
            f"program set {path!r} was saved by the JAX package (XLA "
            "executables and StableHLO), which this runtime cannot run: "
            "save a set from this package's engine")
    if fmt != PROGRAM_SET_FORMAT:
        raise ProgramSetError(
            f"program set {path!r}: format {fmt!r} unsupported (this "
            f"build reads {PROGRAM_SET_FORMAT!r})")
    body = envelope["body"]
    if hashlib.sha256(body).hexdigest() != envelope.get("sha256"):
        raise ProgramSetError(
            f"program set {path!r}: checksum mismatch (corrupt artifact) "
            "- refusing to load; delete it and re-save")
    try:
        return pickle.loads(body)
    except Exception as e:
        raise ProgramSetError(
            f"program set {path!r}: body undecodable: "
            f"{type(e).__name__}: {e}") from e


def read_manifest(path: str) -> dict:
    """The artifact's manifest, save metadata, program names and library
    digests, without loading anything."""
    body = _read_body(path)
    return {"manifest": body["manifest"],
            "extra_meta": body.get("extra_meta", {}),
            "programs": sorted(body["programs"]),
            "libraries": {n: lib["digest"]
                          for n, lib in body["libraries"].items()}}


def _install(libraries: dict) -> dict:
    """Install each library (sha256 and digest checked) into the build
    directory; {name: "installed" | "present"}."""
    from ..ops import _build
    out = {}
    for name, lib in sorted(libraries.items()):
        data = lib["bytes"]
        if hashlib.sha256(data).hexdigest() != lib["sha256"]:
            raise ProgramSetError(
                f"program set library {name}: bytes do not match their "
                "sha256 (corrupt artifact)")
        try:
            wrote = _build.install(name, lib["digest"], data)
        except ValueError as e:
            raise ProgramSetError(f"program set library {name}: {e}") from e
        out[name] = "installed" if wrote else "present"
    return out


def load_program_set(path: str, engine) -> Dict[str, LoadedProgram]:
    """Hold the artifact against the engine and the runtime, install its
    libraries when the runtime matches, and make the engine's programs
    (not yet captured), checking each one's input buffers against its
    record.  The engine then captures them and calls
    ``check_captures``.  Raises ``ProgramSetError`` on any mismatch or
    corruption."""
    body = _read_body(path)
    saved = body["manifest"]
    live = engine_manifest(engine)
    bad = _mismatches(saved, live, runtime=False)
    if bad:
        raise ProgramSetError(
            "program set does not match this engine (a stale set is never "
            "reused): " + "; ".join(bad[:6]))
    records = body["programs"]
    missing = [n for n in family_names(engine) if n not in records]
    if missing:
        raise ProgramSetError(
            f"program set lacks programs {missing} that this engine "
            "configuration runs")
    runtime_bad = _mismatches(saved, live, runtime=True)
    libraries = ({"skipped": "; ".join(runtime_bad[:3])} if runtime_bad
                 else _install(body["libraries"]))
    if not engine._programs:
        engine._programs = engine._make_programs()
    loaded = {}
    for key, prog in engine._programs.items():
        name = program_name(key)
        rec = records[name]
        got = {k: [list(t.shape), _dtype_name(t.dtype)]
               for k, t in prog.inputs.items()}
        if got != rec["inputs"]:
            raise ProgramSetError(
                f"program {name}: input buffers {got} != the set's "
                f"{rec['inputs']}")
        loaded[name] = LoadedProgram(name, rec)
    engine._set_libraries = libraries
    return loaded


def check_captures(loaded: Dict[str, LoadedProgram], engine):
    """After the engine made its programs: hold each one's outputs and,
    where both were captured, its launches per replay against the set's
    record."""
    for key, prog in engine._programs.items():
        lp = loaded[program_name(key)]
        live = _record(prog)
        rec = lp.record
        if live["captured"] and rec["captured"]:
            for field in ("outputs", "launches"):
                if live[field] != rec[field]:
                    raise ProgramSetError(
                        f"program {lp.name}: captured {field} "
                        f"{live[field]} != the set's {rec[field]}")
        lp.program = prog
