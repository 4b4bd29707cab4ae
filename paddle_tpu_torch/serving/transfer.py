"""Replica-portable run transfer codec (port of
paddle_tpu/serving/transfer.py).

A `PreemptedRun` (``engine.preempt_slot``: per-layer KV rows, key, write
position, produced count, last token) encodes to a blob of numpy arrays
and scalars, and from there to bytes (npz), which any
configuration-compatible engine decodes back into a `PreemptedRun` for
its own ``restore_run``: the stream resumes as a run that never moved.

- **The wire form is the reference's.**  The npz keys (``key``,
  ``prompt``, ``k<i>`` / ``v<i>``, ``dk<i>`` / ``dv<i>``, ``header``), the
  ``(pos, heads, head_dim)`` rows per layer, numpy dtype names in the
  manifest (``"float32"``, not ``"torch.float32"``) and the codec version
  are the reference's, so a run encoded by either framework decodes in
  the other.  The port's rows are CPU tensors: they cross as numpy
  arrays (bfloat16 as ml_dtypes' ``bfloat16``, the reference's type, when
  ml_dtypes is installed) and decode back into CPU tensors.
- **The rows are layout-agnostic**: a run moves between fixed- and
  paged-pool engines of the same model.
- **Every compatibility axis is checked** (``check_compatible``): codec
  version, the source engine's config hash (``engine_config_hash``, over
  the reference's axes with the reference's spelling), layer count, row
  shapes and dtypes against the target's pools (target and draft), and
  the length budget.  A mismatch is the typed `RunTransferError`, never a
  quiet cast.
"""
from __future__ import annotations

import hashlib
import io
import json
from typing import Dict, Optional

import numpy as np
import torch

from ..core.errors import InvalidArgumentError
from ..weights import dtype_name, host_array, host_tensor
from .engine import PreemptedRun
from .request import Request, Response

__all__ = ["RunTransferError", "encode_run", "decode_run", "run_to_bytes",
           "run_from_bytes", "check_compatible", "engine_config_hash",
           "target_manifest", "TRANSFER_VERSION", "file_sha256",
           "artifact_manifest", "iter_artifact_chunks",
           "ARTIFACT_CHUNK_SIZE"]

# weight / program-set shipping: frames this size keep any single RPC
# frame small enough that a mid-frame connection cut loses at most one
# chunk (and the per-chunk sha pinpoints exactly which one was torn)
ARTIFACT_CHUNK_SIZE = 1 << 18

# the reference's codec version: the version and the source engine's
# config hash live inside the wire form's header
TRANSFER_VERSION = 2

# Request fields the codec carries so that the receiving side can rebuild
# the request (json-serializable scalars only)
_REQ_FIELDS = ("id", "max_new_tokens", "greedy", "temperature", "top_k",
               "top_p", "eos_token_id", "seed", "priority", "tenant",
               "spec", "session", "resubmit", "adapter")

# the width of a request key: two uint32 words (threefry-2x32), as the
# reference's ``len(jax.random.PRNGKey(0))``
KEY_WIDTH = 2


class RunTransferError(InvalidArgumentError):
    """The snapshot cannot be restored on the target engine: version,
    config-hash, layer-count, shape, dtype, or length-budget mismatch.
    Typed so that a caller fails the stream instead of corrupting it."""
    code = "InvalidArgument"


def _state_sig(state: Dict) -> str:
    """The reference's weight-shape signature (``programs/program_set.py``
    ``_state_sig``): sha256 of the sorted (name, shape, dtype name)."""
    items = sorted((k, tuple(int(d) for d in v.shape), dtype_name(v.dtype))
                   for k, v in state.items())
    return hashlib.sha256(repr(items).encode()).hexdigest()[:16]


def engine_config_hash(engine) -> str:
    """Digest of the config axes a run transfer depends on: model class,
    weight shape/dtype signature (target and draft), max_len / pool_len,
    spec_tokens, the KV dtype override and the key width, as the
    reference hashes them.  It leaves out the axes a run may cross — kv
    layout, block_size, max_slots, buckets, decode_chunk.  The KV dtype
    override is spelled as a numpy dtype name (``"bfloat16"``); the
    reference spells its JAX dtype object, so engines built with an
    override hash apart across the two frameworks (with None, the
    default, they hash equal).  A worker replica's proxy answers from
    the manifest its worker computed at boot."""
    tm = getattr(engine, "transfer_manifest", None)
    if callable(tm):
        return tm()["config_hash"]
    spec = engine.draft_model is not None
    ident = {
        "model_class": type(engine.model).__name__,
        "state_sig": _state_sig(engine.model.state_dict()),
        "draft_state_sig": (_state_sig(engine.draft_model.state_dict())
                            if spec else None),
        "max_len": int(engine.max_len),
        "pool_len": int(engine._pool_len),
        "spec_tokens": int(engine.spec_tokens) if spec else None,
        "dtype": (dtype_name(engine._dtype)
                  if engine._dtype is not None else None),
        "key_width": KEY_WIDTH,
    }
    return hashlib.sha256(
        json.dumps(ident, sort_keys=True).encode()).hexdigest()[:16]


def target_manifest(engine) -> dict:
    """The restore-compatibility descriptor of an engine: per-layer KV row
    trailing shapes and dtype names (target and draft halves), max_len,
    and the config hash.  A worker replica's proxy (``serving/worker.py``)
    returns the one its worker computed at boot, by
    ``transfer_manifest()``, so ``check_compatible`` runs against it as
    against a live engine."""
    tm = getattr(engine, "transfer_manifest", None)
    if callable(tm):
        return tm()

    def side(pools):
        return [{"k_shape": [int(d) for d in k.shape[2:]],
                 "v_shape": [int(d) for d in v.shape[2:]],
                 "k_dtype": dtype_name(k.dtype),
                 "v_dtype": dtype_name(v.dtype)}
                for k, v in pools]

    return {
        "config_hash": engine_config_hash(engine),
        "max_len": int(engine.max_len),
        "kv": side(engine._pools),
        "draft_kv": (side(engine._draft_store)
                     if engine.draft_model is not None else None),
    }


# ---------------------------------------------------------------------------
# artifact shipping: weight files over a boot handshake
# ---------------------------------------------------------------------------

def file_sha256(path: str) -> str:
    """Whole-file sha256 hex digest (streamed; artifacts can be GBs)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def artifact_manifest(path: str,
                      chunk_size: int = ARTIFACT_CHUNK_SIZE) -> dict:
    """The shipping manifest of one artifact file (a ``jit.save`` weight
    npz): whole-artifact sha256 plus per-chunk sha256s, so the receiver
    checks every chunk before any byte reaches an engine."""
    chunks = []
    total = hashlib.sha256()
    nbytes = 0
    with open(path, "rb") as f:
        while True:
            data = f.read(chunk_size)
            if not data:
                break
            total.update(data)
            nbytes += len(data)
            chunks.append({"sha256": hashlib.sha256(data).hexdigest(),
                           "nbytes": len(data)})
    return {"sha256": total.hexdigest(), "nbytes": nbytes,
            "chunk_size": int(chunk_size), "chunks": chunks}


def iter_artifact_chunks(path: str,
                         chunk_size: int = ARTIFACT_CHUNK_SIZE):
    """Yield (seq, bytes) chunks of the artifact in manifest order."""
    seq = 0
    with open(path, "rb") as f:
        while True:
            data = f.read(chunk_size)
            if not data:
                break
            yield seq, data
            seq += 1


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

def _to_numpy(rows) -> np.ndarray:
    """A snapshot row array as numpy: a CPU tensor's values (bfloat16 as
    ml_dtypes' ``bfloat16``, the reference's type), or an array as it
    is."""
    if not isinstance(rows, torch.Tensor):
        return np.asarray(rows)
    try:
        return host_array(rows)
    except ImportError as e:
        raise RunTransferError(
            "a bfloat16 run snapshot crosses as ml_dtypes' bfloat16 arrays "
            "(the reference's type), and ml_dtypes is not installed") from e


def encode_run(paused: PreemptedRun, engine=None) -> dict:
    """PreemptedRun -> portable blob: numpy arrays and scalars, no live
    object.  The source engine's config hash rides the manifest: from
    ``engine=`` when given, else the hash ``preempt_slot`` stamped on the
    snapshot (``source_config_hash``)."""
    kv = [(_to_numpy(k), _to_numpy(v)) for k, v in paused.kv_rows]
    draft = None
    if paused.draft_kv_rows is not None:
        draft = [(_to_numpy(k), _to_numpy(v))
                 for k, v in paused.draft_kv_rows]
    req = paused.req
    req_desc = {f: getattr(req, f) for f in _REQ_FIELDS}
    # the deadline crosses as its REMAINING budget (the Deadline object is
    # anchored to this process's clock): a moved run keeps counting down
    req_desc["deadline_remaining_s"] = (
        None if req.deadline is None else req.deadline.remaining())
    return {
        "version": TRANSFER_VERSION,
        "pos": int(paused.pos),
        "produced": int(paused.produced),
        "last_token": int(paused.last_token),
        "key": np.asarray(paused.key),
        "kv_rows": kv,
        "draft_kv_rows": draft,
        "prompt": np.asarray(req.prompt, np.int32),
        "req": req_desc,
        "manifest": {
            "layers": len(kv),
            "draft_layers": None if draft is None else len(draft),
            "kv_shapes": [(list(k.shape), list(v.shape)) for k, v in kv],
            "kv_dtypes": [(str(k.dtype), str(v.dtype)) for k, v in kv],
            "config_hash": (engine_config_hash(engine)
                            if engine is not None
                            else getattr(paused, "source_config_hash",
                                         None)),
        },
    }


def check_compatible(blob: dict, engine) -> None:
    """Raise RunTransferError unless ``blob`` can restore into
    ``engine``'s pools exactly: a codec version this build understands, a
    matching config hash (when the snapshot carries one), the same layer
    count, the same row trailing shape and dtype per layer (target and
    draft halves), and the budget within the target's max_len."""
    if blob.get("version") != TRANSFER_VERSION:
        raise RunTransferError(
            f"run snapshot codec version {blob.get('version')!r} != "
            f"{TRANSFER_VERSION} — refusing a format this build does not "
            "understand")
    man = blob["manifest"]
    target = target_manifest(engine)
    src_hash = man.get("config_hash")
    if src_hash is not None and src_hash != target["config_hash"]:
        raise RunTransferError(
            f"snapshot came from an engine with config hash {src_hash} "
            f"but the target's is {target['config_hash']} — the replicas "
            "were built from different program-set manifests (model, "
            "weights signature, length budget, or spec config differ); "
            "a silent restore would decode garbage rows")

    def check_side(rows, sides, what):
        if len(rows) != len(sides):
            raise RunTransferError(
                f"{what}: snapshot has {len(rows)} layers, target engine "
                f"has {len(sides)} — replicas must serve the same model")
        for i, ((rk, rv), s) in enumerate(zip(rows, sides)):
            for r, shape, dt, half in (
                    (rk, s["k_shape"], s["k_dtype"], "k"),
                    (rv, s["v_shape"], s["v_dtype"], "v")):
                # pool leaves are (slots|blocks, rows, heads, dim); a
                # snapshot row array is (pos, heads, dim): the trailing
                # dims must agree exactly
                if list(r.shape[1:]) != list(shape):
                    raise RunTransferError(
                        f"{what} layer {i}/{half}: snapshot row shape "
                        f"{tuple(r.shape[1:])} != target pool row shape "
                        f"{tuple(shape)}")
                if dtype_name(r.dtype) != dt:
                    raise RunTransferError(
                        f"{what} layer {i}/{half}: snapshot dtype "
                        f"{r.dtype} != target pool dtype {dt} — a "
                        "silent cast would break bit-identity")

    check_side(blob["kv_rows"], target["kv"], "KV rows")
    if blob["draft_kv_rows"] is not None:
        if target["draft_kv"] is None:
            raise RunTransferError(
                "snapshot carries draft KV but the target engine has no "
                "draft model")
        check_side(blob["draft_kv_rows"], target["draft_kv"],
                   "draft KV rows")
    elif target["draft_kv"] is not None:
        # restorable (the draft pool would start cold), but the resumed
        # stream's accept rate would collapse: refused as the reference
        raise RunTransferError(
            "target engine is speculative but the snapshot has no draft "
            "KV rows — resume would decay to target-only throughput")
    pos = int(blob["pos"])
    plen = int(blob["prompt"].shape[0])
    budget = int(blob["req"]["max_new_tokens"])
    max_len = int(target["max_len"])
    if plen + budget > max_len:
        raise RunTransferError(
            f"run needs {plen} prompt + {budget} new tokens but the "
            f"target engine's max_len is {max_len}")
    if pos > max_len:
        raise RunTransferError(
            f"snapshot position {pos} exceeds target max_len {max_len}")
    if man["layers"] != len(blob["kv_rows"]):
        raise RunTransferError(
            f"manifest says {man['layers']} layers, blob carries "
            f"{len(blob['kv_rows'])} — corrupt snapshot")


def _rows(pairs):
    return [(host_tensor(np.asarray(k)), host_tensor(np.asarray(v)))
            for k, v in pairs]


def decode_run(blob: dict, req: Optional[Request] = None,
               resp: Optional[Response] = None,
               engine=None) -> PreemptedRun:
    """Blob -> PreemptedRun ready for ``engine.restore_run``, its rows as
    CPU tensors.  An in-process move passes the original ``req`` /
    ``resp``, so the consumer's stream continues; otherwise the Request is
    rebuilt from the blob.  With ``engine``, ``check_compatible`` runs
    first."""
    if engine is not None:
        check_compatible(blob, engine)
    if req is None:
        r = blob["req"]
        req = Request(r["id"], blob["prompt"], r["max_new_tokens"],
                      greedy=r["greedy"], temperature=r["temperature"],
                      top_k=r["top_k"], top_p=r["top_p"],
                      eos_token_id=r["eos_token_id"], seed=r["seed"],
                      deadline=r.get("deadline_remaining_s"),
                      priority=r["priority"], tenant=r["tenant"],
                      spec=r["spec"], session=r["session"],
                      resubmit=r["resubmit"],
                      adapter=r.get("adapter"))
    if resp is None:
        resp = Response(req)
    draft = blob["draft_kv_rows"]
    paused = PreemptedRun.from_state(
        req, resp, pos=blob["pos"], produced=blob["produced"],
        last_token=blob["last_token"], key=blob["key"],
        kv_rows=_rows(blob["kv_rows"]),
        draft_kv_rows=None if draft is None else _rows(draft))
    # the source hash stays on the decoded snapshot: a later re-encode
    # must not drop the check
    paused.source_config_hash = blob["manifest"].get("config_hash")
    return paused


def run_to_bytes(blob: dict) -> bytes:
    """Serialize a blob to one npz byte string: arrays under indexed keys,
    scalars (the codec version and the config hash among them) in a json
    header."""
    arrays = {"key": blob["key"], "prompt": blob["prompt"]}
    for i, (k, v) in enumerate(blob["kv_rows"]):
        arrays[f"k{i}"] = k
        arrays[f"v{i}"] = v
    if blob["draft_kv_rows"] is not None:
        for i, (k, v) in enumerate(blob["draft_kv_rows"]):
            arrays[f"dk{i}"] = k
            arrays[f"dv{i}"] = v
    header = {kk: blob[kk] for kk in ("version", "pos", "produced",
                                      "last_token", "req", "manifest")}
    arrays["header"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8).copy()
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def run_from_bytes(data: bytes) -> dict:
    """Inverse of ``run_to_bytes``.  A malformed header, or a codec
    version this build does not speak, is the typed RunTransferError."""
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        try:
            header = json.loads(bytes(z["header"].tobytes()).decode())
        except Exception as e:
            raise RunTransferError(f"corrupt run snapshot header: {e!r}")
        if header.get("version") != TRANSFER_VERSION:
            raise RunTransferError(
                f"run snapshot codec version {header.get('version')!r} "
                f"!= {TRANSFER_VERSION} — refusing a wire format this "
                "build does not understand")
        n = header["manifest"]["layers"]
        kv = [(z[f"k{i}"], z[f"v{i}"]) for i in range(n)]
        dn = header["manifest"]["draft_layers"]
        draft = (None if dn is None
                 else [(z[f"dk{i}"], z[f"dv{i}"]) for i in range(dn)])
        blob = dict(header, key=z["key"], prompt=z["prompt"],
                    kv_rows=kv, draft_kv_rows=draft)
    return blob
