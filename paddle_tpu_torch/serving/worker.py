"""Serving replicas in processes of their own: the worker process and
its manager-side clients (port of paddle_tpu/serving/worker.py).

- **The worker** (``python -m paddle_tpu_torch.serving.worker``, ``main``)
  boots a whole ``ServingEngine`` in its own process from a json boot
  spec (a model factory ``"module:callable"`` with its kwargs, optional
  weights ``spec["weights"]`` from a ``jit.save`` npz, and the engine's
  options with its ``device``: the card unless the spec says ``"cpu"``),
  warms it (on the card: captures its graphs in the worker's own CUDA
  context), then drives ``engine.step()`` in one thread that also serves
  a length-prefixed frame RPC: submit / cancel / preempt / restore /
  swap_weights / load_adapter / fault / metrics / ping / abort_epoch /
  close.  Every frame is the npz wire form of ``serving/transfer.py`` (the
  arrays plus a json ``header``), and a malformed frame is the typed
  ``WireFormatError``.
- **The heartbeat is out of band**: after every step the worker rewrites
  a small json file (step counter, monotonic stamp) by ``os.replace``.
  The socket shows that the process is alive; only the heartbeat shows
  that it makes progress, so a wedged step (``replica_wedge``) is fenced
  on the heartbeat's age while the socket stays connected.
- **``WorkerClient``** is the manager's handle: it spawns the process by
  ``subprocess.Popen`` (never a fork: a CUDA context does not survive
  one), speaks the RPC on the fleet's driving thread, and has the
  ``ServingEngine`` surface that ``ReplicaManager``, ``FleetRouter`` and
  ``ServingGateway`` use, so a worker replica routes, migrates, drains
  and rolls out through the in-process code paths.  Runs migrate through
  the transfer codec's bytes; the client's local queue is the admission
  queue (a request ships once the worker has a free slot), so a crash's
  failover sees every queued request without a round trip.

Threading: socket I/O and state changes happen on the fleet's driving
thread (``step()`` and the RPC calls); only ``scheduler.submit`` (any
thread) and ``close()`` touch a client elsewhere, each under its lock.

**Remote mode**: ``python -m paddle_tpu_torch.serving.worker --listen
HOST:PORT`` runs a standalone worker that outlives any one manager; a
``RemoteWorkerClient`` attaches over TCP.  The attach ships the boot spec
and a ``jit.save`` weight artifact in chunks, each chunk and the whole
checked against a sha256 manifest (a mismatch is the typed
``WeightShipError``).  Liveness moves onto the wire: the worker pushes
beat frames on a side connection and the manager ages them by arrival on
its own clock.  Every (re)attach carries a manager-issued epoch: on a
partition the manager fences on beat age and resubmits elsewhere while
the isolated worker aborts its residents after ``manager_silence_s``, and
a healed worker of a stale epoch is told to abort, never to resume.  A
retried submit is deduplicated by its wid on the worker, and the
``net_delay`` / ``net_drop`` / ``net_partition`` knobs drive each path.

A spec's ``"program_set"`` (a path on the worker's host) boots the
worker's engine from a program set: its kernel libraries are installed
(no ``nvcc`` runs) and its graphs captured and held against the set's
records; a remote attach with ``"ship_program_set": True`` ships the
set in checked chunks, as weights are shipped.
"""
from __future__ import annotations

import io
import json
import os
import select
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.errors import (FatalError, InvalidArgumentError,
                           ResourceExhaustedError, UnavailableError)
from ..utils import faults as _faults
from ..utils.monitor import stat_add
from .request import Request, Response, RequestCancelled
from .scheduler import DeadlineExceededError, QueueFullError

__all__ = ["WorkerClient", "RemoteWorkerClient", "WorkerDiedError",
           "WireFormatError", "StaleEpochError", "WeightShipError",
           "pack_frame", "unpack_frame", "build_gpt", "main",
           "WIRE_VERSION"]

WIRE_VERSION = 1
_MAX_FRAME = 1 << 30  # a tiny-model KV snapshot is KBs; 1 GiB = corruption
_LEN = struct.Struct(">Q")


class WireFormatError(InvalidArgumentError):
    """A frame could not be decoded: bad length prefix, corrupt npz,
    missing/garbled header, or a wire version this build does not speak.
    The RunTransferError stance applied to the RPC itself — fail typed
    at the boundary, never decode garbage into engine state."""
    code = "InvalidArgument"


class WorkerDiedError(UnavailableError):
    """The subprocess worker is gone or unresponsive: process exited,
    socket closed, or an RPC timed out (the wedged case).  The manager
    treats it exactly like a replica crash — fence + failover."""
    code = "Unavailable"


class StaleEpochError(UnavailableError):
    """This worker session's manager-issued epoch token was superseded
    (partition healed after a fence, a newer manager re-attached, or
    the manager went silent past its deadline).  Every resident run
    dies with this error HERE because its resubmitted twin may already
    be streaming elsewhere — aborting typed is what makes double-serving
    impossible, token for token."""
    code = "Unavailable"


class WeightShipError(InvalidArgumentError):
    """A shipped boot artifact failed verification: chunk out of order,
    per-chunk or whole-artifact sha256 mismatch, short ship, or the
    assembled weights do not fit the model.  The RunTransferError stance
    applied to weights — reject typed at the boundary, never serve
    garbage parameters."""
    code = "InvalidArgument"


# ---------------------------------------------------------------------------
# frame codec: length prefix + the transfer.py npz wire form
# ---------------------------------------------------------------------------

def pack_frame(verb: str, header: Optional[dict] = None,
               arrays: Optional[Dict[str, np.ndarray]] = None) -> bytes:
    """One RPC frame: u64 big-endian length + an npz holding every array
    plus a json header under the reserved ``header`` key (the exact
    shape `transfer.run_to_bytes` uses, so run snapshots embed without a
    second codec)."""
    h = {"v": WIRE_VERSION, "verb": str(verb)}
    if header:
        h.update(header)
    arrs = {k: np.asarray(v) for k, v in (arrays or {}).items()}
    if "header" in arrs:
        raise InvalidArgumentError("'header' is a reserved frame key")
    arrs["header"] = np.frombuffer(
        json.dumps(h, default=str).encode(), dtype=np.uint8).copy()
    buf = io.BytesIO()
    np.savez(buf, **arrs)
    payload = buf.getvalue()
    return _LEN.pack(len(payload)) + payload


def unpack_frame(payload: bytes) -> Tuple[str, dict, Dict[str, np.ndarray]]:
    """payload (sans length prefix) -> (verb, header, arrays); raises
    the typed WireFormatError on ANY decode mismatch."""
    try:
        z = np.load(io.BytesIO(payload), allow_pickle=False)
    except Exception as e:
        raise WireFormatError(f"corrupt RPC frame (npz decode): {e!r}")
    with z:
        try:
            h = json.loads(bytes(z["header"].tobytes()).decode())
        except Exception as e:
            raise WireFormatError(f"corrupt RPC frame header: {e!r}")
        if h.get("v") != WIRE_VERSION:
            raise WireFormatError(
                f"RPC wire version {h.get('v')!r} != {WIRE_VERSION} — "
                "manager and worker builds disagree")
        verb = h.get("verb")
        if not isinstance(verb, str) or not verb:
            raise WireFormatError("RPC frame carries no verb")
        arrays = {k: z[k] for k in z.files if k != "header"}
    return verb, h, arrays


class _FrameConn:
    """Length-prefixed frames over one stream socket.  Reads are
    non-blocking (select-bounded) and a single frame's ASSEMBLY is
    deadline-bounded: a peer trickling one frame byte-by-byte (the
    slowloris case `PDTPU_FAULT_NET_DELAY` injects) raises the typed
    WireFormatError instead of occupying `recv_frames` forever.  Writes
    tolerate partial sends under `send_timeout` and raise WorkerDiedError
    past it — the peer being too wedged to drain its socket buffer is a
    liveness verdict, not a reason to hang the fleet loop.  When
    `fault_index` names this endpoint's replica, every send/recv
    consults the PDTPU_FAULT_NET_* chaos knobs (delay trickle, mid-frame
    cut, blackhole partition with the socket alive)."""

    def __init__(self, sock: socket.socket, send_timeout: float = 10.0,
                 frame_deadline: Optional[float] = 30.0,
                 fault_index: Optional[int] = None):
        self._sock = sock
        self._sock.setblocking(False)
        try:
            # every send is one complete frame — Nagle can only add
            # latency here (the classic 40ms delayed-ACK stall turns an
            # incremental chunk stream into one end-of-stream lump)
            self._sock.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
        except OSError:
            pass  # not a TCP socket (tests wrap socketpairs)
        self._buf = bytearray()
        self._wlock = threading.Lock()
        self._send_timeout = send_timeout
        self._frame_deadline = frame_deadline
        self._fault_index = fault_index
        self._asm_started: Optional[float] = None
        self._sent_frames = 0
        self._closed = False
        self._eof = False

    def _send_view(self, view: memoryview, what: str):
        """Push every byte of `view` under the send deadline, riding out
        partial writes (a full socket buffer hands back short sends, not
        errors)."""
        deadline = time.monotonic() + self._send_timeout
        while view:
            budget = deadline - time.monotonic()
            if budget <= 0:
                raise WorkerDiedError(
                    f"RPC send of {what} stalled "
                    f">{self._send_timeout}s — peer not draining")
            _, w, _ = select.select([], [self._sock], [], budget)
            if not w:
                continue
            try:
                n = self._sock.send(view)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError as e:
                raise WorkerDiedError(f"RPC send failed: {e!r}")
            view = view[n:]

    def send(self, verb: str, header: Optional[dict] = None,
             arrays: Optional[dict] = None):
        data = pack_frame(verb, header, arrays)
        if _faults.net_partition_active(self._fault_index):
            return  # blackholed: the bytes vanish, the socket stays up
        with self._wlock:
            if self._closed:
                raise WorkerDiedError("RPC connection is closed")
            if _faults.maybe_net_drop():
                # cut mid-frame: half the bytes land, then the socket
                # dies under the peer's feet — the torn-stream case
                try:
                    self._send_view(
                        memoryview(data)[:max(1, len(data) // 2)],
                        repr(verb))
                finally:
                    self._closed = True
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                raise WorkerDiedError(
                    f"RPC send of {verb!r} cut mid-frame "
                    "(PDTPU_FAULT_NET_DROP)")
            seq = self._sent_frames
            self._sent_frames += 1
            delay = _faults.net_delay_config()
            if delay is not None and seq % delay[1] == 0:
                # slowloris: trickle the frame in tiny bursts so the
                # RECEIVER's assembly deadline is what trips
                view = memoryview(data)
                while view:
                    self._send_view(view[:64], repr(verb))
                    view = view[64:]
                    if view:
                        time.sleep(delay[0] / 1000.0)
                return
            self._send_view(memoryview(data), repr(verb))

    def recv_frames(self, max_wait: float = 0.0) -> List[Tuple]:
        """Every complete frame currently available (waiting up to
        `max_wait` for the first byte).  Raises WorkerDiedError when the
        peer closed the connection, WireFormatError when one frame's
        assembly outlives `frame_deadline` (the slow-peer hold)."""
        if _faults.net_partition_active(self._fault_index):
            # blackholed: nothing readable, but no error either — the
            # connection LOOKS idle, which is the whole point
            if max_wait > 0:
                time.sleep(min(max_wait, 0.002))
            return []
        first = True
        while not self._eof:
            try:
                r, _, _ = select.select([self._sock], [], [],
                                        max_wait if first else 0.0)
            except OSError as e:
                raise WorkerDiedError(f"RPC socket lost: {e!r}")
            first = False
            if not r:
                break
            try:
                chunk = self._sock.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                break
            except OSError as e:
                raise WorkerDiedError(f"RPC recv failed: {e!r}")
            if not chunk:
                # EOF: deliver every COMPLETE frame already buffered
                # before raising (a typed `fatal` sent right before the
                # peer closed must never be lost to the close itself);
                # the death verdict lands on the next call
                self._eof = True
                break
            self._buf.extend(chunk)
        frames = []
        while True:
            if len(self._buf) < _LEN.size:
                break
            (n,) = _LEN.unpack_from(self._buf)
            if n > _MAX_FRAME:
                raise WireFormatError(
                    f"frame length {n} exceeds the {_MAX_FRAME} cap — "
                    "corrupt stream")
            if len(self._buf) < _LEN.size + n:
                break
            payload = bytes(self._buf[_LEN.size:_LEN.size + n])
            del self._buf[:_LEN.size + n]
            frames.append(unpack_frame(payload))
        if not frames and self._eof:
            raise WorkerDiedError("RPC peer closed the connection")
        if frames:
            # progress: whatever partial tail remains is a NEW frame
            self._asm_started = None
        if self._buf:
            now = time.monotonic()
            if self._asm_started is None:
                self._asm_started = now
            elif (self._frame_deadline is not None
                  and now - self._asm_started > self._frame_deadline):
                raise WireFormatError(
                    f"partial frame stuck {now - self._asm_started:.1f}s "
                    f"(> {self._frame_deadline}s assembly deadline) — "
                    "slow peer or torn stream")
        else:
            self._asm_started = None
        return frames

    def close(self):
        with self._wlock:
            self._closed = True
            try:
                self._sock.close()
            except OSError:
                pass

    def drain_close(self, timeout: float = 5.0):
        """Error-reply half-close: stop sending, then discard inbound
        until the peer closes (bounded).  A plain close() with unread
        bytes in the kernel buffer answers the peer with RST — which
        destroys the typed `fatal` frame still in flight to it.  The
        drain keeps the stream FIN-clean so the verdict arrives."""
        with self._wlock:
            self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                r, _, _ = select.select([self._sock], [], [], 0.1)
                if r and not self._sock.recv(1 << 16):
                    break
            except OSError:
                break
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# heartbeat side channel
# ---------------------------------------------------------------------------

class _Heartbeat:
    """Worker-side heartbeat writer: a small json file atomically
    replaced after every completed step (throttled).  The file — not the
    RPC socket — is the liveness signal: a wedged step stops the
    rewrites while the socket stays connected."""

    def __init__(self, path: str, min_interval: float = 0.02):
        self._path = path
        self._min_interval = min_interval
        self._last = 0.0

    def beat(self, steps: int, phase: str = "serve", force: bool = False):
        now = time.time()
        if not force and now - self._last < self._min_interval:
            return
        tmp = f"{self._path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                # `mono` (CLOCK_MONOTONIC — one timeline for every
                # process on the machine) is what age is computed from:
                # an NTP step / suspend-resume wall-clock jump must not
                # falsely wedge-fence the whole fleet.  Wall `time`
                # rides along for humans reading the file.
                f.write(json.dumps({"steps": int(steps), "time": now,
                                    "mono": time.monotonic(),
                                    "pid": os.getpid(), "phase": phase}))
            os.replace(tmp, self._path)
            self._last = now
        except OSError:
            pass  # a failed beat reads as staleness — the safe direction


def read_heartbeat(path: str) -> Optional[dict]:
    """Last complete heartbeat record, or None (no beat yet / torn
    file — os.replace makes torn reads near-impossible, but a missing
    file during boot is normal)."""
    try:
        with open(path) as f:
            return json.loads(f.read())
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# worker process: boot + serve loop
# ---------------------------------------------------------------------------

def build_gpt(seed: int = 0, device=None, **config):
    """Deterministic GPT factory for boot specs: ``GPTForPretraining``
    built on the CPU from a CPU generator seeded with ``seed``, then moved
    to ``device`` (the card by default), so a restarted worker serves the
    weights its predecessor served without shipping them.  The JAX
    package's ``build_gpt`` draws with threefry, so the same seed gives
    other weights there: carry the reference's weights across with
    ``spec["weights"]``."""
    from ..core.device import resolve_device
    from ..models import GPTConfig, GPTForPretraining
    dev = resolve_device(device)
    model = GPTForPretraining(GPTConfig(**config), device="cpu",
                              seed=int(seed))
    return model.to(dev).eval()


def _resolve(path: str):
    """'pkg.mod:callable' -> the callable."""
    import importlib
    mod, sep, name = path.partition(":")
    if not sep or not name:
        raise InvalidArgumentError(
            f"factory {path!r} must be 'package.module:callable'")
    return getattr(importlib.import_module(mod), name)


def _apply_weights(model, path: str) -> str:
    """Load a ``jit.save`` npz (name -> array, either framework's) into
    ``model`` in place by ``load_paddle_state`` and return the file's
    sha256.  A file that does not fit the model is the typed
    ``WeightShipError``: a worker never serves half-loaded weights."""
    from ..weights import load_paddle_state
    from .transfer import file_sha256
    try:
        data = np.load(path, allow_pickle=False)
    except Exception as e:
        raise WeightShipError(f"weight artifact {path!r} unreadable: {e!r}")
    with data:
        state = {k: data[k] for k in data.files}
    try:
        load_paddle_state(model, state)
    except Exception as e:
        raise WeightShipError(f"weight artifact does not fit the model: {e}")
    return file_sha256(path)


def _call_factory(entry: dict, device):
    """Call a spec's ``{"factory", "kwargs"}``; a factory with a
    ``device`` parameter that the kwargs leave unset gets the engine's."""
    import inspect
    fn = _resolve(entry["factory"])
    kw = dict(entry.get("kwargs") or {})
    try:
        takes_device = "device" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        takes_device = False
    if takes_device:
        kw.setdefault("device", str(device))
    return fn(**kw)


def _build_engine(spec: dict):
    """Boot spec -> (ServingEngine, weights_sha).  ``spec["weights"]`` (an
    npz path, shipped by the attach or on shared storage) replaces the
    factory's seeded weights before the engine copies them; weights_sha is
    None for a seeded boot.  ``spec["engine"]["device"]`` is the engine's
    device, the card unless it says ``"cpu"``: a worker asked for the card
    that finds none fails its boot, typed."""
    from ..core.device import resolve_device
    from .engine import ServingEngine
    ekw = dict(spec.get("engine") or {})
    dev = resolve_device(ekw.pop("device", None))
    model = _call_factory(spec["model"], dev)
    weights_sha = None
    if spec.get("weights"):
        weights_sha = _apply_weights(model, spec["weights"])
    draft = None
    if spec.get("draft"):
        draft = _call_factory(spec["draft"], dev).to(dev)
    if ekw.get("prefill_buckets") is not None:
        ekw["prefill_buckets"] = tuple(int(b)
                                       for b in ekw["prefill_buckets"])
    if spec.get("lora"):
        from ..lora import LoRAConfig
        ekw["lora"] = LoRAConfig.from_spec(spec["lora"])
    return ServingEngine(model.to(dev), draft_model=draft, device=dev,
                         program_set=spec.get("program_set"),
                         **ekw), weights_sha


def _process_report(engine, registry: bool = False) -> dict:
    """What this worker process holds beyond its engine's report: every
    kernel wrapper's launch count (``core.programs.counters()``: the
    replays of captured graphs included), each engine program's replays,
    its pid and device, whether the JAX package or ``jax`` was ever
    imported here, its kernel library builds (``ops._build.counts``:
    hits, nvcc misses, installs from a program set) and the program
    store's stats, and with ``registry`` the program registry's records
    (captures and capture seconds per program)."""
    from ..core.programs import counters
    from ..ops import _build
    from ..programs.store import store_stats
    launches = {owner.__name__: int(owner.launches)
                for owner, key in counters() if key == "launches"}
    out = {"pid": os.getpid(), "launches": launches,
           "modules": {m: m in sys.modules for m in ("jax", "paddle_tpu")},
           "device": str(engine.device),
           "kernel_builds": dict(_build.counts),
           "program_store": store_stats(),
           "program_set": _jsonable(engine.program_set_info),
           "replays": {str(name): int(prog.replays)
                       for name, prog in engine._programs.items()}}
    if registry:
        from .. import observability as obs
        out["programs"] = _jsonable(obs.report().get("programs"))
    return out


class _WireResponse(Response):
    """Worker-local response that additionally records per-token logps
    so stream chunks carry them across the wire (the base Response only
    keeps the cumulative sum)."""

    def __init__(self, req: Request):
        super().__init__(req)
        self.logps: List[float] = []

    def _push_token(self, tok: int, logp: float = 0.0):
        super()._push_token(tok, logp)
        self.logps.append(float(logp))


def _jsonable(obj):
    """Best-effort scalar-tree copy for status/metrics headers."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (str, int, bool)) or obj is None:
        return obj
    if isinstance(obj, float):
        return obj if np.isfinite(obj) else None
    return str(obj)


class _WorkerServer:
    """The worker's single-threaded drive loop (see module docstring).
    Local mode: `hb` writes the heartbeat file and the manager owns the
    process.  Remote mode (`listener` set): liveness is pushed as beat
    frames on `beat_conn`, the session carries a manager-issued `epoch`
    token, and losing the manager (connection or `manager_silence_s` of
    inbound silence) aborts every resident typed and returns the worker
    to its accept loop — it never exits just because one manager did."""

    def __init__(self, engine, conn: _FrameConn, hb: Optional[_Heartbeat],
                 index: int, epoch: int = 0,
                 beat_conn: Optional[_FrameConn] = None,
                 manager_silence_s: Optional[float] = None,
                 listener: Optional[socket.socket] = None,
                 weights_sha: Optional[str] = None,
                 cache: Optional[dict] = None,
                 _clock=time.monotonic):
        from ..utils import faults
        self._faults = faults
        self.engine = engine
        self.conn = conn
        self.hb = hb
        self.index = index
        self.epoch = int(epoch)
        self.beat_conn = beat_conn
        # the remote session's engine cache (remote mode only): a weight
        # swap updates its sha/key so a post-partition re-attach reuses
        # the swapped engine and ships zero bytes
        self._cache = cache
        self.manager_silence_s = (None if manager_silence_s is None
                                  else float(manager_silence_s))
        self.listener = listener
        self.weights_sha = weights_sha
        self._clock = _clock
        self._last_rx = _clock()
        self._last_beat_tx = 0.0
        self._seen_wids: set = set()  # submit dedup (exactly-once admit)
        self.pending_attach = None    # (conn, header) epoch takeover
        self.detach: Optional[str] = None
        self.streams: Dict[int, list] = {}  # wid -> [resp, n_sent]
        self.step_no = 0
        self._ewma: Optional[float] = None
        self._recent_dts: List[float] = []
        self._last_status = 0.0
        self._stopping = False

    # -- inbound verbs --------------------------------------------------
    def _handle(self, verb: str, h: dict, arrays: dict):
        if verb == "submit":
            self._on_submit(h, arrays)
        elif verb == "cancel":
            entry = self.streams.get(h.get("wid"))
            if entry is not None:
                entry[0].cancel()
        elif verb == "preempt":
            self._on_preempt(h)
        elif verb == "restore":
            self._on_restore(h, arrays)
        elif verb == "metrics":
            self.conn.send("metrics", {
                "wid": h.get("wid"),
                "metrics": _jsonable(self.engine.metrics()),
                "process": _process_report(self.engine, registry=True)})
        elif verb == "fault":
            point, value = h.get("point"), h.get("value")
            if value is None:
                self._faults.disable(point)
            else:
                self._faults.enable(point, value)
        elif verb == "swap_weights":
            self._on_swap(h)
        elif verb == "load_adapter":
            self._on_load_adapter(h)
        elif verb == "close":
            self._stopping = True
        elif verb == "ping":
            pass  # liveness only: receipt already fed the silence clock
        elif verb == "abort_epoch":
            if int(h.get("epoch", -1)) == self.epoch:
                # the manager declared this session stale: a resubmitted
                # twin of every resident may already be live elsewhere
                self._abort_residents(
                    "epoch superseded (manager abort_epoch)")
                self.detach = "abort_epoch"
        else:
            self.conn.send("log", {"msg": f"unknown verb {verb!r} ignored"})

    def _on_submit(self, h: dict, arrays: dict):
        wid = int(h["wid"])
        if wid in self._seen_wids:
            # retried submit after a lost/timed-out ack: exactly-once
            # admission — re-ack, never double-admit
            self.conn.send("accepted", {"wid": wid, "epoch": self.epoch,
                                        "dup": True})
            return
        self._seen_wids.add(wid)
        try:
            req, _ = self.engine.make_request(
                np.asarray(arrays["prompt"], np.int32),
                int(h["max_new_tokens"]),
                decode_strategy=h.get("decode_strategy", "greedy_search"),
                temperature=h.get("temperature", 1.0),
                top_k=h.get("top_k", 0), top_p=h.get("top_p", 1.0),
                eos_token_id=h.get("eos_token_id"), seed=h.get("seed"),
                deadline=h.get("deadline_remaining_s"),
                priority=h.get("priority", 0), tenant=h.get("tenant"),
                spec=h.get("spec"), session=h.get("session"),
                resubmit=h.get("resubmit", False),
                adapter=h.get("adapter"))
            resp = _WireResponse(req)
            self.engine.scheduler.submit(req, resp)
        except Exception as e:
            self.conn.send("failed", {"wid": wid,
                                      "etype": type(e).__name__,
                                      "msg": str(e)[:500]})
            return
        self.streams[wid] = [resp, 0]
        self.conn.send("accepted", {"wid": wid, "epoch": self.epoch})

    def _find_slot(self, resp) -> Optional[int]:
        for slot, run in self.engine._slots.items():
            if run.resp is resp:
                return slot
        return None

    def _on_preempt(self, h: dict):
        from .transfer import encode_run, run_to_bytes
        wid = int(h["wid"])
        entry = self.streams.get(wid)
        slot = None if entry is None else self._find_slot(entry[0])
        if slot is None:
            # finished / still queued / unknown — nothing resident to move
            self.conn.send("preempted", {"wid": wid, "ok": False,
                                         "reason": "not-resident"})
            return
        # flush BEFORE snapshotting: the manager must hold every token
        # `produced` counts, or the migrated continuation would skip the
        # in-flight tail and the stream would lose tokens silently
        self._flush_one(wid, entry)
        paused = self.engine.preempt_slot(slot)
        blob = run_to_bytes(encode_run(paused, engine=self.engine))
        self.streams.pop(wid, None)
        self.conn.send("preempted", {"wid": wid, "ok": True},
                       {"run": np.frombuffer(blob, np.uint8).copy()})

    def _on_restore(self, h: dict, arrays: dict):
        from .transfer import decode_run, run_from_bytes
        wid = int(h["wid"])
        try:
            blob = run_from_bytes(arrays["run"].tobytes())
            paused = decode_run(blob, engine=self.engine)
            resp = _WireResponse(paused.req)
            paused.resp = resp
            ok = self.engine.restore_run(paused)
        except Exception as e:
            self.conn.send("restored", {"wid": wid, "ok": False,
                                        "etype": type(e).__name__,
                                        "msg": str(e)[:500]})
            return
        if ok:
            self.streams[wid] = [resp, 0]
        self.conn.send("restored", {"wid": wid, "ok": bool(ok)})

    def _on_swap(self, h: dict):
        """Continuous weight refresh: rebind the engine's served
        weights to a new artifact with nothing captured again
        (``ServingEngine.swap_weights`` writes the engine's weights in
        place, where its graphs read them).  Local mode: the artifact is a
        path on this host, sha256-verified before a byte reaches the
        engine.  Remote mode: the header carries a manifest and the
        bytes follow as chunk frames after the `swap_ready` ack, over
        the same verified channel the attach handshake uses.  Any
        failure — truncated file, sha mismatch, shape mismatch — is
        reported typed and leaves the OLD weights serving."""
        from .transfer import file_sha256
        wid = h.get("wid")
        sha = h.get("sha256")
        man = h.get("manifest")
        try:
            if man is not None:
                if self._cache is not None:
                    path = os.path.join(self._cache["dir"], "weights.npz")
                else:
                    path = os.path.join(
                        tempfile.mkdtemp(prefix="pdtorch_swap_"),
                        "weights.npz")
                self.conn.send("swap_ready", {"wid": wid})
                self._recv_swap_chunks(man, path)
                sha = man.get("sha256")
            else:
                path = h.get("path")
                if not path:
                    raise WeightShipError(
                        "swap_weights needs a path (local) or a "
                        "manifest (remote)")
                actual = file_sha256(path)
                if sha is not None and actual != sha:
                    raise WeightShipError(
                        f"weight artifact {path!r} sha256 {actual} != "
                        f"published {sha} — refusing corrupt weights")
                sha = actual
            with np.load(path, allow_pickle=False) as z:
                state = {k: z[k] for k in z.files}
            self.engine.swap_weights(state, sha)
        except Exception as e:  # noqa: BLE001 — typed rejection, old
            #                     weights keep serving
            self._verdict("swapped", {"wid": wid, "ok": False,
                                      "etype": type(e).__name__,
                                      "msg": str(e)[:500]})
            return
        self.weights_sha = sha
        if self._cache is not None:
            # a post-partition re-attach carrying the NEW manifest must
            # reuse this engine and ship zero bytes
            self._cache["weights_sha"] = sha
            key = self._cache.get("key")
            if key is not None:
                self._cache["key"] = (key[0], sha, key[2])
        self._verdict("swapped", {"wid": wid, "ok": True,
                                  "weights_sha": sha})

    def _recv_swap_chunks(self, man: dict, path: str):
        """Receive the swap artifact's chunk stream (sent only after our
        `swap_ready` ack, so no chunk can race into the serve loop's
        frame batch ahead of this read)."""
        _recv_artifacts(self.conn, {"weights": (man, path)})

    def _on_load_adapter(self, h: dict):
        """Multi-tenant LoRA hot-load: page one adapter artifact into
        the engine's registry with nothing captured again (the factor
        stacks are written in place, where the graphs read them).  Local mode: the artifact is a path on this host,
        verified against the published sha256 before the registry reads
        it.  Remote mode: the header carries a manifest; if the named
        adapter is already resident with the SAME artifact sha the
        worker answers `cached` and zero bytes ship, otherwise the
        chunk stream follows our `adapter_ready` ack over the same
        verified channel the attach handshake uses.  Any failure —
        corrupt bytes, base-hash/rank mismatch, every slot pinned — is
        reported typed and leaves the registry unchanged."""
        from ..lora import AdapterIntegrityError
        from .transfer import file_sha256
        wid = h.get("wid")
        name = h.get("name")
        man = h.get("manifest")
        try:
            if getattr(self.engine, "lora", None) is None:
                raise InvalidArgumentError(
                    "worker engine was not built with lora="
                    "LoRAConfig(...) — add a 'lora' key to the boot "
                    "spec")
            reg = self.engine._lora_reg
            if man is not None:
                idx = reg.loaded().get(name)
                if (idx is not None
                        and reg.file_sha(idx) == man.get("sha256")):
                    # zero-byte re-attach: the identical artifact is
                    # already resident under this name
                    stat_add("STAT_lora_ship_reattaches")
                    self.conn.send("adapter_ready",
                                   {"wid": wid, "cached": True})
                    self._verdict("adapter_loaded",
                                  {"wid": wid, "ok": True, "name": name,
                                   "file_sha": man.get("sha256"),
                                   "cached": True})
                    return
                if self._cache is not None:
                    d = os.path.join(self._cache["dir"], "adapters")
                else:
                    d = tempfile.mkdtemp(prefix="pdtorch_adapter_")
                os.makedirs(d, exist_ok=True)
                path = os.path.join(
                    d, f"{(man.get('sha256') or 'x')[:16]}.npz")
                self.conn.send("adapter_ready",
                               {"wid": wid, "cached": False})
                _recv_artifacts(self.conn, {"adapter": (man, path)})
            else:
                path = h.get("path")
                if not path:
                    raise InvalidArgumentError(
                        "load_adapter needs a path (local) or a "
                        "manifest (remote)")
                sha = h.get("sha256")
                if sha is not None and file_sha256(path) != sha:
                    raise AdapterIntegrityError(
                        f"adapter artifact {path!r} sha256 != published "
                        f"{sha} — refusing corrupt factors")
            file_sha = self.engine.load_adapter(name, path)
        except Exception as e:  # noqa: BLE001 — typed rejection, the
            #                     registry keeps its previous contents
            self._verdict("adapter_loaded",
                          {"wid": wid, "ok": False,
                           "etype": type(e).__name__,
                           "msg": str(e)[:500]})
            return
        self._verdict("adapter_loaded", {"wid": wid, "ok": True,
                                         "name": name,
                                         "file_sha": file_sha})

    def _verdict(self, verb: str, header: dict):
        """Send the verdict of a long verb (a weight swap, an adapter
        load) after a fresh heartbeat: the loop did not step while the
        verb ran, and the manager, which waited for this verdict, must not
        take that gap for a wedge once it reads it."""
        if self.hb is not None:
            self.hb.beat(self.step_no, force=True)
        self._push_beat(force=True)
        self.conn.send(verb, header)

    # -- outbound stream/status -----------------------------------------
    def _flush_one(self, wid: int, entry: list) -> bool:
        resp, sent = entry
        toks = resp.tokens_so_far()
        if len(toks) > sent:
            self.conn.send(
                "chunk", {"wid": wid},
                {"toks": np.asarray(toks[sent:], np.int64),
                 "logps": np.asarray(resp.logps[sent:len(toks)],
                                     np.float64)})
            entry[1] = len(toks)
        if resp.done():
            if resp.error is not None:
                self.conn.send("failed",
                               {"wid": wid,
                                "etype": type(resp.error).__name__,
                                "msg": str(resp.error)[:500]})
            else:
                self.conn.send("done", {"wid": wid,
                                        "reason": resp.finish_reason})
            return True
        return False

    def _flush(self):
        for wid in list(self.streams):
            if self._flush_one(wid, self.streams[wid]):
                self.streams.pop(wid, None)

    def _maybe_status(self):
        now = time.time()
        if now - self._last_status < 0.05:
            return
        self._last_status = now
        sched = self.engine.scheduler
        dts, self._recent_dts = self._recent_dts, []
        self.conn.send(
            "status",
            {"occupancy": sched.occupancy(),
             "queue_depth": sched.queue_depth(),
             "free_slots": sched.free_slot_count(),
             "steps": self.step_no,
             "epoch": self.epoch,
             "weights_sha": self.weights_sha,
             "ewma_ms": (None if self._ewma is None
                         else self._ewma * 1e3),
             "post_warmup_compiles": self.engine.post_warmup_compiles(),
             "metrics": _jsonable(self.engine.metrics()),
             "process": _process_report(self.engine)},
            {"step_s": np.asarray(dts, np.float64)})

    def _push_beat(self, force: bool = False):
        """Remote liveness: one tiny beat frame on the side connection
        after each step (throttled).  Send failure is swallowed — a dead
        beat channel reads as staleness on the manager, which is the
        safe direction."""
        if self.beat_conn is None:
            return
        now = self._clock()
        if not force and now - self._last_beat_tx < 0.02:
            return
        self._last_beat_tx = now
        try:
            self.beat_conn.send("beat", {"steps": self.step_no,
                                         "mono": time.monotonic(),
                                         "epoch": self.epoch,
                                         "phase": "serve"})
        except (WorkerDiedError, WireFormatError, OSError):
            pass

    # -- remote-session fencing -----------------------------------------
    def _abort_residents(self, reason: str, exc_cls=None):
        """Fail every resident + queued run typed and report it to the
        manager best-effort (during a partition these frames blackhole,
        which is fine: the manager already fenced and resubmitted — what
        matters is that THIS side stops decoding, so no token is ever
        served twice)."""
        cls = exc_cls or StaleEpochError
        self.engine._abort_all(lambda req: cls(
            f"request {req.id} aborted on worker {self.index} "
            f"(epoch {self.epoch}): {reason}"))
        try:
            self._flush()
        except (WorkerDiedError, WireFormatError):
            pass
        self.streams.clear()

    def _check_manager_silence(self) -> bool:
        """Partition self-fence: nothing inbound (frames OR pings) for
        `manager_silence_s` means the manager either died or cannot
        reach us — and in both cases it has fenced this replica on beat
        age and resubmitted elsewhere, so the residents must die HERE."""
        if self.manager_silence_s is None:
            return False
        if self._clock() - self._last_rx <= self.manager_silence_s:
            return False
        self._abort_residents(
            f"manager silent >{self.manager_silence_s}s — assuming "
            "partition; the fleet has resubmitted these runs elsewhere")
        self.detach = "manager-silence"
        return True

    def _poll_listener(self) -> bool:
        """Non-blocking accept on the standalone listener: a NEW attach
        with a HIGHER epoch supersedes this session (a manager healed
        from a partition re-attaches); lower-or-equal epochs are stale
        managers and are refused with a typed fatal."""
        if self.listener is None:
            return False
        try:
            s, _ = self.listener.accept()
        except (BlockingIOError, socket.timeout, OSError):
            return False
        nc = _FrameConn(s, fault_index=self.index)
        try:
            h, _ = _wait_frame(nc, "attach", timeout=5.0)
        except (WorkerDiedError, WireFormatError):
            nc.close()
            return False
        if int(h.get("epoch", 0)) <= self.epoch:
            try:
                nc.send("fatal", {
                    "etype": "StaleEpochError",
                    "msg": (f"attach epoch {h.get('epoch')} <= live "
                            f"epoch {self.epoch} — refusing a stale "
                            "manager")})
            except (WorkerDiedError, WireFormatError):
                pass
            nc.close()
            return False
        self.pending_attach = (nc, h)
        self._abort_residents(
            f"superseded by attach epoch {h.get('epoch')}")
        self.detach = "reattach"
        return True

    # -- the loop -------------------------------------------------------
    def serve(self) -> int:
        """Drive until exit.  Return codes: 0 = clean local exit, 4 =
        engine step died, 5 = remote session over (abort residents done;
        keep the process alive and go back to the accept loop)."""
        remote = self.listener is not None
        while True:
            try:
                frames = self.conn.recv_frames(
                    0.0 if self.engine.has_work() else 0.002)
            except WorkerDiedError as e:
                if remote:
                    # standalone worker: the manager is gone but this
                    # process is not its child — abort residents typed
                    # (a resubmitted twin may already be streaming
                    # elsewhere) and go back to listening
                    self._abort_residents(f"manager connection lost ({e})")
                    self.detach = "manager-lost"
                    return 5
                # manager gone: a spawned worker never outlives its fleet
                print(f"worker exiting: manager connection lost ({e})",
                      file=sys.stderr, flush=True)
                self.engine.close()
                return 0
            except WireFormatError as e:
                # torn/trickled stream (the slowloris assembly deadline):
                # this connection is unrecoverable
                if remote:
                    self._abort_residents(f"wire error ({e})")
                    self.detach = "wire-error"
                    return 5
                print(f"worker exiting: wire error ({e})",
                      file=sys.stderr, flush=True)
                self.engine.close()
                return 4
            if frames:
                self._last_rx = self._clock()
            for verb, h, arrays in frames:
                try:
                    self._handle(verb, h, arrays)
                except WorkerDiedError as e:
                    # reply channel gone mid-handle: manager is dead
                    if remote:
                        self._abort_residents(
                            f"manager connection lost mid-frame ({e})")
                        self.detach = "manager-lost"
                        return 5
                    print(f"worker exiting: manager connection lost "
                          f"mid-frame ({e})", file=sys.stderr, flush=True)
                    self.engine.close()
                    return 0
                except Exception as e:  # noqa: BLE001
                    # a malformed/garbled frame (missing field, bad
                    # type) must cost its sender an error report, never
                    # the whole worker — the WireFormatError stance
                    # applied to frame CONTENT too
                    try:
                        self.conn.send("log", {
                            "error": f"frame {verb!r} failed: "
                                     f"{type(e).__name__}: {e}"})
                    except WorkerDiedError:
                        pass
            if frames:
                # a long verb (a swap's or an adapter's ship) read the
                # manager's frames itself: the manager was not silent
                self._last_rx = self._clock()
            if self._stopping:
                if remote:
                    # close ends the SESSION, not the process — the
                    # manager does not own a standalone worker
                    self._abort_residents("manager closed the session",
                                          exc_cls=RequestCancelled)
                    try:
                        self.conn.send("bye", {})
                    except (WorkerDiedError, WireFormatError):
                        pass
                    self.detach = "close"
                    return 5
                print("worker exiting: close verb received",
                      file=sys.stderr, flush=True)
                self.engine.close()
                self._flush()
                try:
                    self.conn.send("bye", {})
                except WorkerDiedError:
                    pass
                return 0
            if self.detach is not None:  # abort_epoch landed
                return 5
            if self._check_manager_silence():
                return 5
            if self._poll_listener():
                return 5
            # the wedge fault blocks HERE forever when armed: the socket
            # stays connected, frames pile up unread, and only the
            # heartbeat (file or beat frames — below, never reached)
            # goes stale
            self._faults.maybe_wedge_replica(self.index, self.step_no)
            t0 = time.perf_counter()
            self._faults.maybe_slow_replica(self.index, self.step_no)
            try:
                self.engine.step()
            except BaseException as e:  # noqa: BLE001 — report, then die
                try:
                    self.conn.send("dying", {"etype": type(e).__name__,
                                             "msg": str(e)[:500]})
                except WorkerDiedError:
                    pass
                return 4
            dt = time.perf_counter() - t0
            self.step_no += 1
            self._ewma = (dt if self._ewma is None
                          else 0.3 * dt + 0.7 * self._ewma)
            self._recent_dts.append(dt)
            if self.hb is not None:
                self.hb.beat(self.step_no)
            self._push_beat()
            try:
                self._flush()
                self._maybe_status()
            except (WorkerDiedError, WireFormatError) as e:
                if remote:
                    self._abort_residents(f"manager send path died ({e})")
                    self.detach = "manager-lost"
                    return 5
                print(f"worker exiting: manager connection lost ({e})",
                      file=sys.stderr, flush=True)
                self.engine.close()
                return 0


def _ready_header(engine, warm: dict, epoch: int = 0,
                  weights_sha: Optional[str] = None,
                  shipped: Optional[dict] = None) -> dict:
    from .transfer import target_manifest
    h = {
        "config": {
            "max_slots": engine.max_slots,
            "max_len": engine.max_len,
            "buckets": list(engine.buckets),
            "max_queue_depth": engine.scheduler.max_queue_depth,
            "has_draft": engine.draft_model is not None,
            "kv": engine.kv,
            "pid": os.getpid(),
            "device": str(engine.device),
        },
        "manifest": target_manifest(engine),
        "warmup": {"seconds": warm.get("seconds"),
                   "programs": warm.get("compile_counts")},
        "epoch": int(epoch),
        "weights_sha": weights_sha,
    }
    if shipped is not None:
        h["shipped"] = {k: int(v) for k, v in shipped.items()}
    return h


def _wait_frame(conn: _FrameConn, want_verb: str,
                timeout: float) -> Tuple[dict, dict]:
    """Block (bounded) until the next frame, which must be `want_verb` —
    the handshake protocol is strictly sequenced, so anything else is a
    typed protocol error."""
    deadline = time.monotonic() + timeout
    while True:
        for verb, h, arrays in conn.recv_frames(0.05):
            if verb == want_verb:
                return h, arrays
            raise WireFormatError(
                f"handshake expected {want_verb!r}, got {verb!r}")
        if time.monotonic() > deadline:
            raise WorkerDiedError(
                f"no {want_verb!r} frame within {timeout}s")


def _recv_artifacts(conn: _FrameConn, wants: dict,
                    timeout: float = 300.0) -> dict:
    """Receive the attach handshake's chunked artifact ship.  `wants`
    maps name -> (manifest-or-None, dest_path); chunks must arrive in
    order and every chunk AND the assembled file must match the
    manifest's sha256 — any mismatch is a typed WeightShipError before a
    single byte reaches an engine.  Returns name -> bytes received."""
    import hashlib
    verbs = {"weights_chunk": "weights", "program_chunk": "programs",
             "adapter_chunk": "adapter"}
    state = {}
    for name, (man, path) in wants.items():
        if man is not None:
            state[name] = {"f": open(path, "wb"), "h": hashlib.sha256(),
                           "seq": 0, "bytes": 0, "man": man}
    try:
        deadline = time.monotonic() + timeout
        done = False
        while not done:
            if time.monotonic() > deadline:
                raise WorkerDiedError(
                    f"artifact ship timed out after {timeout}s")
            for verb, h, arrays in conn.recv_frames(0.05):
                if verb == "attach_end":
                    done = True
                    break
                name = verbs.get(verb)
                if name is None:
                    continue  # e.g. a keepalive ping mid-ship
                st = state.get(name)
                if st is None:
                    raise WeightShipError(
                        f"unsolicited {verb} (artifact not requested)")
                seq = int(h.get("seq", -1))
                if seq != st["seq"]:
                    raise WeightShipError(
                        f"{name} chunk {seq} out of order "
                        f"(expected {st['seq']})")
                chunks = st["man"].get("chunks") or []
                data = arrays["data"].tobytes()
                if (seq >= len(chunks)
                        or hashlib.sha256(data).hexdigest()
                        != chunks[seq].get("sha256")):
                    raise WeightShipError(
                        f"{name} chunk {seq} sha256 mismatch — refusing "
                        "to assemble garbage weights")
                st["f"].write(data)
                st["h"].update(data)
                st["seq"] += 1
                st["bytes"] += len(data)
        out = {}
        for name, st in state.items():
            st["f"].close()
            chunks = st["man"].get("chunks") or []
            if st["seq"] != len(chunks):
                raise WeightShipError(
                    f"{name} artifact short: {st['seq']}/{len(chunks)} "
                    "chunks before attach_end")
            if st["h"].hexdigest() != st["man"].get("sha256"):
                raise WeightShipError(
                    f"{name} whole-artifact sha256 mismatch")
            out[name] = st["bytes"]
        return out
    finally:
        for st in state.values():
            try:
                st["f"].close()
            except OSError:
                pass


def _accept_beat(lsock: socket.socket, epoch: int, index: int,
                 timeout: float = 30.0) -> _FrameConn:
    """Accept the manager's dedicated beat side connection (it must
    introduce itself with a matching-epoch `beat_attach`)."""
    deadline = time.monotonic() + timeout
    lsock.settimeout(0.2)
    try:
        while time.monotonic() < deadline:
            try:
                s, _ = lsock.accept()
            except socket.timeout:
                continue
            except OSError as e:
                raise WorkerDiedError(f"beat accept failed: {e!r}")
            bc = _FrameConn(s, fault_index=index)
            try:
                h, _ = _wait_frame(bc, "beat_attach", timeout=5.0)
            except (WorkerDiedError, WireFormatError):
                bc.close()
                continue
            if int(h.get("epoch", -1)) != epoch:
                bc.close()
                continue
            return bc
        raise WorkerDiedError(
            f"no beat side-connection within {timeout}s")
    finally:
        # the serve loop's listener poll needs non-blocking accepts
        lsock.setblocking(False)


def _serve_session(lsock: socket.socket, conn: _FrameConn, attach: dict,
                   index: int, cache: dict) -> Tuple[int, Optional[tuple]]:
    """One manager session on an accepted connection: attach handshake
    (artifact ship + beat side channel + engine build/reuse), then serve
    until detach.  Returns (rc, pending_attach); rc 5 means 'session
    over, keep listening'.  The engine is CACHED across sessions keyed
    on (spec, weights sha, programs sha): a manager re-attaching after a
    partition pays zero rebuild and zero re-ship."""
    epoch = int(attach.get("epoch", 0))
    spec = dict(attach.get("spec") or {})
    wman = attach.get("weights")
    pman = attach.get("programs")
    silence = attach.get("silence_s")
    need_w = (wman is not None
              and wman.get("sha256") != cache.get("weights_sha"))
    need_p = (pman is not None
              and pman.get("sha256") != cache.get("programs_sha"))
    wpath = os.path.join(cache["dir"], "weights.npz")
    ppath = os.path.join(cache["dir"], "programs")

    def _fatal(e: BaseException) -> Tuple[int, None]:
        print(f"worker session failed: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        try:
            conn.send("fatal", {"etype": type(e).__name__,
                                "msg": str(e)[:800], "epoch": epoch})
        except (WorkerDiedError, WireFormatError):
            pass
        # half-close + drain: the manager may still be mid-ship, and a
        # plain close against its unread bytes would RST the typed
        # fatal right out of its receive buffer
        conn.drain_close()
        return 5, None

    try:
        conn.send("attach_ok", {"epoch": epoch, "need_weights": need_w,
                                "need_programs": need_p})
        shipped = _recv_artifacts(conn, {
            "weights": (wman if need_w else None, wpath),
            "programs": (pman if need_p else None, ppath)})
    except (WeightShipError, WireFormatError, WorkerDiedError) as e:
        return _fatal(e)
    if wman is not None:
        spec["weights"] = wpath
    if pman is not None:
        spec["program_set"] = ppath
    key = (json.dumps(attach.get("spec") or {}, sort_keys=True,
                      default=str),
           None if wman is None else wman.get("sha256"),
           None if pman is None else pman.get("sha256"))
    engine = cache.get("engine")
    if engine is None or cache.get("key") != key:
        if engine is not None:
            try:
                engine.close()
            except Exception:
                pass
            cache.update(engine=None, key=None)
        try:
            engine, _sha = _build_engine(spec)
            warm = engine.warmup()
        except Exception as e:  # noqa: BLE001 — boot failure, typed up
            return _fatal(e)
        cache.update(
            engine=engine, key=key, warm=warm,
            weights_sha=None if wman is None else wman.get("sha256"),
            programs_sha=None if pman is None else pman.get("sha256"))
    warm = cache.get("warm") or {}
    try:
        beat_conn = _accept_beat(lsock, epoch, index)
    except (WorkerDiedError, WireFormatError) as e:
        return _fatal(e)
    try:
        conn.send("ready", _ready_header(
            engine, warm, epoch=epoch,
            weights_sha=cache.get("weights_sha"), shipped=shipped))
    except (WorkerDiedError, WireFormatError):
        beat_conn.close()
        conn.close()
        return 5, None
    server = _WorkerServer(engine, conn, None, index, epoch=epoch,
                           beat_conn=beat_conn, manager_silence_s=silence,
                           listener=lsock,
                           weights_sha=cache.get("weights_sha"),
                           cache=cache)
    server._push_beat(force=True)
    rc = server.serve()
    conn.close()
    beat_conn.close()
    return rc, server.pending_attach


def _remote_main(host: str, port: int, index: int) -> int:
    """Standalone remote worker: listen for manager attaches forever,
    serving one epoch-tokened session at a time.  The worker owns its
    own lifetime — a lost or closed manager ends the SESSION (residents
    aborted typed), never the process."""
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind((host, port))
    lsock.listen(4)
    print(f"worker listening on {lsock.getsockname()[0]}:"
          f"{lsock.getsockname()[1]}", flush=True)
    cache = {"key": None, "engine": None, "weights_sha": None,
             "programs_sha": None, "warm": None,
             "dir": tempfile.mkdtemp(prefix=f"pdtorch_rworker{index}_")}
    pending = None
    try:
        while True:
            if pending is not None:
                conn, attach = pending
                pending = None
            else:
                lsock.settimeout(None)
                try:
                    s, _ = lsock.accept()
                except OSError:
                    return 0
                conn = _FrameConn(s, fault_index=index)
                try:
                    attach, _ = _wait_frame(conn, "attach", timeout=30.0)
                except (WorkerDiedError, WireFormatError) as e:
                    print(f"worker: bad attach: {e}", file=sys.stderr,
                          flush=True)
                    conn.close()
                    continue
            rc, pending = _serve_session(lsock, conn, attach, index, cache)
            if rc != 5:
                return rc
    finally:
        try:
            lsock.close()
        except OSError:
            pass
        eng = cache.get("engine")
        if eng is not None:
            try:
                eng.close()
            except Exception:
                pass
        shutil.rmtree(cache["dir"], ignore_errors=True)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="paddle_tpu_torch serving worker process")
    ap.add_argument("--spec",
                    help="json boot spec path (local mode; a remote "
                         "worker receives its spec over the attach "
                         "handshake)")
    ap.add_argument("--port", type=int,
                    help="manager RPC port on 127.0.0.1 (local mode)")
    ap.add_argument("--heartbeat",
                    help="out-of-band heartbeat file path (local mode)")
    ap.add_argument("--index", type=int, default=0,
                    help="worker index (fault-knob target)")
    ap.add_argument("--listen", metavar="HOST:PORT",
                    help="standalone remote mode: listen for manager "
                         "attaches instead of dialing a spawning "
                         "manager (spec + weights arrive over the wire)")
    args = ap.parse_args(argv)

    # post-mortem hook for the failure mode this module exists to
    # survive: SIGUSR1 dumps every thread's stack to the log file, so a
    # wedged worker can be diagnosed before the manager SIGKILLs it
    import faulthandler
    import signal as _signal
    faulthandler.register(_signal.SIGUSR1, file=sys.stderr)

    if args.listen:
        host, _, port = args.listen.rpartition(":")
        try:
            return _remote_main(host or "127.0.0.1", int(port),
                                args.index)
        except KeyboardInterrupt:
            return 0
    if not (args.spec and args.port and args.heartbeat):
        ap.error("local mode requires --spec, --port and --heartbeat "
                 "(or use --listen HOST:PORT for remote mode)")

    hb = _Heartbeat(args.heartbeat)
    hb.beat(0, phase="boot", force=True)
    sock = socket.create_connection(("127.0.0.1", args.port), timeout=30)
    conn = _FrameConn(sock)
    try:
        with open(args.spec) as f:
            spec = json.load(f)
        engine, weights_sha = _build_engine(spec)
        warm = engine.warmup()
        hb.beat(0, phase="warm", force=True)
    except Exception as e:  # boot failure: report typed, exit nonzero
        try:
            conn.send("fatal", {"etype": type(e).__name__,
                                "msg": str(e)[:800]})
        except Exception:
            pass
        return 3
    conn.send("ready", _ready_header(engine, warm,
                                     weights_sha=weights_sha))
    return _WorkerServer(engine, conn, hb, args.index,
                         weights_sha=weights_sha).serve()


# ---------------------------------------------------------------------------
# manager side: WorkerClient (the subprocess replica's engine proxy)
# ---------------------------------------------------------------------------

_WIRE_ERRORS = None


def _error_types():
    global _WIRE_ERRORS
    if _WIRE_ERRORS is None:
        from ..lora import (AdapterExhaustedError, AdapterIntegrityError,
                            AdapterNotFoundError)
        from .engine import NonFiniteLogitsError
        from .kv_pool import KVPoolExhaustedError
        from .transfer import RunTransferError
        _WIRE_ERRORS = {
            "AdapterNotFoundError": AdapterNotFoundError,
            "AdapterExhaustedError": AdapterExhaustedError,
            "AdapterIntegrityError": AdapterIntegrityError,
            "RequestCancelled": RequestCancelled,
            "DeadlineExceededError": DeadlineExceededError,
            "QueueFullError": QueueFullError,
            "NonFiniteLogitsError": NonFiniteLogitsError,
            "KVPoolExhaustedError": KVPoolExhaustedError,
            "RunTransferError": RunTransferError,
            "InvalidArgumentError": InvalidArgumentError,
            "UnavailableError": UnavailableError,
            "ResourceExhaustedError": ResourceExhaustedError,
            "FatalError": FatalError,
            "WireFormatError": WireFormatError,
            "StaleEpochError": StaleEpochError,
            "WeightShipError": WeightShipError,
        }
    return _WIRE_ERRORS


def _mk_error(etype: str, msg: str) -> BaseException:
    cls = _error_types().get(etype)
    if cls is None:
        return UnavailableError(f"worker reported {etype}: {msg}")
    try:
        return cls(msg)
    except Exception:
        return UnavailableError(f"worker reported {etype}: {msg}")


class _ProxyRun:
    """Manager-side mirror of one run resident on (or in flight to) the
    worker — the `.req`/`.resp`/`.produced` duck shape
    `ReplicaManager._on_crash`, `_pump_migrations` and the gateway's
    preemption-victim scan consume from `engine._slots`."""
    __slots__ = ("req", "resp", "cancel_sent")

    def __init__(self, req: Request, resp: Response):
        self.req = req
        self.resp = resp
        self.cancel_sent = False

    @property
    def produced(self) -> int:
        # delivered tokens mirror the worker's committed count closely
        # enough for victim ranking (the only consumer)
        return len(self.resp.tokens_so_far())


class _ProxyScheduler:
    """The client's local admission queue + residency mirror, speaking
    the RequestScheduler surface the fleet consumes.  The queue is
    ENTIRELY local — a request ships to the worker only when a slot
    mirror says it can admit — so `drain_pending` is complete on crash
    and queue-depth backpressure needs no round trip."""

    def __init__(self, client: "WorkerClient"):
        self._c = client
        self._pending: "deque[Tuple[Request, Response]]" = deque()
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)

    @property
    def max_queue_depth(self) -> int:
        return self._c.max_queue_depth

    def submit(self, req: Request, resp: Response, block: bool = False,
               timeout: Optional[float] = None):
        with self._space:
            if len(self._pending) >= self.max_queue_depth and block:
                self._space.wait_for(
                    lambda: len(self._pending) < self.max_queue_depth,
                    timeout=timeout)
            if len(self._pending) >= self.max_queue_depth:
                stat_add("STAT_serving_rejects")
                raise QueueFullError(
                    f"worker replica queue full ({self.max_queue_depth} "
                    "waiting); request rejected")
            self._pending.append((req, resp))

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def occupancy(self) -> int:
        return len(self._c._slots)

    def free_slot_count(self) -> int:
        return max(0, self._c.max_slots - len(self._c._slots))

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._pending) or bool(self._c._slots)

    def release(self, wid):
        self._c._slots.pop(wid, None)

    def drain_pending(self):
        with self._space:
            drained = list(self._pending)
            self._pending.clear()
            self._space.notify_all()
            return drained

    def _pop_sendable(self) -> Optional[Tuple[Request, Response]]:
        """Next queued request that is still worth shipping, failing
        cancelled/expired entries in passing (scheduler.next_admission's
        sweep, client-side)."""
        with self._space:
            while self._pending:
                req, resp = self._pending.popleft()
                self._space.notify()
                if resp.cancelled:
                    stat_add("STAT_serving_cancelled")
                    resp._fail(RequestCancelled(
                        f"request {req.id} cancelled before prefill"))
                    continue
                if req.deadline is not None and req.deadline.expired():
                    stat_add("STAT_serving_deadline_expired")
                    resp._fail(DeadlineExceededError(
                        f"request {req.id} deadline "
                        f"({req.deadline.seconds}s) expired while queued"))
                    continue
                return req, resp
            return None


class WorkerClient:
    """Spawns one subprocess engine worker and implements the
    ServingEngine surface the fleet consumes over its RPC (module
    docstring).  All methods except `scheduler.submit` and `close` must
    run on the fleet's driving thread."""

    def __init__(self, spec: dict, index: int = 0,
                 boot_timeout_s: float = 180.0,
                 rpc_timeout_s: float = 15.0,
                 verb_deadlines: Optional[Dict[str, float]] = None):
        self._init_state(spec, index, boot_timeout_s, rpc_timeout_s,
                         verb_deadlines)
        self._dir = tempfile.mkdtemp(prefix=f"pdtorch_worker{index}_")
        self.heartbeat_path = os.path.join(self._dir, "heartbeat.json")
        self.log_path = os.path.join(self._dir, "worker.log")
        spec_path = os.path.join(self._dir, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(self.spec, f)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(1)
        self._listener.setblocking(False)
        port = self._listener.getsockname()[1]
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = (root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else root)
        self._log_f = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.worker",
             "--spec", spec_path, "--port", str(port),
             "--heartbeat", self.heartbeat_path,
             "--index", str(self.index)],
            stdin=subprocess.DEVNULL, stdout=self._log_f,
            stderr=subprocess.STDOUT, env=env, start_new_session=True)

    def _init_state(self, spec: dict, index: int, boot_timeout_s: float,
                    rpc_timeout_s: float,
                    verb_deadlines: Optional[Dict[str, float]]):
        """Everything both the local (spawned) and remote (attached)
        client share: the engine-surface mirrors, the admission queue,
        the RPC bookkeeping."""
        self.spec = dict(spec)
        self.index = int(index)
        self.boot_timeout_s = float(boot_timeout_s)
        self.rpc_timeout_s = float(rpc_timeout_s)
        # per-verb deadlines on every blocking RPC: a cheap telemetry
        # verb must never consume the full migration budget
        self.verb_deadlines: Dict[str, float] = {
            "metrics": min(5.0, self.rpc_timeout_s),
            "fault": min(5.0, self.rpc_timeout_s)}
        self.verb_deadlines.update(verb_deadlines or {})
        self._conn: Optional[_FrameConn] = None
        # frames read after an RPC's reply, in the same read: the next
        # read takes them first
        self._held: List[Tuple] = []
        self._boot_deadline = time.monotonic() + self.boot_timeout_s
        self._boot_error: Optional[str] = None
        # engine-surface mirrors (filled by the ready handshake)
        self._warm = False
        self.max_slots = 0
        self.max_len = 0
        self.buckets: Tuple[int, ...] = ()
        self.max_queue_depth = int(
            (self.spec.get("engine") or {}).get("max_queue_depth", 64))
        self.draft_model = None  # a sentinel object once the worker has one
        self.kv = "fixed"        # crash-path duck shape; remote kv in spec
        self._manifest: Optional[dict] = None
        self.warmup_report: Optional[dict] = None
        self._slots: Dict[int, _ProxyRun] = {}
        self.scheduler = _ProxyScheduler(self)
        self._status: dict = {}
        self._step_times: List[float] = []
        self._hb_cache = (0.0, None)  # (read_at, record)
        self._rid = 0
        self._wid = 0
        self._rid_lock = threading.Lock()
        self._thread = None          # ReplicaManager.add's loop check
        self._warm_marks = None      # refresh_warm_marks duck slot
        self._closed = False
        self._dead: Optional[BaseException] = None
        self._close_lock = threading.Lock()
        self.epoch = 0               # manager-issued session token
        self.weights_sha: Optional[str] = None
        self._worker_pid: Optional[int] = None

    # -- lifecycle ------------------------------------------------------
    @property
    def pid(self) -> int:
        return self.proc.pid

    @property
    def warm(self) -> bool:
        return self._warm

    def process_alive(self) -> bool:
        return self.proc.poll() is None

    def poll_ready(self) -> bool:
        """Advance the boot handshake without blocking; True once the
        worker reported ready (warm).  Raises WorkerDiedError on boot
        failure / exit / timeout."""
        if self._warm:
            return True
        if self._conn is None:
            try:
                s, _ = self._listener.accept()
                self._conn = _FrameConn(s)
                self._listener.close()
            except (BlockingIOError, OSError):
                pass
        if self._conn is not None:
            try:
                for frame in self._frames(0.0):
                    self._dispatch(frame)
            except WorkerDiedError:
                pass  # fall through to the death checks below
        if self._warm:
            return True
        if self._boot_error is not None:
            raise WorkerDiedError(
                f"worker {self.index} failed to boot: {self._boot_error} "
                f"(log: {self.log_path})")
        if self.proc.poll() is not None:
            raise WorkerDiedError(
                f"worker {self.index} exited rc={self.proc.returncode} "
                f"during boot (log: {self.log_path})")
        if time.monotonic() > self._boot_deadline:
            raise WorkerDiedError(
                f"worker {self.index} did not become ready within "
                f"{self.boot_timeout_s}s (log: {self.log_path})")
        return False

    def warmup(self) -> dict:
        """Block until the worker's boot warmup finished (it warms
        itself; this just waits out the handshake)."""
        while not self.poll_ready():
            time.sleep(0.01)
        return dict(self.warmup_report or {}, worker_pid=self.pid)

    # -- frame dispatch -------------------------------------------------
    def _dispatch(self, frame):
        verb, h, arrays = frame
        if verb == "chunk":
            run = self._slots.get(h.get("wid"))
            if run is not None:
                toks = arrays["toks"].tolist()
                logps = arrays.get("logps")
                logps = (logps.tolist() if logps is not None
                         else [0.0] * len(toks))
                for tok, lp in zip(toks, logps):
                    run.resp._push_token(int(tok), float(lp))
        elif verb == "done":
            run = self._slots.pop(h.get("wid"), None)
            if run is not None:
                run.resp._finish(h.get("reason") or "length")
        elif verb == "failed":
            run = self._slots.pop(h.get("wid"), None)
            if run is not None:
                run.resp._fail(_mk_error(h.get("etype", ""),
                                         h.get("msg", "")))
        elif verb == "status":
            self._status = h
            st = arrays.get("step_s")
            if st is not None and st.size:
                self._step_times.extend(float(x) for x in st)
        elif verb == "ready":
            cfg = h.get("config") or {}
            self.max_slots = int(cfg.get("max_slots", 0))
            self.max_len = int(cfg.get("max_len", 0))
            self.buckets = tuple(int(b) for b in cfg.get("buckets", ()))
            self.max_queue_depth = int(cfg.get("max_queue_depth",
                                               self.max_queue_depth))
            if cfg.get("has_draft"):
                self.draft_model = object()  # truthy `is not None` duck
            self._manifest = h.get("manifest")
            self.warmup_report = h.get("warmup")
            self._worker_pid = cfg.get("pid")
            self.weights_sha = h.get("weights_sha", self.weights_sha)
            # drop the heartbeat cache: the last cached record predates
            # warmup (the long no-beat boot window), and the wedge fence
            # must never judge a freshly-healthy worker by it
            self._hb_cache = (0.0, None)
            self._warm = True
        elif verb == "fatal":
            self._boot_error = f"{h.get('etype')}: {h.get('msg')}"
        elif verb == "dying":
            self._dead = _mk_error(h.get("etype", ""), h.get("msg", ""))
        elif verb in ("bye", "log", "metrics", "preempted", "restored",
                      "accepted", "attach_ok", "swap_ready", "swapped",
                      "adapter_ready", "adapter_loaded"):
            pass  # bye/log informational; RPC replies consumed by _rpc;
            #       accepted acks matter only to the remote subclass

    def _rpc(self, verb: str, header: dict, arrays: Optional[dict],
             reply_verb: str,
             timeout_s: Optional[float] = None) -> Tuple[dict, dict]:
        """Send one frame and pump until its reply arrives, dispatching
        unrelated frames (chunks/status) normally.  Every blocking RPC
        runs under its own per-verb deadline (`verb_deadlines`, default
        `rpc_timeout_s`); timeout or process death -> WorkerDiedError
        (the wedged-worker verdict)."""
        if self._conn is None:
            raise WorkerDiedError(f"worker {self.index} has no connection")
        budget = (timeout_s if timeout_s is not None
                  else self.verb_deadlines.get(verb, self.rpc_timeout_s))
        self._conn.send(verb, header, arrays)
        return self._await(reply_verb, header.get("wid"), budget, verb)

    def _frames(self, max_wait: float) -> List[Tuple]:
        """The frames an RPC's reply held back, else the socket's."""
        if self._held:
            held, self._held = self._held, []
            return held
        return self._conn.recv_frames(max_wait)

    def _await(self, reply_verb: str, wid, budget: float,
               what: str) -> Tuple[dict, dict]:
        """Pump frames until ``reply_verb`` for ``wid`` arrives,
        dispatching the others.  The frames read after the reply in the
        same read are held for the next read, not dropped: a restore's
        first token chunk may come in right behind its reply, before the
        caller has registered the run it belongs to."""
        deadline = time.monotonic() + budget
        while True:
            if self.proc.poll() is not None:
                raise WorkerDiedError(
                    f"worker {self.index} exited rc={self.proc.returncode} "
                    f"mid-RPC ({what})")
            frames = self._frames(0.01)
            for i, frame in enumerate(frames):
                v, h, _ = frame
                if v == reply_verb and h.get("wid") == wid:
                    self._held = frames[i + 1:]
                    return h, frame[2]
                self._dispatch(frame)
            if time.monotonic() > deadline:
                raise WorkerDiedError(
                    f"worker {self.index} RPC {what!r} timed out after "
                    f"{budget}s — wedged, partitioned or overloaded "
                    "beyond the liveness budget")

    # -- engine surface: admission -------------------------------------
    def make_request(self, prompt, max_new_tokens: int,
                     decode_strategy: str = "greedy_search",
                     temperature=1.0, top_k=0, top_p=1.0,
                     eos_token_id: Optional[int] = None,
                     seed: Optional[int] = None,
                     deadline: Optional[float] = None, priority: int = 0,
                     tenant: Optional[str] = None,
                     spec: Optional[bool] = None,
                     session: Optional[str] = None,
                     resubmit: bool = False,
                     adapter: Optional[str] = None):
        """ServingEngine.make_request's validation against the worker's
        handshake config — no round trip; the worker re-validates on its
        side and any disagreement comes back as a typed `failed`.
        `adapter` names a LoRA adapter in the WORKER's registry; the
        name cannot be resolved from here, so an unknown adapter fails
        the response typed (AdapterNotFoundError) at worker admission
        rather than at this call — still terminal, never a hung
        consumer."""
        if self._closed:
            raise UnavailableError("worker replica is closed")
        if self._dead is not None:
            raise UnavailableError(
                f"worker {self.index} died: {self._dead!r}")
        if not self._warm:
            raise UnavailableError(
                f"worker {self.index} is still booting")
        if decode_strategy not in ("greedy_search", "sampling"):
            raise InvalidArgumentError(
                f"serving supports 'greedy_search' or 'sampling', got "
                f"{decode_strategy!r}")
        if spec is None:
            spec = self.draft_model is not None
        elif spec and self.draft_model is None:
            raise InvalidArgumentError(
                "spec=True requires the worker engine to be built with "
                "a draft model")
        if resubmit and decode_strategy != "greedy_search":
            raise InvalidArgumentError(
                "resubmit=True (re-prefill-from-prompt crash recovery) "
                "is greedy-only: a replayed sampled stream is not "
                "covered by any engine contract — drop resubmit or use "
                "greedy_search")
        with self._rid_lock:
            rid = self._rid
            self._rid += 1
        req = Request(rid, prompt, max_new_tokens,
                      greedy=decode_strategy == "greedy_search",
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      eos_token_id=eos_token_id,
                      seed=seed if seed is not None else rid,
                      deadline=deadline, priority=priority, tenant=tenant,
                      spec=bool(spec), session=session, resubmit=resubmit,
                      adapter=adapter)
        plen = req.prompt.shape[0]
        if plen > self.buckets[-1]:
            stat_add("STAT_serving_rejects")
            raise InvalidArgumentError(
                f"prompt length {plen} exceeds the largest prefill "
                f"bucket {self.buckets[-1]} (worker max_len="
                f"{self.max_len})")
        if plen + req.max_new_tokens > self.max_len:
            stat_add("STAT_serving_rejects")
            raise InvalidArgumentError(
                f"prompt ({plen}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds the worker's max_len "
                f"{self.max_len}")
        stat_add("STAT_serving_requests")
        return req, Response(req)

    def try_admit(self, req: Request, resp: Response) -> bool:
        """Ship NOW if the residency mirror has room (the gateway's
        direct-admission path; driving thread only)."""
        if self._closed or not self._warm or self._conn is None:
            return False
        if self.scheduler.free_slot_count() <= 0:
            return False
        try:
            self._ship(req, resp)
        except WorkerDiedError as e:
            # admission must answer False, not blow up the gateway loop;
            # the next fleet tick's step() re-raises and fences us
            self._dead = self._dead or e
            return False
        return True

    def _submit_header(self, req: Request, wid: int) -> dict:
        return {"wid": wid, "max_new_tokens": req.max_new_tokens,
                "decode_strategy": ("greedy_search" if req.greedy
                                    else "sampling"),
                "temperature": req.temperature, "top_k": req.top_k,
                "top_p": req.top_p, "eos_token_id": req.eos_token_id,
                "seed": req.seed,
                "deadline_remaining_s": (None if req.deadline is None
                                         else req.deadline.remaining()),
                "priority": req.priority, "tenant": req.tenant,
                "spec": bool(req.spec) if self.draft_model is not None
                else False,
                "session": req.session, "resubmit": req.resubmit,
                "adapter": req.adapter}

    def _ship(self, req: Request, resp: Response):
        wid = self._wid
        self._wid += 1
        self._conn.send("submit", self._submit_header(req, wid),
                        {"prompt": req.prompt})
        self._slots[wid] = _ProxyRun(req, resp)

    # -- engine surface: the driving tick ------------------------------
    def step(self) -> bool:
        """One pump: propagate cancels, ship queued requests into free
        slots, drain inbound frames.  Raises WorkerDiedError when the
        process is gone — the fleet tick's crash path."""
        if self._closed or self._conn is None:
            return False
        did = False
        for wid, run in list(self._slots.items()):
            if run.resp.cancelled and not run.cancel_sent:
                self._conn.send("cancel", {"wid": wid})
                run.cancel_sent = True
                did = True
        while self.scheduler.free_slot_count() > 0:
            nxt = self.scheduler._pop_sendable()
            if nxt is None:
                break
            self._ship(*nxt)
            did = True
        try:
            frames = self._frames(0.0)
        except WorkerDiedError:
            if self.proc.poll() is not None:
                raise WorkerDiedError(
                    f"worker {self.index} exited "
                    f"rc={self.proc.returncode} (log: {self.log_path})")
            raise
        for frame in frames:
            self._dispatch(frame)
            did = True
        if self._dead is not None:
            raise WorkerDiedError(
                f"worker {self.index} step loop died: {self._dead!r}")
        if self.proc.poll() is not None:
            raise WorkerDiedError(
                f"worker {self.index} exited rc={self.proc.returncode} "
                f"(log: {self.log_path})")
        return did

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def take_step_times(self) -> List[float]:
        """Worker-reported per-step wall times since the last call —
        the fleet health EWMA's input (pump time on this side measures
        nothing)."""
        ts, self._step_times = self._step_times, []
        return ts

    def _heartbeat(self) -> Optional[dict]:
        """Last heartbeat record, re-read at most every 50ms — the tick
        polls this per replica, and age resolution far below the fence
        threshold buys nothing for a file read per tick."""
        now = time.monotonic()
        read_at, rec = self._hb_cache
        if now - read_at > 0.05:
            rec = read_heartbeat(self.heartbeat_path)
            self._hb_cache = (now, rec)
        return rec

    def heartbeat_age(self, fresh: bool = False) -> Optional[float]:
        """Seconds since the worker's last out-of-band heartbeat write,
        or None before the first beat.  Computed on the shared
        CLOCK_MONOTONIC timeline (wall clock only as a legacy fallback)
        so an NTP step cannot falsely wedge the fleet.  `fresh=True`
        bypasses the 50ms cache — the fence decision re-reads the file
        so a cached pre-warmup record can never wedge-fence a healthy
        worker."""
        if fresh:
            self._hb_cache = (0.0, None)
        d = self._heartbeat()
        if d is None:
            return None
        try:
            if "mono" in d:
                return max(0.0, time.monotonic() - float(d["mono"]))
            return max(0.0, time.time() - float(d["time"]))
        except (TypeError, ValueError, KeyError):
            return None

    def heartbeat_steps(self) -> Optional[int]:
        d = self._heartbeat()
        try:
            return None if d is None else int(d["steps"])
        except (TypeError, ValueError, KeyError):
            return None

    # -- engine surface: migration -------------------------------------
    def transfer_manifest(self) -> dict:
        """The restore-compatibility descriptor the worker computed at
        boot — `transfer.check_compatible`'s target view of this
        replica."""
        if self._manifest is None:
            raise UnavailableError(
                f"worker {self.index} has not completed its handshake")
        return self._manifest

    def preempt_slot(self, wid) -> "object":
        """Preempt the run tracked under `wid` on the worker and decode
        its snapshot against the ORIGINAL req/resp (the consumer's
        stream object survives the move, exactly like the in-process
        path).  WorkerDiedError on RPC failure; InvalidArgumentError if
        the run finished in the race window."""
        from .transfer import decode_run, run_from_bytes
        run = self._slots.get(wid)
        if run is None:
            raise InvalidArgumentError(f"wid {wid} holds no active run")
        h, a = self._rpc("preempt", {"wid": wid}, None, "preempted")
        if not h.get("ok"):
            raise InvalidArgumentError(
                f"wid {wid} is not resident on worker {self.index} "
                f"({h.get('reason')})")
        blob = run_from_bytes(a["run"].tobytes())
        paused = decode_run(blob, req=run.req, resp=run.resp)
        self._slots.pop(wid, None)
        run.req.preempts += 1
        stat_add("STAT_serving_preemptions")
        return paused

    def restore_run(self, paused) -> bool:
        """Restore a (possibly cross-replica) snapshot onto the worker.
        False on capacity; typed RunTransferError if the worker rejects
        the snapshot as incompatible (its engine re-checks)."""
        from .transfer import RunTransferError, encode_run, run_to_bytes
        if self._closed or not self._warm or self._conn is None:
            return False
        if self.scheduler.free_slot_count() <= 0:
            return False
        blob = run_to_bytes(encode_run(paused))
        wid = self._wid
        self._wid += 1
        h, _ = self._rpc("restore", {"wid": wid},
                         {"run": np.frombuffer(blob, np.uint8).copy()},
                         "restored")
        if h.get("ok"):
            self._slots[wid] = _ProxyRun(paused.req, paused.resp)
            paused.req.resumes += 1
            paused.req.paused_seconds += (time.monotonic()
                                          - paused.preempted_at)
            stat_add("STAT_serving_resumes")
            return True
        if h.get("etype") == "RunTransferError":
            raise RunTransferError(
                f"worker {self.index} rejected the run snapshot: "
                f"{h.get('msg')}")
        return False

    # -- engine surface: telemetry -------------------------------------
    def adapter_shas(self):
        """name -> artifact sha reported in the worker's latest status
        frame (cheap cached read for fleet health snapshots)."""
        lora = (self._status.get("metrics") or {}).get("lora") or {}
        return lora.get("shas") or None

    def metrics(self, fresh: bool = False) -> dict:
        """The engine report of the worker's latest status frame (or, with
        ``fresh``, of a ``metrics`` RPC now, which adds the program
        registry's records), plus ``process`` (the worker process's kernel
        launch counts, program replays, pid, device and loaded modules)
        and this client's view under ``worker``."""
        if fresh:
            wid = self._wid
            self._wid += 1
            h, _ = self._rpc("metrics", {"wid": wid}, None, "metrics")
            m = dict(h.get("metrics") or {})
            m["process"] = h.get("process")
        else:
            m = dict(self._status.get("metrics") or {})
            m["process"] = self._status.get("process")
        m["queue_depth"] = self.scheduler.queue_depth()
        m["slot_occupancy"] = len(self._slots)
        m["worker"] = {"pid": self.pid, "index": self.index,
                       "alive": self.process_alive(),
                       "steps": self._status.get("steps"),
                       "heartbeat_age_s": self.heartbeat_age(),
                       "log": self.log_path}
        return m

    def post_warmup_compiles(self) -> int:
        if not self._warm:
            return -1
        v = self._status.get("post_warmup_compiles")
        return 0 if v is None else int(v)

    def _compile_marks(self) -> dict:
        # the worker's program registry lives in ITS process: peers'
        # warmups can never pollute it, so there is nothing to re-mark
        return {"engine": 0, "registry": {}}

    def set_fault(self, point: str, value: Optional[str]):
        """Arm/disarm a utils.faults knob INSIDE the worker process
        (env vars set after spawn don't cross the boundary)."""
        if self._conn is None:
            raise WorkerDiedError(
                f"worker {self.index} has no connection")
        self._conn.send("fault", {"point": point, "value": value})

    # -- engine surface: continuous weight refresh ---------------------
    def swap_weights(self, path: str, sha: Optional[str] = None,
                     timeout_s: float = 60.0) -> str:
        """Flip the worker's served weights to the npz artifact at
        `path` (same host — the spawned worker shares our filesystem)
        with nothing captured again.  The worker verifies `sha` against the
        file before a byte reaches its engine; any rejection comes back
        as the typed error (WeightShipError for corrupt artifacts,
        InvalidArgumentError for shape mismatches) and the worker keeps
        serving its OLD weights.  Returns the served sha.  Driving
        thread only; the fleet calls this at the replica's idle
        boundary."""
        if self._conn is None:
            raise WorkerDiedError(
                f"worker {self.index} has no connection")
        wid = self._wid
        self._wid += 1
        h, _ = self._rpc("swap_weights",
                         {"wid": wid, "path": path, "sha256": sha},
                         None, "swapped", timeout_s=timeout_s)
        if not h.get("ok"):
            raise _mk_error(h.get("etype", ""), h.get("msg", ""))
        self.weights_sha = h.get("weights_sha", sha)
        return self.weights_sha

    # -- engine surface: multi-tenant LoRA hot-load --------------------
    def load_adapter(self, name: str, path: str,
                     sha: Optional[str] = None,
                     timeout_s: float = 60.0, retries: int = 1) -> str:
        """Page the adapter artifact at `path` (same host — the spawned
        worker shares our filesystem) into the worker's registry under
        `name`, with nothing captured again.  The worker verifies the artifact
        before a factor reaches its device stacks; a corrupt read comes
        back typed (AdapterIntegrityError) and is re-shipped once
        (`retries`) — the supervised re-ship path, the registry never
        holds garbage factors.  A persistent or non-retryable failure
        (unknown base hash, rank mismatch, all slots pinned) propagates
        typed.  Returns the resident artifact's sha256.  Driving thread
        only."""
        if self._conn is None:
            raise WorkerDiedError(
                f"worker {self.index} has no connection")
        attempts = max(1, int(retries) + 1)
        for i in range(attempts):
            wid = self._wid
            self._wid += 1
            h, _ = self._rpc("load_adapter",
                             {"wid": wid, "name": name, "path": path,
                              "sha256": sha},
                             None, "adapter_loaded", timeout_s=timeout_s)
            if h.get("ok"):
                return h.get("file_sha")
            err = _mk_error(h.get("etype", ""), h.get("msg", ""))
            retryable = h.get("etype") in ("AdapterIntegrityError",
                                           "WeightShipError")
            if not retryable or i == attempts - 1:
                raise err
            stat_add("STAT_lora_ship_reships")
        raise err  # unreachable; loop always returns or raises

    # -- engine surface: teardown --------------------------------------
    def _abort_all(self, make_exc):
        for wid, run in list(self._slots.items()):
            run.resp._fail(make_exc(run.req))
        self._slots.clear()
        for req, resp in self.scheduler.drain_pending():
            resp._fail(make_exc(req))

    def kill(self):
        """SIGKILL + reap.  Idempotent: a second kill of an
        already-dead (or already-reaped) pid is a no-op."""
        try:
            self.proc.kill()  # no-op once returncode is set
        except (ProcessLookupError, OSError):
            pass
        try:
            self.proc.wait(timeout=5)
        except Exception:
            pass

    def close(self, graceful: bool = True):
        """Stop the worker and reap the process (no orphans, no
        zombies), failing anything still outstanding.  `graceful=True`
        asks the worker to exit first and gives it 2s; the fleet passes
        `graceful=False` for crashed/wedged corpses — a wedged process
        would never read the close verb and the 2s wait would stall the
        driving thread (and every healthy replica) for nothing.
        Idempotent and safe under concurrent double-close (the
        engine/gateway/fleet contract)."""
        self._closed = True
        with self._close_lock:
            if graceful:
                if self._conn is not None:
                    try:
                        self._conn.send("close", {})
                    except (WorkerDiedError, WireFormatError):
                        pass
                try:
                    self.proc.wait(timeout=2.0)
                except Exception:
                    pass
            self.kill()
            if self._conn is not None:
                self._conn.close()
            try:
                self._listener.close()
            except OSError:
                pass
            try:
                self._log_f.close()
            except OSError:
                pass
            self._abort_all(lambda req: RequestCancelled(
                f"request {req.id} aborted: worker replica closed"))
            shutil.rmtree(self._dir, ignore_errors=True)


class _NullProc:
    """Remote workers have no local child process: the base client's
    poll/kill/wait liveness checks become no-ops against this stub —
    death is decided on the wire (beat age + connection loss), never by
    a pid this host does not own."""
    pid = -1
    returncode: Optional[int] = None

    def poll(self):
        return None

    def kill(self):
        pass

    def wait(self, timeout=None):
        return None


class RemoteWorkerClient(WorkerClient):
    """Manager-side handle for a STANDALONE remote worker started with
    ``--listen HOST:PORT`` — the network-transparent half of the fleet.
    Differences from the spawned-local base:

    - **Attach, not fork**: connects over real TCP, sends an `attach`
      carrying the manager-issued `epoch` token, the boot spec, and
      the manifest of the weight artifact (``spec["weights"]``, a
      jit.save npz) and, with ``spec["ship_program_set"]``, of the
      program set at ``spec["program_set"]`` — then streams them as
      sha256-verified chunks.  The worker replies
      `attach_ok` with what it actually needs, so a re-attach onto a
      warm cached engine ships zero bytes and rebuilds nothing.
    - **Liveness on the wire**: a dedicated beat side connection carries
      the worker's step counter; `heartbeat_age` is the ARRIVAL age of
      the last beat on THIS host's monotonic clock (the worker's stamps
      belong to another machine's timeline), so the manager's wedge
      fence works unchanged with no heartbeat file at all.
    - **Partition-safe submits**: every submit is acked (`accepted`) and
      retried on ack timeout; the worker dedups on wid, so a retried
      submit after a lost ack can never double-admit.  Frames from a
      stale epoch are answered with `abort_epoch` — a healed worker is
      told to abort, never to resume.
    """

    def __init__(self, spec: dict, address: str, index: int = 0,
                 epoch: int = 1, boot_timeout_s: float = 180.0,
                 rpc_timeout_s: float = 15.0,
                 connect_timeout_s: float = 10.0,
                 manager_silence_s: float = 6.0,
                 ack_timeout_s: float = 2.0, submit_retries: int = 2,
                 verb_deadlines: Optional[Dict[str, float]] = None):
        from .transfer import artifact_manifest
        self._init_state(spec, index, boot_timeout_s, rpc_timeout_s,
                         verb_deadlines)
        host, _, port = str(address).rpartition(":")
        if not port:
            raise InvalidArgumentError(
                f"remote worker address {address!r} must be HOST:PORT")
        self.address = (host or "127.0.0.1", int(port))
        self.epoch = int(epoch)
        self.manager_silence_s = float(manager_silence_s)
        self.ack_timeout_s = float(ack_timeout_s)
        self.submit_retries = int(submit_retries)
        self.proc = _NullProc()
        self.heartbeat_path = None  # liveness is beat FRAMES, not a file
        self.log_path = f"<remote {self.address[0]}:{self.address[1]}>"
        self.bytes_shipped = 0
        self._beat_conn: Optional[_FrameConn] = None
        self._last_beat: Optional[dict] = None
        self._last_beat_rx: Optional[float] = None  # ARRIVAL mono stamp
        self._await_ack: Dict[int, list] = {}
        self._last_tx = time.monotonic()
        # shipped artifacts come OUT of the wire spec: their paths are
        # THIS host's, meaningless on the worker's filesystem
        wire_spec = dict(self.spec)
        self._weights_path = wire_spec.pop("weights", None)
        self._programs_path = None
        if wire_spec.pop("ship_program_set", False):
            self._programs_path = wire_spec.pop("program_set", None)
        self._wire_spec = wire_spec
        self._weights_man = (None if self._weights_path is None
                             else artifact_manifest(self._weights_path))
        self._programs_man = (None if self._programs_path is None
                              else artifact_manifest(self._programs_path))
        self._hs_state = "connect"
        self._connect(float(connect_timeout_s))

    # -- attach handshake ----------------------------------------------
    def _connect(self, connect_timeout_s: float):
        deadline = time.monotonic() + connect_timeout_s
        while True:
            try:
                sock = socket.create_connection(self.address, timeout=2.0)
                break
            except OSError as e:
                if time.monotonic() > deadline:
                    raise WorkerDiedError(
                        f"could not reach remote worker at "
                        f"{self.address[0]}:{self.address[1]}: {e!r}")
                time.sleep(0.1)
        self._conn = _FrameConn(sock, fault_index=self.index)
        self._conn.send("attach", {
            "epoch": self.epoch, "index": self.index,
            "silence_s": self.manager_silence_s,
            "spec": self._wire_spec,
            "weights": self._weights_man,
            "programs": self._programs_man})
        self._hs_state = "attach_sent"
        self._last_tx = time.monotonic()

    def _ship_artifacts(self, need_weights: bool, need_programs: bool):
        import hashlib
        from .transfer import iter_artifact_chunks
        for need, path, verb in (
                (need_weights, self._weights_path, "weights_chunk"),
                (need_programs, self._programs_path, "program_chunk")):
            if not need:
                continue
            if path is None:
                raise WorkerDiedError(
                    f"worker requested {verb} but the spec ships none")
            for seq, data in iter_artifact_chunks(path):
                self._conn.send(
                    verb,
                    {"seq": seq,
                     "sha256": hashlib.sha256(data).hexdigest()},
                    {"data": np.frombuffer(data, np.uint8).copy()})
                self.bytes_shipped += len(data)
        self._conn.send("attach_end", {})
        self._last_tx = time.monotonic()
        if self.bytes_shipped:
            stat_add("STAT_fleet_weight_bytes_shipped",
                     self.bytes_shipped)

    def _open_beat_conn(self):
        try:
            s = socket.create_connection(self.address, timeout=5.0)
        except OSError as e:
            raise WorkerDiedError(
                f"beat side-connection to {self.address[0]}:"
                f"{self.address[1]} failed: {e!r}")
        self._beat_conn = _FrameConn(s, fault_index=self.index)
        self._beat_conn.send("beat_attach", {"epoch": self.epoch,
                                             "index": self.index})

    def poll_ready(self) -> bool:
        if self._warm:
            return True
        try:
            for frame in self._frames(0.0):
                v, h, a = frame
                if v == "attach_ok" and self._hs_state == "attach_sent":
                    self._ship_artifacts(bool(h.get("need_weights")),
                                         bool(h.get("need_programs")))
                    self._open_beat_conn()
                    self._hs_state = "await_ready"
                else:
                    self._dispatch(frame)
        except WorkerDiedError as e:
            if self._boot_error is None:
                self._boot_error = f"connection lost mid-attach: {e}"
        if self._warm:
            return True
        if self._boot_error is not None:
            raise WorkerDiedError(
                f"remote worker {self.index} at {self.log_path} failed "
                f"to attach: {self._boot_error}")
        if time.monotonic() > self._boot_deadline:
            raise WorkerDiedError(
                f"remote worker {self.index} at {self.log_path} not "
                f"ready within {self.boot_timeout_s}s")
        return False

    # -- epoch-fenced dispatch -----------------------------------------
    def _dispatch(self, frame):
        verb, h, a = frame
        ep = h.get("epoch")
        if ep is not None and int(ep) != self.epoch and verb != "fatal":
            # a frame from another session epoch of this worker: tell it
            # to abort — its runs were already resubmitted elsewhere and
            # a resumed stale stream would double-serve tokens
            try:
                self._conn.send("abort_epoch", {"epoch": int(ep)})
            except (WorkerDiedError, WireFormatError):
                pass
            return
        if verb == "accepted":
            self._await_ack.pop(h.get("wid"), None)
            return
        super()._dispatch(frame)

    # -- partition-safe submits ----------------------------------------
    def _ship(self, req: Request, resp: Response):
        wid = self._wid
        self._wid += 1
        h = self._submit_header(req, wid)
        prompt = np.asarray(req.prompt, np.int32)
        # the worker dedups on wid, so a retried submit is idempotent: a
        # lost ack can cost a resend, never a double admission
        self._await_ack[wid] = [time.monotonic() + self.ack_timeout_s,
                                self.submit_retries, h, prompt]
        # register the run BEFORE the send: a submit cut mid-frame (net
        # drop) raises out of send() after the request already left the
        # scheduler — it must sit in _slots so the fleet's failover
        # sweep can resubmit it instead of orphaning the consumer
        self._slots[wid] = _ProxyRun(req, resp)
        self._conn.send("submit", h, {"prompt": prompt})
        self._last_tx = time.monotonic()

    def _pump_acks(self):
        now = time.monotonic()
        for wid in list(self._await_ack):
            if wid not in self._slots:
                # done/failed landed first: the stream already answered
                self._await_ack.pop(wid, None)
                continue
            entry = self._await_ack[wid]
            if now < entry[0]:
                continue
            if entry[1] <= 0:
                self._await_ack.pop(wid, None)
                run = self._slots.pop(wid, None)
                if run is not None:
                    run.resp._fail(WorkerDiedError(
                        f"request {run.req.id}: remote worker "
                        f"{self.index} never acknowledged submit "
                        f"wid={wid} ({self.submit_retries} retries)"))
                continue
            entry[0] = now + self.ack_timeout_s
            entry[1] -= 1
            self._conn.send("submit", entry[2], {"prompt": entry[3]})
            self._last_tx = now

    def _maybe_ping(self):
        """Keep the worker's manager-silence clock fed while idle — a
        quiet-but-connected manager must not look like a partition."""
        now = time.monotonic()
        if now - self._last_tx < self.manager_silence_s / 3.0:
            return
        self._conn.send("ping", {})
        self._last_tx = now

    def step(self) -> bool:
        if self._closed or self._conn is None:
            return False
        did = super().step()
        self._pump_acks()
        self._drain_beats()
        self._maybe_ping()
        return did

    # -- liveness on the wire ------------------------------------------
    def _drain_beats(self):
        if self._beat_conn is None:
            return
        try:
            frames = self._beat_conn.recv_frames(0.0)
        except (WorkerDiedError, WireFormatError):
            return  # a dead beat channel reads as staleness — the safe
            #         direction for a fence
        for v, h, _ in frames:
            if v != "beat":
                continue
            ep = h.get("epoch")
            if ep is not None and int(ep) != self.epoch:
                continue  # a stale session's beat proves nothing
            self._last_beat = h
            self._last_beat_rx = time.monotonic()

    def _note_verdict(self):
        """A long verb's verdict comes from the worker's loop after the
        verb's work: progress, aged like a beat (the beat the worker sent
        before it rides another connection and may land later)."""
        self._last_beat_rx = time.monotonic()

    def heartbeat_age(self, fresh: bool = False) -> Optional[float]:
        """Age of the last beat FRAME, clocked on ARRIVAL (this host's
        monotonic clock — the worker's stamps belong to another
        machine's timeline).  None before the first beat, exactly like
        the file path during boot.  The file path's 50ms cache has no
        analogue: draining a socket is cheap."""
        self._drain_beats()
        if self._last_beat_rx is None:
            return None
        return max(0.0, time.monotonic() - self._last_beat_rx)

    def heartbeat_steps(self) -> Optional[int]:
        self._drain_beats()
        try:
            return (None if self._last_beat is None
                    else int(self._last_beat["steps"]))
        except (TypeError, ValueError, KeyError):
            return None

    def process_alive(self) -> bool:
        # no pid to poll across a network: the session being open and
        # un-dead IS aliveness; staleness is heartbeat_age's verdict
        return not self._closed and self._dead is None

    # -- continuous weight refresh over the wire -----------------------
    def swap_weights(self, path: str, sha: Optional[str] = None,
                     timeout_s: float = 120.0) -> str:
        """Ship the artifact at `path` to the remote worker and flip it
        in, nothing captured again.  Two phases: the manifest goes first and
        the chunk stream starts only after the worker's `swap_ready`
        ack, so no chunk can land inside an unrelated frame batch.
        Every chunk and the assembled file are sha256-verified on the
        worker; a corrupt artifact is refused there (typed
        WeightShipError here) with the old weights still serving."""
        import hashlib
        from .transfer import artifact_manifest, iter_artifact_chunks
        if self._conn is None:
            raise WorkerDiedError(
                f"worker {self.index} has no connection")
        man = artifact_manifest(path)
        if sha is not None and man.get("sha256") != sha:
            raise WeightShipError(
                f"weight artifact {path!r} sha256 {man.get('sha256')} "
                f"!= published {sha} — refusing to ship a corrupt "
                "artifact")
        sha = man.get("sha256")
        wid = self._wid
        self._wid += 1
        self._rpc("swap_weights",
                  {"wid": wid, "sha256": sha, "manifest": man},
                  None, "swap_ready", timeout_s=timeout_s)
        for seq, data in iter_artifact_chunks(path):
            self._conn.send(
                "weights_chunk",
                {"seq": seq, "sha256": hashlib.sha256(data).hexdigest()},
                {"data": np.frombuffer(data, np.uint8).copy()})
            self.bytes_shipped += len(data)
        self._conn.send("attach_end", {})
        self._last_tx = time.monotonic()
        h, _ = self._await("swapped", wid, timeout_s, "swap_weights")
        self._note_verdict()
        if not h.get("ok"):
            raise _mk_error(h.get("etype", ""), h.get("msg", ""))
        self.weights_sha = h.get("weights_sha", sha)
        return self.weights_sha

    # -- multi-tenant LoRA: adapter hot-load over the wire --------------
    def load_adapter(self, name: str, path: str,
                     sha: Optional[str] = None,
                     timeout_s: float = 120.0, retries: int = 1) -> str:
        """Ship the adapter artifact at `path` to the remote worker and
        page it into the registry, nothing captured again.  Manifest-first:
        the chunk stream starts only after the worker's `adapter_ready`
        ack; if the worker already holds the identically-hashed
        artifact under `name` it answers `cached: True` and ZERO bytes
        ship (the re-attach path).  Every chunk and the assembled file
        are sha256-verified on the worker; a corrupt chunk or a
        poisoned read is refused there typed and re-shipped once
        (`retries`) — garbage factors never reach the registry."""
        import hashlib
        from .transfer import artifact_manifest, iter_artifact_chunks
        if self._conn is None:
            raise WorkerDiedError(
                f"worker {self.index} has no connection")
        man = artifact_manifest(path)
        if sha is not None and man.get("sha256") != sha:
            raise WeightShipError(
                f"adapter artifact {path!r} sha256 {man.get('sha256')} "
                f"!= published {sha} — refusing to ship a corrupt "
                "artifact")
        sha = man.get("sha256")
        attempts = max(1, int(retries) + 1)
        for i in range(attempts):
            wid = self._wid
            self._wid += 1
            rh, _ = self._rpc("load_adapter",
                              {"wid": wid, "name": name, "sha256": sha,
                               "manifest": man},
                              None, "adapter_ready", timeout_s=timeout_s)
            if not rh.get("cached"):
                for seq, data in iter_artifact_chunks(path):
                    self._conn.send(
                        "adapter_chunk",
                        {"seq": seq,
                         "sha256": hashlib.sha256(data).hexdigest()},
                        {"data": np.frombuffer(data, np.uint8).copy()})
                    self.bytes_shipped += len(data)
                    stat_add("STAT_lora_ship_bytes", len(data))
                self._conn.send("attach_end", {})
                self._last_tx = time.monotonic()
            h, _ = self._await("adapter_loaded", wid, timeout_s,
                               "load_adapter")
            self._note_verdict()
            if h.get("ok"):
                return h.get("file_sha", sha)
            err = _mk_error(h.get("etype", ""), h.get("msg", ""))
            retryable = isinstance(err, (WeightShipError,)) or (
                type(err).__name__ == "AdapterIntegrityError")
            if not retryable or i == attempts - 1:
                raise err
            stat_add("STAT_lora_ship_reships")
        raise err  # unreachable; loop always returns or raises

    @property
    def pid(self) -> int:
        return -1 if self._worker_pid is None else int(self._worker_pid)

    # -- teardown -------------------------------------------------------
    def kill(self):
        """No SIGKILL crosses a network: drop both connections.  The
        worker sees manager-loss (or manager silence) and self-aborts
        its residents typed — the fence holds without owning the
        process."""
        for c in (self._conn, self._beat_conn):
            if c is not None:
                c.close()

    def close(self, graceful: bool = True):
        """Detach from the worker (the manager does not own a standalone
        process: `close` ends the SESSION — the worker aborts residents
        and goes back to listening).  Idempotent."""
        self._closed = True
        with self._close_lock:
            if graceful and self._conn is not None:
                try:
                    self._conn.send("close", {})
                except (WorkerDiedError, WireFormatError):
                    pass
            self.kill()
            self._abort_all(lambda req: RequestCancelled(
                f"request {req.id} aborted: remote worker replica "
                "detached"))


if __name__ == "__main__":
    sys.exit(main())
