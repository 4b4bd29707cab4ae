"""Continuous weight refresh: the train -> serve side of the loop (port of
paddle_tpu/serving/refresh.py).

A trainer publishes weight sets into a watch directory with the atomic
contract of the checkpoint writer (tmp dir -> fsync -> ``os.rename`` ->
fsync of the parent -> atomic LATEST pointer), so a reader never sees a
half-written publish: ``push-%09d/{weights.npz, manifest.json}``, the
reference's layout, so either framework's refresher reads the other's
publishes.  The serving side walks each new publish through three gates
before the fleet converges onto it:

1. **artifact gate**: the whole-file sha256 must match the manifest (the
   manifest's sha is of the good bytes, computed before the rename);
2. **oracle gate**: an in-process reference engine swaps to the new
   weights and generates the expected canary streams (a key or shape
   mismatch dies here, before any serving replica is touched);
3. **canary gate**: exactly one routable replica is flipped
   (``FleetRouter.flip_weights``: fence -> idle boundary -> swap, nothing
   captured again) and its canary streams must EQUAL the oracle's.

A publish that fails a gate is quarantined by content hash, and the
canary is flipped back to the last verified weights: a bad publish
degrades to serving the old model.  Only after the canary passes does the
refresher converge every other replica (and, by its convergence sweep,
every replica that turns warm later).

On the card the oracle and the replicas must be built with the same
engine options (``max_slots``, ``decode_chunk``, ``kv``, ``dtype``), so
that each canary run launches the same kernels at the same shapes as the
oracle's and the comparison can demand equality.

The refresher runs OFF the fleet's driving thread: it only schedules
flips and polls their entries, so something else (the gateway loop or
``fleet.start()``) must drive ``fleet.step()``.

Fault knobs (``utils.faults``): ``PDTPU_FAULT_PUBLISH_CORRUPT=n``
corrupts the n-th published artifact after its rename (gate 1 must catch
it); ``PDTPU_FAULT_CANARY_DIVERGE=1`` fails the canary comparison (the
rollback drill).
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.errors import InvalidArgumentError
from ..distributed.checkpoint import _fsync_dir, _host_array, _write_atomic
from ..utils import faults
from .fleet import DEGRADED, HEALTHY
from .transfer import file_sha256

__all__ = ["WeightPublisher", "latest_publish", "FleetRefresher"]

_PUSH_DIR_RE = re.compile(r"^push-(\d{9})$")
_LATEST = "LATEST"
_MANIFEST = "manifest.json"
_WEIGHTS = "weights.npz"


def _state_arrays(model) -> Dict[str, np.ndarray]:
    """A model's state as host numpy arrays under the reference's names
    (``jit.state_arrays``; bf16 as ml_dtypes' bfloat16)."""
    from ..jit import state_arrays
    return {k: _host_array(v) for k, v in state_arrays(model).items()}


def _load_state(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# trainer side: atomic publishes
# ---------------------------------------------------------------------------

class WeightPublisher:
    """Writes ``push-<step>/{weights.npz, manifest.json}`` publishes a
    refresher can trust: both files written and fsynced in a hidden tmp
    dir, the manifest holding the sha256 of the GOOD npz bytes, one
    ``os.rename`` making the publish visible, then the atomic LATEST
    pointer.  A crash mid-publish leaves only an invisible tmp dir; a
    publish corrupted after the rename fails the artifact gate."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()
        # resume numbering past anything already on disk
        step = 0
        for name in os.listdir(self.directory):
            m = _PUSH_DIR_RE.match(name)
            if m:
                step = max(step, int(m.group(1)) + 1)
        self._step = step

    def publish(self, model=None, state: Optional[Dict] = None,
                step: Optional[int] = None) -> Dict:
        """Publish one weight set (a model via ``model=``, or a state dict
        of arrays or tensors via ``state=``); returns ``{"dir", "step",
        "sha256", "path"}``."""
        if (model is None) == (state is None):
            raise InvalidArgumentError(
                "publish takes exactly one of model= or state=")
        if model is not None:
            arrs = _state_arrays(model)
        else:
            arrs = {k: v if isinstance(v, np.ndarray) else _host_array(v)
                    for k, v in state.items()}
        with self._lock:
            explicit = step is not None
            step = self._step if step is None else int(step)
            if not explicit:
                # another publisher may have taken this number: skip on
                while os.path.exists(os.path.join(
                        self.directory, f"push-{step:09d}")):
                    step += 1
            self._step = max(self._step, step) + 1
        name = f"push-{step:09d}"
        final_dir = os.path.join(self.directory, name)
        if os.path.exists(final_dir):
            raise InvalidArgumentError(
                f"publish step {step} already exists at {final_dir}")
        tmp_dir = os.path.join(self.directory, f".{name}.tmp-{os.getpid()}")
        os.makedirs(tmp_dir)
        npz_tmp = os.path.join(tmp_dir, _WEIGHTS)
        with open(npz_tmp, "wb") as f:
            np.savez(f, **arrs)
            f.flush()
            os.fsync(f.fileno())
        # the sha of the good bytes, BEFORE the rename: later corruption
        # of the visible artifact can only disagree with the manifest
        sha = file_sha256(npz_tmp)
        with open(os.path.join(tmp_dir, _MANIFEST), "w") as f:
            json.dump({"step": step, "sha256": sha, "file": _WEIGHTS,
                       "keys": len(arrs)}, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp_dir)
        os.rename(tmp_dir, final_dir)
        _fsync_dir(self.directory)
        _write_atomic(os.path.join(self.directory, _LATEST), name)
        path = os.path.join(final_dir, _WEIGHTS)
        faults.maybe_corrupt_publish(path)
        return {"dir": final_dir, "step": step, "sha256": sha,
                "path": path}


def _load_publish(d: str) -> Optional[Dict]:
    try:
        with open(os.path.join(d, _MANIFEST)) as f:
            man = json.load(f)
    except (OSError, ValueError):
        return None
    path = os.path.join(d, str(man.get("file") or _WEIGHTS))
    if not man.get("sha256") or not os.path.exists(path):
        return None
    return {"dir": d, "step": int(man.get("step", -1)),
            "sha256": str(man["sha256"]), "path": path}


def latest_publish(directory: str) -> Optional[Dict]:
    """Newest complete publish in ``directory``, or None.  LATEST is a
    hint: a missing or torn pointer falls back to scanning push-* dirs
    newest first for one with a valid manifest."""
    try:
        with open(os.path.join(directory, _LATEST)) as f:
            hint = f.read().strip()
    except OSError:
        hint = ""
    if hint and _PUSH_DIR_RE.match(hint):
        pub = _load_publish(os.path.join(directory, hint))
        if pub is not None:
            return pub
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    for name in sorted((n for n in names if _PUSH_DIR_RE.match(n)),
                       reverse=True):
        pub = _load_publish(os.path.join(directory, name))
        if pub is not None:
            return pub
    return None


# ---------------------------------------------------------------------------
# serving side: watch -> verify -> canary -> converge (or roll back)
# ---------------------------------------------------------------------------

class FleetRefresher:
    """Watches a publish directory and walks the fleet onto each new
    weight set through the three gates (module docstring).  ``oracle`` is
    an in-process ServingEngine over the same model configuration as the
    replicas, not started (the refresher drives it synchronously), and
    warmed by the caller before traffic when post-warmup captures are
    checked.  ``sha_ok()`` backs the fleet's ``routable_verified``: a
    replica serving a quarantined sha is never verified capacity."""

    def __init__(self, fleet, directory: str, oracle,
                 canary_prompts: Sequence[Sequence[int]] = ((1, 2, 3),),
                 canary_max_new_tokens: int = 8,
                 poll_interval_s: float = 0.25,
                 flip_timeout_s: float = 120.0,
                 canary_timeout_s: float = 60.0,
                 _clock=time.monotonic):
        if oracle._thread is not None:
            raise InvalidArgumentError(
                "the oracle engine must not be started: the refresher "
                "drives it synchronously (run_until_drained)")
        self.fleet = fleet
        self.directory = os.path.abspath(directory)
        self.oracle = oracle
        self.canary_prompts = [list(map(int, p)) for p in canary_prompts]
        if not self.canary_prompts:
            raise InvalidArgumentError(
                "at least one canary prompt is required")
        self.canary_max_new_tokens = int(canary_max_new_tokens)
        self.poll_interval_s = float(poll_interval_s)
        self.flip_timeout_s = float(flip_timeout_s)
        self.canary_timeout_s = float(canary_timeout_s)
        self._clock = _clock
        self._verified: set = set()
        self._quarantined: Dict[str, str] = {}
        self._current: Optional[Dict] = None   # last canary-passed publish
        self._baseline: Optional[Dict] = None  # the oracle's boot state
        self._last_error: Optional[str] = None
        self._lock = threading.Lock()
        self._poll_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        fleet.attach_refresher(self)

    # -- health plumbing ----------------------------------------------
    def sha_ok(self, sha: Optional[str]) -> bool:
        """Is ``sha`` acceptable to serve?  Boot weights (sha None) are;
        anything else must have passed the canary and never have been
        quarantined."""
        with self._lock:
            if sha in self._quarantined:
                return False
            return sha is None or sha in self._verified

    def status(self) -> Dict:
        with self._lock:
            return {
                "current_sha": (None if self._current is None
                                else self._current["sha256"]),
                "current_step": (None if self._current is None
                                 else self._current["step"]),
                "verified": len(self._verified),
                "quarantined": dict(self._quarantined),
                "last_error": self._last_error,
            }

    # -- one refresh cycle --------------------------------------------
    def poll(self) -> Dict:
        """One watch cycle: admit a new publish through the gates, then
        converge stragglers (replicas booted or scaled up later) onto the
        current verified weights.  ``start()`` loops it."""
        with self._poll_lock:
            if self._baseline is None:
                self._baseline = _state_arrays(self.oracle.model)
            pub = latest_publish(self.directory)
            if pub is not None:
                sha = pub["sha256"]
                with self._lock:
                    stale = (sha in self._quarantined
                             or sha in self._verified)
                if not stale:
                    self._admit(pub)
            self._converge()
            return self.status()

    def _admit(self, pub: Dict):
        sha = pub["sha256"]
        # gate 1: the artifact's bytes against the manifest's sha
        try:
            actual = file_sha256(pub["path"])
        except OSError as e:
            self._quarantine(sha, f"artifact unreadable: {e!r}")
            return
        if actual != sha:
            self._quarantine(sha, "artifact sha mismatch (corrupt publish)")
            return
        try:
            state = _load_state(pub["path"])
        except Exception as e:  # noqa: BLE001 — any decode failure
            self._quarantine(sha, f"artifact undecodable: {e!r}")
            return
        # gate 2: the oracle swaps first (key and shape mismatches die
        # here), then generates the expected canary streams
        try:
            self.oracle.swap_weights(state, sha)
            expected = self._oracle_tokens()
        except Exception as e:  # noqa: BLE001 — typed swap / gen errors
            self._quarantine(
                sha, f"oracle rejected publish: {type(e).__name__}: {e}")
            self._oracle_rollback()
            return
        # gate 3: one canary replica, equal streams required
        rep = self._pick_canary()
        if rep is None:
            # no routable capacity now: leave the publish unjudged and
            # retry next cycle (the oracle back on the old weights)
            self._oracle_rollback()
            with self._lock:
                self._last_error = ("no routable replica for canary; "
                                    "deferred")
            return
        try:
            entry = self.fleet.flip_weights(rep.id, path=pub["path"],
                                            sha=sha, state=state)
        except InvalidArgumentError as e:
            self._oracle_rollback()
            with self._lock:
                self._last_error = f"canary flip not schedulable: {e}"
            return
        if not self._wait_entry(entry):
            self._quarantine(sha, "canary flip failed: "
                             f"{entry.get('error') or 'timeout'}")
            self._oracle_rollback()
            return
        try:
            got = self._replica_tokens(rep)
        except Exception as e:  # noqa: BLE001 — a failed canary diverged
            got = f"canary request failed: {type(e).__name__}: {e}"
        if faults.canary_diverge() or got != expected:
            self._rollback_canary(rep)
            self._quarantine(sha, "canary diverged from the new-weights "
                                  "oracle")
            self._oracle_rollback()
            return
        with self._lock:
            self._verified.add(sha)
            self._current = pub
            self._last_error = None

    def _converge(self):
        """Flip every serving replica not on the current verified weights:
        the sweep that heals rollout replacements and scale-ups."""
        cur = self._current
        if cur is None:
            return
        sha = cur["sha256"]
        state = None
        for rep in self.fleet.manager.replicas((HEALTHY, DEGRADED)):
            if rep.flipping or not rep.engine.warm:
                continue
            if rep.engine.weights_sha == sha:
                continue
            if state is None:
                state = _load_state(cur["path"])
            try:
                self.fleet.flip_weights(rep.id, path=cur["path"], sha=sha,
                                        state=state)
            except InvalidArgumentError:
                pass  # lost liveness between the snapshot and the flip

    # -- internals -----------------------------------------------------
    def _oracle_tokens(self) -> List[List[int]]:
        resps = [self.oracle.submit(
            p, max_new_tokens=self.canary_max_new_tokens)
            for p in self.canary_prompts]
        self.oracle.run_until_drained(timeout=self.canary_timeout_s)
        return [list(r.tokens(timeout=1.0)) for r in resps]

    def _replica_tokens(self, rep) -> List[List[int]]:
        resps = []
        for p in self.canary_prompts:
            req, resp = rep.engine.make_request(
                p, self.canary_max_new_tokens)
            rep.engine.scheduler.submit(req, resp)
            resps.append(resp)
        # the fleet's driving loop runs these; wake it
        self.fleet._work.set()
        return [list(r.tokens(timeout=self.canary_timeout_s))
                for r in resps]

    def _pick_canary(self):
        reps = self.fleet.manager.routable()
        if not reps:
            return None
        return min(reps, key=lambda r: r.load())

    def _wait_entry(self, entry: Dict) -> bool:
        deadline = self._clock() + self.flip_timeout_s
        while not entry["done"]:
            if self._clock() > deadline:
                return False
            time.sleep(0.01)
        return bool(entry["ok"])

    def _rollback_target(self):
        """(path, sha, state) of the weights a bad canary rolls back to:
        the last verified publish or, before any passed, the oracle's boot
        state, written once as an artifact under ``.baseline``."""
        with self._lock:
            cur = self._current
        if cur is not None:
            return cur["path"], cur["sha256"], None
        d = os.path.join(self.directory, ".baseline")
        path = os.path.join(d, _WEIGHTS)
        if not os.path.exists(path):
            os.makedirs(d, exist_ok=True)
            tmp = path + f".tmp-{os.getpid()}"
            with open(tmp, "wb") as f:
                np.savez(f, **self._baseline)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        sha = file_sha256(path)
        with self._lock:
            # the baseline IS the boot weights: verified
            self._verified.add(sha)
        return path, sha, self._baseline

    def _rollback_canary(self, rep):
        path, sha, state = self._rollback_target()
        try:
            self._wait_entry(self.fleet.flip_weights(
                rep.id, path=path, sha=sha, state=state))
        except InvalidArgumentError:
            pass  # the replica died meanwhile

    def _oracle_rollback(self):
        path, sha, state = self._rollback_target()
        self.oracle.swap_weights(
            state if state is not None else _load_state(path), sha)

    def _quarantine(self, sha: str, reason: str):
        with self._lock:
            self._quarantined[sha] = reason
            self._last_error = f"{sha[:12]}: {reason}"
        self.fleet.manager.note_rollback()

    # -- background loop ----------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.poll()
                except Exception as e:  # noqa: BLE001 — keep watching
                    with self._lock:
                        self._last_error = (
                            f"poll failed: {type(e).__name__}: {e}")
                self._stop.wait(self.poll_interval_s)

        self._thread = threading.Thread(target=loop, name="fleet-refresher",
                                        daemon=True)
        self._thread.start()

    def close(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
