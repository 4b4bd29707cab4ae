"""The in-process serving fleet: a replica manager and a router over N
``ServingEngine`` replicas (port of paddle_tpu/serving/fleet.py).

- **Routing** is least-loaded (occupancy + queue depth) with session
  affinity: requests sharing a ``session`` key stick to one replica while
  it stays routable, in an LRU map bounded by ``max_sessions``, and
  re-home when it is fenced.  ``prefix_affinity`` pins sessionless
  requests by a hash of (tenant, leading prompt tokens).
- **Health**: a replica is routable only once it is warm (every program
  captured); each step's wall time feeds an EWMA that fences a browned-out
  replica (``slow_threshold_ms``), and a step that raises is a crash — the
  replica is fenced at once.  Every step that returns beats the replica's
  heartbeat (``serving_replica_heartbeat_age_seconds``).
- **Failover**: a fenced-but-alive replica's residents are preempted,
  encoded by the run-transfer codec (``serving/transfer.py``) and restored
  on a peer, resuming equal to an uninterrupted run.  A crashed replica's
  runs are lost with it: a greedy request that opted in
  (``resubmit=True``) is re-prefilled from its prompt on a survivor, which
  forwards only the suffix not yet delivered; any other fails with the
  typed ``ReplicaLostError``.  Queued work that never started re-routes.
- **Drain and rollout**: ``drain(rid)`` stops admissions, migrates
  residents to peers (or lets them finish in place when the fleet is
  full), then closes the replica; ``rollout(factory)`` boots, warms and
  adds a replacement per replica, drains the old one and removes it.
- **Weight flips** (``flip_weights``, driven by ``serving/refresh.py``):
  the replica is fenced from new admissions, its work finishes on the old
  weights, and the swap lands at its idle boundary
  (``ServingEngine.swap_weights``: in place, nothing captured again).

One thread drives ``step()``: the fleet's own ``start()`` loop or a
``ServingGateway`` fronting the router (the router has the engine surface
the gateway consumes).  ``submit`` is safe from any thread.

On the card every replica is an engine of its own in this process: one
thread steps them in turn, each step ending in a host read, so replicas do
not overlap on the card; a replica booted while the loop serves captures
its graphs on the booting thread (``core.programs``: ``"thread_local"``
capture).  A CUDA error that is sticky loses the context of every replica
at once, which no in-process fleet survives: replicas of their own
processes (``add_worker``, the subprocess and remote replicas with their
heartbeat files, kills and supervised restarts) are not ported yet.

Fault knobs (``utils.faults``): ``PDTPU_FAULT_REPLICA_CRASH=replica:tick``
and ``PDTPU_FAULT_REPLICA_SLOW=ms[:every_n[:replica]]``.
"""
from __future__ import annotations

import hashlib
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.errors import (InvalidArgumentError, UnavailableError,
                           UnimplementedError)
from ..utils import faults
from ..utils.monitor import stat_add
from ..utils.retry import RetryPolicy
from .engine import PreemptedRun, ServingEngine
from .request import Request, RequestCancelled, Response
from .scheduler import DeadlineExceededError, QueueFullError
from .transfer import (RunTransferError, check_compatible, decode_run,
                       encode_run)

__all__ = ["FleetRouter", "ReplicaManager", "Replica", "RestartBackoff",
           "ReplicaLostError"]

# replica lifecycle states
BOOTING = "booting"      # added, not yet warm: never routed to
HEALTHY = "healthy"      # warm and fast: routable
DEGRADED = "degraded"    # fenced by slow-step health; residents migrate
DRAINING = "draining"    # admissions stopped; residents migrate/finish
CRASHED = "crashed"      # step raised / injected kill; state abandoned
CLOSED = "closed"        # engine closed (drain finished or shutdown)

_LIVE = (BOOTING, HEALTHY, DEGRADED, DRAINING)


class ReplicaLostError(UnavailableError):
    """The replica serving this run crashed and its KV snapshot was lost
    with it; the request did not opt into resubmission (or no capacity
    was left to resubmit into).  Retry it if it is idempotent for you."""
    code = "Unavailable"


class _InjectedReplicaCrash(RuntimeError):
    """PDTPU_FAULT_REPLICA_CRASH fired: the SIGKILL-equivalent for an
    in-process replica (raised before the engine can fail its runs)."""


class _ForwardingResponse(Response):
    """The resubmission bridge: a crashed replica's lost greedy run is
    replayed from its prompt on a survivor into this response, which
    swallows the first ``skip`` tokens (delivered before the crash) and
    forwards the rest into the ORIGINAL response the consumer iterates.
    Greedy decode depends on the prompt only, so the consumer sees one
    stream equal to an uninterrupted one.  It chains: a second crash
    targets the original with a recomputed skip."""

    def __init__(self, request: Request, target: Response, skip: int):
        super().__init__(request)
        self._target = target
        self._skip = int(skip)

    @property
    def cancelled(self) -> bool:
        # the consumer cancels the ORIGINAL stream; the replay honours it
        return self._cancel_requested or self._target.cancelled

    def _push_token(self, tok: int, logp: float = 0.0):
        super()._push_token(tok, logp)
        if self._skip > 0:
            self._skip -= 1
            return
        self._target._push_token(tok, logp)

    def _finish(self, reason: str):
        super()._finish(reason)
        self._target._finish(reason)

    def _fail(self, exc: BaseException):
        super()._fail(exc)
        self._target._fail(exc)


_obs_handles = None


def _obs():
    """Cached fleet telemetry handles, under the reference's names
    (registry.reset() zeroes the values in place; handles stay valid)."""
    global _obs_handles
    if _obs_handles is None:
        from ..observability import metrics as _m
        _obs_handles = {
            "up": _m.gauge(
                "serving_replica_up",
                "1 while the replica is routable (healthy + warm), else 0",
                labelnames=("replica",)),
            "inflight": _m.gauge(
                "serving_replica_inflight",
                "decoding slots + queued requests on the replica",
                labelnames=("replica",)),
            "replicas_up": _m.gauge(
                "fleet_replicas_up", "routable replicas in the fleet"),
            "failovers": _m.counter(
                "fleet_failovers_total",
                "replica fences (crash or brownout) that triggered "
                "failover handling"),
            "migrated": _m.counter(
                "fleet_migrated_runs_total",
                "in-flight runs moved between replicas via the run "
                "transfer codec"),
            "hb_age": _m.gauge(
                "serving_replica_heartbeat_age_seconds",
                "seconds since the replica's last heartbeat (its last "
                "step that returned)", labelnames=("replica",)),
            # registered for the report's section; 0 until worker
            # replicas are ported
            "workers": _m.gauge(
                "fleet_worker_processes",
                "live subprocess worker replicas (process alive)"),
            "refreshes": _m.counter(
                "fleet_weight_refreshes_total",
                "replica weight flips applied (one per replica per "
                "publish, rollbacks included)"),
            "rollbacks": _m.counter(
                "fleet_rollbacks_total",
                "published weight sets rejected by a refresh gate and "
                "rolled back to the previous weights_sha"),
            "scale_up": _m.counter(
                "fleet_scale_up_total",
                "autoscaler scale-up actions (replicas spawned on "
                "sustained SLO pressure)"),
            "scale_down": _m.counter(
                "fleet_scale_down_total",
                "autoscaler scale-down actions (least-loaded replica "
                "drained, never killed)"),
            "target_replicas": _m.gauge(
                "fleet_target_replicas",
                "the autoscaler's current desired replica count"),
        }
    return _obs_handles


class RestartBackoff:
    """A supervisor's restart schedule: ``utils.retry.RetryPolicy``'s
    exponential backoff with full jitter over a hard restart budget, the
    sleep turned into a delay the caller schedules.  ``rng`` is
    injectable (deterministic tests)."""

    def __init__(self, max_restarts: int = 3, base_delay: float = 0.5,
                 max_delay: float = 30.0, jitter: float = 0.5,
                 rng: Optional[Callable[[float, float], float]] = None):
        self.max_restarts = max(0, int(max_restarts))
        self._policy = RetryPolicy(retries=self.max_restarts,
                                   base_delay=base_delay,
                                   max_delay=max_delay, jitter=jitter)
        self._rng = rng if rng is not None else random.uniform

    def delay_for(self, attempt: int) -> Optional[float]:
        """Jittered delay before restart number ``attempt`` (1-based), or
        None once the budget is exhausted."""
        if attempt < 1 or attempt > self.max_restarts:
            return None
        delay = list(self._policy.delays())[attempt - 1]
        if self._policy.jitter:
            delay += self._rng(0.0, self._policy.jitter * delay)
        return delay


class Replica:
    """One managed ServingEngine and its health state.  ``id`` increases
    monotonically and is never reused; the replica fault knobs target
    it."""

    kind = "inproc"

    def __init__(self, rid: int, engine: ServingEngine):
        self.id = rid
        self.engine = engine
        self.state = HEALTHY if engine.warm else BOOTING
        self.steps = 0
        self.last_beat = time.monotonic()
        self.step_ewma: Optional[float] = None  # seconds
        self.fast_steps = 0
        self.fence_reason: Optional[str] = None
        # a pending weight flip fences NEW admissions while queued and
        # resident work finishes on the old weights (no stream spans two)
        self.flipping = False
        # the autoscaler's remove of a draining replica: the drain-finish
        # sweep removes it when its last resident is done
        self.remove_after_drain = False

    def routable(self) -> bool:
        return (self.state == HEALTHY and self.engine.warm
                and not self.flipping)

    def load(self) -> int:
        s = self.engine.scheduler
        return s.occupancy() + s.queue_depth()

    def observe_step(self, dt: float, threshold: Optional[float]):
        """One step that returned: the heartbeat, and its wall time into
        the EWMA (and the fast-step streak that ends a probation)."""
        self.last_beat = time.monotonic()
        a = 0.3
        self.step_ewma = (dt if self.step_ewma is None
                          else a * dt + (1 - a) * self.step_ewma)
        if threshold is not None:
            self.fast_steps = self.fast_steps + 1 if dt < 0.5 * threshold \
                else 0

    def heartbeat_age(self) -> float:
        """Seconds since the last liveness evidence."""
        return max(0.0, time.monotonic() - self.last_beat)

    def snapshot(self) -> Dict:
        return {
            "kind": self.kind,
            "state": self.state,
            "warm": bool(self.engine.warm),
            "occupancy": self.engine.scheduler.occupancy(),
            "queue_depth": self.engine.scheduler.queue_depth(),
            "steps": self.steps,
            "step_ewma_ms": (None if self.step_ewma is None
                             else round(self.step_ewma * 1e3, 3)),
            "heartbeat_age_s": round(self.heartbeat_age(), 3),
            "fence_reason": self.fence_reason,
            "post_warmup_compiles": (self.engine.post_warmup_compiles()
                                     if self.engine.warm else None),
            "weights_sha": self.engine.weights_sha,
            "refresh_epoch": self.engine.refresh_epoch,
            "flipping": self.flipping,
            "adapters": self.engine.adapter_shas(),
        }


class ReplicaManager:
    """Replica lifecycle: stepping, health, fencing, migration, drain,
    weight flips.  Replica state changes on the driving thread (the fleet
    loop or the gateway loop), except ``add`` / ``drain`` / ``remove`` /
    ``flip_weights``, which flip flags under the lock for the next tick.
    ``heartbeat_timeout_s`` flags routable replicas whose last step is
    older (``stale_routable``: the driving loop itself stalled);
    ``kill_grace_s`` and ``restart_backoff`` are the reference's
    supervisor settings for worker replicas, kept for them."""

    def __init__(self, slow_threshold_ms: Optional[float] = None,
                 probation_steps: int = 5,
                 heartbeat_timeout_s: Optional[float] = 10.0,
                 kill_grace_s: float = 2.0,
                 restart_backoff: Optional[RestartBackoff] = None):
        self._replicas: Dict[int, Replica] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        self._ticks = 0
        self.slow_threshold_s = (None if slow_threshold_ms is None
                                 else float(slow_threshold_ms) / 1e3)
        self.probation_steps = int(probation_steps)
        self.heartbeat_timeout_s = (None if heartbeat_timeout_s is None
                                    else float(heartbeat_timeout_s))
        self.kill_grace_s = float(kill_grace_s)
        self.restart_backoff = (RestartBackoff() if restart_backoff is None
                                else restart_backoff)
        # runs preempted off a fenced replica that no peer could hold yet
        # (paged-block shortfall): retried every tick, swept for
        # cancel / deadline, failed at close
        self._parked: List[PreemptedRun] = []
        # pending weight flips: {"rid", "sha", "path", "state", "done",
        # "ok", "error"}, applied at each replica's idle boundary
        self._flips: List[Dict] = []
        # LoRA adapters the fleet serves: name -> (path, sha), re-applied
        # to every replica that turns warm later
        self._adapters: Dict[str, Tuple[str, Optional[str]]] = {}
        self._n = {"failovers": 0, "migrated": 0, "resubmits": 0,
                   "lost": 0, "reroutes": 0, "drains": 0, "wedges": 0,
                   "worker_restarts": 0, "restarts_exhausted": 0,
                   "weight_refreshes": 0, "rollbacks": 0,
                   "scale_up": 0, "scale_down": 0}

    # -- membership ---------------------------------------------------
    def add(self, engine: ServingEngine) -> Replica:
        if engine._thread is not None:
            raise InvalidArgumentError(
                "replica engine loop already started; the fleet drives "
                "engine.step() itself — construct the engine without "
                "start()")
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            rep = Replica(rid, engine)
            self._replicas[rid] = rep
        self._publish_up(rep)
        return rep

    def add_worker(self, spec: Dict, **kwargs):
        raise UnimplementedError(
            "subprocess and remote replicas (add_worker) are not ported "
            "yet: they come with serving/worker.py (ROADMAP §1 item 5); "
            "add in-process engines with add()")

    def get(self, rid: int) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(rid)

    def replicas(self, states=None) -> List[Replica]:
        with self._lock:
            reps = list(self._replicas.values())
        if states is None:
            return reps
        return [r for r in reps if r.state in states]

    def routable(self) -> List[Replica]:
        return [r for r in self.replicas((HEALTHY,)) if r.routable()]

    def remove(self, rid: int):
        """Forget a closed or crashed replica and release its engine's
        device memory (graphs, pools, weight copy).  On a replica still
        draining it only flags the replica: the drain-finish sweep removes
        it after its last resident.  Idempotent."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None:
                return
            if rep.state == DRAINING:
                rep.remove_after_drain = True
                return
            if rep.state not in (CLOSED, CRASHED):
                raise InvalidArgumentError(
                    f"replica {rid} is {rep.state}; drain it before "
                    "remove (or let crash handling finish)")
            del self._replicas[rid]
        rep.engine.close()
        rep.engine._free_device()
        _obs()["up"].labels(replica=str(rid)).set(0)
        self._publish_counts()

    def warm_all(self) -> Dict[int, Dict]:
        """warmup() every replica not yet warm; booting replicas become
        healthy (routable) once every program is captured."""
        reports = {}
        for rep in self.replicas(_LIVE):
            if not rep.engine.warm:
                reports[rep.id] = rep.engine.warmup()
            if rep.state == BOOTING and rep.engine.warm:
                rep.state = HEALTHY
                self._converge_adapters(rep)
                self._publish_up(rep)
        self.refresh_warm_marks()
        return reports

    def refresh_warm_marks(self):
        """Re-baseline every warm replica's post-warmup compile marks
        after a membership warm event (warm_all, a rollout's boot), as the
        reference does: ``post_warmup_compiles()`` then means captures
        since the fleet's latest warmup."""
        for rep in self.replicas(_LIVE):
            if rep.engine.warm:
                rep.engine._warm_marks = rep.engine._compile_marks()

    def drain(self, rid: int):
        """Fence ``rid`` for graceful removal: no new admissions; queued
        requests re-route now (or stay, served before the drain ends, when
        no peer has queue space), residents migrate or finish in place
        over the next ticks, then the engine closes."""
        rep = self.get(rid)
        if rep is None:
            raise InvalidArgumentError(f"no replica {rid}")
        if rep.state not in (BOOTING, HEALTHY, DEGRADED):
            return
        rep.state = DRAINING
        rep.fence_reason = "drain"
        self._n["drains"] += 1
        stat_add("STAT_fleet_drains")
        self._publish_up(rep)
        for req, resp in rep.engine.scheduler.drain_pending():
            self._reroute(req, resp, exclude_id=rid,
                          fallback_engine=rep.engine)

    # -- the driving tick ---------------------------------------------
    def tick(self) -> bool:
        """One fleet iteration on the driving thread: step every live
        warm replica (the crash and brownout knobs consulted per step,
        its wall time fed to health), fence what health demands, migrate
        residents off fenced replicas, retry parked runs, apply due
        weight flips, close drained-empty replicas."""
        self._ticks += 1
        did = False
        crash_cfg = faults.replica_crash_config()
        for rep in self.replicas(_LIVE):
            if rep.state == BOOTING:
                continue   # warm_all / rollout make it routable
            if (rep.state == DEGRADED and not rep.engine.has_work()
                    and self._ticks % 16):
                # probation sampling: an idle fenced replica is stepped
                # only now and then, so a browned-out replica's step
                # latency cannot keep stalling the shared loop
                continue
            try:
                # the brownout sleep counts INTO the measured step time
                t0 = time.perf_counter()
                faults.maybe_slow_replica(rep.id, rep.steps)
                if crash_cfg is not None and crash_cfg == (rep.id,
                                                           rep.steps):
                    rep.steps += 1
                    raise _InjectedReplicaCrash(
                        f"replica {rep.id} lost at tick {rep.steps - 1} "
                        "(PDTPU_FAULT_REPLICA_CRASH)")
                stepped = rep.engine.step()
                dt = time.perf_counter() - t0
                rep.steps += 1
                rep.observe_step(dt, self.slow_threshold_s)
                did = stepped or did
            except Exception as e:  # noqa: BLE001 — fence, never hang
                self._on_crash(rep, e)
                did = True
        self._update_health()
        did = self._pump_migrations() or did
        did = self._pump_parked() or did
        self._sweep_parked()
        did = self._pump_flips() or did
        did = self._finish_drains() or did
        self._publish_inflight()
        return did

    # -- health --------------------------------------------------------
    def _update_health(self):
        thr = self.slow_threshold_s
        if thr is None:
            return
        for rep in self.replicas((HEALTHY, DEGRADED)):
            if (rep.state == HEALTHY and rep.steps >= 3
                    and rep.step_ewma is not None and rep.step_ewma > thr):
                rep.state = DEGRADED
                rep.fence_reason = (
                    f"slow: step EWMA {rep.step_ewma * 1e3:.1f}ms > "
                    f"{thr * 1e3:.1f}ms")
                self._n["failovers"] += 1
                stat_add("STAT_fleet_failovers")
                _obs()["failovers"].inc()
                self._publish_up(rep)
            elif (rep.state == DEGRADED and rep.step_ewma is not None
                    and rep.step_ewma < 0.5 * thr
                    and rep.fast_steps >= self.probation_steps):
                # brownout over: probation passed, back into rotation
                rep.state = HEALTHY
                rep.fence_reason = None
                self._publish_up(rep)

    def _on_crash(self, rep: Replica, exc: BaseException):
        """SIGKILL-equivalent loss: the engine had no chance to fail its
        runs.  Fence it, then give every resident stream a future:
        resubmission for greedy opt-ins, ReplicaLostError for the rest, a
        re-route for queued work that never started."""
        rep.state = CRASHED
        rep.fence_reason = repr(exc)
        self._n["failovers"] += 1
        stat_add("STAT_fleet_failovers")
        _obs()["failovers"].inc()
        self._publish_up(rep)
        self._fail_over_all(rep)

    def _fail_over_all(self, rep: Replica):
        """Give every consumer of an unreachable replica a future; its
        parked OOM snapshots count as lost too."""
        engine = rep.engine
        lost = [(run.req, run.resp) for run in engine._slots.values()]
        # release the scheduler's slot bookkeeping too: the abandoned
        # engine must not pin its occupancy or its Request refs
        for slot in list(engine._slots):
            engine.scheduler.release(slot)
        engine._slots.clear()
        if engine.kv == "paged":
            lost.extend((p.req, p.resp) for p in engine._oom_paused)
            engine._oom_paused = []
        for req, resp in lost:
            self._failover_lost(req, resp, rep.id)
        # queued but never prefilled: nothing was delivered, re-route
        for req, resp in engine.scheduler.drain_pending():
            self._reroute(req, resp, exclude_id=rep.id)

    def _failover_lost(self, req: Request, resp: Response, crashed_id: int):
        produced = len(resp.tokens_so_far())
        if req.resubmit and req.greedy:
            if self._resubmit(req, resp, produced, crashed_id):
                self._n["resubmits"] += 1
                stat_add("STAT_fleet_resubmits")
                return
        self._n["lost"] += 1
        stat_add("STAT_fleet_lost_runs")
        resp._fail(ReplicaLostError(
            f"request {req.id}: replica {crashed_id} crashed mid-decode "
            f"and its run snapshot was lost ({produced} tokens were "
            "delivered); "
            + ("no surviving replica could take the resubmission"
               if req.resubmit and req.greedy else
               "submit with resubmit=True (greedy) to opt into "
               "re-prefill-from-prompt recovery")))

    def _resubmit(self, req: Request, resp: Response, produced: int,
                  crashed_id: int) -> bool:
        """Replay a lost greedy run from its prompt on a survivor; the
        forwarding response swallows the ``produced`` tokens already
        delivered."""
        # a second crash: target the ORIGINAL stream, the bridge's token
        # count being what the original has seen end to end
        target = resp._target if isinstance(resp, _ForwardingResponse) \
            else resp
        for rep in self._targets(exclude_id=crashed_id):
            engine = rep.engine
            try:
                shadow, _ = engine.make_request(
                    req.prompt, req.max_new_tokens,
                    decode_strategy="greedy_search",
                    eos_token_id=req.eos_token_id, seed=req.seed,
                    priority=req.priority, tenant=req.tenant,
                    spec=(req.spec if engine.draft_model is not None
                          else False),
                    session=req.session, resubmit=True)
            except Exception:  # noqa: BLE001 — try the next survivor
                continue
            # the original deadline keeps counting from the original
            # submission: a crash does not extend a budget
            shadow.deadline = req.deadline
            fwd = _ForwardingResponse(shadow, target, skip=produced)
            try:
                engine.scheduler.submit(shadow, fwd)
            except QueueFullError:
                continue
            return True
        return False

    def _reroute(self, req: Request, resp: Response, exclude_id: int,
                 fallback_engine=None):
        """Re-home a queued (never prefilled) request.  A drain passes its
        still-alive engine as ``fallback_engine`` (no peer queue space:
        the request stays and is served before the drain ends); a crash
        has none, and no peer space is the typed terminal state."""
        for rep in self._targets(exclude_id=exclude_id):
            try:
                rep.engine.scheduler.submit(req, resp)
            except QueueFullError:
                continue
            self._n["reroutes"] += 1
            stat_add("STAT_fleet_reroutes")
            return
        if fallback_engine is not None:
            try:
                fallback_engine.scheduler.submit(req, resp)
                return
            except QueueFullError:
                pass
        self._n["lost"] += 1
        stat_add("STAT_fleet_lost_runs")
        resp._fail(ReplicaLostError(
            f"request {req.id}: replica {exclude_id} was fenced before "
            "prefill and no surviving replica had queue space"))

    def _targets(self, exclude_id: Optional[int] = None) -> List[Replica]:
        reps = [r for r in self.routable() if r.id != exclude_id]
        reps.sort(key=lambda r: (r.load(), r.id))
        return reps

    # -- migration -----------------------------------------------------
    def _pump_migrations(self) -> bool:
        """Move residents off fenced-but-alive replicas (drain or
        brownout) through the run-transfer codec."""
        did = False
        for rep in self.replicas((DRAINING, DEGRADED)):
            did = self._migrate_residents(rep) or did
        return did

    def _migrate_residents(self, rep: Replica) -> bool:
        """Preempt a resident only once a peer has a free slot; a paged
        shortfall at the restore parks the snapshot for a retry."""
        did = False
        for slot in sorted(rep.engine._slots):
            target = self._pick_slot_target(exclude_id=rep.id)
            if target is None:
                break  # fleet full: residents finish in place
            paused = rep.engine.preempt_slot(slot)
            try:
                snap = decode_run(encode_run(paused), req=paused.req,
                                  resp=paused.resp, engine=target.engine)
                restored = target.engine.restore_run(snap)
            except RunTransferError as e:
                # an incompatible peer: the run fails typed, never written
                # into a pool it does not fit
                self._n["lost"] += 1
                stat_add("STAT_fleet_lost_runs")
                paused.resp._fail(e)
                did = True
                continue
            if restored:
                self._note_migrated(snap)
            else:
                self._parked.append(snap)
            did = True
        return did

    def _note_migrated(self, snap: PreemptedRun):
        snap.req.migrations += 1
        self._n["migrated"] += 1
        stat_add("STAT_fleet_migrated_runs")
        _obs()["migrated"].inc()

    def _pick_slot_target(self, exclude_id: int) -> Optional[Replica]:
        cands = [r for r in self._targets(exclude_id)
                 if r.engine.scheduler.free_slot_count() > 0]
        return cands[0] if cands else None

    def _pump_parked(self) -> bool:
        did = False
        still = []
        for snap in self._parked:
            placed = False
            for rep in self._targets():
                if rep.engine.scheduler.free_slot_count() <= 0:
                    continue
                try:
                    restored = rep.engine.restore_run(snap)
                except RunTransferError:
                    continue  # incompatible peer: try the next one
                if restored:
                    self._note_migrated(snap)
                    placed = did = True
                    break
            if not placed:
                still.append(snap)
        self._parked = still
        return did

    def _sweep_parked(self):
        """Parked snapshots still honour cancel and deadline."""
        keep = []
        for p in self._parked:
            if p.resp.cancelled:
                p.resp._fail(RequestCancelled(
                    f"request {p.req.id} cancelled while parked for "
                    "replica migration"))
            elif p.req.deadline is not None and p.req.deadline.expired():
                p.resp._fail(DeadlineExceededError(
                    f"request {p.req.id} deadline "
                    f"({p.req.deadline.seconds}s) expired while parked "
                    "for replica migration"))
            else:
                keep.append(p)
        self._parked = keep

    def _finish_drains(self) -> bool:
        did = False
        for rep in self.replicas((DRAINING,)):
            if rep.engine.has_work():
                continue
            # under the lock, so a concurrent remove() sees DRAINING
            # (defers) or CLOSED (removes), never a state in between
            with self._lock:
                rep.state = CLOSED
                do_remove = rep.remove_after_drain
            rep.engine.close()
            self._publish_up(rep)
            if do_remove:
                self.remove(rep.id)
            did = True
        return did

    # -- continuous weight refresh ------------------------------------
    def flip_weights(self, rid: int, path: Optional[str] = None,
                     sha: Optional[str] = None,
                     state: Optional[Dict] = None) -> Dict:
        """Schedule a weight flip on replica ``rid``: it is fenced from
        new admissions now, its work finishes on the old weights, and
        ``_pump_flips`` swaps at its idle boundary (nothing captured
        again, no stream spans two weight sets).  Takes a host ``state``
        dict or the ``path`` of an npz.  Returns the entry; poll
        ``entry["done"]`` / ``["ok"]`` / ``["error"]``.  A failed flip
        leaves the replica on the old weights and routable again."""
        rep = self.get(rid)
        if rep is None or rep.state not in _LIVE:
            raise InvalidArgumentError(
                f"replica {rid} is not live; cannot flip weights")
        entry = {"rid": rid, "path": path, "sha": sha, "state": state,
                 "done": False, "ok": None, "error": None}
        rep.flipping = True
        self._publish_up(rep)
        self._flips.append(entry)
        return entry

    def _pump_flips(self) -> bool:
        """Apply pending flips on replicas at their idle boundary; one
        onto a replica no longer live fails."""
        if not self._flips:
            return False
        did = False
        still = []
        for entry in self._flips:
            rep = self.get(entry["rid"])
            if rep is None or rep.state not in _LIVE:
                entry.update(done=True, ok=False,
                             error=f"replica {entry['rid']} is no "
                                   "longer live")
                did = True
                continue
            if rep.engine.has_work():
                still.append(entry)  # old-weights work still in flight
                continue
            try:
                self._apply_flip(rep, entry)
                entry.update(done=True, ok=True)
                self._n["weight_refreshes"] += 1
                stat_add("STAT_fleet_weight_refreshes")
                _obs()["refreshes"].inc()
            except Exception as e:  # noqa: BLE001 — a rejected swap
                # (key or shape mismatch, unreadable artifact): the
                # replica still serves the old weights
                entry.update(done=True, ok=False,
                             error=f"{type(e).__name__}: {e}")
            rep.flipping = False
            self._publish_up(rep)
            did = True
        self._flips = still
        return did

    def _apply_flip(self, rep: Replica, entry: Dict):
        state = entry["state"]
        if state is None:
            if entry["path"] is None:
                raise InvalidArgumentError(
                    "flip_weights needs `state` or `path`")
            with np.load(entry["path"], allow_pickle=False) as z:
                state = {k: z[k] for k in z.files}
        rep.engine.swap_weights(state, entry["sha"])

    # -- multi-tenant LoRA: fleet-wide adapter hot-load ----------------
    def load_adapter(self, name: str, path: str,
                     sha: Optional[str] = None) -> Dict[int, str]:
        """Page the LoRA adapter at ``path`` into every live warm
        replica's registry under ``name`` (additive, nothing captured, no
        fencing) and record it, so replicas that turn warm later load it
        too.  Returns {rid: file sha} of the replicas that hold it; a
        replica that refuses keeps serving what it had, and only when
        every replica refuses is the error raised and nothing recorded."""
        results: Dict[int, str] = {}
        errors: Dict[int, BaseException] = {}
        for rep in self.replicas(_LIVE):
            if not rep.engine.warm:
                continue  # _converge_adapters loads it when warm
            try:
                results[rep.id] = rep.engine.load_adapter(name, path)
            except Exception as e:  # noqa: BLE001 — typed per replica
                errors[rep.id] = e
        if errors and not results:
            raise next(iter(errors.values()))
        self._adapters[name] = (path, sha)
        stat_add("STAT_lora_fleet_loads")
        return results

    def _converge_adapters(self, rep: Replica):
        """Load every recorded adapter onto a replica that just turned
        warm; a refusal is counted, and requests naming the adapter fail
        typed at admission there."""
        for name, (path, _sha) in list(self._adapters.items()):
            try:
                rep.engine.load_adapter(name, path)
            except Exception:  # noqa: BLE001 — typed refusal, counted
                stat_add("STAT_lora_converge_failures")

    # the refresher and the autoscaler run off the driving thread and
    # count through these, so every counter, stat and gauge stays here
    def note_rollback(self):
        self._n["rollbacks"] += 1
        stat_add("STAT_fleet_rollbacks")
        _obs()["rollbacks"].inc()

    def note_scale(self, up: bool):
        key = "scale_up" if up else "scale_down"
        self._n[key] += 1
        stat_add(f"STAT_fleet_{key}")
        _obs()[key].inc()

    def set_target_replicas(self, n: int):
        _obs()["target_replicas"].set(int(n))

    # -- shutdown ------------------------------------------------------
    def abort_all(self, make_exc: Callable):
        for rep in self.replicas(_LIVE):
            rep.engine._abort_all(make_exc)
        parked, self._parked = self._parked, []
        for p in parked:
            p.resp._fail(make_exc(p.req))

    def close_all(self):
        """Close every replica and release every engine's device memory;
        parked runs fail typed."""
        for rep in self.replicas(_LIVE):
            rep.engine.close()
            rep.state = CLOSED
            self._publish_up(rep)
        for rep in self.replicas():
            rep.engine.close()
            rep.engine._free_device()
        parked, self._parked = self._parked, []
        for p in parked:
            p.resp._fail(RequestCancelled(
                f"request {p.req.id} aborted: fleet closed while the run "
                "was parked for migration"))

    # -- observability -------------------------------------------------
    def _publish_up(self, rep: Replica):
        _obs()["up"].labels(replica=str(rep.id)).set(
            1 if rep.routable() else 0)
        self._publish_counts()

    def _publish_counts(self):
        _obs()["replicas_up"].set(len(self.routable()))

    def _publish_inflight(self):
        obs = _obs()
        for rep in self.replicas(_LIVE):
            obs["inflight"].labels(replica=str(rep.id)).set(rep.load())
            obs["hb_age"].labels(replica=str(rep.id)).set(
                rep.heartbeat_age())

    def stale_routable(self) -> List[int]:
        """Routable replica ids whose heartbeat is older than
        ``heartbeat_timeout_s`` right now: nonzero when the driving loop
        itself stalled, when an outside health scraper is the only
        observer left."""
        if self.heartbeat_timeout_s is None:
            return []
        return [rep.id for rep in self.routable()
                if rep.heartbeat_age() > self.heartbeat_timeout_s]

    def counters(self) -> Dict:
        return dict(self._n, parked=len(self._parked), pending_restarts=0,
                    pending_flips=len(self._flips))


class _FleetSchedulerView:
    """The slice of RequestScheduler the gateway's signals read,
    aggregated over the fleet: free slots on routable replicas only,
    occupancy and queue depth over every live one."""

    def __init__(self, manager: ReplicaManager):
        self._m = manager

    def free_slot_count(self) -> int:
        return sum(r.engine.scheduler.free_slot_count()
                   for r in self._m.routable())

    def occupancy(self) -> int:
        return sum(r.engine.scheduler.occupancy()
                   for r in self._m.replicas(_LIVE))

    def queue_depth(self) -> int:
        return sum(r.engine.scheduler.queue_depth()
                   for r in self._m.replicas(_LIVE))

    def has_work(self) -> bool:
        return any(r.engine.scheduler.has_work()
                   for r in self._m.replicas(_LIVE))


class FleetRouter:
    """N replicas behind one front door.

    ::

        fleet = FleetRouter([make_engine() for _ in range(3)],
                            slow_threshold_ms=50)
        fleet.warmup()                  # all replicas routable
        fleet.start()                   # or front it with ServingGateway
        r = fleet.submit(prompt, 64, session="user-7", resubmit=True)
        for tok in r: ...
        fleet.rollout(make_engine)      # zero-downtime replacement
        fleet.close()

    It has the engine surface ``ServingGateway`` consumes, so
    ``ServingGateway(fleet, ...)`` fronts the fleet as it fronts one
    engine (its loop drives ``fleet.step()``).  Every replica must serve
    the same model with the same engine options.  ``workers`` (subprocess
    replicas) take an empty sequence only."""

    def __init__(self, replicas=(),
                 slow_threshold_ms: Optional[float] = None,
                 affinity: bool = True, max_sessions: int = 4096,
                 prefix_affinity: bool = False,
                 prefix_affinity_tokens: int = 32,
                 heartbeat_timeout_s: Optional[float] = 10.0,
                 kill_grace_s: float = 2.0,
                 restart_backoff: Optional[RestartBackoff] = None,
                 workers=()):
        self.manager = ReplicaManager(
            slow_threshold_ms=slow_threshold_ms,
            heartbeat_timeout_s=heartbeat_timeout_s,
            kill_grace_s=kill_grace_s, restart_backoff=restart_backoff)
        for engine in replicas:
            self.manager.add(engine)
        for spec in workers:
            self.manager.add_worker(spec)
        self._affinity_enabled = bool(affinity)
        self._prefix_affinity = bool(prefix_affinity)
        self._prefix_tokens = max(1, int(prefix_affinity_tokens))
        # LRU-bounded: one entry per live session key, refreshed on use
        self._affinity: Dict[str, int] = {}
        self._max_sessions = max(1, int(max_sessions))
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._work = threading.Event()
        self._closed = False
        self._close_lock = threading.Lock()
        self._dead: Optional[BaseException] = None
        # the attached FleetRefresher, whose canary verdicts back
        # `routable_verified` (none: every routable replica is verified)
        self._refresher = None

    # -- membership / lifecycle ---------------------------------------
    def add_replica(self, engine: ServingEngine) -> int:
        """Add a replica (warm it first, or call ``warmup()``); returns
        its id.  A replica not yet warm is never routed to."""
        if self._closed:
            raise UnavailableError("fleet is closed")
        return self.manager.add(engine).id

    def add_worker(self, spec: Dict, **kwargs) -> int:
        """Subprocess / remote replicas: not ported yet (raises
        UnimplementedError)."""
        if self._closed:
            raise UnavailableError("fleet is closed")
        return self.manager.add_worker(spec, **kwargs)

    def _unpin(self, rid: int):
        with self._lock:
            self._affinity = {s: r for s, r in self._affinity.items()
                              if r != rid}

    def drain(self, rid: int):
        self.manager.drain(rid)
        self._unpin(rid)
        self._work.set()

    def flip_weights(self, rid: int, path: Optional[str] = None,
                     sha: Optional[str] = None,
                     state: Optional[Dict] = None) -> Dict:
        """Schedule a weight flip on one replica (``ReplicaManager.
        flip_weights``); sessions pinned to it re-home meanwhile."""
        entry = self.manager.flip_weights(rid, path=path, sha=sha,
                                          state=state)
        self._unpin(rid)
        self._work.set()
        return entry

    def load_adapter(self, name: str, path: str,
                     sha: Optional[str] = None) -> Dict[int, str]:
        """Fleet-wide LoRA adapter hot-load (``ReplicaManager.
        load_adapter``)."""
        out = self.manager.load_adapter(name, path, sha=sha)
        self._work.set()
        return out

    def attach_refresher(self, refresher):
        """Register the FleetRefresher whose canary verdicts back the
        ``routable_verified`` health field."""
        self._refresher = refresher

    def remove(self, rid: int):
        self.manager.remove(rid)

    def warmup(self) -> Dict[int, Dict]:
        return self.manager.warm_all()

    def rollout(self, factory: Callable[[], ServingEngine],
                timeout: float = 300.0, drive: bool = False) -> List[int]:
        """Zero-downtime rolling restart: for each current replica, boot
        a replacement with ``factory()``, warm it (on the card: capture
        its graphs on this thread while the loop serves), add it, drain
        the old one, wait for its residents to migrate or finish, remove
        it.  ``drive=True`` steps the fleet from this thread while waiting
        (only when nothing else drives the loop); by default it polls."""
        old_ids = [r.id for r in self.manager.replicas(_LIVE)]
        new_ids = []
        for rid in old_ids:
            engine = factory()
            if not engine.warm:
                engine.warmup()
            new_ids.append(self.add_replica(engine))
            self.manager.refresh_warm_marks()
            self.drain(rid)
            t0 = time.monotonic()
            while True:
                rep = self.manager.get(rid)
                if rep is None or rep.state in (CLOSED, CRASHED):
                    break
                if drive:
                    self.step()
                else:
                    time.sleep(0.005)
                if time.monotonic() - t0 > timeout:
                    raise TimeoutError(
                        f"replica {rid} did not drain in {timeout}s "
                        f"({rep.engine.scheduler.occupancy()} residents)")
            self.remove(rid)
        return new_ids

    # -- engine-compatible surface (what ServingGateway consumes) -----
    @property
    def scheduler(self) -> _FleetSchedulerView:
        return _FleetSchedulerView(self.manager)

    @property
    def max_slots(self) -> int:
        return sum(r.engine.max_slots for r in self.manager.replicas(_LIVE))

    @property
    def warm(self) -> bool:
        live = self.manager.replicas(_LIVE)
        return bool(live) and all(r.engine.warm for r in live)

    @property
    def _slots(self) -> Dict:
        """{(replica id, slot): run} over live replicas: the gateway's
        preemption victim scan."""
        merged = {}
        for rep in self.manager.replicas(_LIVE):
            for slot, run in rep.engine._slots.items():
                merged[(rep.id, slot)] = run
        return merged

    def make_request(self, prompt, max_new_tokens: int, **kwargs):
        """Validate against a live replica's limits (the fleet is
        homogeneous by contract)."""
        if self._closed:
            raise UnavailableError("fleet is closed")
        if self._dead is not None:
            raise UnavailableError(f"fleet loop died: {self._dead!r}")
        reps = self.manager.routable() or self.manager.replicas(_LIVE)
        if not reps:
            raise UnavailableError("fleet has no live replicas")
        return reps[0].engine.make_request(prompt, max_new_tokens,
                                           **kwargs)

    def _affinity_key(self, req: Request) -> Optional[str]:
        """An explicit session wins; with ``prefix_affinity`` a
        sessionless request pins by a hash of its tenant and leading
        prompt tokens (the prefix the cache indexes)."""
        if req.session:
            return req.session
        if not self._prefix_affinity:
            return None
        head = np.asarray(req.prompt[:self._prefix_tokens], np.int32)
        h = hashlib.blake2b((req.tenant or "").encode() + b"\0"
                            + head.tobytes(), digest_size=8)
        return "px:" + h.hexdigest()

    def set_share_groups(self, groups: Dict[str, str]):
        """Broadcast the gateway's tenant -> KV share-group mapping to
        every replica."""
        for rep in self.manager.replicas(_LIVE):
            rep.engine.set_share_groups(groups)

    def try_admit(self, req: Request, resp: Response) -> bool:
        """Place the request now on the best replica (affinity, then
        least-loaded): the gateway's admission, on the driving thread."""
        akey = self._affinity_key(req)
        for rep in self._route_order(akey):
            if rep.engine.try_admit(req, resp):
                self._note_affinity(akey, rep.id)
                return True
        return False

    def preempt_slot(self, key) -> PreemptedRun:
        rid, slot = key
        rep = self.manager.get(rid)
        if rep is None or rep.state not in _LIVE:
            raise InvalidArgumentError(f"replica {rid} is not live")
        return rep.engine.preempt_slot(slot)

    def restore_run(self, paused: PreemptedRun) -> bool:
        """Resume a preempted run on any replica with capacity: the
        gateway's restore, fleet-wide."""
        for rep in self.manager._targets():
            if rep.engine.scheduler.free_slot_count() <= 0:
                continue
            try:
                check_compatible(encode_run(paused), rep.engine)
                if rep.engine.restore_run(paused):
                    return True
            except RunTransferError:
                continue
        return False

    def step(self) -> bool:
        if self._closed:
            return False
        return self.manager.tick()

    def has_work(self) -> bool:
        return (any(r.engine.has_work()
                    for r in self.manager.replicas(_LIVE))
                or bool(self.manager._parked))

    def _abort_all(self, make_exc):
        self.manager.abort_all(make_exc)

    # -- submission (caller threads) ----------------------------------
    def submit(self, prompt, max_new_tokens: int, block: bool = False,
               timeout: Optional[float] = None, **kwargs) -> Response:
        """Route one request: session-affine while its replica stays
        routable, least-loaded otherwise.  Raises the typed errors
        ``ServingEngine.submit`` raises; every accepted request reaches a
        terminal state even if its replica dies later."""
        req, resp = self.make_request(prompt, max_new_tokens, **kwargs)
        last_exc = None
        akey = self._affinity_key(req)
        for rep in self._route_order(akey):
            try:
                rep.engine.scheduler.submit(req, resp, block=block,
                                            timeout=timeout)
            except QueueFullError as e:
                last_exc = e
                continue
            self._note_affinity(akey, rep.id)
            self._work.set()
            return resp
        raise last_exc or UnavailableError(
            "no routable replica accepted the request")

    def _route_order(self, session: Optional[str]) -> List[Replica]:
        reps = self.manager._targets()
        if not (self._affinity_enabled and session):
            return reps
        with self._lock:
            rid = self._affinity.get(session)
        if rid is not None:
            for i, rep in enumerate(reps):
                if rep.id == rid:
                    if i:
                        reps.insert(0, reps.pop(i))
                    return reps
            # the pinned replica is gone or fenced: re-home
            with self._lock:
                self._affinity.pop(session, None)
        return reps

    def _note_affinity(self, session: Optional[str], rid: int):
        if self._affinity_enabled and session:
            with self._lock:
                # delete-then-insert is an LRU touch; overflow evicts the
                # oldest entry
                self._affinity.pop(session, None)
                self._affinity[session] = rid
                while len(self._affinity) > self._max_sessions:
                    self._affinity.pop(next(iter(self._affinity)))

    # -- driving -------------------------------------------------------
    def run_until_drained(self, timeout: Optional[float] = None):
        t0 = time.monotonic()
        while self.has_work():
            self.step()
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(f"fleet did not drain in {timeout}s")

    def start(self):
        """Background fleet loop (not under a gateway: the gateway's loop
        drives ``step()`` itself)."""
        if self._thread is not None:
            return
        if self._closed:
            raise UnavailableError("fleet is closed")
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    did = self.step()
                except BaseException as e:  # noqa: BLE001 — no hangs
                    self._dead = e
                    self._abort_all(lambda req: UnavailableError(
                        f"request {req.id} aborted: fleet loop died: "
                        f"{e!r}"))
                    return
                if not did:
                    self._work.wait(0.002)
                    self._work.clear()

        self._thread = threading.Thread(target=loop, name="serving-fleet",
                                        daemon=True)
        self._thread.start()

    def close(self):
        """Close every replica (releasing their device memory); every
        outstanding request reaches a terminal state.  Idempotent and safe
        under concurrent double-close."""
        self._closed = True
        self._stop.set()
        self._work.set()
        with self._close_lock:
            if self._thread is not None:
                self._thread.join(timeout=5.0)
                self._thread = None
            self.manager.close_all()
        with self._lock:
            self._affinity.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- introspection -------------------------------------------------
    def health(self) -> Dict:
        """Per-replica health and fleet aggregates, under the reference's
        keys: the gateway's /healthz fleet block.  ``all_routable_stale``
        means every replica the router would still feed has a heartbeat
        older than ``heartbeat_timeout_s`` (the driving loop stopped).
        The worker fields stay 0 until subprocess replicas are ported."""
        reps = self.manager.replicas()
        stale = self.manager.stale_routable()
        routable = self.manager.routable()
        if self._refresher is None:
            verified = len(routable)
        else:
            verified = sum(1 for r in routable
                           if self._refresher.sha_ok(r.engine.weights_sha))
        out = {
            "replicas": {str(r.id): r.snapshot() for r in reps},
            "routable": len(routable),
            "routable_verified": verified,
            "total": len(reps),
            "workers": 0,
            "remote_workers": 0,
            "warm": self.warm,
            "heartbeat_timeout_s": self.manager.heartbeat_timeout_s,
            "stale_routable": stale,
            "all_routable_stale": bool(routable)
            and len(stale) == len(routable),
            **self.manager.counters(),
        }
        if self._refresher is not None:
            out["refresh"] = self._refresher.status()
        return out

    def post_warmup_compiles(self) -> int:
        """The worst live replica's post-warmup capture count (the fleet
        contract is 0 on every replica); -1 if one never warmed."""
        vals = [r.engine.post_warmup_compiles()
                for r in self.manager.replicas(_LIVE)]
        return max(vals) if vals else -1

    def metrics(self) -> Dict:
        live = self.manager.replicas(_LIVE)
        totals = {"requests_completed": 0, "requests_errored": 0,
                  "tokens_out": 0}
        per = {}
        for rep in self.manager.replicas():
            m = rep.engine.metrics()
            if rep.state in _LIVE:
                for k in totals:
                    totals[k] += m.get(k) or 0
            per[str(rep.id)] = {"state": rep.state,
                                "occupancy": m.get("slot_occupancy"),
                                "queue_depth": m.get("queue_depth"),
                                "completed": m.get("requests_completed"),
                                "errored": m.get("requests_errored")}
        return {
            **totals,
            "replicas": per,
            "routable": len(self.manager.routable()),
            "live": len(live),
            "sessions": len(self._affinity),
            "prefix_affinity": self._prefix_affinity,
            "max_slots": self.max_slots,
            "warm": self.warm,
            "post_warmup_compiles": (self.post_warmup_compiles()
                                     if self.warm else None),
            **{f"fleet_{k}": v for k, v in self.manager.counters().items()},
        }
