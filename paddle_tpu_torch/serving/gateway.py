"""Multi-tenant serving gateway: SLO-aware admission in front of the
engine (port of paddle_tpu/serving/gateway.py).

The ServingEngine ends at a bounded FIFO — under overload every caller
degrades equally.  The gateway is the front door on top of it:

- **Per-tenant token buckets + weighted fairness.**  Each tenant gets a
  rate/burst bucket (checked at submit — a rate-limited request costs
  nothing downstream) and a weight; admission within a priority lane is
  stride-scheduled across tenants, so a weight-2 tenant drains twice as
  fast as a weight-1 tenant while both have work queued.
- **Priority lanes with preemption.**  A high-priority arrival that finds
  every KV slot occupied evicts a lower-priority decode: the victim's
  KV rows and sampling state go to the host (``engine.preempt_slot``),
  the slot serves the high request, and the victim resumes later
  (``engine.restore_run``) with the stream of a run that was never
  preempted.  Neither adds a captured program: the rows cross in one
  copy each way, written in place into the pools the graphs read.
- **Load shedding from live signals** (``slo.ShedPolicy``): lane depth,
  slot occupancy, the measured service-time EWMA, and the high lane's
  recent TTFT p99 — rejecting cheap-to-reject work at submit time instead
  of letting it time out expensively after queue residence + prefill.
- **Every admission outcome is a terminal Response** — shed,
  rate-limited, deadline-expired, preempted-then-cancelled, gateway
  closed: a consumer blocked in ``Response.tokens()`` / iteration always
  gets a terminal state, never a hang.  ``submit`` therefore returns a
  (possibly already-failed) Response instead of raising for policy
  outcomes.
- **An OpenAI-shaped streaming HTTP endpoint** (stdlib http.server, the
  ``observability.exporters.serve_metrics`` pattern): POST
  /v1/completions with ``stream`` support (SSE), plus /v1/models,
  /healthz and the Prometheus /metrics passthrough.  ``handle()`` renders
  any request without a socket.

The gateway owns the engine loop: it drives ``engine.step()`` from its
own thread (preempt/restore must interleave with steps, single-threaded).
Do not call ``engine.start()`` on a gatewayed engine.  Its telemetry is
the reference's: ``gateway_*`` counters, gauges and histograms and the
``STAT_gateway_*`` monitor counters, which ``observability.report()``
reads under ``"gateway"``.
"""
from __future__ import annotations

import json
import threading
import time
import types
from collections import deque
from typing import Dict, List, Optional

from ..core.errors import (InvalidArgumentError, ResourceExhaustedError,
                           UnavailableError)
from ..utils.monitor import stat_add
from .engine import ServingEngine, PreemptedRun
from .request import Request, Response, RequestCancelled
from .scheduler import DeadlineExceededError
from .slo import ShedPolicy, Signals, SLOTracker, TenantConfig

__all__ = ["ServingGateway", "GatewayServer", "RateLimitedError",
           "SheddedError", "serve_gateway", "PRIORITY_HIGH", "PRIORITY_LOW"]

PRIORITY_LOW = 0
PRIORITY_HIGH = 1


class RateLimitedError(ResourceExhaustedError):
    """The tenant's token bucket is empty: the request was rejected at
    submit.  Retry after the bucket refills (HTTP 429)."""
    code = "ResourceExhausted"


class SheddedError(UnavailableError):
    """The gateway shed this request to protect the latency SLO of work
    already admitted (HTTP 503).  `.reason` carries the tripped rule:
    queue_depth | est_wait | slo_pressure."""
    code = "Unavailable"

    def __init__(self, msg: str, reason: str = ""):
        super().__init__(msg)
        self.reason = reason


def _lane_name(priority: int) -> str:
    return "hi" if priority > 0 else "lo"


class _LaneEntry:
    __slots__ = ("req", "resp", "enq_at")

    def __init__(self, req: Request, resp: Response):
        self.req = req
        self.resp = resp
        self.enq_at = time.monotonic()


class _TenantState:
    __slots__ = ("name", "cfg", "bucket", "passes")

    def __init__(self, name: str, cfg: TenantConfig):
        self.name = name
        self.cfg = cfg
        self.bucket = cfg.make_bucket()
        self.passes: Dict[int, float] = {}  # priority -> stride pass


_obs_handles = None


def _obs():
    """Cached gateway observability handles (registry.reset() zeroes the
    values in place, handles stay valid)."""
    global _obs_handles
    if _obs_handles is None:
        from ..observability import metrics as _m
        _obs_handles = {
            "requests": _m.counter(
                "gateway_requests_total", "requests received by the gateway",
                labelnames=("tenant", "lane")),
            "shed": _m.counter(
                "gateway_shed_total", "requests shed at admission",
                labelnames=("reason",)),
            "rate_limited": _m.counter(
                "gateway_rate_limited_total",
                "requests rejected by a tenant token bucket",
                labelnames=("tenant",)),
            "preempt": _m.counter(
                "gateway_preempt_total",
                "low-priority decodes preempted for a high-priority "
                "arrival"),
            "resume": _m.counter(
                "gateway_resume_total", "preempted decodes resumed"),
            "depth_hi": _m.gauge(
                "gateway_lane_hi_depth", "high-priority lane queue depth"),
            "depth_lo": _m.gauge(
                "gateway_lane_lo_depth", "low-priority lane queue depth"),
            "paused": _m.gauge(
                "gateway_paused_runs", "preempted runs awaiting restore"),
            "ttft_hi": _m.histogram(
                "gateway_ttft_hi_seconds",
                "submit -> first token, high-priority lane"),
            "ttft_lo": _m.histogram(
                "gateway_ttft_lo_seconds",
                "submit -> first token, low-priority lane"),
        }
    return _obs_handles


class ServingGateway:
    """SLO-aware multi-tenant admission layer over a ServingEngine.

    ::

        eng = ServingEngine(model, max_slots=8, max_len=256)
        eng.warmup()
        gw = ServingGateway(
            eng,
            tenants={"gold": TenantConfig(rate=50, weight=4.0),
                     "free": TenantConfig(rate=5, weight=1.0,
                                          max_priority=0)},
            shed=ShedPolicy(max_lane_depth=32, ttft_slo=0.5))
        gw.start()                     # gateway drives the engine loop
        r = gw.submit(prompt, 64, tenant="gold", priority=PRIORITY_HIGH)
        for tok in r: ...              # r is terminal-on-rejection too
        gw.close()
    """

    def __init__(self, engine: ServingEngine,
                 tenants: Optional[Dict[str, TenantConfig]] = None,
                 default_tenant: Optional[TenantConfig] = None,
                 shed: Optional[ShedPolicy] = None,
                 preempt: bool = True, max_paused: Optional[int] = None,
                 model_name: str = "paddle-tpu",
                 request_timeout: float = 120.0):
        if engine._thread is not None:
            raise InvalidArgumentError(
                "engine loop already started; the gateway drives "
                "engine.step() itself — construct the engine without "
                "start()")
        self.engine = engine
        self.model_name = model_name
        self.request_timeout = float(request_timeout)
        self._default_cfg = default_tenant or TenantConfig()
        self._tenants: Dict[str, _TenantState] = {
            name: _TenantState(name, cfg)
            for name, cfg in (tenants or {}).items()}
        self.shed_policy = shed or ShedPolicy()
        self.tracker = SLOTracker()
        self._preempt_enabled = bool(preempt)
        self.max_paused = (int(max_paused) if max_paused is not None
                           else engine.max_slots * 4)
        # priority -> {tenant: deque[_LaneEntry]}
        self._lanes: Dict[int, Dict[str, deque]] = {}
        self._vtime: Dict[int, float] = {}  # per-lane stride virtual time
        self._paused: List[PreemptedRun] = []
        self._inflight: List[tuple] = []  # (resp, lane_name, [ttft_seen])
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._work = threading.Event()
        self._closed = False
        # concurrent double-close safety (see ServingEngine.close): the
        # join + fail-everything sequence runs exactly once at a time
        self._close_lock = threading.Lock()
        self._dead: Optional[BaseException] = None
        # counters surfaced by metrics() (registry handles shared with
        # Prometheus; these are the gateway-local snapshot copies)
        self._n = {"requests": 0, "admitted": 0, "shed": 0,
                   "rate_limited": 0, "preempted": 0, "resumed": 0,
                   "rejected_invalid": 0}
        # tenancy IS the prefix-cache share policy: tenants naming a
        # kv_share_group share cached KV; everyone else stays private
        groups = {name: cfg.kv_share_group
                  for name, cfg in (tenants or {}).items()
                  if cfg.kv_share_group is not None}
        set_groups = getattr(engine, "set_share_groups", None)
        if groups and set_groups is not None:
            set_groups(groups)

    # ------------------------------------------------------------------
    # submission (caller threads)
    # ------------------------------------------------------------------
    def _tenant_state(self, name: str) -> _TenantState:
        with self._lock:
            ts = self._tenants.get(name)
            if ts is None:
                ts = _TenantState(name, self._default_cfg)
                self._tenants[name] = ts
            return ts

    def _terminal(self, resp: Response, exc: BaseException) -> Response:
        resp._fail(exc)
        return resp

    def _synthetic_fail(self, exc: BaseException) -> Response:
        """Terminal Response for a request that failed validation before a
        Request object existed — the no-consumer-ever-hangs contract
        covers malformed submissions too."""
        stub = types.SimpleNamespace(id=-1, deadline=None, priority=0,
                                     tenant=None)
        return self._terminal(Response(stub), exc)

    def submit(self, prompt, max_new_tokens: int, tenant: str = "default",
               priority: int = PRIORITY_LOW, **kwargs) -> Response:
        """Admit one request.  ALWAYS returns a streaming Response; every
        admission outcome — shed, rate-limited, invalid, closed — is a
        terminal error on the Response rather than an exception, so a
        consumer can uniformly iterate / call tokens() without hanging.
        `kwargs` pass through to `ServingEngine.make_request`
        (decode_strategy, temperature, top_k, top_p, eos_token_id, seed,
        deadline).  `block`/`timeout` — engine.submit's queue-full
        backpressure knobs — are accepted and ignored: gateway admission
        is immediate (enqueue or a terminal rejection), there is no full
        queue to wait on."""
        kwargs.pop("block", None)
        kwargs.pop("timeout", None)
        if self._closed:
            return self._synthetic_fail(
                UnavailableError("gateway is closed"))
        if self._dead is not None:
            return self._synthetic_fail(UnavailableError(
                f"gateway loop died: {self._dead!r}"))
        ts = self._tenant_state(tenant)
        priority = max(0, min(int(priority), ts.cfg.max_priority))
        lane = _lane_name(priority)
        obs = _obs()
        obs["requests"].labels(tenant=tenant, lane=lane).inc()
        stat_add("STAT_gateway_requests")
        with self._lock:
            self._n["requests"] += 1
        if ts.cfg.adapter is not None:
            # the tenant's LoRA adapter rides on every one of its
            # requests; an unknown/unloaded adapter fails typed right
            # here (AdapterNotFoundError via make_request validation),
            # through the same no-consumer-ever-hangs path as any other
            # malformed submission
            kwargs.setdefault("adapter", ts.cfg.adapter)
        try:
            req, resp = self.engine.make_request(
                prompt, max_new_tokens, priority=priority, tenant=tenant,
                **kwargs)
        except Exception as e:
            with self._lock:
                self._n["rejected_invalid"] += 1
            return self._synthetic_fail(e)
        # load shedding from live signals, decided BEFORE the bucket is
        # debited: a shed request must not also burn the tenant's rate
        # budget (it was told to retry with backoff — punishing the retry
        # with a 429 would double-charge overload the tenant didn't cause)
        reason = self.shed_policy.decide(self._signals(priority), priority)
        if reason is not None:
            obs["shed"].labels(reason=reason).inc()
            stat_add("STAT_gateway_shed")
            with self._lock:
                self._n["shed"] += 1
            return self._terminal(resp, SheddedError(
                f"request {req.id} shed ({reason}): gateway over "
                "capacity — retry with backoff", reason=reason))
        # rate limit: the tenant's own budget, charged only for work that
        # passed admission policy
        if not ts.bucket.try_take():
            obs["rate_limited"].labels(tenant=tenant).inc()
            stat_add("STAT_gateway_rate_limited")
            with self._lock:
                self._n["rate_limited"] += 1
            return self._terminal(resp, RateLimitedError(
                f"tenant {tenant!r} over its rate limit "
                f"({ts.cfg.rate}/s, burst {ts.bucket.burst:g}); request "
                f"{req.id} rejected"))
        with self._lock:
            # re-check under the SAME lock _fail_everything drains with:
            # a close()/loop-death racing this submit must not let an
            # entry land in a lane nobody will ever process (the consumer
            # would hang forever — the contract this module exists for)
            if self._closed or self._dead is not None:
                closed_race = True
            else:
                closed_race = False
                tq = self._lanes.setdefault(req.priority, {})
                dq = tq.get(tenant)
                if dq is None:
                    dq = tq[tenant] = deque()
                if not dq:
                    # (re)activating tenant: jump its stride pass to the
                    # lane's virtual time so an idle spell cannot bank
                    # credit
                    vt = self._vtime.get(req.priority, 0.0)
                    ts.passes[req.priority] = max(
                        ts.passes.get(req.priority, 0.0), vt)
                dq.append(_LaneEntry(req, resp))
        if closed_race:
            return self._terminal(resp, UnavailableError(
                f"request {req.id} rejected: gateway "
                + ("closed" if self._closed
                   else f"loop died: {self._dead!r}")))
        self._update_depth_gauges()
        self._work.set()
        return resp

    # ------------------------------------------------------------------
    # signals + lane bookkeeping
    # ------------------------------------------------------------------
    def _depths(self):
        """(high_lane_depth, low_lane_depth) in ONE locked pass — this
        runs on every submit and every gauge update, and the lock is
        shared with the loop thread's lane pops."""
        with self._lock:
            hi = lo = 0
            for p, tq in self._lanes.items():
                n = sum(len(dq) for dq in tq.values())
                if p > 0:
                    hi += n
                else:
                    lo += n
            return hi, lo

    def _group_depth(self, hi: bool) -> int:
        depth_hi, depth_lo = self._depths()
        return depth_hi if hi else depth_lo

    def _signals(self, priority: int) -> Signals:
        depth_hi, depth_lo = self._depths()
        lane_depth = depth_hi if priority > 0 else depth_lo
        total = depth_hi + depth_lo
        occ = self.engine.scheduler.occupancy()
        free = self.engine.scheduler.free_slot_count()
        # a low arrival waits behind everything; a high arrival only
        # behind the high lane (it can preempt through the rest)
        ahead = depth_hi if priority > 0 else total
        return Signals(
            lane_depth=lane_depth, total_depth=total, occupancy=occ,
            free_slots=free, max_slots=self.engine.max_slots,
            ttft_p99_hi=self.tracker.ttft_p99("hi"),
            est_wait=self.tracker.est_wait(ahead, self.engine.max_slots),
            paused=len(self._paused))

    def _update_depth_gauges(self):
        obs = _obs()
        depth_hi, depth_lo = self._depths()
        obs["depth_hi"].set(depth_hi)
        obs["depth_lo"].set(depth_lo)
        obs["paused"].set(len(self._paused))

    # ------------------------------------------------------------------
    # the gateway loop (single thread; also drives engine.step())
    # ------------------------------------------------------------------
    def _sweep_lanes(self):
        """Queued entries whose caller cancelled or whose deadline expired
        get their terminal response here — they never cost a slot."""
        failed = False
        with self._lock:
            for priority, tq in self._lanes.items():
                for tenant, dq in tq.items():
                    keep = deque()
                    for e in dq:
                        if e.resp.cancelled:
                            e.resp._fail(RequestCancelled(
                                f"request {e.req.id} cancelled while "
                                "queued in the gateway"))
                            failed = True
                        elif (e.req.deadline is not None
                              and e.req.deadline.expired()):
                            stat_add("STAT_serving_deadline_expired")
                            e.resp._fail(DeadlineExceededError(
                                f"request {e.req.id} deadline "
                                f"({e.req.deadline.seconds}s) expired in "
                                "the gateway queue"))
                            failed = True
                        else:
                            keep.append(e)
                    tq[tenant] = keep
        if failed:
            self._update_depth_gauges()

    def _sweep_paused(self):
        """A preempted run can be cancelled or expire while paused; it
        must reach a terminal state without ever being restored."""
        keep = []
        for p in self._paused:
            if p.resp.cancelled:
                p.resp._fail(RequestCancelled(
                    f"request {p.req.id} cancelled while preempted"))
            elif p.req.deadline is not None and p.req.deadline.expired():
                stat_add("STAT_serving_deadline_expired")
                p.resp._fail(DeadlineExceededError(
                    f"request {p.req.id} deadline "
                    f"({p.req.deadline.seconds}s) expired while preempted"))
            else:
                keep.append(p)
        if len(keep) != len(self._paused):
            self._paused = keep
            self._update_depth_gauges()

    def _observe_inflight(self):
        """Record TTFT at first token and service time at completion for
        the SLO tracker + histograms (drives the shed policy live)."""
        obs = _obs()
        keep = []
        for resp, lane, seen in self._inflight:
            if not seen[0] and resp.first_token_at is not None:
                seen[0] = True
                ttft = resp.ttft
                self.tracker.note_ttft(lane, ttft)
                (obs["ttft_hi"] if lane == "hi"
                 else obs["ttft_lo"]).observe(ttft)
            if resp.done():
                if (resp.error is None and resp.finished_at is not None
                        and resp.first_token_at is not None):
                    # service time from FIRST TOKEN, minus time spent
                    # preempted: neither queue wait nor paused wall time
                    # may feed back into est_wait (congestion would
                    # inflate "service", which sheds more, which keeps
                    # shedding after the backlog drains)
                    self.tracker.note_service(max(0.0, (
                        resp.finished_at - resp.first_token_at
                        - getattr(resp.request, "paused_seconds", 0.0))))
            else:
                keep.append((resp, lane, seen))
        self._inflight = keep

    def _best_waiting_lane(self) -> Optional[int]:
        with self._lock:
            live = [p for p, tq in self._lanes.items()
                    if any(tq.values())]
            return max(live) if live else None

    def _pop_lane(self, priority: int):
        """Stride-fair pop across the lane's tenants: the tenant with the
        smallest pass value goes, then its pass advances by 1/weight.
        Returns (entry, tenant, previous_pass) so a failed admission can
        roll the pass back."""
        with self._lock:
            tq = self._lanes.get(priority) or {}
            candidates = [(self._tenants[t].passes.get(priority, 0.0), t)
                          for t, dq in tq.items() if dq]
            if not candidates:
                return None
            prev_pass, tenant = min(candidates)
            ts = self._tenants[tenant]
            entry = tq[tenant].popleft()
            new_pass = prev_pass + 1.0 / ts.cfg.weight
            ts.passes[priority] = new_pass
            self._vtime[priority] = max(
                self._vtime.get(priority, 0.0), new_pass)
            return entry, tenant, prev_pass

    def _admit_one(self) -> bool:
        """Place ONE unit of waiting work into a free slot: the best
        waiting lane entry, or a paused run of >= that priority (it holds
        progress and arrived earlier).  False when nothing is waiting or
        no slot is free."""
        if self.engine.scheduler.free_slot_count() <= 0:
            return False
        best_lane = self._best_waiting_lane()
        best_paused = max((p.req.priority for p in self._paused),
                          default=None)
        if best_lane is None and best_paused is None:
            return False
        if best_paused is not None and (best_lane is None
                                        or best_paused >= best_lane):
            for i, p in enumerate(self._paused):
                if p.req.priority == best_paused:
                    self._paused.pop(i)
                    break
            if self.engine.restore_run(p):
                _obs()["resume"].inc()
                stat_add("STAT_gateway_resumes")
                with self._lock:
                    self._n["resumed"] += 1
                self._update_depth_gauges()
                return True
            self._paused.insert(0, p)  # no slot after all; retry later
            return False
        popped = self._pop_lane(best_lane)
        if popped is None:
            return False
        entry, tenant, prev_pass = popped
        if not self.engine.try_admit(entry.req, entry.resp):
            # no slot (or, paged, no blocks — try_admit's block-aware
            # gate makes this ROUTINE under pool pressure): requeue at
            # the front and ROLL BACK the stride pass, so waiting on
            # capacity never eats the tenant's configured fair share
            with self._lock:
                self._lanes.setdefault(best_lane, {}).setdefault(
                    tenant, deque()).appendleft(entry)
                ts = self._tenants.get(tenant)
                if ts is not None:
                    ts.passes[best_lane] = prev_pass
            return False
        with self._lock:
            self._n["admitted"] += 1
        stat_add("STAT_gateway_admitted")
        self._inflight.append(
            (entry.resp, _lane_name(entry.req.priority), [False]))
        self._update_depth_gauges()
        return True

    def _maybe_preempt(self):
        """While a waiting arrival outranks an active decode and no slot
        is free: snapshot the weakest victim to host, free its slot, admit
        the high entry into it.  Victim choice: lowest priority first,
        then fewest tokens produced (least progress lost to pausing)."""
        if not self._preempt_enabled:
            return
        while True:
            hi = self._best_waiting_lane()
            if hi is None or hi <= 0:
                return
            if self.engine.scheduler.free_slot_count() > 0:
                return  # plain admission will take it
            if len(self._paused) >= self.max_paused:
                return
            victim_slot, best = None, None
            for slot, run in self.engine._slots.items():
                if run.req.priority < hi:
                    key = (run.req.priority, run.produced)
                    if best is None or key < best:
                        best, victim_slot = key, slot
            if victim_slot is None:
                return  # everything active outranks the arrival
            try:
                paused = self.engine.preempt_slot(victim_slot)
            except InvalidArgumentError:
                # the victim finished between the scan and the preempt;
                # this loop retries at the next tick
                return
            self._paused.append(paused)
            _obs()["preempt"].inc()
            stat_add("STAT_gateway_preemptions")
            with self._lock:
                self._n["preempted"] += 1
            self._update_depth_gauges()
            # the freed slot goes to the high lane NOW (the paused run,
            # being lower priority, cannot win it back this round)
            self._admit_one()

    def _tick(self) -> bool:
        self._sweep_lanes()
        self._sweep_paused()
        self._observe_inflight()
        did = False
        while self._admit_one():
            did = True
        self._maybe_preempt()
        did = self.engine.step() or did
        return did

    def has_work(self) -> bool:
        with self._lock:
            lanes = any(dq for tq in self._lanes.values()
                        for dq in tq.values())
        return lanes or bool(self._paused) or self.engine.has_work()

    def run_until_drained(self, timeout: Optional[float] = None):
        """Drive the gateway+engine in the caller's thread until every
        lane, paused run, and slot is empty (tests / batch use).  Not for
        use while start() is live."""
        t0 = time.monotonic()
        while self.has_work():
            self._tick()
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"gateway did not drain in {timeout}s")
        # requests that completed inside the final tick's engine.step()
        # still owe their TTFT/service samples
        self._observe_inflight()

    def start(self):
        """Background gateway loop (also the engine loop — the engine's
        own start() must not be used)."""
        if self._thread is not None:
            return
        if self._closed:
            raise UnavailableError("gateway is closed")
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    did = self._tick()
                except BaseException as e:  # noqa: BLE001 — no hangs
                    self._dead = e
                    self._fail_everything(lambda req: UnavailableError(
                        f"request {req.id} aborted: gateway loop died: "
                        f"{e!r}"))
                    return
                if not did:
                    self._work.wait(0.002)
                    self._work.clear()

        self._thread = threading.Thread(target=loop,
                                        name="serving-gateway",
                                        daemon=True)
        self._thread.start()

    def _fail_everything(self, make_exc):
        """Terminal responses for every lane entry, paused run, and
        in-flight slot (gateway death/close)."""
        with self._lock:
            entries = [e for tq in self._lanes.values()
                       for dq in tq.values() for e in dq]
            self._lanes = {}
            paused, self._paused = self._paused, []
        for e in entries:
            e.resp._fail(make_exc(e.req))
        for p in paused:
            p.resp._fail(make_exc(p.req))
        self.engine._abort_all(make_exc)
        self._update_depth_gauges()

    def close(self, close_engine: bool = True):
        """Stop the loop; every outstanding request — queued, paused, or
        decoding — reaches a terminal error (never a hang).  Idempotent
        and safe under concurrent double-close: the flag flips first so
        racing submits reject, and the join/drain sequence serializes
        under _close_lock."""
        self._closed = True
        self._stop.set()
        self._work.set()
        with self._close_lock:
            if self._thread is not None:
                self._thread.join(timeout=5.0)
                self._thread = None
            self._fail_everything(lambda req: RequestCancelled(
                f"request {req.id} aborted: gateway closed"
                + (" (was preempted)"
                   if getattr(req, "preempts", 0) > getattr(req, "resumes",
                                                            0)
                   else "")))
        if close_engine:
            self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def metrics(self) -> Dict:
        def ms(v):
            return None if v is None else v * 1e3
        with self._lock:
            n = dict(self._n)
            # snapshot under the lock: _tenant_state inserts first-seen
            # tenants concurrently from caller threads
            tenants = dict(self._tenants)
        depth_hi, depth_lo = self._depths()
        return {
            **n,
            "lane_depth_hi": depth_hi,
            "lane_depth_lo": depth_lo,
            "paused": len(self._paused),
            "ttft_p99_hi_ms": ms(self.tracker.ttft_p99("hi")),
            "ttft_p99_lo_ms": ms(self.tracker.ttft_p99("lo")),
            "service_ewma_ms": ms(self.tracker.service_ewma()),
            # inf (unlimited) renders as None: json.dumps would emit the
            # non-RFC literal `Infinity` that strict parsers reject
            "tenants": {name: {
                "weight": ts.cfg.weight,
                "rate": None if ts.cfg.rate == float("inf")
                else ts.cfg.rate,
                "bucket_level": None if ts.bucket.level() == float("inf")
                else round(ts.bucket.level(), 3)}
                for name, ts in tenants.items()},
            "engine": self.engine.metrics(),
        }

    def scale_signals(self) -> Dict:
        """The cheap SLO signals an autoscaler polls every tick: current
        estimated queue wait (EWMA service time x depth / slots), lane
        depths, and the monotonic shed/admitted counters (the caller
        diffs them per tick to get a shed *rate*).  No engine round-trip
        beyond depth reads — safe to call at high frequency."""
        depth_hi, depth_lo = self._depths()
        depth = depth_hi + depth_lo
        with self._lock:
            shed = self._n["shed"]
            admitted = self._n["admitted"]
        slots = max(1, int(getattr(self.engine, "max_slots", 1) or 1))
        return {
            "est_wait_s": self.tracker.est_wait(depth, slots),
            "queue_depth": depth,
            "lane_depth_hi": depth_hi,
            "lane_depth_lo": depth_lo,
            "shed_total": shed,
            "admitted_total": admitted,
        }

    # ------------------------------------------------------------------
    # OpenAI-shaped HTTP surface (port-free handler + stdlib server)
    # ------------------------------------------------------------------
    @staticmethod
    def _http_status(exc: BaseException) -> int:
        if isinstance(exc, RateLimitedError):
            return 429
        if isinstance(exc, SheddedError):
            return 503
        if isinstance(exc, (DeadlineExceededError, TimeoutError)):
            return 504
        if isinstance(exc, RequestCancelled):
            return 499
        if isinstance(exc, (InvalidArgumentError, ValueError, TypeError,
                            KeyError)):
            return 400
        if isinstance(exc, ResourceExhaustedError):
            return 503
        return 500

    @staticmethod
    def _error_body(exc: BaseException) -> dict:
        return {"error": {"message": str(exc),
                          "type": type(exc).__name__,
                          "code": getattr(exc, "code", None)}}

    def _parse_completion(self, body: dict):
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            prompt = [int(t) for t in prompt.split()]
        if not isinstance(prompt, (list, tuple)) or not prompt:
            raise ValueError(
                "prompt must be a non-empty list of token ids (or a "
                "space-separated id string); paddle_tpu serves token ids — "
                "tokenize client-side")
        kwargs = {"max_new_tokens": int(body.get("max_tokens", 16))}
        # OpenAI convention: temperature 0 (the default here) = greedy
        temp = float(body.get("temperature", 0.0))
        if temp > 0.0:
            kwargs.update(decode_strategy="sampling", temperature=temp,
                          top_p=float(body.get("top_p", 1.0)),
                          top_k=int(body.get("top_k", 0)))
            if body.get("seed") is not None:
                kwargs["seed"] = int(body["seed"])
        if body.get("eos_token_id") is not None:
            kwargs["eos_token_id"] = int(body["eos_token_id"])
        if body.get("deadline_ms") is not None:
            kwargs["deadline"] = float(body["deadline_ms"]) / 1e3
        tenant = str(body.get("user") or body.get("tenant") or "default")
        pr = body.get("priority", PRIORITY_LOW)
        priority = {"high": PRIORITY_HIGH, "low": PRIORITY_LOW}.get(
            pr, pr if isinstance(pr, int) else PRIORITY_LOW)
        stream = bool(body.get("stream", False))
        return prompt, kwargs, tenant, priority, stream

    def _completion_json(self, resp: Response, toks: List[int]) -> dict:
        reason = {"eos": "stop", "length": "length"}.get(
            resp.finish_reason, resp.finish_reason)
        plen = (len(resp.request.prompt)
                if isinstance(resp.request, Request) else 0)
        return {
            "id": f"cmpl-{resp.request.id}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": [{"index": 0,
                         "text": " ".join(str(t) for t in toks),
                         "token_ids": list(toks),
                         "finish_reason": reason}],
            "usage": {"prompt_tokens": plen,
                      "completion_tokens": len(toks),
                      "total_tokens": plen + len(toks)},
        }

    def _sse_stream(self, resp: Response):
        """SSE chunk iterator for stream=true: one data: line per token,
        a finish chunk, then [DONE].  A mid-stream error becomes an error
        chunk — the consumer always sees a terminal event.  A consumer
        that stops reading (client disconnect closes the generator)
        cancels the request: an abandoned stream must not leave a slot
        decoding for nobody."""
        rid = f"cmpl-{resp.request.id}"

        def chunk(text, token_ids, finish_reason):
            return ("data: " + json.dumps({
                "id": rid, "object": "text_completion",
                "model": self.model_name,
                "choices": [{"index": 0, "text": text,
                             "token_ids": token_ids,
                             "finish_reason": finish_reason}],
            }) + "\n\n").encode()

        try:
            try:
                for tok in resp:
                    yield chunk(f"{tok} ", [int(tok)], None)
                reason = {"eos": "stop", "length": "length"}.get(
                    resp.finish_reason, resp.finish_reason)
                yield chunk("", [], reason)
            except GeneratorExit:
                raise  # consumer gone: no further yields allowed
            except BaseException as e:  # noqa: BLE001 — must terminate
                yield ("data: " + json.dumps(self._error_body(e)) + "\n\n"
                       ).encode()
            yield b"data: [DONE]\n\n"
        finally:
            if not resp.done():
                resp.cancel()

    def handle(self, method: str, path: str, body: Optional[bytes] = None):
        """(status, content_type, payload) for one HTTP request — payload
        is bytes, or an iterator of SSE byte chunks for streaming
        completions.  Callable without a socket."""
        route = path.split("?")[0]
        if method == "GET":
            if route == "/v1/models":
                return 200, "application/json", json.dumps({
                    "object": "list",
                    "data": [{"id": self.model_name, "object": "model",
                              "owned_by": "paddle_tpu"}]}).encode()
            if route == "/healthz":
                status = 503 if (self._closed or self._dead) else 200
                # the port keeps no persistent program store (a CUDA
                # graph is not saved): the section of a store that is off
                from ..observability.exporters import program_store_stats
                pstore = program_store_stats()
                # a fleet-fronted gateway aggregates per-replica health
                # (state, warm, step EWMA, heartbeat age, post-warmup
                # captures, served weights_sha) and the routable count:
                # whether this front door still has capacity behind it
                health_fn = getattr(self.engine, "health", None)
                fleet = health_fn() if callable(health_fn) else None
                if fleet is not None and (
                        fleet["routable"] == 0
                        # replicas up, but none serves canary-verified
                        # weights (mid-rollback, or a bad publish)
                        or fleet["routable_verified"] == 0
                        # every routable replica's heartbeat is stale:
                        # the driving loop itself stalled
                        or fleet["all_routable_stale"]):
                    status = 503
                # prefix-cache effectiveness
                pc = getattr(self.engine, "prefix_cache", None)
                prefix = pc.stats() if pc is not None else None
                # multi-tenant LoRA: which adapters are resident, how
                # many slots are pinned, load/eviction counters — the
                # operator's "is tenant X actually loaded here" signal
                reg = getattr(self.engine, "_lora_reg", None)
                lora = reg.stats() if reg is not None else None
                return status, "application/json", json.dumps({
                    "ok": status == 200,
                    "fleet": fleet,
                    "prefix_cache": prefix,
                    "lora": lora,
                    # readiness: warm=True means every serving program is
                    # captured (engine.warmup ran) — no admitted request
                    # will ever pay a capture
                    "warm": bool(getattr(self.engine, "warm", False)),
                    "program_store": pstore,
                    "gateway": {k: v for k, v in self.metrics().items()
                                if k != "engine"}},
                    default=str).encode()
            if route in ("/metrics", "/report"):
                from ..observability.exporters import render_endpoint
                return render_endpoint(route)
            return 404, "text/plain", b"not found\n"
        if method == "POST" and route == "/v1/completions":
            try:
                parsed = json.loads((body or b"{}").decode() or "{}")
                prompt, kwargs, tenant, priority, stream = \
                    self._parse_completion(parsed)
            except Exception as e:
                return (400, "application/json",
                        json.dumps(self._error_body(e)).encode())
            resp = self.submit(prompt, tenant=tenant, priority=priority,
                               **kwargs)
            if stream:
                # rejection surfaces as a proper status even in stream
                # mode: terminal-on-submit responses are failed already
                if resp.done() and resp.error is not None:
                    return (self._http_status(resp.error),
                            "application/json",
                            json.dumps(self._error_body(
                                resp.error)).encode())
                return 200, "text/event-stream", self._sse_stream(resp)
            try:
                toks = resp.tokens(timeout=self.request_timeout)
            except BaseException as e:  # noqa: BLE001 — typed status out
                if not resp.done():
                    # handler timeout with the request still decoding:
                    # cancel it so an abandoned HTTP client cannot leave
                    # a slot burning decode cycles with no consumer
                    resp.cancel()
                return (self._http_status(e), "application/json",
                        json.dumps(self._error_body(e)).encode())
            return (200, "application/json",
                    json.dumps(self._completion_json(resp, toks)).encode())
        return 405, "text/plain", b"method not allowed\n"


class GatewayServer:
    """The OpenAI-shaped endpoint over stdlib http.server (the
    `serve_metrics` pattern): POST /v1/completions (+SSE streaming), GET
    /v1/models, /healthz, /metrics, /report."""

    def __init__(self, gateway: ServingGateway, port: int = 0,
                 addr: str = "127.0.0.1"):
        import http.server
        gw = gateway

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _respond(self, status, ctype, payload):
                if isinstance(payload, (bytes, bytearray)):
                    self.send_response(status)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                # SSE: stream chunks as the engine produces them
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                try:
                    for chunk in payload:
                        self.wfile.write(chunk)
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client went away mid-stream

            def do_GET(self):  # noqa: N802 (stdlib naming)
                self._respond(*gw.handle("GET", self.path))

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                self._respond(*gw.handle("POST", self.path, body))

            def log_message(self, *a):  # per-request stderr noise
                pass

        self._httpd = http.server.ThreadingHTTPServer((addr, port), Handler)
        self.port = self._httpd.server_address[1]
        self.addr = addr
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="paddle_tpu_torch-gateway-http",
                                        daemon=True)
        self._thread.start()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def serve_gateway(gateway: ServingGateway, port: int = 8000,
                  addr: str = "127.0.0.1") -> GatewayServer:
    """Start the OpenAI-shaped endpoint; returns the server (`.close()`
    stops it; the gateway itself is left running)."""
    return GatewayServer(gateway, port=port, addr=addr)
