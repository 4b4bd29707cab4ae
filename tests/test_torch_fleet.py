"""paddle_tpu_torch's in-process serving fleet against the JAX package's on
the CPU (``serving/fleet.py``, the gateway's fleet health).

Both frameworks run the same script on ``torch_parity``'s tiny GPT (the
weights carried across), paged KV, driven in the caller's thread: the
replica each request is routed to, session affinity and its LRU bound,
greedy and keyed-sampled streams, a drain that migrates residents
mid-decode through the run-transfer codec and one that finishes in place
on a full fleet, crash failover (which runs are resubmitted, which end in
``ReplicaLostError``, the resubmitted streams), ``counters()``,
``health()`` (timing fields aside) and the telemetry report's fleet
section must all be equal.  A gateway over each fleet answers /healthz
with the same statuses and fleet block, 503 included.  Port-only: the
fault knobs' parse rules against the reference's, a rollout under traffic
on the fleet's own thread, a removed replica giving its device state
back, and a brownout fenced on an injected delay of over 100x a step
(never on a tight wall-clock margin).  A test that starts a thread holds
a SIGALRM limit that raises a BaseException (a fleet tick would take an
Exception for a replica crash) and closes everything in ``finally``."""
import json
import signal
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest

import paddle_tpu.serving as J
from paddle_tpu import observability as jobs
from paddle_tpu.utils import faults as jfaults

import paddle_tpu_torch.serving as T
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.utils import faults as tfaults

from torch_parity import tiny_pair, torch_solo

ENGINE = dict(max_slots=2, max_len=48, prefill_buckets=(16,),
              decode_chunk=2, kv="paged", block_size=8)
PROMPTS = [np.random.RandomState(i).randint(0, 128, (n,)).tolist()
           for i, n in enumerate((3, 5, 9, 4, 7, 10, 6, 8, 11, 5))]
SAMPLED = dict(decode_strategy="sampling", top_k=8, temperature=0.8)
SAMPLED_AT = (1, 3)   # the routing script's keyed-sampled requests
# health fields that read a wall clock
TIMING = ("heartbeat_age_s", "step_ewma_ms")


class _Limit(BaseException):
    """A test's time limit: not an Exception, so a fleet tick in the main
    thread does not fence a replica for it."""


@contextmanager
def hard_limit(seconds):
    def boom(*_):
        raise _Limit(f"test exceeded its {seconds} s limit")
    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=1)


@pytest.fixture(scope="module")
def sides(pair):
    """name -> (serving module, faults module, engine factory)."""
    jm, tm = pair
    return {
        "ref": (J, jfaults, lambda: J.ServingEngine(jm, **ENGINE)),
        "port": (T, tfaults,
                 lambda: T.ServingEngine(tm, device="cpu", **ENGINE)),
    }


def _health(h):
    """``health()`` without the wall-clock fields."""
    out = dict(h, replicas={rid: {k: v for k, v in snap.items()
                                  if k not in TIMING}
                            for rid, snap in h["replicas"].items()})
    return out


def _outcome(resp):
    return (type(resp.error).__name__ if resp.error else None,
            resp.tokens_so_far(), resp.request.migrations)


def _routing_and_drains(mod, faults, make):
    """Three replicas, sessions with an LRU bound of 2: four requests
    (greedy and keyed-sampled; two pinned to replica 0) routed and
    decoded, replica 0 drained mid-decode (its residents migrate, one to
    each peer); then four greedy requests fill replicas 1 and 2 and
    replica 1 drains on the full fleet (its residents finish in place)."""
    fleet = mod.FleetRouter([make() for _ in range(3)], max_sessions=2)
    fleet.warmup()
    rec = {"loads": [], "occupancy": []}
    try:
        sessions = ["a", "a", "b", "c"]
        resps = []
        for i, s in enumerate(sessions):
            kw = dict(SAMPLED, seed=20 + i) if i in SAMPLED_AT else {}
            resps.append(fleet.submit(PROMPTS[i], 12, session=s, **kw))
            rec["loads"].append([r.engine.scheduler.queue_depth()
                                 for r in fleet.manager.replicas()])
        rec["affinity"] = dict(fleet._affinity)
        for _ in range(3):
            fleet.step()
        rec["occupancy"].append([r.engine.scheduler.occupancy()
                                 for r in fleet.manager.replicas()])
        fleet.drain(0)
        fleet.run_until_drained(timeout=60)
        rec["wave1"] = [_outcome(r) for r in resps]
        rec["counters1"] = fleet.manager.counters()
        more = [fleet.submit(PROMPTS[6 + i], 12) for i in range(4)]
        for _ in range(3):
            fleet.step()
        rec["occupancy"].append([r.engine.scheduler.occupancy()
                                 for r in fleet.manager.replicas()])
        fleet.drain(1)
        fleet.run_until_drained(timeout=60)
        rec["wave2"] = [_outcome(r) for r in more]
        rec["health"] = _health(fleet.health())
        rec["metric_keys"] = sorted(fleet.metrics())
        rec["post_warmup_compiles"] = fleet.post_warmup_compiles()
    finally:
        fleet.close()
    return rec


def test_routing_streams_and_drains_equal_the_reference(sides, pair):
    got = {name: _routing_and_drains(*side) for name, side in sides.items()}
    port, ref = got["port"], got["ref"]
    assert port == ref
    # the script did what it says: sessions pinned and bounded, sampled
    # and greedy streams, migrations off replica 0, none off replica 1
    assert list(port["affinity"]) == ["b", "c"]
    assert port["loads"][1] == [2, 0, 0]
    assert port["occupancy"] == [[2, 1, 1], [0, 2, 2]]
    wave1 = port["wave1"]
    assert all(err is None and len(toks) == 12 for err, toks, _ in wave1)
    assert sum(m for *_, m in wave1) == 2 == port["counters1"]["migrated"]
    assert all(m == 0 for *_, m in port["wave2"])
    assert port["health"]["replicas"]["1"]["state"] == "closed"
    assert port["health"]["routable"] == 1
    assert port["post_warmup_compiles"] == 0
    model = pair[1]
    for i, (err, toks, _) in enumerate(wave1):
        if i not in SAMPLED_AT:
            assert toks == torch_solo(model, PROMPTS[i], 12), i
    for i, (err, toks, _) in enumerate(port["wave2"]):
        assert toks == torch_solo(model, PROMPTS[6 + i], 12), i


def _report_fleet(obs):
    return obs.report()["fleet"]


def _crash(mod, faults, make, obs):
    """Two replicas, six requests (greedy with resubmit, keyed-sampled,
    plain greedy) over the four slots and the queues; replica 1 crashes
    mid-decode."""
    fleet = mod.FleetRouter([make() for _ in range(2)])
    fleet.warmup()
    before = _report_fleet(obs)
    try:
        resps = []
        for i in range(6):
            kw = ({"resubmit": True} if i % 3 == 0 else
                  dict(SAMPLED, seed=30 + i) if i % 3 == 1 else {})
            resps.append(fleet.submit(PROMPTS[i], 12, **kw))
        for _ in range(3):
            fleet.step()
        assert all(resps[i].tokens_so_far() for i in range(4))
        rep = fleet.manager.get(1)
        faults.enable("replica_crash", f"1:{rep.steps}")
        fleet.run_until_drained(timeout=60)
        faults.reset()
        after = _report_fleet(obs)
        rec = {"outcomes": [_outcome(r) for r in resps],
               "done": [r.done() for r in resps],
               "counters": fleet.manager.counters(),
               "health": _health(fleet.health()),
               "crashed_occupancy": rep.engine.scheduler.occupancy(),
               "report": {k: after[k] - before[k] for k in
                          ("failovers", "resubmits", "lost_runs",
                           "reroutes")},
               "replicas_up": after["replicas_up"]}
    finally:
        fleet.close()
    return rec


def test_crash_failover_equals_the_reference(sides, pair):
    jm_obs = {"ref": jobs, "port": tobs}
    got = {name: _crash(*side, jm_obs[name]) for name, side in sides.items()}
    port, ref = got["port"], got["ref"]
    assert port == ref
    errs = [err for err, _, _ in port["outcomes"]]
    assert "ReplicaLostError" in errs and all(port["done"])
    c = port["counters"]
    assert c["failovers"] == 1 and c["resubmits"] >= 1 and c["lost"] >= 1
    assert port["report"]["failovers"] == 1 and port["replicas_up"] == 1
    assert port["crashed_occupancy"] == 0
    assert port["health"]["replicas"]["1"]["state"] == "crashed"
    model = pair[1]
    for i in (0, 3):   # resubmitted greedy streams, whole end to end
        err, toks, _ = port["outcomes"][i]
        assert err is None and toks == torch_solo(model, PROMPTS[i], 12)


class _Verdict:
    """A stand-in refresher whose canary verdict the test sets."""

    def __init__(self):
        self.ok = True

    def sha_ok(self, sha):
        return self.ok

    def status(self):
        return {"current_sha": None, "verified": 0, "quarantined": {},
                "last_error": None}


def _gateway_healthz(mod, make):
    """A gateway over a 2-replica fleet: served requests, then /healthz
    while healthy, with no verified replica, with every heartbeat stale,
    and with nothing routable."""
    fleet = mod.FleetRouter([make() for _ in range(2)])
    fleet.warmup()
    gw = mod.ServingGateway(fleet)
    out = []
    try:
        resps = [gw.submit(PROMPTS[i], 8, tenant="t", session=f"u{i}")
                 for i in range(3)]
        gw.run_until_drained(timeout=60)
        out.append([r.tokens() for r in resps])

        def healthz():
            status, _, body = gw.handle("GET", "/healthz")
            fl = json.loads(body)["fleet"]
            out.append((status, fl and _health(fl)))

        healthz()
        verdict = _Verdict()
        fleet.attach_refresher(verdict)
        verdict.ok = False
        healthz()
        fleet.attach_refresher(None)
        fleet.manager.heartbeat_timeout_s = 0.0
        healthz()
        fleet.manager.heartbeat_timeout_s = 10.0
        fleet.drain(0)
        fleet.drain(1)
        gw.run_until_drained(timeout=60)
        healthz()
    finally:
        gw.close()
    return out


def test_gateway_over_the_fleet_reports_its_health(sides):
    got = {name: _gateway_healthz(side[0], side[2])
           for name, side in sides.items()}
    port, ref = got["port"], got["ref"]
    # a stale heartbeat is judged against the wall clock: the reference
    # and the port agree on the verdict, not on the ages
    for rec in (port, ref):
        rec[3][1]["stale_routable"] = sorted(rec[3][1]["stale_routable"])
    assert port == ref
    statuses = [s for s, _ in port[1:]]
    assert statuses == [200, 503, 503, 503]
    assert port[1][1]["routable"] == 2 and port[1][1]["total"] == 2
    assert port[2][1]["routable_verified"] == 0
    assert port[3][1]["all_routable_stale"] is True
    assert port[4][1]["routable"] == 0


def test_fault_knobs_parse_as_the_reference(sides):
    cases = [("replica_crash", "2:17"), ("replica_slow", "25"),
             ("replica_slow", "25:4"), ("replica_slow", "25:4:1"),
             ("publish_corrupt", "3"), ("canary_diverge", "1")]
    for point, raw in cases:
        for faults in (jfaults, tfaults):
            faults.enable(point, raw)
        for fn in ("replica_crash_config", "replica_slow_config",
                   "publish_corrupt_n", "canary_diverge"):
            assert getattr(tfaults, fn)() == getattr(jfaults, fn)(), \
                (point, raw, fn)
        if point == "replica_slow":
            for rid, step in ((0, 0), (1, 0), (1, 1), (1, 4)):
                assert (tfaults.maybe_slow_replica(rid, step) > 0) == \
                    (jfaults.maybe_slow_replica(rid, step) > 0)
        for faults in (jfaults, tfaults):
            faults.reset()
    assert tfaults.replica_crash_config() is None
    assert tfaults.replica_slow_config() is None
    assert not tfaults.canary_diverge()
    backoffs = [mod.RestartBackoff(max_restarts=4, base_delay=0.5,
                                   max_delay=1.5, rng=lambda a, b: b / 2)
                for mod in (J, T)]
    assert [backoffs[1].delay_for(i) for i in range(6)] == \
        [backoffs[0].delay_for(i) for i in range(6)]


def test_subprocess_replicas_are_refused(sides):
    """Worker replicas and their program sets are ported
    (tests/test_torch_worker.py, tests/test_torch_programs.py): a spec
    with a program set is no longer refused.  What fails, typed and
    before any connection is made, is shipping a set that is not there;
    the fleet keeps its in-process replica."""
    fleet = T.FleetRouter([sides["port"][2]()])
    try:
        with pytest.raises(FileNotFoundError):
            fleet.add_worker({"model": {}, "program_set": "/nowhere",
                              "ship_program_set": True},
                             address="127.0.0.1:9")
        assert fleet.manager.replicas()[0].kind == "inproc"
        assert len(fleet.manager.replicas()) == 1
    finally:
        fleet.close()


def test_rollout_under_traffic_drops_nothing(sides, pair):
    """The fleet's own loop serves while another thread submits and the
    caller rolls every replica out (boot, drain, remove): every stream
    equals solo generate, and each removed replica's engine holds no
    device state any more."""
    make, model = sides["port"][2], pair[1]
    fleet = T.FleetRouter([make() for _ in range(2)])
    fleet.warmup()
    old = [r.engine for r in fleet.manager.replicas()]
    resps = []

    def submitter():
        for i, p in enumerate(PROMPTS):
            resps.append((p, fleet.submit(p, 10, session=f"u{i % 3}")))
            time.sleep(0.01)

    t = threading.Thread(target=submitter)
    with hard_limit(60):
        try:
            fleet.start()
            t.start()
            time.sleep(0.03)
            new_ids = fleet.rollout(make)
            t.join(timeout=30)
            assert not t.is_alive()
            for p, r in resps:
                assert r.tokens(timeout=30) == torch_solo(model, p, 10)
            assert len(resps) == len(PROMPTS)
            assert sorted(r.id for r in fleet.manager.replicas()) == new_ids
            assert fleet.post_warmup_compiles() == 0
            for eng in old:
                assert eng._programs == {} and eng.model is None
                assert eng._pool_store is None
        finally:
            fleet.close()
            t.join(timeout=5)


def test_brownout_fences_migrates_then_recovers(sides, pair):
    """A replica whose steps take 400 ms (PDTPU_FAULT_REPLICA_SLOW, over
    100x a tiny CPU step) against a 100 ms threshold is fenced DEGRADED
    and its residents migrate, streams equal solo generate; disarmed, its
    probation steps bring it back into rotation."""
    fleet = T.FleetRouter([sides["port"][2]() for _ in range(2)],
                          slow_threshold_ms=100)
    fleet.warmup()
    with hard_limit(60):
        try:
            resps = [fleet.submit(p, 20, session="pin") for p in PROMPTS[:2]]
            for _ in range(3):
                fleet.step()
            assert fleet.manager.get(0).engine.scheduler.occupancy() == 2
            tfaults.enable("replica_slow", "400:1:0")
            fleet.run_until_drained(timeout=30)
            tfaults.reset()
            for p, r in zip(PROMPTS[:2], resps):
                assert r.tokens(timeout=5) == torch_solo(pair[1], p, 20)
            c = fleet.manager.counters()
            assert c["migrated"] == 2 and c["failovers"] == 1
            assert fleet.manager.get(0).state == "degraded"
            for _ in range(400):
                fleet.step()
                if fleet.manager.get(0).state == "healthy":
                    break
            assert fleet.manager.get(0).state == "healthy"
        finally:
            fleet.close()
