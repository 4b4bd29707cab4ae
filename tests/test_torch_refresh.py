"""paddle_tpu_torch's continuous weight refresh and autoscaler against the
JAX package's on the CPU (``serving/refresh.py``, ``serving/autoscaler.py``).

- The publisher: the reference's on-disk layout (``push-%09d/{weights.npz,
  manifest.json}``, hidden tmp dirs never read, the LATEST pointer,
  numbering resumed past what is on disk), the manifest's sha of the good
  bytes, and the corrupt-publish knob naming one publish.  Each
  framework's ``latest_publish`` reads the other's directory, and the two
  publishers write the same arrays under the same names for one state
  (the npz bytes differ: zip headers carry timestamps).
- The refresh loop, across the frameworks: a port fleet (two replicas and
  an oracle over one model, the fleet on its own thread) refreshed from
  the reference's publishes, and the reference's fleet from the port's;
  a good publish passes the three gates and converges both replicas (a
  request admitted before it finishes on the old weights; afterwards each
  replica's streams equal the new weights' solo streams, nothing captured
  after warmup), a corrupt one is quarantined at the artifact gate with
  nothing flipped, a canary forced to diverge is rolled back and the fleet
  reconverges.  Statuses, quarantine reasons, rollback and refresh counts
  and ``routable_verified`` equal the reference's.
- The autoscaler's decisions equal the reference's under one injected
  sequence of signals and clock; a real port fleet scales up by a spawned
  replica and down by a drain.

A test that starts a thread holds a SIGALRM limit raising a BaseException
and closes everything in ``finally``."""
import os
import signal
import time
from contextlib import contextmanager

import numpy as np
import pytest

import paddle_tpu.serving as J
from paddle_tpu.utils import faults as jfaults

import paddle_tpu_torch.serving as T
from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.serving.fleet import DRAINING, HEALTHY
from paddle_tpu_torch.serving.transfer import file_sha256
from paddle_tpu_torch.utils import faults as tfaults

from torch_parity import jax_state, tiny_pair, torch_solo

ENGINE = dict(max_slots=2, max_len=48, prefill_buckets=(16,),
              decode_chunk=2, kv="paged", block_size=8)
CANARY = ([7, 8, 9], [3, 1, 4, 1, 5])
SEED_OLD, SEED_NEW, SEED_BAD, SEED_DIV = 1, 2, 3, 4


class _Limit(BaseException):
    """A test's time limit: not an Exception, so no serving loop takes it
    for a replica crash."""


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
def draws():
    """seed -> (jax model, port model) with the same weights."""
    return {s: tiny_pair(seed=s)
            for s in (SEED_OLD, SEED_NEW, SEED_BAD, SEED_DIV)}


def wait_for(pred, timeout, what):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


# ---------------------------------------------------------------------------
# the publisher
# ---------------------------------------------------------------------------

def test_publisher_layout_latest_and_corrupt_knob(tmp_path):
    d = str(tmp_path / "pub")
    pub = T.WeightPublisher(d)
    state = {"w/a": np.arange(8, dtype=np.float32),
             "w/b": np.ones((2, 3), dtype=np.float32)}
    assert T.latest_publish(d) is None
    p0 = pub.publish(state=state)
    assert p0["step"] == 0 and p0["dir"].endswith("push-000000000")
    got = T.latest_publish(d)
    assert got["sha256"] == p0["sha256"] == file_sha256(got["path"])
    with np.load(got["path"], allow_pickle=False) as z:
        assert sorted(z.files) == sorted(state)
    assert pub.publish(state=state)["step"] == 1
    assert T.latest_publish(d)["step"] == 1
    # numbering resumes past what is on disk; tmp dirs are never read
    assert T.WeightPublisher(d).publish(state=state)["step"] == 2
    os.makedirs(os.path.join(d, ".push-000000099.tmp-1"))
    assert T.latest_publish(d)["step"] == 2
    # the reference reads the port's directory and the port the
    # reference's
    assert J.latest_publish(d) == T.latest_publish(d)
    jd = str(tmp_path / "jpub")
    jp = J.WeightPublisher(jd).publish(state=state)
    assert T.latest_publish(jd) == J.latest_publish(jd)
    assert T.latest_publish(jd)["sha256"] == jp["sha256"]
    # the knob corrupts ONE publish after its rename; the manifest keeps
    # the good sha
    tfaults.enable("publish_corrupt", "1")
    p3 = pub.publish(state=state)
    assert file_sha256(p3["path"]) != p3["sha256"]
    tfaults.disable("publish_corrupt")
    p4 = pub.publish(state=state)
    assert file_sha256(p4["path"]) == p4["sha256"]
    with pytest.raises(InvalidArgumentError):
        pub.publish()
    with pytest.raises(InvalidArgumentError):
        pub.publish(model=object(), state={})


def test_both_publishers_write_the_same_arrays(draws, tmp_path):
    """A model published by the port and its state by the reference: the
    same names, dtypes and values (the hashes differ: zip timestamps)."""
    jm, tm = draws[SEED_NEW]
    ours = T.WeightPublisher(str(tmp_path / "t")).publish(model=tm)
    theirs = J.WeightPublisher(str(tmp_path / "j")).publish(
        state=jax_state(jm))
    with np.load(ours["path"]) as a, np.load(theirs["path"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# the refresh loop across the frameworks
# ---------------------------------------------------------------------------

def _refresh(mod, faults, make, publisher, states, tmp):
    """The fleet of ``mod`` (two replicas and an oracle from ``make``)
    refreshed from ``publisher``'s publishes of ``states`` (label ->
    state); returns what each gate decided, shas named by label."""
    oracle = make()
    oracle.warmup()
    fleet = mod.FleetRouter([make(), make()])
    fleet.warmup()
    refresher = mod.FleetRefresher(fleet, tmp, oracle,
                                   canary_prompts=CANARY,
                                   canary_max_new_tokens=8,
                                   flip_timeout_s=30.0,
                                   canary_timeout_s=30.0)
    names = {}

    def shas():
        return [names.get(r.engine.weights_sha, r.engine.weights_sha)
                for r in fleet.manager.replicas((HEALTHY,))]

    def converged(label):
        refresher.poll()
        return shas() == [label, label]

    def status():
        st = refresher.status()
        return {"current": names.get(st["current_sha"]),
                "verified": st["verified"],
                "quarantined": {names[k]: v
                                for k, v in st["quarantined"].items()},
                "last_error": (st["last_error"] or "").split(": ", 1)[-1],
                "counters": {k: fleet.manager.counters()[k]
                             for k in ("rollbacks", "weight_refreshes")},
                "routable_verified": fleet.health()["routable_verified"],
                "shas": shas()}

    rec = {}
    with hard_limit(90):
        try:
            fleet.start()
            pre = fleet.submit(CANARY[0], 24)
            pub = publisher.publish(state=states["good"])
            names[pub["sha256"]] = "good"
            wait_for(lambda: converged("good"), 30, "both replicas flipped")
            rec["pre"] = pre.tokens(timeout=30)
            rec["good"] = status()
            rec["served"] = []
            for rep in fleet.manager.replicas((HEALTHY,)):
                req, resp = rep.engine.make_request(CANARY[1], 8)
                rep.engine.scheduler.submit(req, resp)
                fleet._work.set()
                rec["served"].append(resp.tokens(timeout=30))
            rec["captures"] = fleet.post_warmup_compiles()
            # the publisher's own framework's knob corrupts its publish
            pub_faults = (jfaults if isinstance(publisher, J.WeightPublisher)
                          else tfaults)
            pub_faults.enable("publish_corrupt", "1")
            bad = publisher.publish(state=states["bad"])
            pub_faults.disable("publish_corrupt")
            names[bad["sha256"]] = "bad"
            refresher.poll()
            rec["bad"] = status()
            faults.enable("canary_diverge")
            div = publisher.publish(state=states["div"])
            names[div["sha256"]] = "div"
            refresher.poll()
            faults.disable("canary_diverge")
            wait_for(lambda: converged("good"), 30, "rollback convergence")
            rec["div"] = status()
            rec["captures_after"] = fleet.post_warmup_compiles()
        finally:
            refresher.close()
            fleet.close()
            oracle.close()
    return rec


def test_refresh_gates_across_frameworks(draws, tmp_path):
    """The port's fleet on the reference's publishes, the reference's on
    the port's: the same decisions at every gate."""
    states = {"good": jax_state(draws[SEED_NEW][0]),
              "bad": jax_state(draws[SEED_BAD][0]),
              "div": jax_state(draws[SEED_DIV][0])}
    jm, tm = draws[SEED_OLD]
    port = _refresh(
        T, tfaults, lambda: T.ServingEngine(tm, device="cpu", **ENGINE),
        J.WeightPublisher(str(tmp_path / "j")), states,
        str(tmp_path / "j"))
    ref = _refresh(
        J, jfaults, lambda: J.ServingEngine(jm, **ENGINE),
        T.WeightPublisher(str(tmp_path / "t")), states,
        str(tmp_path / "t"))
    assert port == ref
    new = draws[SEED_NEW][1]
    assert port["pre"] == torch_solo(tm, CANARY[0], 24)
    assert port["served"] == [torch_solo(new, CANARY[1], 8)] * 2
    assert port["captures"] == port["captures_after"] == 0
    assert port["good"]["current"] == "good"
    assert port["bad"]["quarantined"] == {
        "bad": "artifact sha mismatch (corrupt publish)"}
    assert port["bad"]["shas"] == ["good", "good"]
    assert set(port["div"]["quarantined"]) == {"bad", "div"}
    assert port["div"]["counters"]["rollbacks"] == 2
    # good onto both, div onto the canary, good back onto it
    assert port["div"]["counters"]["weight_refreshes"] == 4
    assert port["div"]["routable_verified"] == 2
    # the port's replicas and the model they were built on: the model
    # still holds the boot weights
    for k, t in tm.state_dict().items():
        assert np.array_equal(t.numpy(), jax_state(jm)[k]), k


# ---------------------------------------------------------------------------
# the autoscaler
# ---------------------------------------------------------------------------

class _FakeRep:
    def __init__(self, rid):
        self.id = rid
        self.state = HEALTHY
        self.flipping = False
        self._load = 0

    def load(self):
        return self._load


class _FakeManager:
    def __init__(self):
        self.reps = {}
        self.scales = []
        self.target = None

    def replicas(self, states=None):
        return [r for r in self.reps.values()
                if states is None or r.state in states]

    def note_scale(self, up):
        self.scales.append("up" if up else "down")

    def set_target_replicas(self, n):
        self.target = n


class _FakeFleet:
    """Replica membership only, with the reference's drain-then-remove."""

    def __init__(self, n=1):
        self.manager = _FakeManager()
        self._next = 0
        self.removed = []
        for _ in range(n):
            self.spawn()

    def spawn(self):
        rid = self._next
        self._next += 1
        self.manager.reps[rid] = _FakeRep(rid)
        return rid

    def drain(self, rid):
        self.manager.reps[rid].state = DRAINING

    def remove(self, rid):
        self.removed.append(rid)
        self.manager.reps.pop(rid, None)


def _decisions(mod):
    """One injected sequence of signals and clock through ``mod``'s
    Autoscaler: breach streaks, cooldown, the max bound, shed counters,
    idle retirements down to the min, a mid-flip replica never retired."""
    clock = {"t": 0.0}
    sig = {"est_wait_s": 0.0, "queue_depth": 0, "shed_total": 0}
    fleet = _FakeFleet(n=1)
    asc = mod.Autoscaler(fleet, lambda: dict(sig), fleet.spawn,
                         min_replicas=1, max_replicas=3,
                         scale_up_est_wait_s=0.5, breach_ticks=3,
                         idle_ticks=4, cooldown_s=10.0,
                         _clock=lambda: clock["t"])
    script = ([(1.0, 2.0, 0, 0)] * 12 + [(100.0, 2.0, 0, 0)]
              + [(1.0, 2.0, 0, 0)] * 8 + [(100.0, 0.0, 0, 0)]
              + [(1.0, 0.0, 0, 5), (1.0, 0.0, 0, 5), (1.0, 0.3, 2, 5)]
              + [(100.0, 0.0, 0, 5)] + [(1.0, 0.0, 0, 5)] * 40)
    out = []
    for dt, wait, depth, shed in script:
        clock["t"] += dt
        sig.update(est_wait_s=wait, queue_depth=depth, shed_total=shed)
        out.append((asc.tick(), asc.status()["breach_streak"],
                    asc.status()["idle_streak"]))
    flipping = _FakeFleet(n=2)
    for r in flipping.manager.reps.values():
        r.flipping = True
    asc2 = mod.Autoscaler(flipping, lambda: dict(sig), flipping.spawn,
                          idle_ticks=1, cooldown_s=0.0,
                          _clock=lambda: clock["t"])
    out.append([asc2.tick() for _ in range(3)])
    return {"ticks": out, "scales": fleet.manager.scales,
            "removed": fleet.removed, "target": fleet.manager.target,
            "actions": [(a["dir"], a["replicas"]) for a in asc.actions],
            "status": asc.status()}


def test_autoscaler_decides_as_the_reference():
    port, ref = _decisions(T), _decisions(J)
    assert port == ref
    assert port["scales"] == ["up", "up", "down", "down"]
    assert port["target"] == 1 and port["ticks"][-1] == [None] * 3
    with pytest.raises(InvalidArgumentError):
        T.Autoscaler(_FakeFleet(), lambda: {}, lambda: None,
                     min_replicas=0, max_replicas=2)
    with pytest.raises(InvalidArgumentError):
        T.Autoscaler(_FakeFleet(), lambda: {}, lambda: None,
                     min_replicas=3, max_replicas=2)


def test_autoscaler_scales_a_port_fleet_up_and_down(draws):
    """A spawned replica serves; a retirement is a drain, then the
    replica is removed and its device state released."""
    tm = draws[SEED_OLD][1]

    def make():
        return T.ServingEngine(tm, device="cpu", **ENGINE)

    fleet = T.FleetRouter([make()])
    fleet.warmup()
    sig = {"est_wait_s": 0.0, "queue_depth": 0, "shed_total": 0}

    def spawn():
        eng = make()
        eng.warmup()
        return fleet.add_replica(eng)

    asc = T.Autoscaler(fleet, lambda: dict(sig), spawn, min_replicas=1,
                       max_replicas=2, breach_ticks=2, idle_ticks=2,
                       cooldown_s=0.0, _clock=lambda: 0.0)
    with hard_limit(60):
        try:
            fleet.start()
            sig["est_wait_s"] = 3.0
            assert asc.tick() is None and asc.tick() == "up"
            assert len(fleet.manager.routable()) == 2
            resps = [fleet.submit(CANARY[0], 8) for _ in range(2)]
            assert [r.tokens(timeout=30) for r in resps] == \
                [torch_solo(tm, CANARY[0], 8)] * 2
            sig["est_wait_s"] = 0.0
            assert asc.tick() is None and asc.tick() == "down"
            wait_for(lambda: len(fleet.manager.replicas()) == 1, 30,
                     "the drained replica removed")
            c = fleet.manager.counters()
            assert (c["scale_up"], c["scale_down"], c["drains"]) == (1, 1, 1)
            assert fleet.submit(CANARY[0], 8).tokens(timeout=30) == \
                torch_solo(tm, CANARY[0], 8)
        finally:
            fleet.close()
