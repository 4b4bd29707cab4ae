"""paddle_tpu_torch's serving gateway against the JAX package's on the CPU.

The two gateways run the same submission script, driven in the caller's
thread (``_tick`` / ``run_until_drained``, no background loop): every
request gets the same outcome (completed, shed with the same reason,
rate-limited), the same preemptions and resumes happen, and the streams
(greedy and keyed-sampled, fixed and paged KV) are equal, the greedy ones
to a solo run too.  Token buckets read an injected clock; no test decides
on wall-time SLO signals.  ``handle()`` answers with the reference's
statuses and JSON bodies (timing fields aside).  One test opens a real
socket, under a hard SIGALRM limit, and closes it in ``finally``."""
import json
import signal
import threading
import urllib.request
from contextlib import contextmanager

import numpy as np
import pytest

from paddle_tpu.serving import PRIORITY_HIGH as J_HIGH
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import ServingGateway as JGateway
from paddle_tpu.serving import ShedPolicy as JShed
from paddle_tpu.serving import TenantConfig as JTenant

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.core.errors import InvalidArgumentError, UnavailableError
from paddle_tpu_torch.serving import (PRIORITY_HIGH, PRIORITY_LOW,
                                      GatewayServer, RateLimitedError,
                                      RequestCancelled, ServingEngine,
                                      ServingGateway, SheddedError,
                                      ShedPolicy, Signals, SLOTracker,
                                      TenantConfig, TokenBucket)

from torch_parity import tiny_pair, torch_solo

ENGINE = dict(max_slots=2, max_len=48, prefill_buckets=(8, 16),
              decode_chunk=2, block_size=8)
PROMPTS = [np.random.RandomState(i).randint(0, 128, (n,)).tolist()
           for i, n in enumerate((3, 5, 9, 4, 7, 10, 6, 8))]


@contextmanager
def hard_limit(seconds):
    """SIGALRM after ``seconds``: a hung socket or thread fails the test
    instead of the worker."""
    def boom(*_):
        raise TimeoutError(f"test exceeded its {seconds} s limit")
    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=1)


@pytest.fixture(scope="module", params=["fixed", "paged"])
def engines(request, pair):
    jm, tm = pair
    eng = ServingEngine(tm, kv=request.param, device="cpu", **ENGINE)
    eng.warmup()
    jeng = JEngine(jm, kv=request.param, **ENGINE)
    jeng.warmup()
    return eng, jeng


def _gateway(cls, tenant, shed, eng, clock, **kw):
    gw = cls(eng, tenants={
        "free": tenant(rate=0.5, burst=3.0, max_priority=0),
        "gold": tenant(weight=4.0, max_priority=1)},
        shed=shed(max_lane_depth=3), **kw)
    for ts in gw._tenants.values():
        ts.bucket._clock = clock
        ts.bucket._t = clock()
    return gw


def _outcome(resp):
    if resp.error is None:
        return ("ok", resp.request.preempts, resp.request.resumes)
    reason = getattr(resp.error, "reason", "")
    return (type(resp.error).__name__, reason)


def _script(gw, high):
    """The submission script: two low decodes fill the slots; a queued
    low request, a rate-limited one, two shed ones; two high requests
    preempt the low decodes; then a close with work outstanding."""
    sampled = dict(decode_strategy="sampling", temperature=0.8, top_k=5,
                   top_p=0.9)
    r = {}
    r["a"] = gw.submit(PROMPTS[0], 12, tenant="free")
    r["b"] = gw.submit(PROMPTS[1], 12, tenant="free", seed=11, **sampled)
    gw._tick()
    gw._tick()
    r["c"] = gw.submit(PROMPTS[2], 6, tenant="free")     # bucket's last
    r["d"] = gw.submit(PROMPTS[3], 6, tenant="free")     # rate-limited
    r["e"] = gw.submit(PROMPTS[4], 6, tenant="other")
    r["f"] = gw.submit(PROMPTS[5], 6, tenant="other")
    r["x"] = gw.submit(PROMPTS[6], 6, tenant="other")    # lane full: shed
    r["g"] = gw.submit(PROMPTS[6], 8, tenant="gold", priority=high)
    r["h"] = gw.submit(PROMPTS[7], 8, tenant="gold", priority=high, seed=5,
                       **sampled)
    r["i"] = gw.submit(PROMPTS[0], 4, tenant="free", priority=high)
    r["bad"] = gw.submit(list(range(20)), 4)             # past the bucket
    gw.run_until_drained(timeout=240)
    r["late1"] = gw.submit(PROMPTS[3], 20)
    r["late2"] = gw.submit(PROMPTS[4], 20)
    r["late3"] = gw.submit(PROMPTS[5], 20)
    gw._tick()
    gw.close(close_engine=False)
    r["closed"] = gw.submit(PROMPTS[0], 4)
    return r


def test_gateway_outcomes_preemptions_and_streams_equal_reference(engines):
    eng, jeng = engines
    t = [100.0]
    clock = lambda: t[0]  # noqa: E731  (no refill during the script)
    gw = _gateway(ServingGateway, TenantConfig, ShedPolicy, eng, clock)
    jgw = _gateway(JGateway, JTenant, JShed, jeng, clock)
    with hard_limit(240):
        ours = _script(gw, PRIORITY_HIGH)
        theirs = _script(jgw, J_HIGH)
    for name in ours:
        a, b = ours[name], theirs[name]
        assert a.done() and b.done(), name
        assert _outcome(a) == _outcome(b), name
        if a.error is None:
            assert a.tokens() == b.tokens(), name
            assert a.request.priority == b.request.priority
        else:
            assert a.tokens_so_far() == b.tokens_so_far(), name
    assert isinstance(ours["d"].error, RateLimitedError)
    assert ours["x"].error.reason == ours["i"].error.reason == "queue_depth"
    assert ours["i"].request.priority == PRIORITY_LOW   # clamped
    assert isinstance(ours["late3"].error, RequestCancelled)
    assert isinstance(ours["closed"].error, UnavailableError)
    assert ours["a"].request.preempts >= 1
    for name, i in (("a", 0), ("c", 2), ("e", 4), ("g", 6)):
        assert ours[name].tokens() == torch_solo(
            eng.model, PROMPTS[i], ours[name].request.max_new_tokens), name
    keys = ("requests", "admitted", "shed", "rate_limited", "preempted",
            "resumed", "rejected_invalid")
    m, jm_ = gw.metrics(), jgw.metrics()
    assert {k: m[k] for k in keys} == {k: jm_[k] for k in keys}
    assert set(m) == set(jm_)
    assert set(gw.scale_signals()) == set(jgw.scale_signals())
    assert eng.post_warmup_compiles() == 0
    if eng.kv == "paged":
        assert eng.kv_pool.used_blocks() == 0


def _strip_timing(body):
    body = dict(body)
    body.pop("created", None)
    return body


def _unused_reference_program_store():
    """The reference's persistent program store is process-wide and keeps
    its counters after an earlier test file in this process used it; the
    /healthz comparison below is against a store that is off and unused,
    which the port's always is."""
    from paddle_tpu.programs import store as jstore
    st = jstore.get_program_store()
    if not st.stats()["enabled"]:
        st._hits = st._misses = st._requests = 0


def test_handle_gives_the_reference_statuses_and_bodies(engines):
    eng, jeng = engines
    _unused_reference_program_store()
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    gws = [_gateway(ServingGateway, TenantConfig, ShedPolicy, eng, clock,
                    request_timeout=0.05),
           _gateway(JGateway, JTenant, JShed, jeng, clock,
                    request_timeout=0.05)]

    def both(method, path, body=None):
        return [gw.handle(method, path, body) for gw in gws]

    def post(body):
        return both("POST", "/v1/completions", json.dumps(body).encode())

    try:
        with hard_limit(120):
            a, b = both("GET", "/v1/models")
            assert a == b and a[0] == 200
            for route in ("/nope", "/v1/completions"):
                assert both("GET", route)[0] == both("GET", route)[1]
            assert both("PUT", "/v1/models")[0][0] == 405
            a, b = post({"prompt": []})
            assert a[0] == b[0] == 400 and a[2] == b[2]
            # nothing drives the loops: the handler's wait times out (504)
            # and cancels the request
            a, b = post({"prompt": PROMPTS[0], "max_tokens": 3})
            assert a[0] == b[0] == 504 and a[2] == b[2]
            for gw in gws:
                gw.run_until_drained(timeout=60)
            # a tenant past its bucket (429), then a full lane (503)
            for status in (200, 200, 200, 429):
                a, b = post({"prompt": PROMPTS[1], "user": "free",
                             "max_tokens": 2, "stream": True})
                assert a[0] == b[0] == status
                for gw in gws:
                    gw.run_until_drained(timeout=60)
            assert a[2] == b[2]
            for status in (200, 200, 200, 503):
                a, b = post({"prompt": PROMPTS[1], "max_tokens": 2,
                             "stream": True})
                assert a[0] == b[0] == status
            assert a[2] == b[2]
            for gw in gws:
                gw.run_until_drained(timeout=60)
            # a completed request, greedy then sampled, run by the loops
            results = []
            for gw in gws:
                gw.start()
            for body in ({"prompt": " ".join(map(str, PROMPTS[2])),
                          "max_tokens": 5},
                         {"prompt": PROMPTS[3], "max_tokens": 5,
                          "temperature": 0.7, "top_k": 4, "seed": 3,
                          "eos_token_id": 127}):
                for gw in gws:
                    gw.request_timeout = 60.0
                a, b = post(body)
                assert a[0] == b[0] == 200
                ja, jb = json.loads(a[2]), json.loads(b[2])
                assert _strip_timing(ja) == _strip_timing(jb)
                results.append(ja["choices"][0]["token_ids"])
            # streamed: the same SSE chunks, ending in [DONE]
            a, b = post({"prompt": PROMPTS[4], "max_tokens": 4,
                         "stream": True})
            assert a[0] == b[0] == 200 and a[1] == "text/event-stream"
            ca, cb = list(a[2]), list(b[2])
            assert ca == cb and ca[-1] == b"data: [DONE]\n\n"
            a, b = both("GET", "/healthz")
            assert a[0] == b[0] == 200
            ha, hb = json.loads(a[2]), json.loads(b[2])
            assert set(ha) == set(hb)
            for k in ("ok", "fleet", "prefix_cache", "lora", "warm",
                      "program_store"):
                assert ha[k] == hb[k], k
            assert set(ha["gateway"]) == set(hb["gateway"])
            a, _ = both("GET", "/metrics")
            assert a[0] == 200 and b"gateway_requests_total" in a[2]
    finally:
        for gw in gws:
            gw.close(close_engine=False)


def test_gateway_telemetry_under_the_reference_names(engines):
    eng, _ = engines
    obs.reset()
    gw = ServingGateway(eng)
    try:
        lo = gw.submit(PROMPTS[0], 10)
        lo2 = gw.submit(PROMPTS[1], 10)
        gw._tick()
        hi = gw.submit(PROMPTS[2], 4, priority=PRIORITY_HIGH)
        gw.run_until_drained(timeout=120)
        assert lo.error is None and lo2.error is None and hi.error is None
    finally:
        gw.close(close_engine=False)
    rep = obs.report()["gateway"]
    assert rep["requests"] == 3 and rep["admitted"] == 3
    assert rep["preemptions"] == rep["resumes"] >= 1
    assert rep["ttft_hi_seconds"]["count"] == 1
    assert rep["ttft_lo_seconds"]["count"] == 2
    text = obs.prometheus_text()
    for name in ("gateway_requests_total", "gateway_preempt_total",
                 "gateway_lane_hi_depth", "gateway_ttft_lo_seconds"):
        assert name in text


def test_real_socket_completion_and_stream_then_close(pair):
    _, tm = pair
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    eng.warmup()
    gw = ServingGateway(eng)
    server = None
    try:
        with hard_limit(60):
            gw.start()
            server = GatewayServer(gw, port=0)
            base = f"http://127.0.0.1:{server.port}"
            body = json.dumps({"prompt": PROMPTS[0], "max_tokens": 6,
                               "stream": True}).encode()
            req = urllib.request.Request(base + "/v1/completions", data=body,
                                         method="POST")
            toks, done = [], False
            with urllib.request.urlopen(req, timeout=30) as r:
                for line in r:
                    line = line.strip()
                    if line == b"data: [DONE]":
                        done = True
                    elif line.startswith(b"data: "):
                        toks += json.loads(line[6:])["choices"][0][
                            "token_ids"]
            assert done and toks == torch_solo(tm, PROMPTS[0], 6)
            with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
                health = json.loads(r.read())
            assert health["warm"] is True and health["ok"] is True
    finally:
        if server is not None:
            server.close()
        gw.close()
    assert not any(t.name.startswith(("serving-gateway",
                                      "paddle_tpu_torch-gateway"))
                   for t in threading.enumerate())


def test_policy_objects_and_refusals(pair):
    t = [0.0]
    b = TokenBucket(rate=10.0, burst=2.0, _clock=lambda: t[0])
    assert b.try_take() and b.try_take() and not b.try_take()
    t[0] += 0.1
    assert b.try_take() and not b.try_take()
    p = ShedPolicy(max_lane_depth=4, max_est_wait=1.0, ttft_slo=0.5)
    assert p.decide(Signals(lane_depth=4), 1) == "queue_depth"
    assert p.decide(Signals(est_wait=2.0), 0) == "est_wait"
    assert p.decide(Signals(est_wait=2.0), 1) is None
    assert p.decide(Signals(ttft_p99_hi=0.9), 0) == "slo_pressure"
    tr = SLOTracker(max_age=10.0, _clock=lambda: t[0])
    tr.note_ttft("hi", 2.0)
    t[0] += 11.0
    assert tr.ttft_p99("hi") is None
    with pytest.raises(ValueError):
        TenantConfig(weight=0.0)
    assert TenantConfig(adapter="a").adapter == "a"
    _, tm = pair
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    eng.start()
    try:
        with pytest.raises(InvalidArgumentError, match="already started"):
            ServingGateway(eng)
    finally:
        eng.close()
    assert ServingGateway._http_status(SheddedError("x")) == 503
    assert ServingGateway._http_status(TimeoutError()) == 504
