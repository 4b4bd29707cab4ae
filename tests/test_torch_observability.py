"""paddle_tpu_torch.observability (and the ``utils.monitor`` /
``utils.profiler`` shims over it) against the JAX package on the CPU.

- The same sequence of registry operations gives equal ``snapshot()``,
  quantiles and ``prometheus_text()``, byte for byte; the tracer gives the
  same nesting, ring bound, aggregates and chrome-trace keys; the STAT
  verbs and the profiler shim give the reference's results; the
  reference's thread hammers pass on the port's registry and shim.
- A tiny GPT served by the port's engine and by the reference's, both
  with ``profile=True``, the same traffic: ``metrics()`` counts, the
  serving histograms' counts, the span names and counts and the
  ``STAT_serving_*`` counters are equal; every program is in the
  registry under the reference's name (the all-greedy decode graph under
  its own), nothing is captured after warmup; ``profile=False`` opens no
  span.  After a tiny train step and a checkpoint on each side,
  ``report()`` has the reference's keys in every section.
- A speculative engine observes the accept-rate histogram once per
  speculating slot per tick.

Tolerances: none — counts, names, keys and rendered text are compared
for equality.
"""
import json
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu.observability import exporters as jexp
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import tracer as jtracer
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.utils import monitor as jmonitor

from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.observability import exporters as texp
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import tracer as ttracer
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.utils import monitor as tmonitor
from paddle_tpu_torch.utils import profiler as tprof

from torch_parity import tiny_pair

ENGINE = dict(max_slots=3, max_len=48, prefill_buckets=(8, 16),
              decode_chunk=4, block_size=8)


# ---------------------------------------------------------------------------
# the registry, the tracer, the shims: one sequence of operations each side
# ---------------------------------------------------------------------------

def _drive_registry(metrics, exporters):
    """One seeded sequence of registry operations; everything it shows."""
    rng = np.random.RandomState(0)
    reg = metrics.MetricsRegistry()
    req = reg.counter("requests_total", "requests served",
                      labelnames=("route",))
    req.labels(route="a").inc()
    req.labels(route="b").inc(2.5)
    req.labels(route='q"uo\\te').inc(3)
    depth = reg.gauge("queue_depth", "waiting")
    depth.set(3)
    depth.inc(2)
    depth.dec(0.5)
    lat = reg.histogram("latency_seconds", "latency", labelnames=("kind",))
    for v in rng.exponential(0.05, 300):
        lat.labels(kind="decode").observe(v)
    for v in rng.exponential(2.0, 50):
        lat.labels(kind="prefill").observe(v)
    custom = reg.histogram("custom", buckets=(10.0, 0.1, 1.0))
    for v in (0.05, 0.1, 0.5, 5.0, 50.0):
        custom.observe(v)
    reg.register_collector(lambda: [
        {"name": "collected_total", "kind": "counter", "value": 7,
         "labels": ("x",)},
        {"name": "queue_depth", "value": 1.5}])
    reg.register_collector(lambda: 1 / 0)     # a broken collector is skipped
    errors = []
    for bad in (lambda: reg.gauge("requests_total"),
                lambda: reg.counter("requests_total", labelnames=("x",)),
                lambda: req.labels(route="a").inc(-1),
                lambda: req.labels(other="a")):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    q = [lat.quantile(p, kind="decode") for p in (0, 0.5, 0.9, 0.99, 1)]
    q.append(custom.quantile(0.5))
    q.append(reg.histogram("empty").quantile(0.5))
    before = (reg.snapshot(), exporters.prometheus_text(reg))
    reg.reset()
    req.labels(route="a").inc()            # cached handles stay valid
    after = (reg.snapshot(), exporters.prometheus_text(reg))
    return before, after, q, errors, reg.names()


def test_registry_snapshot_and_text_equal_the_reference():
    ref = _drive_registry(jmetrics, jexp)
    got = _drive_registry(tmetrics, texp)
    assert got[0][1] == ref[0][1]             # text, byte for byte
    assert got[1][1] == ref[1][1]
    assert got[0][0] == ref[0][0]             # snapshot
    assert got[1][0] == ref[1][0]
    assert got[2:] == ref[2:]                 # quantiles, errors, names
    assert 'route="q\\"uo\\\\te"' in got[0][1]


def _drive_tracer(tracer_mod, tmp_path, tag):
    tr = tracer_mod.Tracer(max_events=50)
    with tr.span("outer", args={"step": 3}) as outer:
        assert tr.current_span() is outer
        with tr.span("inner") as inner:
            with tr.span("leaf") as leaf:
                pass
        with tr.span("adopted", parent=inner) as adopted:
            pass
    abandoned = tr.span("abandoned")
    with tr.span("after") as after:
        pass
    abandoned.end()
    abandoned.end()                               # idempotent

    def other():
        with tr.span("thread_span"):
            pass
    t = threading.Thread(target=other)
    t.start()
    t.join()
    for _ in range(120):
        with tr.span("hot"):
            pass
    ids = {s.span_id: s.name for s in (outer, inner, leaf, adopted,
                                       abandoned, after)}
    rel = [(s.name, ids.get(s.parent_id)) for s in
           (outer, inner, leaf, adopted, abandoned, after)]
    doc = tr.chrome_trace()
    path = tr.export_chrome_trace(str(tmp_path / tag / "trace.json"))
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    events = doc["traceEvents"]
    return (rel, len(tr), tr.max_events,
            {k: v[0] for k, v in tr.aggregates().items()},
            sorted(doc), [sorted(e) for e in events],
            [sorted(e["args"]) for e in events], len({e["tid"] for e in
                                                      events}))


def test_tracer_nesting_ring_and_chrome_trace_equal_the_reference(tmp_path):
    assert (_drive_tracer(ttracer, tmp_path, "port")
            == _drive_tracer(jtracer, tmp_path, "ref"))


def test_annotated_span_opens_a_profiler_range():
    from torch.profiler import ProfilerActivity, profile
    tr = ttracer.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("annotated_range", annotate=True):
            torch.ones(3) + 1
        with tr.span("plain_range"):
            torch.ones(3) + 1
    names = {e.name for e in prof.events()}
    assert "annotated_range" in names and "plain_range" not in names


def _drive_monitor(monitor):
    names = ("STAT_obs_parity_a", "STAT_obs_parity_b", "STAT_other_c")
    monitor.stat_reset()
    monitor.stat_add(names[0])
    monitor.stat_add(names[0], 4)
    monitor.stat_sub(names[0], 2)
    monitor.STAT_ADD(names[1], 7)
    monitor.stat_add(names[2])
    out = [monitor.stats(), monitor.stats(prefix="obs_parity_"),
           monitor.stats(prefix="STAT_other"), monitor.stat_get(names[0]),
           monitor.stat_get("STAT_never_set")]
    monitor.stat_reset(names[1])
    out.append(monitor.stats())
    monitor.STAT_RESET()
    out.append(monitor.stats())
    return out


def test_monitor_verbs_equal_the_reference():
    assert _drive_monitor(tmonitor) == _drive_monitor(jmonitor)
    tmonitor.stat_add("STAT_obs_registry_backed", 3)
    assert tobs.get_registry().get("STAT_obs_registry_backed").value() == 3
    tmonitor.stat_reset("STAT_obs_registry_backed")


def test_profiler_shim_reports_the_window_and_writes_traces(tmp_path):
    tprof.start_profiler()
    with tprof.RecordEvent("shim_window"):
        pass
    ev = tprof.RecordEvent("shim_window").__enter__()
    ev.end()
    agg = tprof.stop_profiler(profile_path=str(tmp_path / "report.txt"))
    assert agg["shim_window"][0] == 2
    assert "shim_window" in (tmp_path / "report.txt").read_text()
    with tprof.profiler(log_dir=str(tmp_path / "tb"),
                        profile_path=str(tmp_path / "r2.txt")):
        with tprof.RecordEvent("shim_traced"):
            torch.ones(4) * 2
    trace = json.loads((tmp_path / "tb" / "trace.json").read_text())
    assert any(e.get("name") == "shim_traced" for e in trace["traceEvents"])
    assert tprof._records["shim_traced"][0] == 1
    assert "shim_traced" in tprof.summary()   # since the last start
    path = tprof.export_chrome_tracing(str(tmp_path / "host.json"))
    assert json.loads(open(path).read())["traceEvents"]


def test_metrics_registry_concurrent_increments():
    """8 threads hammering one counter / histogram lose nothing
    (reference tests/test_observability.py:223)."""
    reg = tmetrics.MetricsRegistry()
    c = reg.counter("hits_total")
    h = reg.histogram("obs_seconds")
    n_threads, per_thread = 8, 500
    barrier = threading.Barrier(n_threads)

    def worker():
        barrier.wait()
        for i in range(per_thread):
            c.inc()
            h.observe(0.001 * (i % 10))

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value() == n_threads * per_thread
    assert h.snapshot()["count"] == n_threads * per_thread


def test_profiler_shim_thread_safety_hammer():
    """8 threads x 200 RecordEvent spans land exactly while a reader
    polls snapshots (reference tests/test_observability.py:276)."""
    tobs.get_tracer().clear()
    n_threads, per_thread = 8, 200
    barrier = threading.Barrier(n_threads + 1)
    errors = []

    def worker(tid):
        try:
            barrier.wait()
            for _ in range(per_thread):
                with tprof.RecordEvent(f"hammer_{tid % 2}"):
                    pass
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def reader():
        barrier.wait()
        for _ in range(50):
            dict(tprof._records)
            tprof.summary()

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    threads.append(threading.Thread(target=reader))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    agg = tobs.get_tracer().aggregates()
    total = agg["hammer_0"][0] + agg["hammer_1"][0]
    assert total == n_threads * per_thread
    recs = tprof._records
    assert recs["hammer_0"][0] + recs["hammer_1"][0] == total


def test_endpoint_and_jsonl_sink(tmp_path):
    tobs.counter("obs_endpoint_total").inc()
    status, ctype, body = tobs.render_endpoint("/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    assert body.decode() == tobs.prometheus_text()
    status, _, body = tobs.render_endpoint("/report?x=1")
    assert status == 200 and "serving" in json.loads(body)
    assert tobs.render_endpoint("/nope")[0] == 404
    sink = tobs.JsonlSink(str(tmp_path / "r.jsonl"), interval_seconds=None)
    sink.flush()
    sink.close()
    lines = (tmp_path / "r.jsonl").read_text().splitlines()
    assert len(lines) == 2 and "metrics" not in json.loads(lines[0])


def test_program_registry_tracks_programs_and_callables():
    from paddle_tpu_torch.core.programs import Program
    reg = tobs.ProgramRegistry()
    prog = tobs.track("toy", Program(lambda x: (x * 2,),
                                     {"x": torch.ones(4)}), reg)
    prog.made(0.25)
    for _ in range(3):
        prog.run()
    rec = reg.get("toy")
    assert rec["compiles"] == 1 and rec["replays"] == 3
    assert rec["argument_bytes"] == 16 and rec["output_bytes"] == 16
    assert rec["compile_seconds_total"] == 0.25
    assert all(rec[k] is None for k in ("flops", "bytes_accessed",
                                        "peak_live_bytes"))
    fn = tobs.track("toy_fn", lambda a: a + 1, reg)
    assert isinstance(fn, tobs.TrackedJit)
    fn(torch.ones(2))
    fn(torch.ones(2))
    fn(torch.ones(3))
    assert reg.get("toy_fn")["compiles"] == 2
    assert tobs.aot_fallbacks(reg) == []
    reg.clear()
    assert reg.names() == []


def test_observability_all_is_the_reference_all():
    assert tobs.__all__ == jobs.__all__
    assert all(hasattr(tobs, n) for n in tobs.__all__)


# ---------------------------------------------------------------------------
# the engine's and the training step's telemetry against the reference's
# ---------------------------------------------------------------------------

def _traffic():
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 128, (n,)) for n in (4, 11, 14)]
    return [(p, dict(max_new_tokens=5 + i)) for i, p in enumerate(prompts)]


def _serve(engine_cls, model, obs, monitor, kv, profile, **extra):
    obs.reset()
    monitor.stat_reset()
    eng = engine_cls(model, kv=kv, profile=profile, **ENGINE, **extra)
    resps = [eng.submit(p, **kw) for p, kw in _traffic()]
    resps.append(eng.submit(_traffic()[0][0], max_new_tokens=6,
                            decode_strategy="sampling", seed=3))
    eng.run_until_drained(timeout=240)
    toks = [r.tokens(timeout=5) for r in resps]
    m = eng.metrics()
    reg = obs.get_registry()
    hist = {n: reg.get(n).snapshot()["count"]
            for n in ("serving_ttft_seconds", "serving_inter_token_seconds")}
    spans = {k: v[0] for k, v in obs.get_tracer().aggregates().items()
             if k.startswith("serving_")}
    stats = monitor.stats(prefix="serving_")
    progs = obs.get_program_registry().snapshot()
    return dict(eng=eng, toks=toks, metrics=m, hist=hist, spans=spans,
                stats=stats, progs=progs)


@pytest.fixture(scope="module")
def served():
    jm, tm = tiny_pair(seed=1)
    ref = _serve(JEngine, jm, jobs, jmonitor, "paged", True)
    got = _serve(ServingEngine, tm, tobs, tmonitor, "paged", True,
                 device="cpu")
    return "paged", ref, got


def test_engine_metrics_histograms_and_spans_equal_the_reference(served):
    _, ref, got = served
    assert got["toks"] == ref["toks"]
    # (a cold port engine warms up at its first step, a cold reference
    # engine compiles as it goes: "warm" and "post_warmup_compiles" differ)
    for key in ("requests_completed", "requests_errored", "tokens_out",
                "queue_depth", "slot_occupancy"):
        assert got["metrics"][key] == ref["metrics"][key], key
    assert set(got["metrics"]) == set(ref["metrics"])
    tokens = sum(len(t) for t in got["toks"])
    assert got["hist"] == ref["hist"] == {
        "serving_ttft_seconds": len(got["toks"]),
        "serving_inter_token_seconds": tokens - len(got["toks"])}
    assert got["spans"] == ref["spans"]
    assert set(got["spans"]) == {"serving_prefill", "serving_decode"}
    # the port captures the all-greedy decode graph besides (ROADMAP §3)
    stats = dict(got["stats"])
    stats["STAT_serving_compiles"] -= 1
    assert stats == ref["stats"]


def test_engine_programs_are_registered_under_the_reference_names(served):
    kv, ref, got = served
    eng = got["eng"]
    want = {"serving_decode", "serving_prefill_b8", "serving_prefill_b16"}
    assert want <= set(ref["progs"])
    assert set(got["progs"]) == want | {"serving_decode_greedy"}
    for name, rec in got["progs"].items():
        assert rec["compiles"] == 1
        assert rec["argument_bytes"] > 0 and rec["output_bytes"] > 0
        assert rec["meta"] == {"captured": False}
    assert got["progs"]["serving_decode"]["replays"] \
        + got["progs"]["serving_decode_greedy"]["replays"] \
        == got["stats"]["STAT_serving_decode_steps"]
    assert eng.post_warmup_compiles() == 0
    marks = eng._compile_marks()
    assert marks["registry"] == {n: 1 for n in got["progs"]}
    # a capture after warmup shows in post_warmup_compiles, as the
    # reference's counts a registry compile
    eng._programs["decode"].made(0.0)
    assert eng.post_warmup_compiles() == 1


def test_profile_off_opens_no_span():
    _, tm = tiny_pair(seed=1)
    out = _serve(ServingEngine, tm, tobs, tmonitor, "paged", False,
                 device="cpu")
    assert out["spans"] == {}
    assert out["hist"]["serving_ttft_seconds"] == len(out["toks"])


def test_spec_engine_observes_the_accept_rate_and_verify_spans():
    from test_torch_spec_decode import gpt_pair
    _, tm = gpt_pair(seed=1)
    _, draft = gpt_pair(seed=1)               # a clone accepts everything
    tobs.reset()
    eng = ServingEngine(tm, kv="paged", profile=True, draft_model=draft,
                        spec_tokens=3, device="cpu", **ENGINE)
    resps = [eng.submit(p, **kw) for p, kw in _traffic()[:3]]
    eng.run_until_drained(timeout=120)
    [r.tokens(timeout=5) for r in resps]
    spec = eng.metrics()["spec"]
    h = tobs.get_registry().get("serving_spec_accept_rate").snapshot()
    assert h["count"] == spec["proposed"] // 3 > 0
    assert h["sum"] == pytest.approx(spec["accepted"] / 3)
    spans = tobs.get_tracer().aggregates()
    assert spans["serving_verify"][0] == spec["ticks"]
    assert "serving_decode" not in spans
    assert {"serving_verify", "serving_verify_greedy",
            "serving_prefill_spec_b8"} <= set(tobs.get_program_registry()
                                              .names())


def _train_and_checkpoint(side, tmp_path):
    """Two steps of a tiny MLP through the side's TrainStep, then a
    checkpoint; the report after it."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 4).astype(np.float32)
    y = rng.randint(0, 2, (4,)).astype(np.int64)
    if side == "ref":
        import paddle_tpu.nn as jnn
        import paddle_tpu.nn.functional as JF
        from paddle_tpu.jit import TrainStep as JStep
        jobs.reset()
        paddle.seed(0)
        model = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2))
        opt = paddle.optimizer.SGD(learning_rate=0.1,
                                   parameters=model.parameters())
        step = JStep(model, lambda o, lbl: JF.cross_entropy(o, lbl), opt)
        for _ in range(2):
            step(paddle.to_tensor(x), paddle.to_tensor(y))
        step.save_checkpoint(str(tmp_path / "ref"))
        return jobs
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as TF
    tobs.reset()
    model = pt.nn.Sequential(pt.nn.Linear(4, 8, device="cpu"), pt.nn.ReLU(),
                             pt.nn.Linear(8, 2, device="cpu"))
    opt = pt.optimizer.AdamW(learning_rate=0.1,
                             parameters=model.parameters())
    step = TrainStep(model, lambda o, lbl: TF.cross_entropy(o, lbl), opt)
    for _ in range(2):
        step(torch.from_numpy(x), torch.from_numpy(y))
    step.save_checkpoint(str(tmp_path / "port"))
    return tobs


def test_report_has_the_reference_keys_after_train_and_serve(served,
                                                             tmp_path):
    reports = {}
    for side in ("ref", "port"):
        obs = _train_and_checkpoint(side, tmp_path)
        rep = obs.report()
        assert rep["train"]["step_seconds"]["count"] == 2
        assert rep["checkpoint"]["save_stall_seconds"]["count"] == 1
        assert rep["checkpoint"]["saves"] == 1
        assert rep["spans"]["train_step"][0] == 2
        assert rep["spans"]["checkpoint_publish"][0] == 1
        (name, prog), = [(k, v) for k, v in rep["programs"].items()
                         if k.startswith("train_step:")]
        assert name == "train_step:Sequential" and prog["compiles"] == 1
        reports[side] = rep
    ref, got = reports["ref"], reports["port"]
    assert set(got) == set(ref)
    for key, section in ref.items():
        if key in ("programs", "spans", "stats", "metrics"):
            continue                   # keyed by what ran
        if isinstance(section, dict):
            assert set(got[key]) == set(section), key
    assert got["programs_aot_fallbacks"] == []
    assert got["program_store"]["enabled"] is False
    assert got["dispatch_cache"]["hit_rate"] is None
    text = tobs.prometheus_text()
    for series in ("train_step_seconds_count",
                   "checkpoint_save_stall_seconds_sum"):
        assert series in text
