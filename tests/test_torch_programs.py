"""paddle_tpu_torch.programs (the program store and program sets) held
against the JAX package on the CPU.

The store: every fingerprint axis moves the fingerprint, ``enable`` uses
``v-<fingerprint>`` and the kernel build follows it (paths only: the CPU
has no ``nvcc``, and a stand-in compiler exercises the rebuild of a
library that fails to load), the knob is read at import in a process
without jax, and the report and ``/healthz`` read the live store.  Sets:
fixed and paged round trips give greedy and keyed-sampled streams equal
to the saving engine's and the reference engine's; every engine axis of
the manifest, a flipped byte, a missing program, a library that does not
match and a set of the JAX package are each refused with
``ProgramSetError``; the predictor falls back and counts; a worker boots
from a spec's set and a remote attach ships one.  Streams are compared
exactly (token ids); the tiny GPT's argmaxes are well separated."""
import hashlib
import json
import os
import pickle
import subprocess
import sys
import warnings

import pytest

from paddle_tpu.serving import ServingEngine as JEngine

import paddle_tpu_torch.serving as T
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.programs import (ProgramSetError, cache_fingerprint,
                                       get_program_store, read_manifest,
                                       store_stats)
from paddle_tpu_torch.programs import program_set as pset
from paddle_tpu_torch.programs import store as pstore
from paddle_tpu_torch.serving import ServingEngine, ServingGateway

from torch_parity import tiny_pair
from torch_workers import (PROMPTS, ROOT, guard, hard_limit,  # noqa: F401
                           listen_worker, local_engine, spec, wait_for)

ENGINE = dict(max_slots=2, max_len=48, prefill_buckets=(8, 16),
              decode_chunk=2, block_size=8)
SAMPLED = dict(decode_strategy="sampling", temperature=0.8, top_k=5,
               top_p=0.9)
REF_KEYS = {"enabled", "dir", "fingerprint", "entries", "bytes", "hits",
            "misses", "requests"}


def _reset_store():
    st = get_program_store()
    st.disable()
    st._hits = st._misses = st._requests = 0


@pytest.fixture
def store(tmp_path):
    _reset_store()
    yield tmp_path / "store"
    _reset_store()


def _drive(eng):
    """Greedy and keyed-sampled streams of the same requests."""
    rs = [eng.submit(p, max_new_tokens=5 + i) for i, p in enumerate(PROMPTS)]
    rs += [eng.submit(PROMPTS[1], max_new_tokens=6, seed=s, **SAMPLED)
           for s in (3, 4)]
    eng.run_until_drained(timeout=120)
    return [r.tokens(timeout=5) for r in rs]


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=1)


@pytest.fixture(scope="module", params=["fixed", "paged"])
def saved(request, pair, tmp_path_factory):
    """(kv, saving engine, artifact path, its streams, the reference
    engine's streams): one of each per layout for the module."""
    kv = request.param
    jm, tm = pair
    eng = ServingEngine(tm, kv=kv, device="cpu", **ENGINE)
    eng.warmup()
    path = eng.save_program_set(str(tmp_path_factory.mktemp(kv) / "gpt"),
                                extra_meta={"by": "test"})
    ours = _drive(eng)
    jeng = JEngine(jm, kv=kv, **ENGINE)
    theirs = _drive(jeng)
    jeng.close()
    yield kv, eng, path, ours, theirs
    eng.close()


def _rewrite(src, dst, edit):
    """A copy of the set at ``src`` with ``edit(body)`` applied, sealed
    with a fresh checksum (so only the edit can refuse it)."""
    with open(src, "rb") as f:
        env = pickle.load(f)
    body = pickle.loads(env["body"])
    edit(body)
    raw = pickle.dumps(body)
    env.update(body=raw, sha256=hashlib.sha256(raw).hexdigest())
    with open(dst, "wb") as f:
        pickle.dump(env, f)
    return str(dst)


# ------------------------------------------------------------------ store

AXES = {"port_version": "9.9.9", "op_versions": {"matmul": 99},
        "torch_version": "0.0.1", "cuda_version": "1.0",
        "nvcc_flags": ("-O0",)}


@pytest.mark.parametrize("axis", sorted(AXES))
def test_every_fingerprint_axis_moves_the_fingerprint(axis):
    base = cache_fingerprint()
    assert cache_fingerprint() == base and len(base) == 16
    assert cache_fingerprint(**{axis: AXES[axis]}) != base


def test_enable_uses_the_fingerprint_and_the_build_follows(store):
    assert _build.build_dir() == _build.BUILD_DIR
    off = store_stats()
    assert set(off) == REF_KEYS and off["enabled"] is False
    got = pstore.enable(str(store))
    assert got == os.path.join(str(store), f"v-{cache_fingerprint()}")
    assert pstore.enable(str(store)) == got          # idempotent
    kdir = os.path.join(got, "kernels")
    assert _build.build_dir() == _build.Path(kdir)
    target = _build._target("paged_attention")
    assert str(target.parent) == kdir
    assert target.name == f"libpaged_attention_{_build.digest('paged_attention')}.so"
    s = store_stats()
    assert (s["enabled"], s["dir"], s["entries"]) == (True, got, 0)
    pstore.disable()
    assert _build.build_dir() == _build.BUILD_DIR


def test_the_knob_is_read_at_import_without_jax(tmp_path):
    code = ("import sys, json; import paddle_tpu_torch as pt; "
            "s = pt.programs.store_stats(); "
            "print(json.dumps([s['enabled'], s['dir'], "
            "'jax' in sys.modules, 'paddle_tpu' in sys.modules]))")
    env = dict(os.environ, PDTPU_PROGRAM_CACHE_DIR=str(tmp_path),
               PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    enabled, d, jax_in, ref_in = json.loads(out.stdout.strip().splitlines()[-1])
    assert enabled and d.startswith(str(tmp_path) + os.sep + "v-")
    assert not jax_in and not ref_in


def test_hits_installs_and_a_library_that_fails_to_load(store, tmp_path,
                                                         monkeypatch):
    """A library found built is a hit; a set's library is installed with
    its digest checked; one that fails to load is a warning, a miss and a
    rebuild (here by a stand-in compiler that copies a real shared
    library), never a crash."""
    import _ctypes
    pstore.enable(str(store))
    name = "int8_matmul"
    before = dict(_build.counts)
    with pytest.raises(ValueError, match="digest"):
        _build.install(name, "0" * 16, b"junk")
    assert _build.install(name, _build.digest(name), b"not an elf")
    assert not _build.install(name, _build.digest(name), b"again")
    assert _build._start(name) is None            # found built: a hit
    assert store_stats()["hits"] == 1 and store_stats()["entries"] == 1
    fake = tmp_path / "nvcc"
    fake.write_text("#!" + sys.executable + "\nimport shutil, sys\n"
                    f"shutil.copy({_ctypes.__file__!r}, "
                    "sys.argv[sys.argv.index('-o') + 1])\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.delitem(_build._libs, name, raising=False)
    try:
        with pytest.warns(UserWarning, match="failed to load"):
            lib = _build.load(name)
        assert lib is not None
        assert _build.counts["load_failures"] == before["load_failures"] + 1
        assert _build.counts["misses"] == before["misses"] + 1
        assert _build.counts["installs"] == before["installs"] + 1
        assert store_stats()["misses"] == 1
    finally:
        _build._libs.pop(name, None)
        _build._lib_paths.pop(name, None)


def test_max_bytes_trims_the_oldest_libraries(store, monkeypatch):
    kdir = os.path.join(pstore.enable(str(store)), "kernels")
    for i in range(4):
        p = os.path.join(kdir, f"libk{i}_{i:016d}.so")
        with open(p, "wb") as f:
            f.write(b"x" * 100)
        os.utime(p, (1000 + i, 1000 + i))
    monkeypatch.setenv("PDTPU_PROGRAM_CACHE_MAX_BYTES", "250")
    get_program_store().trim()
    assert sorted(os.listdir(kdir)) == ["libk2_0000000000000002.so",
                                        "libk3_0000000000000003.so"]


def test_report_and_healthz_read_the_live_store(store, pair):
    _, tm = pair
    assert obs.report()["program_store"] == store_stats()
    pstore.enable(str(store))
    rep = obs.report()["program_store"]
    assert rep["enabled"] and rep["dir"] == get_program_store()._dir
    text = obs.prometheus_text()
    assert "program_store_enabled 1" in text
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    gw = ServingGateway(eng)
    try:
        status, _, body = gw.handle("GET", "/healthz")
        assert status == 200
        assert json.loads(body)["program_store"] == store_stats()
    finally:
        gw.close()


# ------------------------------------------------------------ program sets

def test_round_trip_streams_equal_the_saver_and_the_reference(saved, pair):
    kv, eng, path, ours, theirs = saved
    _, tm = pair
    assert ours == theirs
    man = read_manifest(path)
    assert man["programs"] == sorted(["prefill_b8", "prefill_b16", "decode",
                                      "decode_greedy"])
    assert man["extra_meta"] == {"by": "test"} and man["libraries"] == {}
    assert man["manifest"]["kv"] == kv
    booted = ServingEngine(tm, kv=kv, device="cpu", program_set=path,
                           **ENGINE)
    try:
        info = booted.metrics()["program_set"]
        assert info["path"] == path and set(info["kinds"].values()) == {
            "recaptured"}
        assert info["libraries"] == {}
        report = booted.warmup()
        assert set(report["programs"].values()) == {"program_set:recaptured"}
        assert booted.compile_counts() == eng.compile_counts()
        assert _drive(booted) == ours
        assert booted.post_warmup_compiles() == 0
        with pytest.raises(ProgramSetError, match="re-saving"):
            booted.save_program_set(path + ".again")
    finally:
        booted.close()


def test_state_sig_hashes_equal_across_the_frameworks(pair, saved):
    jm, tm = pair
    jeng = JEngine(jm, kv=saved[0], **ENGINE)
    try:
        from paddle_tpu.programs.program_set import engine_manifest as jman
        ref = jman(jeng)
        got = saved[1]
        live = pset.engine_manifest(got)
        for key in ("state_sig", "model_class", "max_slots", "max_len",
                    "pool_len", "buckets", "decode_chunk", "pad_token_id",
                    "spec_tokens", "kv", "block_size", "num_blocks", "mesh",
                    "dtype", "key_width", "lora", "op_versions"):
            assert live[key] == ref[key], key
    finally:
        jeng.close()


ENGINE_AXES = {"state_sig": "0" * 16, "max_slots": 9, "max_len": 64,
               "buckets": (8,), "decode_chunk": 4, "kv": "other",
               "dtype": "bfloat16", "op_versions": {"matmul": 99},
               "paddle_tpu_torch_version": "0.0", "lora": {"rank": 4},
               "spec_tokens": 2, "pad_token_id": 5, "model_class": "Bert",
               "pool_len": 7, "prefix_cache": True}


@pytest.mark.parametrize("axis", sorted(ENGINE_AXES))
def test_each_engine_axis_is_refused(saved, pair, tmp_path, axis):
    kv, _, path, _, _ = saved
    bad = _rewrite(path, tmp_path / "bad.pdprograms",
                   lambda b: b["manifest"].__setitem__(axis,
                                                       ENGINE_AXES[axis]))
    with pytest.raises(ProgramSetError, match=axis):
        ServingEngine(pair[1], kv=kv, device="cpu", program_set=bad,
                      **ENGINE)


def test_runtime_axes_disqualify_only_the_libraries(saved, pair, tmp_path):
    kv, _, path, ours, _ = saved

    def edit(b):
        b["manifest"]["torch_version"] = "0.0.1"
        b["libraries"] = {"paged_attention": {"digest": "0" * 16,
                                              "sha256": "0", "bytes": b""}}
    odd = _rewrite(path, tmp_path / "odd.pdprograms", edit)
    eng = ServingEngine(pair[1], kv=kv, device="cpu", program_set=odd,
                        **ENGINE)
    try:
        assert "torch_version" in eng.program_set_info["libraries"]["skipped"]
        assert _drive(eng) == ours
    finally:
        eng.close()


def test_corruption_a_missing_program_and_bad_libraries_are_refused(
        saved, pair, tmp_path, store):
    kv, _, path, _, _ = saved
    tm = pair[1]
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    flipped = tmp_path / "flipped.pdprograms"
    flipped.write_bytes(bytes(raw))
    gone = _rewrite(path, tmp_path / "gone.pdprograms",
                    lambda b: b["programs"].pop("decode_greedy"))
    pstore.enable(str(store))
    name = "paged_attention"

    def lib(digest, data, sha=None):
        def edit(b):
            b["libraries"] = {name: {
                "digest": digest, "bytes": data,
                "sha256": sha or hashlib.sha256(data).hexdigest()}}
        return edit
    stale = _rewrite(path, tmp_path / "stale.pdprograms",
                     lib("0" * 16, b"lib"))
    torn = _rewrite(path, tmp_path / "torn.pdprograms",
                    lib(_build.digest(name), b"lib", sha="0" * 64))
    shapes = _rewrite(path, tmp_path / "shapes.pdprograms", lambda b: b[
        "programs"]["decode"]["inputs"].__setitem__("pos", [[99], "int32"]))
    for bad, words in ((flipped, "checksum"), (gone, "decode_greedy"),
                       (stale, "digest"), (torn, "sha256"),
                       (shapes, "input buffers"),
                       (tmp_path / "none.pdprograms", "unreadable")):
        with pytest.raises(ProgramSetError, match=words):
            ServingEngine(tm, kv=kv, device="cpu", program_set=str(bad),
                          **ENGINE)
    assert os.listdir(os.path.join(get_program_store()._dir,
                                   "kernels")) == []
    good = _rewrite(path, tmp_path / "good.pdprograms",
                    lib(_build.digest(name), b"lib"))
    eng = ServingEngine(tm, kv=kv, device="cpu", program_set=good, **ENGINE)
    eng.close()
    assert eng.program_set_info["libraries"] == {name: "installed"}
    assert _build._target(name).read_bytes() == b"lib"


def test_a_set_of_the_jax_package_is_refused_without_jax(pair, tmp_path):
    jm, tm = pair
    jeng = JEngine(jm, max_slots=2, max_len=32, prefill_buckets=(16,))
    try:
        jeng.warmup()
        ref = jeng.save_program_set(str(tmp_path / "ref"))
    finally:
        jeng.close()
    with pytest.raises(ProgramSetError, match="JAX package"):
        ServingEngine(tm, max_slots=2, max_len=32, prefill_buckets=(16,),
                      device="cpu", program_set=ref)
    code = ("import sys, json\nfrom paddle_tpu_torch.programs import "
            "read_manifest, ProgramSetError\n"
            f"try:\n    read_manifest({ref!r})\n    got = 'loaded'\n"
            "except ProgramSetError as e:\n    got = str(e)\n"
            "print(json.dumps([got, 'jax' in sys.modules, "
            "'paddle_tpu' in sys.modules]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    got, jax_in, ref_in = json.loads(out.stdout.strip().splitlines()[-1])
    assert "JAX package" in got and not jax_in and not ref_in


def test_the_predictor_falls_back_and_counts(saved, pair, tmp_path, store):
    kv, _, path, ours, _ = saved
    tm = pair[1]
    bad = _rewrite(path, tmp_path / "bad.pdprograms",
                   lambda b: b["manifest"].__setitem__("max_slots", 7))
    counter = obs.metrics.counter("program_set_fallback_total")
    before = counter.value()
    cfg = Config().disable_gpu()
    cfg.enable_serving(model=tm, kv=kv, start=False, program_set=bad,
                       program_cache_dir=str(store), **ENGINE)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        pred = create_predictor(cfg)
    try:
        assert any("falling back" in str(w.message) for w in seen)
        assert counter.value() == before + 1
        assert pred.engine.program_set_info is None
        assert store_stats()["enabled"]
        assert _drive(pred.engine) == ours
        again = pred.save_program_set(str(tmp_path / "again"))
    finally:
        pred.close()
    cfg = Config().disable_gpu()
    cfg.enable_serving(model=tm, kv=kv, start=False, program_set=again,
                       **ENGINE)
    pred = create_predictor(cfg)
    try:
        assert pred.engine.program_set_info["path"] == again
        assert counter.value() == before + 1
    finally:
        pred.close()


# ----------------------------------------------------------------- workers

WORKER_SEED = 11


@pytest.fixture(scope="module")
def worker_set(tmp_path_factory):
    """A set saved by an in-process engine over the workers' weights, and
    that engine's streams."""
    eng = local_engine(WORKER_SEED)
    eng.warmup()
    path = eng.save_program_set(str(tmp_path_factory.mktemp("w") / "gpt"))
    want = [_tokens(eng.submit(p, max_new_tokens=6), eng)
            for p in PROMPTS[:2]]
    eng.close()
    return path, want


def _tokens(resp, eng):
    eng.run_until_drained(timeout=60)
    return resp.tokens(timeout=5)


def _serve(fleet, prompts):
    rs = [fleet.submit(p, max_new_tokens=6) for p in prompts]
    wait_for(lambda: all(r.done() for r in rs), 60, "the streams",
             tick=fleet.step)
    return [r.tokens() for r in rs]


@pytest.mark.subprocess_fleet
def test_a_worker_boots_from_a_spec_set(guard, worker_set):  # noqa: F811
    path, want = worker_set
    with hard_limit(120):
        fleet = T.FleetRouter([])
        guard(fleet)
        rid = fleet.add_worker(dict(spec(WORKER_SEED), program_set=path))
        fleet.warmup()
        assert _serve(fleet, PROMPTS[:2]) == want
        rep = fleet.manager.get(rid)
        proc = rep.engine.metrics(fresh=True)["process"]
        assert proc["program_set"]["path"] == path
        assert set(proc["program_set"]["kinds"].values()) == {"recaptured"}
        assert proc["kernel_builds"]["misses"] == 0
        assert not proc["modules"]["jax"]


@pytest.mark.remote_fleet
def test_a_remote_attach_ships_a_set(guard, listen_worker,  # noqa: F811
                                     worker_set):
    path, want = worker_set
    with hard_limit(120):
        fleet = T.FleetRouter([])
        guard(fleet)
        addr, _ = listen_worker(index=1)
        rid = fleet.add_worker(dict(spec(WORKER_SEED), program_set=path,
                                    ship_program_set=True), address=addr)
        fleet.warmup()
        client = fleet.manager.get(rid).engine
        assert client.bytes_shipped == os.path.getsize(path)
        assert _serve(fleet, PROMPTS[:2]) == want
        proc = client.metrics(fresh=True)["process"]
        assert proc["program_set"]["path"].endswith("programs")
        assert set(proc["program_set"]["kinds"].values()) == {"recaptured"}
