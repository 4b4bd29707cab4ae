"""paddle_tpu_torch's worker replicas (``serving/worker.py`` and the worker
half of ``serving/fleet.py``) on the CPU, against the JAX package.

The wire is held against the reference's byte for byte in meaning: frames
packed by either framework decode in the other (verb, header, arrays,
bf16 through ml_dtypes), the same malformed frames are refused typed in
both, and either framework reads the other's heartbeat file.  A worker
process booted from the reference's ``jit.save`` weights serves the
reference engine's greedy and keyed-sampled streams token for token and
never imports jax.  Then the fleet's worker paths: SIGKILL failover and
the supervised restart with its budget, wedge fencing by heartbeat age,
drains across the process boundary, a flip by path, and a fleet-wide
adapter load whose corrupt first read is re-shipped.  Each test holds
a SIGALRM limit, spawns at most two workers (each in a session of its
own, killed by process group in teardown) and bounds every wait."""
import io
import json
import os
import signal
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.serving as J
from paddle_tpu import jit as jjit
from paddle_tpu.serving import worker as jworker
from paddle_tpu.utils import faults as jfaults

import paddle_tpu_torch.serving as T
from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.serving import worker as tworker
from paddle_tpu_torch.serving.fleet import ReplicaManager

from torch_parity import TINY, tiny_pair, torch_solo
from torch_workers import (ENGINE, PROMPTS, SAMPLED, guard,  # noqa: F401
                           hard_limit, local_engine, pid_alive, spec,
                           wait_for)

pytestmark = pytest.mark.subprocess_fleet

NEW = 24


# ------------------------------------------------------------ the wire

def _frames():
    import ml_dtypes
    return [("submit", {"wid": 3, "temperature": 0.5, "seed": None},
             {"prompt": np.arange(5, dtype=np.int32)}),
            ("chunk", {"wid": 7},
             {"toks": np.array([4, 9], np.int64),
              "logps": np.array([-0.5, -1.25], np.float64),
              "rows": np.linspace(-2, 2, 12, dtype=np.float32)
              .reshape(3, 4).astype(ml_dtypes.bfloat16)}),
            ("ping", {}, {})]


def _same(got, want):
    verb, h, arrays = got
    assert verb == want[0]
    assert {k: v for k, v in h.items() if k not in ("v", "verb")} == want[1]
    assert h["v"] == tworker.WIRE_VERSION == jworker.WIRE_VERSION
    assert sorted(arrays) == sorted(want[2])
    for k, a in want[2].items():
        # npz keeps bf16 as 2-byte voids in both frameworks: compare bits
        assert arrays[k].shape == a.shape
        np.testing.assert_array_equal(
            arrays[k].view(np.uint8), np.ascontiguousarray(a).view(np.uint8))


def test_frames_cross_decode_between_frameworks():
    for frame in _frames():
        for pack, unpack in ((tworker.pack_frame, jworker.unpack_frame),
                             (jworker.pack_frame, tworker.unpack_frame)):
            data = pack(*frame)
            assert int.from_bytes(data[:8], "big") == len(data) - 8
            _same(unpack(data[8:]), frame)


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _hdr(h):
    return np.frombuffer(json.dumps(h).encode(), np.uint8)


@pytest.mark.parametrize("case", ["truncated", "not_npz", "version",
                                  "no_verb", "no_header", "bad_json"])
def test_malformed_frames_are_refused_typed_in_both(case):
    good = tworker.pack_frame("submit", {"wid": 1},
                              {"prompt": np.arange(4)})[8:]
    payload = {
        "truncated": good[:len(good) // 2],
        "not_npz": b"not an npz at all",
        "version": _npz(header=_hdr({"v": 999, "verb": "submit"})),
        "no_verb": _npz(header=_hdr({"v": 1})),
        "no_header": _npz(x=np.zeros(3)),
        "bad_json": _npz(header=np.frombuffer(b"{oops", np.uint8)),
    }[case]
    for mod in (tworker, jworker):
        with pytest.raises(mod.WireFormatError):
            mod.unpack_frame(payload)


def test_reserved_header_key_is_refused_in_both():
    for mod, err in ((tworker, InvalidArgumentError),
                     (jworker, jworker.InvalidArgumentError)):
        with pytest.raises(err, match="reserved"):
            mod.pack_frame("x", {}, {"header": np.zeros(2)})


def test_heartbeat_files_cross_read(tmp_path):
    for writer, reader in ((tworker, jworker), (jworker, tworker)):
        path = str(tmp_path / f"hb_{writer.__name__}.json")
        assert reader.read_heartbeat(path) is None   # no beat yet
        hb = writer._Heartbeat(path)
        hb.beat(7, phase="serve", force=True)
        rec = reader.read_heartbeat(path)
        assert rec["steps"] == 7 and rec["phase"] == "serve"
        assert rec["pid"] == os.getpid()
        assert abs(time.monotonic() - rec["mono"]) < 60
        assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_frameconn_assembly_deadline_and_bounded_send():
    """A frame held open past ``frame_deadline`` is refused typed; a frame
    split with pauses assembles; a peer that does not drain makes a
    bounded send raise ``WorkerDiedError`` instead of hanging."""
    import socket
    a, b = socket.socketpair()
    rx = tworker._FrameConn(b, frame_deadline=0.25)
    a.sendall((1000).to_bytes(8, "big") + b"x" * 10)
    t0 = time.monotonic()
    with pytest.raises(tworker.WireFormatError, match="assembly deadline"):
        while time.monotonic() - t0 < 5.0:
            rx.recv_frames(0.02)
    a.close()
    rx.close()
    a, b = socket.socketpair()
    rx = tworker._FrameConn(b, frame_deadline=5.0)
    frame = jworker.pack_frame("ping", {"k": 1})
    a.sendall(frame[:9])
    assert rx.recv_frames(0.01) == []
    time.sleep(0.05)
    a.sendall(frame[9:])
    frames = rx.recv_frames(0.2)
    assert [f[0] for f in frames] == ["ping"] and frames[0][1]["k"] == 1
    a.close()
    rx.close()
    a, b = socket.socketpair()
    a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
    b.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    tx = tworker._FrameConn(a, send_timeout=0.3)
    with pytest.raises(tworker.WorkerDiedError, match="stalled"):
        tx.send("blob", {}, {"data": np.zeros(1 << 21, np.uint8)})
    tx.close()
    b.close()


def test_frames_read_behind_an_rpc_reply_are_kept():
    """A worker can send a reply and, right behind it, a token chunk of the
    run the reply created (a restore); read together, the chunk is held
    for the client's next read, not dropped (the stream would lose those
    tokens)."""
    import socket
    from paddle_tpu_torch.serving.request import Request, Response
    mgr, wrk = socket.socketpair()
    client = tworker.WorkerClient.__new__(tworker.WorkerClient)
    client._init_state({}, 0, 5.0, 5.0, None)
    client.proc = tworker._NullProc()
    client._conn = tworker._FrameConn(mgr)
    client._warm = True
    peer = tworker._FrameConn(wrk)
    try:
        req = Request(0, np.arange(3, dtype=np.int32), 4)
        resp = Response(req)
        peer.send("restored", {"wid": 5, "ok": True})
        peer.send("chunk", {"wid": 5}, {"toks": np.array([7, 8], np.int64),
                                        "logps": np.zeros(2)})
        time.sleep(0.05)      # both frames in the socket: one read
        h, _ = client._rpc("restore", {"wid": 5}, None, "restored")
        assert h["ok"] and len(client._held) == 1
        client._slots[5] = tworker._ProxyRun(req, resp)
        client.step()
        assert resp.tokens_so_far() == [7, 8]
    finally:
        client._conn.close()
        peer.close()


def test_worker_knobs_parse_as_the_reference():
    cases = [("replica_wedge", "1:5"), ("net_delay", "2"),
             ("net_delay", "2:5"), ("net_drop", "3"),
             ("net_partition", "1:0.5")]
    from paddle_tpu_torch.utils import faults as tfaults
    try:
        for point, raw in cases:
            for faults in (jfaults, tfaults):
                faults.reset()
                faults.enable(point, raw)
            for fn in ("replica_wedge_config", "net_delay_config",
                       "net_drop_frame", "net_partition_config"):
                assert getattr(tfaults, fn)() == getattr(jfaults, fn)(), \
                    (point, raw, fn)
            if point == "net_drop":
                assert [tfaults.maybe_net_drop() for _ in range(5)] == \
                    [jfaults.maybe_net_drop() for _ in range(5)]
            if point == "net_partition":
                for idx in (0, 1, None):
                    assert tfaults.net_partition_active(idx) == \
                        jfaults.net_partition_active(idx)
    finally:
        jfaults.reset()
        tfaults.reset()


def test_supervisor_schedule_under_an_injected_clock(monkeypatch):
    """Nothing restarts before its backoff delay; each failure doubles
    it; the spent budget marks the lineage exhausted and stops."""
    now = {"t": 100.0}
    mgr = ReplicaManager(
        heartbeat_timeout_s=None,
        restart_backoff=T.RestartBackoff(max_restarts=2, base_delay=1.0,
                                         jitter=0.0),
        _clock=lambda: now["t"])
    spawned = []
    monkeypatch.setattr(mgr, "add_worker",
                        lambda spec, lineage=None, **kw:
                        spawned.append(lineage))
    lineage = {"spec": {}, "index": 7, "restarts": 0, "client_kw": {},
               "exhausted": False}
    mgr._schedule_restart_lineage(lineage)
    assert lineage["restarts"] == 1
    assert mgr._restarts[0]["at"] == pytest.approx(101.0)
    assert mgr.counters()["pending_restarts"] == 1
    now["t"] = 100.5
    assert not mgr._pump_restarts() and not spawned
    now["t"] = 101.0
    assert mgr._pump_restarts() and len(spawned) == 1
    mgr._schedule_restart_lineage(lineage)
    assert mgr._restarts[0]["at"] == pytest.approx(103.0)
    now["t"] = 103.5
    assert mgr._pump_restarts() and len(spawned) == 2
    mgr._schedule_restart_lineage(lineage)
    assert lineage["exhausted"]
    assert mgr.counters()["restarts_exhausted"] == 1
    assert not mgr._restarts
    mgr._schedule_restart_lineage(lineage)
    assert not mgr._restarts


def test_program_sets_and_a_missing_card_are_refused_typed(guard):
    """A spec whose program set cannot be read fails its worker's boot
    with ``ProgramSetError`` (sets are ported: tests/test_torch_programs.py
    boots a worker from one); a worker asked for the card on a machine
    without one fails its boot typed; a spent budget removes either."""
    with hard_limit(90):
        fleet = T.FleetRouter([], restart_backoff=T.RestartBackoff(
            max_restarts=0))
        guard(fleet)
        mgr = fleet.manager
        cases = [(dict(spec(), program_set="/nowhere/gpt.pdprograms"),
                  ("ProgramSetError", "unreadable"))]
        if not torch.cuda.is_available():
            card = spec()
            del card["engine"]["device"]
            cases.append((card, ("UnavailableError", "no CUDA device")))
        for bad, words in cases:
            rep = mgr.add_worker(bad)
            wait_for(lambda: rep.state == "crashed", 45, "a failed boot",
                     tick=fleet.step)
            for w in words:
                assert w in rep.fence_reason
            wait_for(lambda: mgr.get(rep.id) is None, 10, "removed",
                     tick=fleet.step)
            assert rep.lineage["exhausted"]


# -------------------------------------------- a worker and the reference

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's tiny GPT, its ``jit.save`` weights, and the
    reference engine's streams: greedy and keyed-sampled."""
    jm, _ = tiny_pair(seed=5)
    path = str(tmp_path_factory.mktemp("ref") / "gpt")
    jjit.save(jm, path)
    eng = J.ServingEngine(jm, **ENGINE)
    kws = [{}, dict(SAMPLED, seed=31), {}, dict(SAMPLED, seed=32)]
    resps = [eng.submit(p, NEW, **kw) for p, kw in zip(PROMPTS, kws)]
    eng.run_until_drained(timeout=120)
    streams = [r.tokens() for r in resps]
    eng.close()
    return path + ".pdiparams.npz", kws, streams


def test_worker_serves_the_reference_streams_without_jax(guard, reference):
    """A port worker booted from the reference's ``jit.save`` npz (its
    factory seed gives other weights) serves the reference engine's
    greedy and keyed-sampled streams token for token, again after the
    first wave is reaped; it never imported jax or the JAX package."""
    wpath, kws, want = reference
    with hard_limit(90):
        fleet = T.FleetRouter([], heartbeat_timeout_s=30.0)
        guard(fleet)
        rid = fleet.add_worker(spec(seed=11, weights=wpath))
        fleet.warmup()
        rep = fleet.manager.get(rid)
        assert isinstance(rep, T.SubprocessReplica)
        client = rep.engine
        assert client.weights_sha == T.transfer.file_sha256(wpath)

        def wave(idx):
            out = []
            for i in idx:
                req, resp = client.make_request(PROMPTS[i], NEW, **kws[i])
                client.scheduler.submit(req, resp)
                out.append(resp)
            wait_for(lambda: all(r.done() for r in out), 60, "a wave",
                     tick=fleet.step)
            return [r.tokens() for r in out]

        assert wave([0, 1]) == want[:2]
        assert wave([2, 3]) == want[2:]
        m = client.metrics(fresh=True)
        proc = m["process"]
        assert proc["modules"] == {"jax": False, "paddle_tpu": False}
        assert proc["pid"] == client.pid and proc["device"] == "cpu"
        assert m["post_warmup_compiles"] == 0
        assert client.post_warmup_compiles() == 0
        assert set(proc["launches"]) >= {"paged_attention",
                                         "dequant_matmul"}
        snap = rep.snapshot()
        assert snap["kind"] == "subprocess" and snap["process_alive"]
        assert snap["heartbeat_age_s"] is not None
        assert fleet.health()["workers"] == 1
        pid = client.pid
        fleet.close()
        assert not pid_alive(pid)
        client.kill()   # a second kill of a reaped worker: a no-op


# ------------------------------------------------------ the fleet paths

def _resident(client, prompt, new=NEW, **kw):
    req, resp = client.make_request(prompt, new, **kw)
    client.scheduler.submit(req, resp)
    return req, resp


def test_sigkill_failover_supervised_restart_and_spent_budget(guard):
    """A worker SIGKILLed mid-decode: its greedy resubmit run finishes on
    the in-process peer equal to the solo stream, its sampled run ends in
    ``ReplicaLostError``; the supervisor's restart boots within the
    backoff and serves equal streams; killed again with its budget spent,
    the lineage is removed and its run fails typed."""
    with hard_limit(90):
        peer = local_engine()
        fleet = T.FleetRouter(
            [peer], heartbeat_timeout_s=30.0,
            restart_backoff=T.RestartBackoff(max_restarts=1,
                                             base_delay=0.05,
                                             max_delay=0.2))
        guard(fleet)
        rid = fleet.add_worker(spec())
        fleet.warmup()
        fleet.start()
        rep = fleet.manager.get(rid)
        want = [torch_solo(peer.model, p, NEW) for p in PROMPTS[:2]]
        rep.engine.set_fault("replica_slow",
                             f"60:1:{rep.lineage['index']}")
        g_req, g_resp = _resident(rep.engine, PROMPTS[0], resubmit=True)
        s_req, s_resp = _resident(rep.engine, PROMPTS[1],
                                  **dict(SAMPLED, seed=41))
        wait_for(lambda: len(g_resp.tokens_so_far()) >= 1
                 and len(s_resp.tokens_so_far()) >= 1, 45,
                 "both runs resident on the worker")
        t_kill = time.monotonic()
        os.kill(rep.engine.pid, signal.SIGKILL)
        assert g_resp.tokens(timeout=45) == want[0]
        with pytest.raises(T.ReplicaLostError):
            s_resp.tokens(timeout=45)
        assert rep.state == "crashed"

        def restarted():
            return next((r for r in fleet.manager.replicas()
                         if r.kind == "subprocess" and r.id != rid
                         and r.state == "healthy"), None)
        wait_for(lambda: restarted() is not None, 60, "the restart")
        boot_s = time.monotonic() - t_kill
        new = restarted()
        assert new.lineage is rep.lineage and new.lineage["restarts"] == 1
        assert boot_s < 60
        _, resp = _resident(new.engine, PROMPTS[1])
        assert resp.tokens(timeout=45) == want[1]
        c = fleet.manager.counters()
        assert c["worker_restarts"] == 1 and c["resubmits"] >= 1
        # killed again: the budget of one is spent
        new.engine.set_fault("replica_slow", f"60:1:{rep.lineage['index']}")
        _, lost = _resident(new.engine, PROMPTS[2])
        wait_for(lambda: len(lost.tokens_so_far()) >= 1, 45, "resident")
        os.kill(new.engine.pid, signal.SIGKILL)
        with pytest.raises(T.ReplicaLostError):
            lost.tokens(timeout=45)
        wait_for(lambda: fleet.manager.get(new.id) is None, 30,
                 "the spent lineage removed")
        assert rep.lineage["exhausted"]
        assert fleet.manager.counters()["restarts_exhausted"] == 1


def test_wedge_fences_by_heartbeat_age_then_kill_and_restart(guard):
    """``replica_wedge`` armed over RPC: the worker's loop blocks, its
    socket stays up, and only the heartbeat's age fences it, near
    ``heartbeat_timeout_s`` (not after an RPC timeout); the resubmit run
    finishes on the peer, the process is killed after the grace period
    and the supervisor's restart serves."""
    timeout_s = 2.0
    with hard_limit(90):
        peer = local_engine()
        fleet = T.FleetRouter(
            [peer], heartbeat_timeout_s=timeout_s, kill_grace_s=0.2,
            restart_backoff=T.RestartBackoff(max_restarts=1,
                                             base_delay=0.05,
                                             max_delay=0.2))
        guard(fleet)
        rid = fleet.add_worker(spec(), rpc_timeout_s=30.0)
        fleet.warmup()
        fleet.start()
        rep = fleet.manager.get(rid)
        want = torch_solo(peer.model, PROMPTS[0], NEW)
        rep.engine.set_fault("replica_slow", f"40:1:{rep.lineage['index']}")
        _, resp = _resident(rep.engine, PROMPTS[0], resubmit=True)
        wait_for(lambda: len(resp.tokens_so_far()) >= 1, 45, "resident")
        proc = rep.engine.proc
        rep.engine.set_fault("replica_wedge", f"{rep.lineage['index']}:0")
        t_arm = time.monotonic()
        wait_for(lambda: rep.state == "wedged", 20, "the wedge fence")
        fence_s = time.monotonic() - t_arm
        assert "heartbeat age" in rep.fence_reason
        assert timeout_s <= fence_s + 0.1 and fence_s < timeout_s + 3.0
        assert resp.tokens(timeout=45) == want
        wait_for(lambda: proc.poll() is not None, 20, "the kill")
        wait_for(lambda: any(r.kind == "subprocess" and r.state == "healthy"
                             for r in fleet.manager.replicas()), 60,
                 "the restart")
        new = next(r for r in fleet.manager.replicas()
                   if r.kind == "subprocess" and r.state == "healthy")
        _, resp2 = _resident(new.engine, PROMPTS[0])
        assert resp2.tokens(timeout=45) == want
        c = fleet.manager.counters()
        assert c["wedges"] == 1 and c["worker_restarts"] == 1


def test_drain_migrates_runs_across_the_process_boundary(guard):
    """Drain an in-process replica: its resident run restores INTO the
    worker through the codec's bytes; drain the worker: its resident
    restores onto a new in-process replica.  Both streams equal solo."""
    with hard_limit(90):
        a = local_engine()
        fleet = T.FleetRouter([a], heartbeat_timeout_s=30.0)
        guard(fleet)
        wid = fleet.add_worker(spec())
        fleet.warmup()
        fleet.start()
        worker = fleet.manager.get(wid)
        want = [torch_solo(a.model, p, NEW) for p in PROMPTS[:2]]
        from paddle_tpu_torch.utils import faults as tfaults
        tfaults.enable("replica_slow", "40:1:0")
        req, resp = _resident(a, PROMPTS[0])
        wait_for(lambda: len(resp.tokens_so_far()) >= 1, 45, "resident")
        fleet.drain(0)
        tfaults.disable("replica_slow")
        assert resp.tokens(timeout=45) == want[0]
        assert req.migrations == 1
        bid = fleet.add_replica(local_engine())
        fleet.warmup()
        worker.engine.set_fault("replica_slow",
                                f"40:1:{worker.lineage['index']}")
        req2, resp2 = _resident(worker.engine, PROMPTS[1])
        wait_for(lambda: len(resp2.tokens_so_far()) >= 1, 45, "resident")
        fleet.drain(wid)
        assert resp2.tokens(timeout=45) == want[1]
        assert req2.migrations == 1
        assert fleet.manager.counters()["migrated"] == 2
        wait_for(lambda: worker.state == "closed", 30, "drained worker")
        assert fleet.manager.get(bid).state == "healthy"


def test_flip_by_path_serves_the_new_weights_capturing_nothing(guard,
                                                               tmp_path):
    """``flip_weights(rid, path, sha)`` on a worker: at its idle boundary
    the worker swaps in place from the artifact, serves a new-weights
    oracle's stream, captures nothing again, and its lineage's spec now
    names the new artifact, so a restart boots on it."""
    from paddle_tpu_torch import jit as tjit
    with hard_limit(90):
        fleet = T.FleetRouter([], heartbeat_timeout_s=30.0)
        guard(fleet)
        rid = fleet.add_worker(spec(seed=11))
        fleet.warmup()
        rep = fleet.manager.get(rid)
        new = tworker.build_gpt(23, device="cpu", **TINY)
        tjit.save(new, str(tmp_path / "new"))
        path = str(tmp_path / "new.pdiparams.npz")
        sha = T.transfer.file_sha256(path)
        # driven on this thread: the RPCs below run on the driving thread
        entry = fleet.flip_weights(rid, path=path, sha=sha)
        wait_for(lambda: entry["done"], 30, "the flip", tick=fleet.step)
        assert entry["ok"], entry
        assert rep.engine.weights_sha == sha
        assert rep.lineage["spec"]["weights"] == path
        want = torch_solo(new, PROMPTS[3], NEW)
        _, resp = _resident(rep.engine, PROMPTS[3])
        wait_for(resp.done, 45, "the new weights' stream", tick=fleet.step)
        assert resp.tokens() == want
        assert rep.engine.metrics(fresh=True)["post_warmup_compiles"] == 0
        bad = fleet.flip_weights(rid, path=path, sha="0" * 64)
        wait_for(lambda: bad["done"], 30, "a refused flip", tick=fleet.step)
        assert not bad["ok"] and "WeightShipError" in bad["error"]
        assert rep.routable()


def test_fleet_adapter_load_reaches_the_worker_and_reships_a_bad_read(
        guard, tmp_path):
    """``FleetRouter.load_adapter`` pages a LoRA artifact into a worker's
    registry over the RPC; with ``adapter_corrupt`` armed in the worker
    its first read is refused typed and the client re-ships once.  The
    worker's adapter stream equals an in-process LoRA engine's."""
    from paddle_tpu_torch import lora
    from paddle_tpu_torch.utils.monitor import stat_get
    base = tworker.build_gpt(11, device="cpu", **TINY)
    gen = torch.Generator().manual_seed(5)
    lora.apply_lora(base, rank=4, generator=gen)
    with torch.no_grad():
        for mod in base.modules():
            if isinstance(mod, lora.LoRALinear):
                mod.lora_B.normal_(0.0, 0.5, generator=gen)
    path = str(tmp_path / "t1.npz")
    lora.export_adapter(base, path)
    cfg = {"rank": 4, "max_adapters": 2}
    eng = local_engine(lora=lora.LoRAConfig.from_spec(cfg))
    eng.load_adapter("t1", path)
    want = eng.submit(PROMPTS[1], NEW, adapter="t1")
    eng.run_until_drained(timeout=60)
    want = want.tokens()
    with hard_limit(90):
        fleet = T.FleetRouter([], heartbeat_timeout_s=30.0)
        guard(fleet)
        rid = fleet.add_worker(dict(spec(), lora=cfg))
        fleet.warmup()
        client = fleet.manager.get(rid).engine
        client.set_fault("adapter_corrupt", "1")
        reships = stat_get("STAT_lora_ship_reships")
        shas = fleet.load_adapter("t1", path)
        assert shas == {rid: T.transfer.file_sha256(path)}
        assert stat_get("STAT_lora_ship_reships") == reships + 1
        req, resp = client.make_request(PROMPTS[1], NEW, adapter="t1")
        client.scheduler.submit(req, resp)
        wait_for(resp.done, 45, "the adapter stream", tick=fleet.step)
        assert resp.tokens() == want
