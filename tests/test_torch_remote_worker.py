"""paddle_tpu_torch's remote workers on the CPU: standalone ``python -m
paddle_tpu_torch.serving.worker --listen 127.0.0.1:0`` processes attached
over loopback TCP by ``RemoteWorkerClient`` / ``FleetRouter.add_worker(
address=...)``.

The attach ships a ``jit.save`` weight artifact in sha256-checked chunks
(the factory's seed gives other weights, so an equal stream proves the
shipped ones serve); a corrupted chunk is refused typed and serves
nothing until the supervisor's re-attach ships clean.  A lost submit ack
(its deadline lapsed, as the reference's tier-1 test forces it) is
resent and admitted once; a submit cut mid-frame by ``net_drop`` fails
over to the in-process peer and the supervisor re-attaches to the
worker's cached engine with nothing shipped.  A stale epoch is refused
and a higher one takes the session over, its residents aborted typed.  A
wedged remote step fences on beat-frame age with no heartbeat file, and a
flip by path ships the artifact and serves it.  The worker's own session
logic (manager silence, ``abort_epoch``) is held with an injected clock,
and a swap's verdict, read by a client from a fake worker, counts as a
beat.  Each test holds a SIGALRM limit, runs at most
one listening worker (killed by process group in teardown) and bounds
every wait."""
import socket
import time

import numpy as np
import pytest

import paddle_tpu_torch.serving as T
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch.serving import transfer as ttransfer
from paddle_tpu_torch.serving import worker as tworker
from paddle_tpu_torch.serving.worker import (RemoteWorkerClient,
                                             StaleEpochError,
                                             WorkerDiedError)
from paddle_tpu_torch.utils import faults as tfaults

from torch_parity import TINY, torch_solo
from torch_workers import (PROMPTS, guard, hard_limit,  # noqa: F401
                           listen_worker, local_engine, spec, wait_for)

pytestmark = pytest.mark.remote_fleet

NEW = 24
FACTORY_SEED, WEIGHT_SEED = 11, 99


@pytest.fixture
def shipped(tmp_path):
    """The weight seed's model and its ``jit.save`` npz."""
    model = tworker.build_gpt(WEIGHT_SEED, device="cpu", **TINY)
    tjit.save(model, str(tmp_path / "m"))
    return model, str(tmp_path / "m.pdiparams.npz")


def _ship(client, prompt, new=NEW, **kw):
    req, resp = client.make_request(prompt, new, **kw)
    client.scheduler.submit(req, resp)
    return req, resp


def test_manager_silence_self_abort_and_abort_epoch():
    """Under an injected clock a session whose manager fell silent past
    ``manager_silence_s`` aborts every run typed (``StaleEpochError``) and
    detaches; ``abort_epoch`` does the same for its own epoch only."""
    engine = local_engine(FACTORY_SEED)
    s_mgr, s_wrk = socket.socketpair()
    conn = tworker._FrameConn(s_wrk)
    now = {"t": 100.0}
    try:
        server = tworker._WorkerServer(engine, conn, None, 0, epoch=3,
                                       manager_silence_s=2.0,
                                       _clock=lambda: now["t"])
        server._handle("abort_epoch", {"epoch": 2}, {})
        assert server.detach is None
        resp = engine.submit(PROMPTS[0], 4)
        now["t"] = 101.9
        assert not server._check_manager_silence()
        assert resp.error is None
        now["t"] = 102.1
        assert server._check_manager_silence()
        assert server.detach == "manager-silence"
        assert isinstance(resp.error, StaleEpochError)
        assert "manager silent" in str(resp.error)
        server2 = tworker._WorkerServer(engine, conn, None, 0, epoch=3,
                                        manager_silence_s=None,
                                        _clock=lambda: now["t"])
        assert not server2._check_manager_silence()
        resp2 = engine.submit(PROMPTS[1], 4)
        server2._handle("abort_epoch", {"epoch": 3}, {})
        assert server2.detach == "abort_epoch"
        assert isinstance(resp2.error, StaleEpochError)
    finally:
        conn.close()
        s_mgr.close()
        engine.close()


def test_attach_ships_checked_weights_dedups_and_survives_a_cut(
        guard, listen_worker, shipped):
    model, wpath = shipped
    with hard_limit(90):
        peer = local_engine(WEIGHT_SEED)
        fleet = T.FleetRouter(
            [peer], heartbeat_timeout_s=30.0,
            restart_backoff=T.RestartBackoff(max_restarts=2,
                                             base_delay=0.05,
                                             max_delay=0.2))
        guard(fleet)
        addr, proc = listen_worker(index=1)
        rid = fleet.add_worker(spec(FACTORY_SEED, weights=wpath),
                               address=addr, ack_timeout_s=30.0)
        rep = fleet.manager.get(rid)
        assert isinstance(rep, T.RemoteReplica) and rep.lineage["index"] == 1
        fleet.warmup()
        client = rep.engine
        assert client.heartbeat_path is None     # liveness: beat frames
        assert client.epoch == 1 and client.pid == proc.pid
        assert client.weights_sha == ttransfer.file_sha256(wpath)
        assert client.bytes_shipped > 0
        snap = rep.snapshot()
        assert snap["kind"] == "remote" and snap["address"] == addr
        assert fleet.health()["remote_workers"] == 1
        want = [torch_solo(model, p, NEW) for p in PROMPTS[:3]]
        # a lost ack: the deadline lapses twice, the submit is resent and
        # the worker's wid dedup admits it once (a double admission would
        # push duplicate tokens into the stream)
        req, resp = client.make_request(PROMPTS[0], NEW)
        client._ship(req, resp)
        wid = next(iter(client._await_ack))
        for _ in range(2):
            client._await_ack[wid][0] = 0.0
            client._pump_acks()
        assert client._await_ack[wid][1] == client.submit_retries - 2
        wait_for(resp.done, 45, "the deduplicated stream", tick=fleet.step)
        assert resp.tokens() == want[0] and not client._await_ack
        wait_for(lambda: client.heartbeat_steps() is not None, 20,
                 "beat frames", tick=fleet.step)
        assert client.heartbeat_age() < 30.0
        assert client.post_warmup_compiles() == 0
        # net_drop cuts the manager's next frame, a submit, mid-frame: the
        # session dies, the resubmit run finishes on the peer, and the
        # supervisor re-attaches (epoch 2) to the cached engine
        client.set_fault("replica_slow", "60:1:1")
        _, r1 = _ship(client, PROMPTS[1], resubmit=True)
        wait_for(lambda: len(r1.tokens_so_far()) >= 1, 45, "resident",
                 tick=fleet.step)
        tfaults.enable("net_drop", "1")
        _, r2 = _ship(client, PROMPTS[2], resubmit=True)
        wait_for(lambda: r1.done() and r2.done(), 45, "the failover",
                 tick=fleet.step)
        tfaults.disable("net_drop")
        assert r1.tokens() == want[1] and r2.tokens() == want[2]
        assert rep.state == "crashed"

        def reattached():
            return next((r for r in fleet.manager.replicas()
                         if r.kind == "remote" and r.state == "healthy"),
                        None)
        wait_for(lambda: reattached() is not None, 60, "the re-attach",
                 tick=fleet.step)
        new = reattached()
        assert new.engine.epoch == 2 and new.engine.bytes_shipped == 0
        assert new.engine.weights_sha == client.weights_sha
        assert proc.poll() is None
        new.engine.set_fault("replica_slow", None)
        _, r3 = _ship(new.engine, PROMPTS[0])
        wait_for(r3.done, 45, "a stream after the re-attach",
                 tick=fleet.step)
        assert r3.tokens() == want[0]
        fleet.close()
        time.sleep(0.2)
        assert proc.poll() is None, "the manager does not own the worker"


def test_corrupt_chunk_is_refused_typed_then_a_clean_reattach_serves(
        guard, listen_worker, shipped, monkeypatch):
    model, wpath = shipped
    real = ttransfer.iter_artifact_chunks
    calls = {"n": 0}

    def corrupting(path, *a, **kw):
        calls["n"] += 1
        first = calls["n"] == 1
        for seq, data in real(path, *a, **kw):
            yield seq, (b"\0" * len(data) if first and seq == 0 else data)

    monkeypatch.setattr(ttransfer, "iter_artifact_chunks", corrupting)
    with hard_limit(90):
        fleet = T.FleetRouter([], heartbeat_timeout_s=30.0,
                              restart_backoff=T.RestartBackoff(
                                  max_restarts=1, base_delay=0.05,
                                  max_delay=0.2))
        guard(fleet)
        addr, _ = listen_worker(index=0)
        rid = fleet.add_worker(spec(FACTORY_SEED, weights=wpath),
                               address=addr)
        rep = fleet.manager.get(rid)

        def healthy():
            return next((r for r in fleet.manager.replicas()
                         if r.kind == "remote" and r.state == "healthy"),
                        None)
        wait_for(lambda: healthy() is not None, 60,
                 "the re-attach after the corrupt ship", tick=fleet.step)
        assert rep.state == "crashed" and rep.steps == 0
        assert "WeightShipError" in rep.fence_reason
        assert "sha256 mismatch" in rep.fence_reason
        new = healthy()
        assert new.engine.epoch == 2 and new.lineage["restarts"] == 1
        assert calls["n"] == 2 and new.engine.bytes_shipped > 0
        _, resp = _ship(new.engine, PROMPTS[3])
        wait_for(resp.done, 45, "a stream", tick=fleet.step)
        assert resp.tokens() == torch_solo(model, PROMPTS[3], NEW)


def test_stale_epoch_is_refused_and_a_higher_one_takes_over(
        guard, listen_worker):
    """An attach with the live session's epoch is refused with a typed
    ``StaleEpochError``; a higher epoch supersedes the session: its
    resident aborts typed (never served twice) and the new one serves."""
    with hard_limit(90):
        addr, _ = listen_worker(index=0)
        want = torch_solo(local_engine(FACTORY_SEED).model, PROMPTS[0], NEW)
        a = RemoteWorkerClient(spec(FACTORY_SEED), addr, index=0, epoch=5,
                               manager_silence_s=30.0)
        guard(a)
        a.warmup()
        a.set_fault("replica_slow", "60:1:0")
        _, ra = _ship(a, PROMPTS[0])
        wait_for(lambda: len(ra.tokens_so_far()) >= 1, 45, "resident",
                 tick=a.step)
        stale = RemoteWorkerClient(spec(FACTORY_SEED), addr, index=0,
                                   epoch=5, boot_timeout_s=30.0)
        guard(stale)
        with pytest.raises(WorkerDiedError, match="StaleEpochError"):
            wait_for(stale.poll_ready, 45, "a refusal", tick=a.step)
        assert ra.error is None and not ra.done()
        b = RemoteWorkerClient(spec(FACTORY_SEED), addr, index=0, epoch=6)
        guard(b)
        wait_for(ra.done, 45, "the old session's abort", tick=a.step)
        assert isinstance(ra.error, StaleEpochError)
        assert "superseded by attach epoch 6" in str(ra.error)
        b.warmup()
        b.set_fault("replica_slow", None)
        _, rb = _ship(b, PROMPTS[0])
        wait_for(rb.done, 45, "the new session's stream", tick=b.step)
        assert rb.tokens() == want


def test_remote_wedge_fences_on_beat_age_without_a_heartbeat_file(
        guard, listen_worker):
    timeout_s = 2.0
    with hard_limit(90):
        peer = local_engine(FACTORY_SEED)
        fleet = T.FleetRouter([peer], heartbeat_timeout_s=timeout_s,
                              kill_grace_s=0.2,
                              restart_backoff=T.RestartBackoff(
                                  max_restarts=0))
        guard(fleet)
        addr, proc = listen_worker(index=1)
        rid = fleet.add_worker(spec(FACTORY_SEED), address=addr)
        rep = fleet.manager.get(rid)
        fleet.warmup()
        fleet.start()
        assert rep.engine.heartbeat_path is None
        want = torch_solo(peer.model, PROMPTS[1], NEW)
        rep.engine.set_fault("replica_slow", "40:1:1")
        _, resp = _ship(rep.engine, PROMPTS[1], resubmit=True)
        wait_for(lambda: len(resp.tokens_so_far()) >= 1, 45, "resident")
        rep.engine.set_fault("replica_wedge", "1:0")
        t_arm = time.monotonic()
        wait_for(lambda: rep.state == "wedged", 20, "the wedge fence")
        fence_s = time.monotonic() - t_arm
        assert "heartbeat age" in rep.fence_reason
        assert fence_s < timeout_s + 3.0
        assert resp.tokens(timeout=45) == want
        wait_for(lambda: fleet.manager.get(rid) is None, 20,
                 "the spent lineage removed")
        assert fleet.manager.counters()["wedges"] == 1
        assert proc.poll() is None     # a remote process is not ours


def test_a_long_verb_is_not_taken_for_manager_silence():
    """A verb that reads the manager's frames itself for longer than
    ``manager_silence_s`` (a swap's or an adapter's ship) leaves the
    session up: the worker does not take the manager for silent once the
    verb is done.  The handler is stubbed to take 5 s of an injected
    clock; the manager then closes the connection."""
    engine = local_engine(FACTORY_SEED)
    s_mgr, s_wrk = socket.socketpair()
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    lsock.setblocking(False)
    now = {"t": 100.0}
    server = tworker._WorkerServer(
        engine, tworker._FrameConn(s_wrk), None, 0, epoch=1,
        manager_silence_s=2.0, listener=lsock, _clock=lambda: now["t"])
    manager = tworker._FrameConn(s_mgr)

    def long_verb(verb, h, arrays):
        now["t"] += 5.0
        manager.close()      # the manager goes away after the verb
    server._handle = long_verb
    try:
        with hard_limit(30):
            manager.send("swap_weights", {"wid": 0})
            assert server.serve() == 5
        assert server.detach == "manager-lost", server.detach
    finally:
        server.conn.close()
        lsock.close()
        engine.close()


def test_a_swap_verdict_counts_as_a_beat(tmp_path):
    """The worker's loop does not step while a swap ships and runs; its
    verdict is progress, so it ages like a beat frame: a manager that
    drained its last beat before the ship does not read the gap as a
    wedge.  A fake worker on a socket pair answers the swap."""
    import threading
    path = str(tmp_path / "w.npz")
    np.savez(path, w=np.arange(5000, dtype=np.float32))
    mgr, wrk = socket.socketpair()
    client = RemoteWorkerClient.__new__(RemoteWorkerClient)
    client._init_state({}, 0, 5.0, 5.0, None)
    client.proc = tworker._NullProc()
    client._conn = tworker._FrameConn(mgr)
    client._beat_conn = client._last_beat = None
    client._last_beat_rx = time.monotonic() - 60.0   # long drained
    client.bytes_shipped, client._last_tx = 0, time.monotonic()
    worker = tworker._FrameConn(wrk)

    def serve():
        h, _ = tworker._wait_frame(worker, "swap_weights", timeout=10.0)
        worker.send("swap_ready", {"wid": h["wid"]})
        tworker._recv_artifacts(worker, {"weights": (
            h["manifest"], str(tmp_path / "got.npz"))}, timeout=10.0)
        worker.send("swapped", {"wid": h["wid"], "ok": True,
                                "weights_sha": h["sha256"]})
    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        with hard_limit(30):
            sha = client.swap_weights(path, timeout_s=10.0)
        t.join(timeout=10)
        assert not t.is_alive()
        assert sha == ttransfer.file_sha256(path)
        assert client.heartbeat_age() < 5.0
    finally:
        client._conn.close()
        worker.close()


def test_a_remote_flip_ships_the_artifact_and_serves_it(guard, listen_worker,
                                                       shipped):
    """A flip by path on a remote worker ships the artifact in checked
    chunks to the worker's own disk, swaps in place at the idle boundary
    and serves the new weights, captured nothing again."""
    model, wpath = shipped
    with hard_limit(90):
        fleet = T.FleetRouter([], heartbeat_timeout_s=30.0)
        guard(fleet)
        addr, _ = listen_worker(index=0)
        rid = fleet.add_worker(spec(FACTORY_SEED), address=addr)
        fleet.warmup()
        rep = fleet.manager.get(rid)
        entry = fleet.flip_weights(rid, path=wpath)
        wait_for(lambda: entry["done"], 45, "the flip", tick=fleet.step)
        assert entry["ok"], entry
        assert rep.engine.weights_sha == ttransfer.file_sha256(wpath)
        assert rep.engine.bytes_shipped > 0
        _, resp = _ship(rep.engine, PROMPTS[2])
        wait_for(resp.done, 45, "a stream on the new weights",
                 tick=fleet.step)
        assert resp.tokens() == torch_solo(model, PROMPTS[2], NEW)
        assert rep.engine.metrics(fresh=True)["post_warmup_compiles"] == 0
