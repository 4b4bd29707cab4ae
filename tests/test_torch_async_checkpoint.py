"""paddle_tpu_torch's AsyncCheckpointManager, train_epoch_range and the
kill_mid_save fault against the JAX package on the CPU: the writer
thread's files equal the synchronous manager's and read back in the
reference, backpressure at ``max_in_flight``, a writer error re-raised
on the training thread, the watchdog, a process killed mid-save leaving
the previous step ``latest``, and an epoch loop resumed after the newest
checkpoint's epoch.  Every manager's writer thread is joined in
teardown.  Arrays are drawn with numpy from a seed; values compare
exactly (the same bytes are written).
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import checkpoint as jck

from paddle_tpu_torch.core.errors import ExecutionTimeoutError
from paddle_tpu_torch.distributed import checkpoint as tck
from paddle_tpu_torch.utils import monitor as tmonitor

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def managers():
    """Managers made by a test; each is closed and its writer joined."""
    made = []
    yield made
    for m in made:
        m.close(timeout=5.0)
        assert not m._writer.is_alive()


def _tree(seed, bf16=True):
    rng = np.random.RandomState(seed)
    params = {"w": torch.from_numpy(rng.randn(4, 3).astype(np.float32)),
              "b": torch.from_numpy(rng.randn(3).astype(np.float32))}
    if bf16:   # the reference's restore cannot read bf16 arrays
        params["h"] = torch.from_numpy(rng.randn(2, 2).astype(
            np.float32)).bfloat16()
    return {"params": params, "opt": {"w": {"moment1": torch.zeros(4, 3)}}}


def _files(step_dir):
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = dict(np.load(os.path.join(step_dir, "shards-p00000.npz")))
    return manifest, arrays


def test_async_files_equal_the_sync_managers(tmp_path, managers):
    """The same trees through CheckpointManager and AsyncCheckpointManager:
    equal manifests and npz arrays (bf16 included), the same retention,
    and the reference restores an async step of f32 arrays."""
    sync = tck.CheckpointManager(str(tmp_path / "sync"), max_to_keep=2)
    am = tck.AsyncCheckpointManager(str(tmp_path / "async"), max_to_keep=2)
    managers.append(am)
    writes = tmonitor.stat_get("STAT_checkpoint_async_writes")
    for step in (1, 2, 3):
        sync.save(_tree(step), step, {"epoch": step})
        path = am.save(_tree(step), step, {"epoch": step})
        assert path.endswith(f"step-{step:09d}")
    assert am.wait_until_finished(timeout=30)
    assert tmonitor.stat_get("STAT_checkpoint_async_writes") == writes + 3
    assert am.all_steps() == sync.all_steps() == [2, 3]
    for step in (2, 3):
        m1, a1 = _files(str(tmp_path / "sync" / f"step-{step:09d}"))
        m2, a2 = _files(str(tmp_path / "async" / f"step-{step:09d}"))
        assert m1 == m2 and sorted(a1) == sorted(a2)
        for k in a1:
            assert a1[k].tobytes() == a2[k].tobytes()
    got = am.restore_latest()
    assert torch.equal(got[0]["params"]["h"], _tree(3)["params"]["h"])
    am.save(_tree(4, bf16=False), 4, {"epoch": 4})
    assert am.wait_until_finished(timeout=30)
    tree, step, extra = jck.restore_sharded(str(tmp_path / "async"))
    assert step == 4 and extra["epoch"] == 4
    np.testing.assert_array_equal(np.asarray(tree["params"]["w"]),
                                  _tree(4)["params"]["w"].numpy())


def _blocking_publish(monkeypatch, gate, started):
    orig = tck.publish_snapshot

    def slow(directory, manifest, shards):
        started.set()
        gate.wait(30)
        return orig(directory, manifest, shards)
    monkeypatch.setattr(tck, "publish_snapshot", slow)


def test_backpressure_at_max_in_flight(tmp_path, monkeypatch, managers):
    """With max_in_flight 1: one snapshot is being written and one waits
    in the queue; the third save blocks until the writer moves on.  The
    checkpoint_async_in_flight gauge counts the three, then none."""
    gate, started = threading.Event(), threading.Event()
    _blocking_publish(monkeypatch, gate, started)
    am = tck.AsyncCheckpointManager(str(tmp_path), max_in_flight=1)
    managers.append(am)
    am.save(_tree(1), 1)
    assert started.wait(10)
    am.save(_tree(2), 2)          # queued
    done = threading.Event()
    t = threading.Thread(target=lambda: (am.save(_tree(3), 3), done.set()))
    t.start()
    time.sleep(0.6)
    assert not done.is_set()      # blocked: the queue holds one
    assert am._outstanding == 3 and tck._obs()[1].value() == 3
    gate.set()
    t.join(30)
    assert done.is_set()
    assert am.wait_until_finished(timeout=30)
    assert am._outstanding == 0 and tck._obs()[1].value() == 0
    assert am.all_steps() == [2, 3]


def test_writer_error_is_reraised(tmp_path, monkeypatch, managers):
    def broken(directory, manifest, shards):
        raise OSError("disk on fire")
    monkeypatch.setattr(tck, "publish_snapshot", broken)
    am = tck.AsyncCheckpointManager(str(tmp_path))
    managers.append(am)
    am.save(_tree(1), 1)
    with pytest.raises(RuntimeError, match="disk on fire"):
        am.wait_until_finished(timeout=30)
    monkeypatch.undo()
    am.save(_tree(2), 2)          # the writer lives on
    assert am.wait_until_finished(timeout=30)
    assert am.all_steps() == [2]


def test_watchdog_raises_on_a_wedged_write(tmp_path, monkeypatch,
                                           managers):
    gate, started = threading.Event(), threading.Event()
    _blocking_publish(monkeypatch, gate, started)
    am = tck.AsyncCheckpointManager(str(tmp_path), watchdog_seconds=0.3)
    managers.append(am)
    am.save(_tree(1), 1)
    assert started.wait(10)
    time.sleep(0.5)
    with pytest.raises(ExecutionTimeoutError):
        am.wait_until_finished(timeout=10)
    with pytest.raises(ExecutionTimeoutError):
        am.save(_tree(2), 2)
    gate.set()
    assert am.wait_until_finished(timeout=30)
    am.close()
    with pytest.raises(RuntimeError, match="closed"):
        am.save(_tree(3), 3)


KILL_SCRIPT = """
import numpy as np, torch
from paddle_tpu_torch.distributed import checkpoint as tck
am = tck.AsyncCheckpointManager({d!r})
for step in (1, 2):
    am.save({{"w": torch.full((3,), float(step))}}, step)
    am.wait_until_finished()
print("not killed")
"""


def test_kill_mid_save_leaves_the_previous_step_latest(tmp_path):
    """PDTPU_FAULT_KILL_MID_SAVE=2 in a subprocess: the writer thread
    SIGKILLs the process after step 2's files are written, before their
    rename.  Step 1 stays latest and restorable, in both frameworks, and
    a new manager clears the debris."""
    d = str(tmp_path / "ckpt")
    env = dict(os.environ, PDTPU_FAULT_KILL_MID_SAVE="2",
               PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", KILL_SCRIPT.format(d=d)],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == -9, proc.stderr
    assert "not killed" not in proc.stdout
    assert os.path.isdir(os.path.join(d, "step-000000002.tmp-p00000"))
    assert tck.latest_step_dir(d).endswith("step-000000001")
    tree, step, _ = tck.restore_sharded(d)
    assert step == 1 and torch.equal(tree["w"], torch.ones(3))
    assert jck.restore_sharded(d)[1] == 1
    tck.CheckpointManager(d)
    assert not any(".tmp-p" in n for n in os.listdir(d))


def test_train_epoch_range_resumes(tmp_path, managers):
    """An epoch loop that saved {"epoch": e} after epochs 0 and 1 and
    stopped resumes at epoch 2, in both frameworks' ranges."""
    am = tck.AsyncCheckpointManager(str(tmp_path))
    managers.append(am)
    seen = []
    for e in tck.train_epoch_range(5, am):
        seen.append(e)
        am.save(_tree(e), e + 1, extra_meta={"epoch": e})
        if e == 1:
            break
    am.wait_until_finished()
    assert seen == [0, 1]
    assert list(tck.train_epoch_range(5, am)) == [2, 3, 4]
    jm = jck.CheckpointManager(str(tmp_path))
    assert list(jck.train_epoch_range(5, jm)) == [2, 3, 4]
    assert list(tck.train_epoch_range(3, tck.CheckpointManager(
        str(tmp_path / "empty")))) == [0, 1, 2]
