"""Shared helpers of tests/test_torch_worker.py and
tests/test_torch_remote_worker.py: the tiny GPT's worker boot spec, a
SIGALRM limit per test, a guard that closes every fleet and client and
kills every worker process by its process group, and bounded waits.

Workers run ``python -m paddle_tpu_torch.serving.worker`` on the CPU
(``device="cpu"`` in the spec) and import neither jax nor the JAX
package.  They get one intra-op thread (``OMP_NUM_THREADS=1``): the tiny
GPT gains nothing from more, and idle OpenMP threads of several processes
spinning on the same cores stretch a step to seconds, which the fleet
would fence as a wedge."""
import os
import signal
import subprocess
import sys
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest

from paddle_tpu_torch.serving import worker as tworker
from paddle_tpu_torch.serving.worker import WireFormatError, WorkerDiedError
from paddle_tpu_torch.utils import faults as tfaults

from torch_parity import TINY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# paged KV through K3's plain version; two slots, one prefill bucket
ENGINE = dict(max_slots=2, max_len=48, prefill_buckets=(16,),
              decode_chunk=2, kv="paged", block_size=8)
PROMPTS = [np.random.RandomState(i).randint(0, 128, (n,)).astype(np.int32)
           for i, n in enumerate((5, 9, 4, 7))]
SAMPLED = dict(decode_strategy="sampling", top_k=8, temperature=0.8)


def spec(seed=11, weights=None, **engine):
    """A worker boot spec of ``torch_parity.TINY`` from ``build_gpt(seed)``
    on the CPU (``weights``: a jit.save npz that replaces them)."""
    ekw = dict(ENGINE, device="cpu", **engine)
    ekw["prefill_buckets"] = list(ekw["prefill_buckets"])
    out = {"model": {"factory": "paddle_tpu_torch.serving.worker:build_gpt",
                     "kwargs": dict(TINY, seed=seed)},
           "engine": ekw}
    if weights is not None:
        out["weights"] = weights
    return out


def local_engine(seed=11, **engine):
    """An in-process port engine over the same weights as ``spec(seed)``."""
    from paddle_tpu_torch.serving import ServingEngine
    model = tworker.build_gpt(seed, device="cpu", **TINY)
    return ServingEngine(model, device="cpu", **dict(ENGINE, **engine))


class Limit(BaseException):
    """A test's time limit: not an Exception, so a fleet tick does not
    take it for a replica's crash."""


@contextmanager
def hard_limit(seconds):
    def boom(*_):
        raise Limit(f"test exceeded its {seconds} s limit")
    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _kill_group(proc):
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        pass
    try:
        proc.wait(timeout=10)
    except Exception:  # noqa: BLE001 — reaped or not ours
        pass


@pytest.fixture
def guard(monkeypatch):
    """Register fleets / clients to close at teardown; every worker
    process the test spawns (each in a session of its own) is killed by
    its process group afterwards, and the fault knobs are reset."""
    closers, procs = [], []
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # inherited by the workers
    real_init = tworker.WorkerClient.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        procs.append(self.proc)
    monkeypatch.setattr(tworker.WorkerClient, "__init__", init)
    tfaults.reset()
    yield closers.append
    for item in reversed(closers):
        try:
            item.close()
        except Exception:  # noqa: BLE001 — teardown goes on
            pass
    for proc in procs:
        _kill_group(proc)
    tfaults.reset()


@pytest.fixture
def listen_worker():
    """Factory of standalone ``--listen 127.0.0.1:0`` workers: returns
    (address, proc); killed by process group at teardown."""
    procs = []

    def spawn(index=0, env_extra=None):
        proc = start_listener(index, env_extra)
        procs.append(proc)
        return proc.address, proc

    yield spawn
    for proc in procs:
        _kill_group(proc)


def start_listener(index=0, env_extra=None):
    """Start one standalone worker and read its address from its first
    line; its output is drained by a daemon thread so it never blocks."""
    env = dict(os.environ)
    env["PYTHONPATH"] = (ROOT + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else ROOT)
    env["OMP_NUM_THREADS"] = "1"
    env.update(env_extra or {})
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.worker",
         "--listen", "127.0.0.1:0", "--index", str(index)],
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env,
        start_new_session=True)
    while True:  # the test's SIGALRM bounds this
        line = proc.stdout.readline()
        if not line:
            raise AssertionError("the worker exited before listening")
        if "worker listening on" in line:
            proc.address = line.strip().rsplit(" ", 1)[-1]
            break
    threading.Thread(target=proc.stdout.read, daemon=True).start()
    return proc


def wait_for(pred, timeout, what, tick=None):
    """Poll ``pred`` (ticking ``tick`` between polls, on this thread)."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if tick is not None:
            try:
                tick()
            except (WorkerDiedError, WireFormatError):
                pass  # the session went down under us: pred decides
        if pred():
            return
        time.sleep(0.002)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


def pid_alive(pid):
    try:
        done, _ = os.waitpid(pid, os.WNOHANG)
        if done:
            return False
    except ChildProcessError:
        pass
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, PermissionError):
        return False
    return True
