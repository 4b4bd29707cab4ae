"""``spawn``: start ``nprocs`` worker processes (counterpart of
paddle_tpu/distributed/spawn.py).

Each worker gets the reference's variables (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_COORDINATOR``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``) and runs
``func(*args)``; ``distributed.init_parallel_env`` in the worker then
starts ``torch.distributed`` over the coordinator.  ``join`` waits at most
``timeout`` seconds (``options["timeout"]``, default 900): when a worker
fails, or the time runs out, the others are terminated (they may be
blocked in a collective waiting for the dead one) and the call raises
with every failed rank, its exit code and its traceback.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import time
import traceback

__all__ = ["spawn"]

_JOIN_S = 900.0


def _worker(fn, rank, nprocs, port, args, errq):
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["PADDLE_TRAINERS_NUM"] = str(nprocs)
    os.environ["PADDLE_COORDINATOR"] = f"127.0.0.1:{port}"
    os.environ["PADDLE_TRAINER_ENDPOINTS"] = ",".join(
        f"127.0.0.1:{port + i}" for i in range(nprocs))
    os.environ["PADDLE_CURRENT_ENDPOINT"] = f"127.0.0.1:{port + rank}"
    try:
        fn(*args)
    except BaseException:
        errq.put((rank, traceback.format_exc()))
        raise


class SpawnContext:
    def __init__(self, procs, errq, timeout):
        self.processes = procs
        self._errq = errq
        self._timeout = timeout

    def join(self, timeout=None):
        """Wait for every worker (at most ``timeout`` seconds, else the
        spawn's); raise if any failed or the time ran out."""
        limit = self._timeout if timeout is None else timeout
        deadline = time.monotonic() + limit
        timed_out = False
        while True:
            alive = [p for p in self.processes if p.is_alive()]
            failed = [p for p in self.processes
                      if not p.is_alive() and p.exitcode not in (0, None)]
            if failed or not alive:
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
        for p in self.processes:
            if p.is_alive():
                p.terminate()
        for p in self.processes:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        errors = {}
        while not self._errq.empty():
            rank, tb = self._errq.get()
            errors[rank] = tb
        bad = [(r, p.exitcode) for r, p in enumerate(self.processes)
               if p.exitcode not in (0, None)]
        if timed_out and not errors:
            raise TimeoutError(
                f"spawn: workers still running after {limit:.0f} s; "
                "terminated")
        if errors or bad:
            lines = [f"rank {r} exited with code {c}" for r, c in bad]
            lines += [f"rank {r} failed:\n{tb}" for r, tb in
                      sorted(errors.items())]
            raise RuntimeError("spawn: " + "\n".join(lines))


def spawn(func, args=(), nprocs=1, join=True, daemon=False, port=23456,
          **options):
    """Run ``func(*args)`` in ``nprocs`` processes (the ``spawn`` start
    method), one per rank; returns the context (joined when ``join``)."""
    ctx = mp.get_context("spawn")
    errq = ctx.Queue()
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_worker,
                        args=(func, rank, nprocs, port, args, errq),
                        daemon=daemon)
        p.start()
        procs.append(p)
    c = SpawnContext(procs, errq, float(options.get("timeout", _JOIN_S)))
    if join:
        c.join()
    return c
