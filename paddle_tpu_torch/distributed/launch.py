"""Launcher: ``python -m paddle_tpu_torch.distributed.launch train.py``
(counterpart of paddle_tpu/distributed/launch.py, the same command line).

Starts one trainer process per local rank (``--nproc_per_node``; one per
card on a GPU host, several for a CPU test) with the reference's
``PADDLE_*`` variables plus ``PADDLE_LOCAL_RANK``; the trainer's
``init_parallel_env`` starts ``torch.distributed`` over the coordinator
(``--ips``' first host at ``--coordinator_port``).  It watches the
children: when one fails, it reports that rank and its exit code and
tears the others down (SIGTERM, then SIGKILL after 10 s).  The wait is
bounded: the job as a whole gets ``--timeout`` seconds, and once one
worker has exited cleanly the others get ``--exit_grace`` seconds to
follow (a rank that hangs in its teardown past its results); past either
limit every worker left is torn down and the launcher exits 124.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

__all__ = ["launch", "start_local_trainers"]

_GRACE_S = 10.0
_TIMEOUT_S = 24 * 3600.0   # --timeout: the whole job
_EXIT_GRACE_S = 300.0      # --exit_grace: the others, after a clean exit
TIMED_OUT = 124            # the exit code when a limit passes (timeout(1)'s)


def _parse_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--ips", type=str, default="127.0.0.1",
                   help="comma-separated host ips (reference --ips)")
    p.add_argument("--host_rank", type=int, default=0,
                   help="this host's index into --ips")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="processes per host (one per card)")
    p.add_argument("--coordinator_port", type=int, default=12355)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--timeout", type=float, default=_TIMEOUT_S,
                   help="seconds the job may run in all")
    p.add_argument("--exit_grace", type=float, default=_EXIT_GRACE_S,
                   help="seconds the other workers get once one has "
                        "exited cleanly")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _teardown(procs):
    for _, p, _ in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + _GRACE_S
    for _, p, _ in procs:
        try:
            p.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def start_local_trainers(args) -> int:
    """Start this host's trainers and watch them; the first failing exit
    code, ``TIMED_OUT`` when a limit passed, else 0."""
    ips = args.ips.split(",")
    nproc = args.nproc_per_node
    world = len(ips) * nproc
    coordinator = f"{ips[0]}:{args.coordinator_port}"
    endpoints = ",".join(f"{ip}:{args.coordinator_port + i}"
                         for ip in ips for i in range(nproc))
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    procs = []
    for local in range(nproc):
        rank = args.host_rank * nproc + local
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_TRAINER_ENDPOINTS": endpoints,
            "PADDLE_CURRENT_ENDPOINT":
                f"{ips[args.host_rank]}:{args.coordinator_port + local}",
            "PADDLE_COORDINATOR": coordinator,
            "PADDLE_LOCAL_RANK": str(local),
        })
        cmd = [sys.executable, "-u", args.training_script,
               *args.training_script_args]
        log = (open(os.path.join(args.log_dir, f"worker.{rank}.log"), "w")
               if args.log_dir else None)
        procs.append((rank, subprocess.Popen(
            cmd, env=env, stdout=log,
            stderr=subprocess.STDOUT if log else None), log))
    code = 0
    deadline = time.monotonic() + getattr(args, "timeout", _TIMEOUT_S)
    grace = getattr(args, "exit_grace", _EXIT_GRACE_S)
    try:
        pending = list(procs)
        while pending:
            still = []
            for rank, proc, log in pending:
                ret = proc.poll()
                if ret is None:
                    still.append((rank, proc, log))
                elif ret != 0:
                    print(f"[launch] worker {rank} FAILED (exit {ret}); "
                          "terminating the others", file=sys.stderr)
                    code = ret
                    still = []
                    break
                else:
                    deadline = min(deadline, time.monotonic() + grace)
            pending = still
            if pending and time.monotonic() > deadline:
                print(f"[launch] workers {[r for r, _, _ in pending]} still "
                      "running past the launcher's limit; terminating them",
                      file=sys.stderr)
                code = TIMED_OUT
                break
            if pending:
                time.sleep(0.2)
    except KeyboardInterrupt:
        code = 130
    finally:
        _teardown(procs)
        for _, _, log in procs:
            if log:
                log.close()
    return code


def launch(argv=None) -> int:
    return start_local_trainers(_parse_args(argv))


if __name__ == "__main__":
    sys.exit(launch())
