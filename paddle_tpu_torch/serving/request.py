"""Request / streaming-Response handles for the serving engine (port of
paddle_tpu/serving/request.py).

A `Request` is the immutable description of one decode job (prompt, token
budget, sampling params, deadline); a `Response` is the caller's handle on
its progress — a thread-safe iterator of generated token ids fed by the
engine loop, with TTFT recorded at the first yield and a typed error if the
request is rejected, cancelled, expired, or its logits go non-finite.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np

from ..core.errors import EnforceNotMet
from ..utils.retry import Deadline

__all__ = ["Request", "Response", "RequestCancelled"]


class RequestCancelled(EnforceNotMet):
    """The caller cancelled the request before it completed."""
    code = "Cancelled"


class Request:
    """One decode job.  `greedy` requests ignore the sampling knobs and are
    the ones whose stream equals a solo
    `generation.generate(decode_strategy='greedy_search')` run.  `spec`:
    whether the request speculates on a speculative engine (the engine
    resolves None before it builds the request).  `priority` / `tenant`:
    the gateway's lane and fairness attribution (the bare engine uses
    them only under KV-pool pressure and for prefix-cache sharing).
    `session` / `resubmit` / `migrations`: the fleet's affinity key, its
    greedy-only re-prefill opt-in and its count of completed run
    transfers, carried by the run-transfer codec.  `adapter`: the LoRA
    adapter's registry name (None: the base model).  The parameters are
    the reference's, in its order."""

    __slots__ = ("id", "prompt", "max_new_tokens", "greedy", "temperature",
                 "top_k", "top_p", "eos_token_id", "seed", "deadline",
                 "poison", "priority", "tenant", "preempts", "resumes",
                 "paused_seconds", "spec", "session", "resubmit",
                 "migrations", "adapter")

    def __init__(self, rid: int, prompt, max_new_tokens: int,
                 greedy: bool = True, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None,
                 seed: Optional[int] = None,
                 deadline: Optional[float] = None,
                 priority: int = 0, tenant: Optional[str] = None,
                 spec: bool = False, session: Optional[str] = None,
                 resubmit: bool = False, adapter: Optional[str] = None):
        self.id = int(rid)
        self.prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens <= 0:
            raise ValueError("max_new_tokens must be positive")
        self.greedy = bool(greedy)
        # None and 1.0 both mean "no tempering" (generation.generate
        # contract); 0.0 must NOT fold into them
        self.temperature = float(1.0 if temperature is None else temperature)
        self.top_k = int(top_k or 0)
        self.top_p = float(1.0 if top_p is None else top_p)
        self.eos_token_id = None if eos_token_id is None else int(eos_token_id)
        self.seed = seed
        # budget counts from SUBMISSION (queue wait included)
        self.deadline = Deadline(deadline) if deadline is not None else None
        self.poison = False  # set by the engine under PDTPU_FAULT_NAN_LOGITS
        # speculative decoding on/off (per request; a spec-off slot of a
        # speculative engine streams as the plain engine)
        self.spec = bool(spec)
        # gateway lane (0 = best effort; a gateway preempts lower
        # priorities for higher ones; under KV-pool pressure the newest
        # run of the lowest class is parked) and the tenant, which is
        # also the prefix cache's share key (tenant-private by default)
        self.priority = int(priority)
        self.tenant = tenant
        # stamped by engine.preempt_slot / restore_run
        self.preempts = 0
        self.resumes = 0
        self.paused_seconds = 0.0  # total wall time spent preempted
        # fleet routing: the session's affinity key, the greedy-only
        # re-prefill opt-in (checked by make_request) and the completed
        # cross-replica run transfers
        self.session = session
        self.resubmit = bool(resubmit)
        self.migrations = 0
        # batched LoRA: resolved to a slot and pinned at admission, unpinned
        # at release; the name (not the slot) travels across preempt and
        # restore, which resolves it again
        self.adapter = adapter


_TOK, _END, _ERR = 0, 1, 2


class Response:
    """Streaming handle: iterate to receive generated token ids as the
    engine produces them.  Terminal state is exactly one of: finished
    (`finish_reason` in {"eos", "length"}), or errored (`error` set —
    rejection, cancellation, deadline expiry, non-finite logits).
    """

    def __init__(self, request: Request):
        self.request = request
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._tokens: List[int] = []
        self._done = threading.Event()
        self.submitted_at = time.monotonic()
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.finish_reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.logprob = 0.0
        self._cancel_requested = False

    # -- engine side --------------------------------------------------------
    def _push_token(self, tok: int, logp: float = 0.0):
        now = time.monotonic()
        with self._lock:
            if self.first_token_at is None:
                self.first_token_at = now
            self._tokens.append(int(tok))
            self.logprob += float(logp)
        self._q.put((_TOK, int(tok)))

    def _finish(self, reason: str):
        with self._lock:
            if self._done.is_set():
                return
            self.finished_at = time.monotonic()
            self.finish_reason = reason
            self._done.set()
        self._q.put((_END, reason))

    def _fail(self, exc: BaseException):
        with self._lock:
            if self._done.is_set():
                return
            self.finished_at = time.monotonic()
            self.finish_reason = "error"
            self.error = exc
            self._done.set()
        self._q.put((_ERR, exc))

    # -- caller side --------------------------------------------------------
    def cancel(self):
        """Ask the engine to drop this request: immediately effective for
        queued requests (never prefilled); an active request's slot is
        recycled at the next step boundary."""
        self._cancel_requested = True

    @property
    def cancelled(self) -> bool:
        return self._cancel_requested

    def done(self) -> bool:
        return self._done.is_set()

    @property
    def ttft(self) -> Optional[float]:
        """Seconds from submission to the first streamed token."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    def __iter__(self):
        while True:
            kind, val = self._q.get()
            if kind == _TOK:
                yield val
            elif kind == _END:
                return
            else:
                raise val

    def tokens(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the request reaches a terminal state, then return
        the full generated token list (raises the request's error if it
        failed)."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request.id} not finished after {timeout}s")
        if self.error is not None:
            raise self.error
        with self._lock:
            return list(self._tokens)

    def tokens_so_far(self) -> List[int]:
        with self._lock:
            return list(self._tokens)

    def result(self, timeout: Optional[float] = None):
        """(tokens, info) after completion; raises on failure."""
        toks = self.tokens(timeout)
        return toks, {"finish_reason": self.finish_reason,
                      "logprob": self.logprob, "ttft": self.ttft,
                      "latency": (self.finished_at - self.submitted_at
                                  if self.finished_at else None)}
