"""ServingEngine: continuous batching over a slot-based KV-cache pool
(port of paddle_tpu/serving/engine.py, fixed and paged pools).

- **Bucketed prefill**: the prompt, right-padded to its bucket, runs
  through ``model.forward_fixed`` against a bucket-sized scratch cache;
  the KV then lands in the slot's pool region — the fixed pool's slot row
  is overwritten over its FULL [0, max_len) range, the paged slot's
  blocks END TO END (prompt KV + zeros to the block boundary), so no
  stale KV of a previous tenant survives.  The first token is sampled
  from the prompt's last-position logits.
- **Decode step**: every slot advances ``decode_chunk`` tokens per step,
  each with its own write position; sampling knobs are per-slot tensors
  (``generation.process_logits_dynamic``) and an all-greedy batch skips
  the sampling pipeline.  Requests join and leave between steps.
- **Paged decode** (``kv="paged"``): per layer the new token's K/V rows
  are written through the block tables — blocks a slot enters at offset
  0 are scrubbed first, inactive slots and unbacked rows go to the
  sentinel and are dropped — then the paged-attention kernel attends on
  the block pool directly (``GPTBlock.forward_paged``).  Nothing is
  gathered on the card; on the CPU the kernel's plain version is the
  reference's gather + masked softmax.

Greedy streams equal a solo ``generation.generate`` run of the same
prompt (the same float ops up to summation order).  The reference's
preempt/restore, speculative decoding, LoRA, prefix cache, mesh and AOT
program sets are not ported yet; without preemption a run whose next
step cannot be backed by the pool fails with ``KVPoolExhaustedError``.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.errors import FatalError, InvalidArgumentError, UnavailableError
from ..generation import gumbel, process_logits_dynamic
from ..ops import _build
from ..ops.paged_attention import RowWrites, write_blocks
from ..utils.monitor import stat_add
from .kv_pool import KVPoolExhaustedError, PagedKVPool
from .request import Request, RequestCancelled, Response
from .scheduler import DeadlineExceededError, RequestScheduler

__all__ = ["ServingEngine", "NonFiniteLogitsError", "KVPoolExhaustedError"]


class NonFiniteLogitsError(FatalError):
    """Decode produced NaN/Inf logits for this request's slot; the request
    is errored individually and its slot recycled."""
    code = "Fatal"


def _default_buckets(max_len: int):
    """Powers of two from 16 up to max_len (prompt lengths round up)."""
    buckets, b = [], 16
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return tuple(buckets)


def _sample(last, gens, temp, top_k, top_p, greedy, all_greedy: bool):
    """One sampling decision per row of (S, V) f32 logits: greedy rows
    argmax their raw logits, the others draw from their own generator
    (``gens[i]``, None for greedy rows) after temperature/top-k/top-p.
    Returns (tokens (S,), logp (S,))."""
    proc = last if all_greedy else process_logits_dynamic(
        last, temp, top_k, top_p, greedy)
    tok = torch.argmax(proc, dim=-1)
    if not all_greedy:
        rows = [i for i, g in enumerate(gens) if g is not None]
        noise = torch.stack([gumbel(proc.shape[-1], gens[i], proc.device)
                             for i in rows])
        tok[rows] = torch.argmax(proc[rows] + noise, dim=-1)
    logp = torch.gather(torch.log_softmax(proc, dim=-1), -1,
                        tok[:, None])[:, 0]
    return tok, logp


def paged_decode_logits(model, pools, tables_np, tables_dev, active, pos,
                        tokens, num_blocks: int, block_size: int,
                        pool_len: int):
    """One paged decode token for every slot: write each active slot's
    new K/V row at ``pos`` through its table (scrubbing entered blocks,
    dropping inactive slots and rows the table does not back), then attend
    on the pools.  ``tables_np`` (S, nb) and ``active`` (S,) are host
    arrays, ``pos`` (S,) host positions; ``tables_dev``/``tokens`` device
    tensors.  Returns (S, V) f32 last-position logits."""
    pos = np.asarray(pos, np.int64)
    bidx = np.clip(pos // block_size, 0, tables_np.shape[1] - 1)
    blk = tables_np[np.arange(len(pos)), bidx]
    ok = active & (pos < pool_len)
    writes = RowWrites(np.where(ok, blk, num_blocks), pos % block_size,
                       num_blocks, tokens.device)
    pos_dev = torch.from_numpy(pos.astype(np.int32)).to(tokens.device)
    logits = model.forward_paged(tokens[:, None], pools, tables_dev, pos_dev,
                                 writes)
    return logits[:, -1].to(torch.float32)


class _SlotRun:
    """Host-side per-slot decode state."""
    __slots__ = ("req", "resp", "pos", "produced", "last_token",
                 "last_token_at", "gen")

    def __init__(self, req: Request, resp: Response, pos: int,
                 first_token: int, gen):
        self.req = req
        self.resp = resp
        self.pos = pos              # kv length so far (write offset)
        self.produced = 1           # first token came from prefill
        self.last_token = first_token
        self.last_token_at = time.monotonic()
        self.gen = gen              # sampling generator (None: greedy)


class ServingEngine:
    """Continuous-batching engine over a model implementing the
    ``gen_fixed_cache`` / ``forward_fixed`` protocol (and, for
    ``kv="paged"``, ``forward_paged``; see models/gpt.py).  Runs on
    ``device`` (default the card; the model must already live there).
    ``dtype`` is the KV pools' and prefill scratch caches' dtype (None:
    the model's ``gen_fixed_cache`` default, f32), as in the reference;
    a bf16 model comes from ``amp.decorate(models=model, level="O2")``."""

    def __init__(self, model, max_slots: int = 8, max_len: int = 256,
                 prefill_buckets=None, max_queue_depth: int = 64,
                 pad_token_id: int = 0, dtype=None, decode_chunk: int = 4,
                 kv: str = "fixed", block_size: int = 16,
                 num_blocks: Optional[int] = None, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise InvalidArgumentError(
                f"engine on {self.device}, but the model lives on "
                f"{model.device}")
        self.model = model
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.pad_token_id = int(pad_token_id)
        self._dtype = dtype
        self.buckets = tuple(sorted(set(
            int(b) for b in (prefill_buckets or _default_buckets(max_len)))))
        if self.buckets[-1] > self.max_len:
            raise InvalidArgumentError(
                f"prefill bucket {self.buckets[-1]} exceeds max_len "
                f"{self.max_len}")
        # tokens decoded per step: amortizes the host's per-step work over
        # chunk tokens per slot; a slot finishing mid-chunk wastes its
        # tail iterations (their tokens are discarded on the host)
        self.decode_chunk = max(1, int(decode_chunk))
        self.scheduler = RequestScheduler(self.max_slots, max_queue_depth)
        if kv not in ("fixed", "paged"):
            raise InvalidArgumentError(
                f"kv must be 'fixed' or 'paged', got {kv!r}")
        self.kv = kv
        self._pool_len = self.max_len
        self.block_size = int(block_size)
        if kv == "paged":
            if self.block_size < 1:
                raise InvalidArgumentError(
                    f"block_size must be >= 1, got {self.block_size}")
            if num_blocks is None:
                # capacity parity with the fixed pool
                num_blocks = self.max_slots * (
                    -(-self._pool_len // self.block_size))
            self.kv_pool = PagedKVPool(int(num_blocks), self.block_size,
                                       self._pool_len)
            self._pools = self.kv_pool.build_pools(model, dtype)
            self._paged_cache = None  # (allocator version, np tables, dev)
            self._oom_failed = 0
        else:
            self.kv_pool = None
            # one gen_fixed_cache(max_slots, max_len) for the engine's life
            self._pools = model.gen_fixed_cache(self.max_slots,
                                                self._pool_len, dtype)
        self._warm = False
        self._slots: Dict[int, _SlotRun] = {}
        self._batch = None
        self._batch_dirty = True
        self._rid = 0
        self._submit_lock = threading.Lock()
        self._m_lock = threading.Lock()
        self._ttfts: List[float] = []
        self._itl_sum = 0.0
        self._itl_n = 0
        self._tokens_out = 0
        self._completed = 0
        self._errored = 0
        self._started_at = time.monotonic()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._work = threading.Event()
        self._closed = False
        self._close_lock = threading.Lock()
        self._dead: Optional[BaseException] = None

    # ------------------------------------------------------------------
    # requests
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               decode_strategy: str = "greedy_search", temperature=1.0,
               top_k=0, top_p=1.0, eos_token_id: Optional[int] = None,
               seed: Optional[int] = None, deadline: Optional[float] = None,
               block: bool = False, timeout: Optional[float] = None,
               priority: int = 0) -> Response:
        """Enqueue one request; returns its streaming Response.  Raises
        InvalidArgumentError for a prompt/budget the engine can never
        serve, QueueFullError at max_queue_depth (backpressure).  A
        sampled request draws from its own generator seeded by ``seed``
        (default: the request id)."""
        if self._closed:
            raise UnavailableError("serving engine is closed")
        if self._dead is not None:
            raise UnavailableError(
                f"serving engine loop died: {self._dead!r}")
        if decode_strategy not in ("greedy_search", "sampling"):
            raise InvalidArgumentError(
                f"serving supports 'greedy_search' or 'sampling', got "
                f"{decode_strategy!r}")
        with self._submit_lock:
            rid = self._rid
            self._rid += 1
        req = Request(rid, prompt, max_new_tokens,
                      greedy=decode_strategy == "greedy_search",
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      eos_token_id=eos_token_id,
                      seed=seed if seed is not None else rid,
                      deadline=deadline, priority=priority)
        plen = req.prompt.shape[0]
        if plen > self.buckets[-1]:
            stat_add("STAT_serving_rejects")
            raise InvalidArgumentError(
                f"prompt length {plen} exceeds the largest prefill bucket "
                f"{self.buckets[-1]} (engine max_len={self.max_len})")
        if plen + req.max_new_tokens > self.max_len:
            stat_add("STAT_serving_rejects")
            raise InvalidArgumentError(
                f"prompt ({plen}) + max_new_tokens ({req.max_new_tokens}) "
                f"exceeds the engine's max_len {self.max_len}")
        if self.kv == "paged":
            # a request that cannot fit the pool even alone is a caller
            # error, not backpressure
            need = self._static_blocks_needed(req)
            if need > self.kv_pool.num_blocks:
                stat_add("STAT_serving_rejects")
                raise InvalidArgumentError(
                    f"request needs {need} KV blocks but the pool holds "
                    f"{self.kv_pool.num_blocks} "
                    f"(block_size={self.block_size}); raise num_blocks or "
                    "shrink the request")
        resp = Response(req)
        self.scheduler.submit(req, resp, block=block, timeout=timeout)
        stat_add("STAT_serving_requests")
        self._work.set()
        return resp

    # ------------------------------------------------------------------
    # the engine loop
    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One engine iteration: sweep deadlines/cancels, admit waiting
        requests into free slots (one bucketed prefill each), then advance
        every occupied slot one decode chunk.  Returns whether any work
        was done."""
        did = False
        self._sweep()
        self.scheduler.sweep_pending()
        gate = self._admission_gate if self.kv == "paged" else None
        with torch.inference_mode():
            while True:
                adm = self.scheduler.next_admission(gate=gate)
                if adm is None:
                    break
                self._admit(*adm)
                did = True
            if self._slots:
                self._decode_step()
                did = True
        return did

    def _static_blocks_needed(self, req: Request) -> int:
        """Blocks the request is guaranteed to need: its prefill bucket or
        the rows the runtime actually backs, whichever is larger."""
        return max(
            self.kv_pool.blocks_for(self._bucket_for(req.prompt.shape[0])),
            self.kv_pool.blocks_for(self._rows_needed(req)))

    def _admission_gate(self, req: Request) -> bool:
        """Block-aware backpressure: a request stays queued until the pool
        can hold its prompt's bucket."""
        bucket = self._bucket_for(req.prompt.shape[0])
        return self.kv_pool.free_blocks() >= self.kv_pool.blocks_for(bucket)

    def _sweep(self):
        for slot in list(self._slots):
            run = self._slots[slot]
            if run.resp.cancelled:
                stat_add("STAT_serving_cancelled")
                run.resp._fail(RequestCancelled(
                    f"request {run.req.id} cancelled mid-decode"))
                self._release(slot)
            elif run.req.deadline is not None and run.req.deadline.expired():
                stat_add("STAT_serving_deadline_expired")
                run.resp._fail(DeadlineExceededError(
                    f"request {run.req.id} deadline "
                    f"({run.req.deadline.seconds}s) expired mid-decode"))
                self._release(slot)

    def _release(self, slot: int):
        self._slots.pop(slot, None)
        self.scheduler.release(slot)
        if self.kv == "paged":
            # blocks return to the free list; their content is scrubbed
            # when they are re-served
            self.kv_pool.free(slot)
        self._batch_dirty = True

    def _bucket_for(self, plen: int) -> int:
        for b in self.buckets:
            if b >= plen:
                return b
        raise InvalidArgumentError(f"no bucket fits prompt length {plen}")

    def _generator(self, req: Request):
        if req.greedy:
            return None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(req.seed))
        return gen

    def _prefill(self, req: Request, slot: int, bucket: int):
        """Run the bucketed prompt and write its KV into the slot's pool
        region; returns the (1, bucket, V) logits."""
        plen = req.prompt.shape[0]
        ids = np.full((1, bucket), self.pad_token_id, np.int64)
        ids[0, :plen] = req.prompt
        scratch = self.model.gen_fixed_cache(1, bucket, self._dtype)
        logits, kv = self.model.forward_fixed(
            torch.from_numpy(ids).to(self.device), scratch, 0)
        if self.kv == "paged":
            bs = self.block_size
            nb_b = -(-bucket // bs)
            table = self.kv_pool.table_array(slot)[:nb_b]
            for (kp, vp), (kc, vc) in zip(self._pools, kv):
                for pool, chunk in ((kp, kc), (vp, vc)):
                    rows = torch.zeros((nb_b * bs,) + tuple(chunk.shape[2:]),
                                       dtype=pool.dtype, device=pool.device)
                    rows[:bucket] = chunk[0]
                    write_blocks(pool, table,
                                 rows.reshape((nb_b, bs) + rows.shape[1:]))
        else:
            for (kp, vp), (kc, vc) in zip(self._pools, kv):
                for pool, chunk in ((kp, kc), (vp, vc)):
                    pool[slot].zero_()
                    pool[slot, :bucket] = chunk[0]
        return logits

    def _admit(self, req: Request, resp: Response, slot: int):
        plen = req.prompt.shape[0]
        bucket = self._bucket_for(plen)
        if self.kv == "paged" and not self.kv_pool.alloc(slot, bucket):
            stat_add("STAT_serving_kv_exhausted")
            with self._m_lock:
                self._errored += 1
            resp._fail(KVPoolExhaustedError(
                f"request {req.id}: KV block pool exhausted at admission "
                f"({self.kv_pool.free_blocks()} free of "
                f"{self.kv_pool.capacity()})"))
            self.scheduler.release(slot)
            return
        logits = self._prefill(req, slot, bucket)
        stat_add("STAT_serving_prefills")
        last = logits[0, plen - 1].to(torch.float32)[None]
        gen = self._generator(req)
        dev = self.device
        tok, logp = _sample(
            last, [gen], torch.tensor([req.temperature], device=dev),
            torch.tensor([req.top_k], device=dev),
            torch.tensor([req.top_p], device=dev),
            torch.tensor([req.greedy], device=dev), req.greedy)
        if not bool(torch.isfinite(last).all()):
            self._fail_slot(slot, resp, "prefill")
            return
        tok = int(tok[0])
        run = _SlotRun(req, resp, pos=plen, first_token=tok, gen=gen)
        self._slots[slot] = run
        self._batch_dirty = True
        self._emit(run, tok, float(logp[0]))
        stat_add("STAT_serving_tokens")
        self._maybe_finish(slot, run, tok)

    # ------------------------------------------------------------------
    # paged KV growth and exhaustion
    # ------------------------------------------------------------------
    def _rows_needed(self, req: Request) -> int:
        """Pool rows that must be backed for every consumed token: the
        final emitted token's logits need rows up to plen + max_new - 1;
        chunk-tail writes past it go to the sentinel and drop."""
        return min(self._pool_len,
                   int(req.prompt.shape[0]) + int(req.max_new_tokens) - 1)

    def _oom_target(self, pos: int, req: Request) -> int:
        """Rows the next step actually requires for this run."""
        return min(pos + self.decode_chunk,
                   max(self._rows_needed(req), pos))

    def _pick_oom_victim(self, needy_slot: int):
        """The newest run in the lowest priority class at or below the
        needy run's priority, excluding the needy slot."""
        needy = self._slots[needy_slot]
        best_slot, best_key = None, None
        for slot, run in self._slots.items():
            if slot == needy_slot or run.req.priority > needy.req.priority:
                continue
            key = (run.req.priority, -run.req.id)
            if best_key is None or key < best_key:
                best_key, best_slot = key, slot
        return best_slot

    def _ensure_decode_blocks(self):
        """Before a paged step: grow every active table to cover the rows
        the step may write.  A shortfall fails the newest lowest-priority
        run (or, when there is none, the needy run) with the typed
        KVPoolExhaustedError and retries — each failure frees blocks."""
        for slot in sorted(self._slots):
            run = self._slots.get(slot)
            if run is None:
                continue
            target = self._oom_target(run.pos, run.req)
            while (slot in self._slots
                   and not self.kv_pool.ensure(slot, target)):
                victim = self._pick_oom_victim(slot)
                self._oom_fail(slot if victim is None else victim)

    def _oom_fail(self, slot: int):
        run = self._slots[slot]
        stat_add("STAT_serving_kv_exhausted")
        self._oom_failed += 1
        with self._m_lock:
            self._errored += 1
        run.resp._fail(KVPoolExhaustedError(
            f"request {run.req.id}: KV block pool exhausted mid-decode "
            f"({self.kv_pool.used_blocks()} used of "
            f"{self.kv_pool.capacity()} blocks)"))
        self._release(slot)

    def _paged_tables(self):
        """(tables np, tables device) for every slot — sentinel rows for
        unoccupied slots — cached against the allocator's version."""
        ver = self.kv_pool.version
        if self._paged_cache is None or self._paged_cache[0] != ver:
            tables = np.tile(self.kv_pool.sentinel_table(),
                             (self.max_slots, 1))
            for slot in self._slots:
                tables[slot] = self.kv_pool.table_array(slot)
            self._paged_cache = (ver, tables,
                                 torch.from_numpy(tables).to(self.device))
        return self._paged_cache[1], self._paged_cache[2]

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _rebuild_batch(self):
        s = self.max_slots
        tokens = np.zeros((s,), np.int64)
        pos = np.zeros((s,), np.int64)
        temp = np.ones((s,), np.float32)
        top_k = np.zeros((s,), np.int64)
        top_p = np.ones((s,), np.float32)
        greedy = np.ones((s,), bool)
        active = np.zeros((s,), bool)
        gens = [None] * s
        for slot, run in self._slots.items():
            tokens[slot] = run.last_token
            pos[slot] = run.pos
            temp[slot] = run.req.temperature
            top_k[slot] = run.req.top_k
            top_p[slot] = run.req.top_p
            greedy[slot] = run.req.greedy
            active[slot] = True
            gens[slot] = run.gen
        dev = self.device
        self._batch = {
            "tokens": torch.from_numpy(tokens).to(dev), "pos": pos,
            "active": active, "gens": gens,
            "all_greedy": bool(greedy.all()),
            "params": tuple(torch.from_numpy(a).to(dev)
                            for a in (temp, top_k, top_p, greedy))}
        self._batch_dirty = False

    def _forward_decode(self, tokens, pos):
        """(S, V) f32 logits of one decode token per slot at host
        positions ``pos``; writes the new KV rows."""
        if self.kv == "paged":
            tables_np, tables_dev = self._paged_tables()
            return paged_decode_logits(
                self.model, self._pools, tables_np, tables_dev,
                self._batch["active"], pos, tokens, self.kv_pool.num_blocks,
                self.block_size, self._pool_len)
        pos_dev = torch.from_numpy(pos).to(self.device)
        logits, self._pools = self.model.forward_fixed(
            tokens[:, None], self._pools, pos_dev)
        return logits[:, -1].to(torch.float32)

    def _decode_step(self):
        if self.kv == "paged":
            # grow block tables for this chunk's writes (may fail runs
            # under pool pressure — membership can change)
            self._ensure_decode_blocks()
            if not self._slots:
                return
        if self._batch_dirty:
            self._rebuild_batch()
        b = self._batch
        temp, top_k, top_p, greedy = b["params"]
        tokens = b["tokens"]
        toks, logps, finites = [], [], []
        for j in range(self.decode_chunk):
            last = self._forward_decode(tokens, b["pos"] + j)
            finites.append(torch.isfinite(last).all(dim=-1))
            tokens, logp = _sample(last, b["gens"], temp, top_k, top_p,
                                   greedy, b["all_greedy"])
            toks.append(tokens)
            logps.append(logp)
        b["tokens"] = tokens
        b["pos"] = b["pos"] + self.decode_chunk
        # one device->host pull for the whole (chunk, slots) burst
        toks, logps, finites = (torch.stack(x).cpu().numpy()
                                for x in (toks, logps, finites))
        stat_add("STAT_serving_decode_steps")
        emitted = 0
        for slot in list(self._slots):
            run = self._slots[slot]
            for j in range(toks.shape[0]):
                # a deadline that expired while the chunk was computing
                # stops the stream here: no post-expiry token is delivered
                if (run.req.deadline is not None
                        and run.req.deadline.expired()):
                    stat_add("STAT_serving_deadline_expired")
                    run.resp._fail(DeadlineExceededError(
                        f"request {run.req.id} deadline "
                        f"({run.req.deadline.seconds}s) expired mid-decode"))
                    self._release(slot)
                    break
                if not finites[j, slot]:
                    self._fail_slot(slot, run.resp, "decode")
                    break
                t = int(toks[j, slot])
                run.pos += 1
                run.produced += 1
                run.last_token = t
                self._emit(run, t, float(logps[j, slot]))
                emitted += 1
                self._maybe_finish(slot, run, t)
                if slot not in self._slots:
                    break  # finished mid-chunk: the tail is discarded
        if emitted:
            stat_add("STAT_serving_tokens", emitted)

    def _fail_slot(self, slot: int, resp: Response, phase: str):
        stat_add("STAT_serving_nonfinite")
        with self._m_lock:
            self._errored += 1
        resp._fail(NonFiniteLogitsError(
            f"request {resp.request.id}: non-finite logits during {phase}; "
            "slot recycled, engine keeps serving"))
        self._release(slot)

    def _emit(self, run: _SlotRun, tok: int, logp: float):
        now = time.monotonic()
        first = run.resp.first_token_at is None
        run.resp._push_token(tok, logp)
        with self._m_lock:
            self._tokens_out += 1
            if first:
                self._ttfts.append(run.resp.ttft)
            else:
                self._itl_sum += now - run.last_token_at
                self._itl_n += 1
        run.last_token_at = now

    def _maybe_finish(self, slot: int, run: _SlotRun, tok: int):
        eos = run.req.eos_token_id
        if eos is not None and tok == eos:
            reason = "eos"
        elif run.produced >= run.req.max_new_tokens:
            reason = "length"
        else:
            return
        with self._m_lock:
            self._completed += 1
        run.resp._finish(reason)
        self._release(slot)

    # ------------------------------------------------------------------
    # driving
    # ------------------------------------------------------------------
    def has_work(self) -> bool:
        return bool(self._slots) or self.scheduler.has_work()

    def run_until_drained(self, timeout: Optional[float] = None):
        """Drive the loop in the caller's thread until queue and slots are
        empty.  Not for use while start() is live."""
        t0 = time.monotonic()
        while self.has_work():
            self.step()
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError("serving engine did not drain in "
                                   f"{timeout}s")

    def _abort_all(self, make_exc):
        """Fail every in-flight and queued request (engine death/close):
        a consumer blocked on a Response must get an error, never hang."""
        for slot in list(self._slots):
            run = self._slots.pop(slot)
            self.scheduler.release(slot)
            if self.kv == "paged":
                self.kv_pool.free(slot)
            run.resp._fail(make_exc(run.req))
        for req, resp in self.scheduler.drain_pending():
            resp._fail(make_exc(req))
        self._batch_dirty = True

    def start(self):
        """Run the engine loop on a background thread."""
        if self._thread is not None:
            return
        if self._closed:
            raise UnavailableError("serving engine is closed")
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    did = self.step()
                except BaseException as e:  # noqa: BLE001 — must not hang
                    # record the cause, fail everything outstanding,
                    # refuse new work
                    self._dead = e
                    self._abort_all(lambda req: UnavailableError(
                        f"request {req.id} aborted: serving engine loop "
                        f"died: {e!r}"))
                    return
                if not did:
                    self._work.wait(0.002)
                    self._work.clear()

        self._thread = threading.Thread(target=loop, name="serving-engine",
                                        daemon=True)
        self._thread.start()

    def close(self):
        """Stop the loop and fail any still-outstanding requests.
        Idempotent and safe under concurrent double-close."""
        self._closed = True
        self._stop.set()
        self._work.set()
        with self._close_lock:
            if self._thread is not None:
                self._thread.join(timeout=5.0)
                self._thread = None
            self._abort_all(lambda req: RequestCancelled(
                f"request {req.id} aborted: serving engine closed"))

    @property
    def warm(self) -> bool:
        return self._warm

    def warmup(self) -> Dict:
        """Build the kernels (on the card) and run one prefill per bucket
        plus one decode token, so no request pays a first-use cost.  Paged
        writes go through sentinel tables and are dropped; the fixed pool
        takes junk in slot rows that the next prefill overwrites.  Safe
        any time no request is in flight."""
        t0 = time.perf_counter()
        report = {}
        if self.device.type == "cuda":
            report["kernel_build"] = _build.build_all()["seconds"]
        probe = Request(-1, [self.pad_token_id], 1)
        with torch.inference_mode():
            for bucket in self.buckets:
                if self.kv == "fixed":
                    self._prefill(probe, 0, bucket)
                else:  # an unallocated slot: its table is all sentinel
                    self._prefill(probe, self.max_slots, bucket)
            tokens = torch.zeros(self.max_slots, dtype=torch.long,
                                 device=self.device)
            pos = np.zeros(self.max_slots, np.int64)
            if self.kv == "paged":
                tables = np.tile(self.kv_pool.sentinel_table(),
                                 (self.max_slots, 1))
                paged_decode_logits(
                    self.model, self._pools, tables,
                    torch.from_numpy(tables).to(self.device),
                    np.zeros(self.max_slots, bool), pos, tokens,
                    self.kv_pool.num_blocks, self.block_size, self._pool_len)
            else:
                self.model.forward_fixed(tokens[:, None], self._pools,
                                         torch.from_numpy(pos).to(
                                             self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warm = True
        report["seconds"] = time.perf_counter() - t0
        return report

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def metrics(self) -> Dict:
        with self._m_lock:
            ttfts = sorted(self._ttfts)
            p50 = ttfts[len(ttfts) // 2] if ttfts else None
            itl = self._itl_sum / self._itl_n if self._itl_n else None
            elapsed = time.monotonic() - self._started_at
            return {
                "requests_completed": self._completed,
                "requests_errored": self._errored,
                "tokens_out": self._tokens_out,
                "tokens_per_sec": (self._tokens_out / elapsed
                                   if elapsed > 0 else 0.0),
                "ttft_p50_ms": None if p50 is None else p50 * 1e3,
                "inter_token_ms": None if itl is None else itl * 1e3,
                "queue_depth": self.scheduler.queue_depth(),
                "slot_occupancy": self.scheduler.occupancy(),
                "max_slots": self.max_slots,
                "warm": self._warm,
                "kv_pool": ({"kind": "fixed", "max_slots": self.max_slots,
                             "pool_len": self._pool_len}
                            if self.kv == "fixed" else
                            {"kind": "paged", **self.kv_pool.stats(),
                             "oom_failed": self._oom_failed}),
            }

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
