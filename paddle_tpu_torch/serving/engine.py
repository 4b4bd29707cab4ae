"""ServingEngine: continuous batching over a slot-based KV-cache pool
(port of paddle_tpu/serving/engine.py, fixed and paged pools).

- **The program family**: like the reference, which compiles one program
  per prefill bucket and one for the decode chunk, the engine runs a
  fixed set of static-shape programs over static input buffers.
  ``warmup()`` makes them all and, on the card, captures each as a CUDA
  graph (all in one memory pool: they never run at once); ``step()``
  fills the buffers on the host when the batch or the allocator's tables
  changed, replays, and pulls the outputs once (``core.programs``, the
  capture mechanism ``jit.TrainStep`` shares).  On the CPU the same
  program functions run directly.  The decode chunk is captured twice,
  all-greedy (no sampling pipeline) and mixed, where the reference
  branches inside one program: ``compile_counts()``'s bound is
  ``len(buckets) + 2``, and ``post_warmup_compiles()`` stays 0 under any
  traffic.
- **Bucketed prefill** (one program per bucket): the prompt, right-padded
  to its bucket, runs through ``model.forward_fixed`` against a
  bucket-sized scratch cache; the KV then lands in the slot's pool region
  — the fixed pool's slot row is overwritten over its FULL [0, max_len)
  range, the paged slot's blocks END TO END (prompt KV + zeros to the
  block boundary), so no stale KV of a previous tenant survives.  The
  first token is sampled from the prompt's last-position logits.
- **Decode chunk**: every slot advances ``decode_chunk`` tokens per
  step, each with its own write position, on the device; the last tokens
  and positions stay in the program's buffers as the next step's inputs.
  Sampling knobs are per-slot tensors
  (``generation.process_logits_dynamic``).
- **Keyed sampling** (``generation.keyed``): a sampled token is drawn
  under the request's key folded in at its position, as the reference
  draws it, so it depends only on the seed, the position and the logits
  — not on the slot, the chunk or the rest of the batch — and equals the
  reference engine's token for the same seed.
- **Paged decode** (``kv="paged"``): per layer the new token's K/V rows
  are written through the block tables (``SlotRowWrites``) — blocks a
  slot enters at offset 0 are scrubbed first, inactive slots and
  unbacked rows drop into trash blocks past the allocator's — then the
  paged-attention kernel attends on the block pool directly
  (``GPTBlock.forward_paged``).  Nothing is gathered on the card; on the
  CPU the kernel's plain version is the reference's gather + masked
  softmax.

- **Preemption** (``preempt_slot`` / ``restore_run``): a run's KV rows
  and sampling state (key, position, produced count, last token) are
  copied to the host (``PreemptedRun``; paged: only the slot's own
  blocks, gathered on the device first) and its slot and blocks freed;
  restoring writes the rows back IN PLACE into the pool the programs
  were captured on (paged: into freshly allocated blocks, tails zeroed,
  which also scrubs them), so the resumed stream equals an uninterrupted
  one token for token.
- **Pool pressure** (paged): a decode step that cannot back its rows
  preempts the newest run of the lowest priority class and parks it
  (``_oom_evict``); parked runs resume first as the pool drains, their
  blocks reserved at admission, and fail with ``KVPoolExhaustedError``
  only when they can never fit again (``_sweep_oom_paused``).
- **Prefix cache** (``prefix_cache=True``, paged): full prompt blocks are
  shared between requests of one share key (``serving/prefix_cache.py``).
  Each bucket's program is then the cached-suffix prefill: it gathers the
  slot's table into the contiguous view, runs only the uncached suffix
  at the device offset ``cached_len`` (0 on a miss: the cold path, one
  program per bucket either way) and writes back only the window from
  there.  A fully cached prompt takes a copy-on-write of its last block
  (``ops.paged_attention.copy_block``, eager, before the program runs).

Greedy streams equal a solo ``generation.generate`` run of the same
prompt (the same float ops up to summation order).  The reference's
speculative decoding, LoRA, mesh and AOT program sets are not ported
yet.
"""
from __future__ import annotations

import functools
import math
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.errors import FatalError, InvalidArgumentError, UnavailableError
from ..core.programs import Program
from ..generation.keyed import (first_token_at, greedy_step, request_key,
                               sample_step)
from ..ops import _build
from ..ops.paged_attention import (RowWrites, SlotRowWrites, copy_block,
                                   gather_block_rows, write_slot_blocks)
from ..utils.monitor import stat_add
from .kv_pool import KVPoolExhaustedError, PagedKVPool
from .prefix_cache import PrefixCache
from .request import Request, RequestCancelled, Response
from .scheduler import DeadlineExceededError, RequestScheduler

__all__ = ["ServingEngine", "PreemptedRun", "NonFiniteLogitsError",
           "KVPoolExhaustedError"]

# host array dtype for each static buffer dtype (``ServingEngine._fill``)
_HOST_DTYPE = {torch.int64: np.int64, torch.int32: np.int32,
               torch.float32: np.float32, torch.bool: np.bool_}


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


def paged_decode_logits(model, pools, tables_np, tables_dev, active, pos,
                        tokens, num_blocks: int, block_size: int,
                        pool_len: int):
    """One paged decode token for every slot, its writes planned on the
    host (``RowWrites``; the engine's programs plan them on the device):
    write each active slot's new K/V row at ``pos`` through its table
    (scrubbing entered blocks, dropping inactive slots and rows the table
    does not back), then attend on the pools.  ``tables_np`` (S, nb) and
    ``active`` (S,) are host arrays, ``pos`` (S,) host positions;
    ``tables_dev``/``tokens`` device tensors.  Returns (S, V) f32
    last-position logits."""
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
                 "last_token_at", "key")

    def __init__(self, req: Request, resp: Response, pos: int,
                 first_token: int, key: np.ndarray):
        self.req = req
        self.resp = resp
        self.pos = pos              # kv length so far (write offset)
        self.produced = 1           # first token came from prefill
        self.last_token = first_token
        self.last_token_at = time.monotonic()
        self.key = key              # sampling key words (uint32 pair)


def _views(flat, shapes):
    """Consecutive views of the flat tensor ``flat``, shaped ``shapes``."""
    out, off = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(flat[off:off + n].view(shape))
        off += n
    return out


def _to_host(parts):
    """``parts`` (tensors of one dtype) on the host in one copy, into page-
    locked memory when they come from a card (a pageable copy is staged
    through the driver's bounce buffer at a fraction of the link's rate):
    views of one flat buffer, shaped like them."""
    flat = torch.cat([p.reshape(-1) for p in parts])
    host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=flat.is_cuda)
    return _views(host.copy_(flat), [p.shape for p in parts])


def _staging(shapes, dtype, device):
    """A zeroed host buffer for tensors of ``shapes`` bound for ``device``
    in one copy (page-locked when that is a card): (flat, views)."""
    host = torch.zeros(sum(math.prod(s) for s in shapes), dtype=dtype,
                       pin_memory=device.type == "cuda")
    return host, _views(host, shapes)


class PreemptedRun:
    """Host snapshot of a preempted run: everything needed to resume its
    stream in any free slot later, equal to an uninterrupted run.
    ``kv_rows`` holds per-layer ``(k_rows, v_rows)`` CPU tensors of shape
    ``(pos, ...)``; the sampling state rides along, so decode step ``pos``
    folds the same key it would have folded uninterrupted."""

    __slots__ = ("req", "resp", "pos", "produced", "last_token", "key",
                 "kv_rows", "preempted_at")

    def __init__(self, run: _SlotRun, kv_rows):
        self.req = run.req
        self.resp = run.resp
        self.pos = run.pos
        self.produced = run.produced
        self.last_token = run.last_token
        self.key = run.key
        self.kv_rows = kv_rows
        self.preempted_at = time.monotonic()

    @classmethod
    def from_state(cls, req, resp, pos: int, produced: int,
                   last_token: int, key, kv_rows):
        """A PreemptedRun from raw snapshot state instead of a live run;
        it restores through the same ``restore_run``."""
        paused = cls.__new__(cls)
        paused.req = req
        paused.resp = resp
        paused.pos = int(pos)
        paused.produced = int(produced)
        paused.last_token = int(last_token)
        paused.key = np.asarray(key)
        paused.kv_rows = kv_rows
        paused.preempted_at = time.monotonic()
        return paused


class _CachedPlan:
    """Host-side warm-admission plan (see ``_cached_plan``)."""

    __slots__ = ("chain", "cow", "cached_len", "bucket", "new_live")

    def __init__(self, chain, cow, cached_len, bucket, new_live):
        self.chain = chain            # cached block ids to adopt
        self.cow = cow                # last chain block needs a private copy
        self.cached_len = cached_len  # the prefill's device offset
        self.bucket = bucket          # SUFFIX bucket (plen - cached_len)
        self.new_live = new_live      # fresh live blocks this admission costs


class ServingEngine:
    """Continuous-batching engine over a model implementing the
    ``gen_fixed_cache`` / ``forward_fixed`` protocol (and, for
    ``kv="paged"``, ``forward_paged``; see models/gpt.py).  Runs on
    ``device`` (default the card; the model must already live there).
    ``dtype`` is the KV pools' and prefill scratch caches' dtype (None:
    the model's ``gen_fixed_cache`` default, f32), as in the reference;
    a bf16 model comes from ``amp.decorate(models=model, level="O2")``.
    ``prefix_cache=True`` (paged only) shares full prompt blocks between
    requests of one share key: the request's tenant, mapped through
    ``set_share_groups``, or ``share_policy(req)`` when given."""

    def __init__(self, model, max_slots: int = 8, max_len: int = 256,
                 prefill_buckets=None, max_queue_depth: int = 64,
                 pad_token_id: int = 0, dtype=None, decode_chunk: int = 4,
                 kv: str = "fixed", block_size: int = 16,
                 num_blocks: Optional[int] = None, prefix_cache: bool = False,
                 share_policy=None, device=DEFAULT_DEVICE):
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
        if prefix_cache and kv != "paged":
            raise InvalidArgumentError(
                f"prefix_cache=True cannot be combined with kv={kv!r}: "
                "prefix reuse shares KV blocks between requests, and only "
                "the paged layout has blocks to share; pass kv='paged'")
        self.prefix_cache = None
        self._share_policy = share_policy
        self._share_groups: Dict[str, str] = {}
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
            # trash blocks past the allocator's, where static-shape writes
            # drop: a row for each decode slot or prefill-window row, a
            # block for each prompt block (the uncached prefill)
            trash = self.kv_pool.blocks_for(max(self.max_slots,
                                                self.buckets[-1]))
            self._pool_store = self.kv_pool.build_pools(model, dtype, trash)
            nb = self.kv_pool.num_blocks
            self._pools = [(k[:nb], v[:nb]) for k, v in self._pool_store]
            self._tables_ver = None   # allocator version in the buffer
            # runs parked on pool pressure, resumed first as it drains
            # (bounded: past it a run fails with KVPoolExhaustedError)
            self._oom_paused: List[PreemptedRun] = []
            self._max_oom_paused = max(2, 2 * self.max_slots)
            self._oom_preempts = 0
            self._oom_resumes = 0
            self._oom_failed = 0
            if prefix_cache:
                self.prefix_cache = PrefixCache(self.kv_pool)
        else:
            self.kv_pool = None
            # one gen_fixed_cache(max_slots, max_len) for the engine's life
            self._pools = model.gen_fixed_cache(self.max_slots,
                                                self._pool_len, dtype)
            self._pool_store = self._pools
        self._warm = False
        self._programs: Dict[object, Program] = {}
        self._compiles = {"decode": 0,
                          "prefill": {b: 0 for b in self.buckets}}
        self._warm_mark: Optional[int] = None
        self._graph_pool = None
        # A/B only (chip_smoke.py and the card tests): on the card, run the
        # same program functions without their CUDA graphs
        self._run_uncaptured = False
        self._slots: Dict[int, _SlotRun] = {}
        self._all_greedy = True
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
    def make_request(self, prompt, max_new_tokens: int,
                     decode_strategy: str = "greedy_search", temperature=1.0,
                     top_k=0, top_p=1.0, eos_token_id: Optional[int] = None,
                     seed: Optional[int] = None,
                     deadline: Optional[float] = None, priority: int = 0,
                     tenant: Optional[str] = None):
        """Validate and build one (Request, Response) pair without queueing
        it (``submit`` queues it; ``try_admit`` places it directly).
        Raises InvalidArgumentError for a prompt/budget the engine can
        never serve.  A sampled request draws under a key made from
        ``seed`` (default: the request id), folded in at each token's
        position: its tokens depend only on the seed, the positions and
        the logits.  ``tenant`` scopes prefix-cache sharing."""
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
                      deadline=deadline, priority=priority, tenant=tenant)
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
        stat_add("STAT_serving_requests")
        return req, Response(req)

    def submit(self, prompt, max_new_tokens: int,
               decode_strategy: str = "greedy_search", temperature=1.0,
               top_k=0, top_p=1.0, eos_token_id: Optional[int] = None,
               seed: Optional[int] = None, deadline: Optional[float] = None,
               block: bool = False, timeout: Optional[float] = None,
               priority: int = 0, tenant: Optional[str] = None) -> Response:
        """Enqueue one request (``make_request``'s checks and keys);
        returns its streaming Response.  Raises QueueFullError at
        max_queue_depth (backpressure)."""
        req, resp = self.make_request(
            prompt, max_new_tokens, decode_strategy=decode_strategy,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_token_id=eos_token_id, seed=seed, deadline=deadline,
            priority=priority, tenant=tenant)
        self.scheduler.submit(req, resp, block=block, timeout=timeout)
        self._work.set()
        return resp

    # ------------------------------------------------------------------
    # the engine loop
    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One engine iteration: sweep deadlines/cancels (queued, active
        and parked runs), resume parked runs, admit waiting requests into
        free slots (one bucketed prefill each), then advance every
        occupied slot one decode chunk.  Returns whether any work was
        done.  An engine not yet warmed up warms up first (on the card:
        captures its programs)."""
        if not self._warm:
            self.warmup()
        did = False
        self._sweep()
        paged = self.kv == "paged"
        dropped = self.scheduler.sweep_pending(
            drop=((self._queued_never_fits, self._queued_exhausted_exc)
                  if paged else None))
        if dropped:
            with self._m_lock:
                self._errored += dropped
        gate = self._admission_gate if paged else None
        with torch.inference_mode():
            if paged:
                did = self._sweep_oom_paused() or did
                # parked runs hold progress and arrived earlier: they get
                # first claim on freed slots and blocks
                did = self._restore_oom_paused() or did
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

    def _queued_never_fits(self, req: Request) -> bool:
        """A queued request whose prefill bucket cannot fit the pool even
        alone under the live capacity (the fault cap) can never admit."""
        return (self.kv_pool.blocks_for(self._bucket_for(req.prompt.shape[0]))
                > self.kv_pool.capacity())

    def _queued_exhausted_exc(self, req: Request) -> BaseException:
        # runs inside the scheduler's lock (sweep_pending's drop): takes no
        # _m_lock (metrics() holds it while reading the scheduler); step()
        # counts the failure from sweep_pending's return value
        stat_add("STAT_serving_kv_exhausted")
        return KVPoolExhaustedError(
            f"request {req.id}: prompt bucket needs "
            f"{self.kv_pool.blocks_for(self._bucket_for(req.prompt.shape[0]))}"
            f" KV blocks but only {self.kv_pool.capacity()} are usable — "
            "the request can never admit")

    def _admission_gate(self, req: Request) -> bool:
        """Block-aware backpressure: a request stays queued until the pool
        can hold its prompt's bucket, beyond the blocks reserved for the
        head parked run (parked runs resume first).  With a prefix cache a
        warm prefix only charges its uncached suffix."""
        reserve = (self.kv_pool.blocks_for(self._oom_paused[0].pos)
                   if self._oom_paused else 0)
        if self.prefix_cache is not None:
            need = self._cached_plan(req).new_live
        else:
            need = self.kv_pool.blocks_for(
                self._bucket_for(req.prompt.shape[0]))
        return self.kv_pool.free_blocks() >= need + reserve

    # ------------------------------------------------------------------
    # prefix cache: share key and admission planning
    # ------------------------------------------------------------------
    def _share_key(self, req: Request) -> str:
        """The cache partition this request may share KV with: its tenant
        ("default" when anonymous) through the share groups, unless an
        engine-level ``share_policy`` decides."""
        if self._share_policy is not None:
            return str(self._share_policy(req))
        tenant = req.tenant if req.tenant is not None else "default"
        return self._share_groups.get(tenant, tenant)

    def set_share_groups(self, groups: Dict[str, str]):
        """Tenant -> share-group mapping: tenants of one group share cached
        prefixes from now on."""
        self._share_groups = dict(groups)

    def _cached_plan(self, req: Request, record: bool = False) -> _CachedPlan:
        """The longest usable cached chain, the prefill's ``cached_len``,
        the SUFFIX bucket and the block cost.  Two invariants: (1)
        ``cached_len + bucket`` never exceeds the gathered view, so the
        model's write offset never clamps onto cached rows (the chain
        trims from its tail until it holds); (2) a prompt cached to its
        last full block recomputes its last token inside that block, which
        is therefore copied to a private block first (copy-on-write)."""
        plen = int(req.prompt.shape[0])
        bs = self.block_size
        view_rows = self.kv_pool.max_blocks_per_slot * bs
        chain = self.prefix_cache.match(self._share_key(req), req.prompt,
                                        record=record)

        def shape(chain):
            cow = bool(chain) and len(chain) * bs == plen
            cached_len = plen - 1 if cow else len(chain) * bs
            return cow, cached_len, self._bucket_for(plen - cached_len)

        cow, cached_len, bucket = shape(chain)
        while chain and cached_len + bucket > view_rows:
            chain = chain[:-1]
            cow, cached_len, bucket = shape(chain)
        total_blocks = min(self.kv_pool.blocks_for(cached_len + bucket),
                           self.kv_pool.max_blocks_per_slot)
        revive = sum(1 for b in chain if self.kv_pool.block_ref(b) == 0)
        new_live = (max(0, total_blocks - len(chain)) + (1 if cow else 0)
                    + revive)
        return _CachedPlan(chain, cow, cached_len, bucket, new_live)

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
            # blocks return to the free list (cached ones stay resident);
            # their content is scrubbed when they are re-served
            self.kv_pool.free(slot)
        self._batch_dirty = True

    def _bucket_for(self, plen: int) -> int:
        for b in self.buckets:
            if b >= plen:
                return b
        raise InvalidArgumentError(f"no bucket fits prompt length {plen}")

    @staticmethod
    def _fill(buffers: Dict[str, torch.Tensor], **host):
        """Copy host values into a program's static input buffers."""
        for name, value in host.items():
            buffers[name].copy_(torch.from_numpy(
                np.asarray(value, dtype=_HOST_DTYPE[buffers[name].dtype])
                .reshape(buffers[name].shape)))

    def _prefill(self, req: Request, slot: int, bucket: int, key,
                 cached_len: int = 0):
        """The bucket's prefill program for ``req`` into ``slot`` (with the
        prefix cache: only the prompt past ``cached_len``): writes the
        prompt's KV into the slot's pool region and samples the first
        token.  Returns (token, logp, finite) on the host."""
        plen = req.prompt.shape[0]
        ids = np.full((1, bucket), self.pad_token_id, np.int64)
        ids[0, :plen - cached_len] = req.prompt[cached_len:]
        target = (self.kv_pool.table_array(slot) if self.kv == "paged"
                  else slot)
        prog = self._programs[bucket]
        extra = ({} if self.prefix_cache is None
                 else {"cached_len": cached_len})
        self._fill(prog.inputs, ids=ids, target=target, prompt_len=plen,
                   key=key, temp=req.temperature, top_k=req.top_k,
                   top_p=req.top_p, greedy=req.greedy, **extra)
        tok, logp, finite = (t.cpu() for t in self._run(prog))
        return int(tok[0]), float(logp[0]), bool(finite[0])

    def _admit_exhausted(self, req: Request, resp: Response, slot: int,
                         stage: str):
        """Blocks ran out between the admission gate and the allocation
        (the fault cap moved): a typed terminal failure, never a hang."""
        stat_add("STAT_serving_kv_exhausted")
        with self._m_lock:
            self._errored += 1
        resp._fail(KVPoolExhaustedError(
            f"request {req.id}: KV block pool exhausted at admission/"
            f"{stage} ({self.kv_pool.free_blocks()} free of "
            f"{self.kv_pool.capacity()} usable)"))
        self.scheduler.release(slot)

    def _admit(self, req: Request, resp: Response, slot: int):
        if self.prefix_cache is not None:
            return self._admit_prefix(req, resp, slot)
        bucket = self._bucket_for(req.prompt.shape[0])
        if self.kv == "paged" and not self.kv_pool.alloc(slot, bucket):
            return self._admit_exhausted(req, resp, slot, "alloc")
        key = request_key(req.seed)
        tok, logp, finite = self._prefill(req, slot, bucket, key)
        self._start_run(req, resp, slot, key, tok, logp, finite)

    def _admit_prefix(self, req: Request, resp: Response, slot: int):
        """Warm admission: adopt the longest cached chain into the slot's
        table, copy its last block when the whole prompt is cached, and
        prefill only the uncached suffix (``cached_len == 0`` is the cold
        path, in the same program)."""
        plen = int(req.prompt.shape[0])
        plan = self._cached_plan(req, record=True)
        if plan.chain and not self.kv_pool.adopt(slot, plan.chain):
            return self._admit_exhausted(req, resp, slot, "adopt")
        if plan.cow:
            pair = self.kv_pool.cow_last(slot)
            if pair is None:
                self.kv_pool.free(slot)
                return self._admit_exhausted(req, resp, slot, "cow")
            # before any program can write the new block
            copy_block(self._pool_store, *pair)
            self.prefix_cache.note_cow()
        if not self.kv_pool.ensure(slot, plan.cached_len + plan.bucket):
            self.kv_pool.free(slot)
            return self._admit_exhausted(req, resp, slot, "suffix")
        key = request_key(req.seed)
        tok, logp, finite = self._prefill(req, slot, plan.bucket, key,
                                          plan.cached_len)
        if finite:
            self.prefix_cache.insert(
                self._share_key(req), req.prompt,
                self.kv_pool.block_ids(slot)[:plen // self.block_size])
        self._start_run(req, resp, slot, key, tok, logp, finite)

    def _start_run(self, req: Request, resp: Response, slot: int, key,
                   tok: int, logp: float, finite: bool):
        """After a prefill: the slot's run, with the first token emitted."""
        stat_add("STAT_serving_prefills")
        if not finite:
            self._fail_slot(slot, resp, "prefill")
            return
        run = _SlotRun(req, resp, pos=int(req.prompt.shape[0]),
                       first_token=tok, key=key)
        self._slots[slot] = run
        self._batch_dirty = True
        self._emit(run, tok, logp)
        stat_add("STAT_serving_tokens")
        self._maybe_finish(slot, run, tok)

    # ------------------------------------------------------------------
    # direct placement, preemption, restore
    # ------------------------------------------------------------------
    def try_admit(self, req: Request, resp: Response) -> bool:
        """Place a request (from ``make_request``) into a free slot now,
        bypassing the FIFO queue.  Returns False when every slot is
        occupied or, paged, when the pool cannot hold the prompt yet.
        Call it from the thread that drives step()."""
        if not self._warm:
            self.warmup()
        if self.kv == "paged" and not self._admission_gate(req):
            return False
        slot = self.scheduler.acquire(req, resp)
        if slot is None:
            return False
        with torch.inference_mode():
            self._admit(req, resp, slot)
        return True

    def preempt_slot(self, slot: int) -> PreemptedRun:
        """Evict the run in ``slot``: its KV rows [0, pos) and sampling
        state go to the host, and its slot (and blocks) are freed.  The
        response stays open; ``restore_run`` continues it.  Paged: only
        the slot's own blocks are gathered on the device; every layer's
        rows then cross in one device-to-host copy.  Call it between
        steps from the driving thread."""
        run = self._slots.get(slot)
        if run is None:
            raise InvalidArgumentError(f"slot {slot} holds no active run")
        pools = [t for pair in self._pool_store for t in pair]
        with torch.no_grad():
            if self.kv == "paged":
                idx = torch.tensor(self.kv_pool.block_ids(slot),
                                   dtype=torch.long).to(self.device)
                parts = [t.index_select(0, idx).reshape(
                    (-1,) + tuple(t.shape[2:]))[:run.pos] for t in pools]
            else:
                parts = [t[slot, :run.pos] for t in pools]
            rows = _to_host(parts)
        paused = PreemptedRun(run, list(zip(rows[0::2], rows[1::2])))
        run.req.preempts += 1
        self._slots.pop(slot, None)
        self.scheduler.release(slot)
        if self.kv == "paged":
            self.kv_pool.free(slot)
        self._batch_dirty = True
        stat_add("STAT_serving_preemptions")
        return paused

    def restore_run(self, paused: PreemptedRun) -> bool:
        """Resume a preempted run in any free slot: its rows cross in one
        host-to-device copy and are written in place into the pool the
        programs read (paged: into fresh blocks, tails zeroed; with the
        prefix cache, past the prefix it re-pins), and decode continues
        from the saved position with the saved key.  Returns False when no
        slot is free or, paged, when the pool cannot hold the rows yet
        (the caller retries)."""
        slot = self.scheduler.acquire(paused.req, paused.resp)
        if slot is None:
            return False
        with torch.no_grad():
            if self.kv == "paged":
                if self.prefix_cache is not None:
                    start = self._restore_paged_prefix(slot, paused)
                elif self.kv_pool.alloc(slot, paused.pos):
                    start = 0
                else:
                    start = None
                if start is None:
                    self.scheduler.release(slot)
                    return False
                self._paged_upload(slot, paused.kv_rows, paused.pos, start)
            else:
                pools = [t for pair in self._pool_store for t in pair]
                rows = [r for pair in paused.kv_rows for r in pair]
                shapes = [r.shape for r in rows]
                host, bufs = _staging(shapes, pools[0].dtype, self.device)
                for buf, r in zip(bufs, rows):
                    buf.copy_(r)
                dev = _views(host.to(self.device), shapes)
                for t, r in zip(pools, dev):
                    t[slot, :paused.pos].copy_(r)
        return self._finish_restore(slot, paused)

    def _restore_paged_prefix(self, slot: int, paused: PreemptedRun):
        """Re-pin a restored run's cached prefix instead of uploading it:
        re-match the prompt, adopt the resident chain (less its last block
        when it covers the whole prompt: that block's private copy was
        freed with the slot) and allocate the rest.  Returns the first row
        to upload, or None (holding nothing) when the pool is short."""
        req = paused.req
        chain = self.prefix_cache.match(self._share_key(req), req.prompt)
        if chain and len(chain) * self.block_size >= req.prompt.shape[0]:
            chain = chain[:-1]
        if chain and not self.kv_pool.adopt(slot, chain):
            return None
        if not self.kv_pool.ensure(slot, paused.pos):
            self.kv_pool.free(slot)
            return None
        return len(chain) * self.block_size

    def _paged_upload(self, slot: int, rows, pos: int, start_row: int = 0):
        """Write snapshot rows [start_row, pos) into the slot's blocks past
        ``start_row`` (block-aligned), in place, block tails zero-filled:
        the upload is also the scrub.  Adopted shared blocks before
        ``start_row`` are never written."""
        bs = self.block_size
        ids = self.kv_pool.block_ids(slot)[start_row // bs:]
        if not ids:
            return
        pools = [t for pair in self._pool_store for t in pair]
        shapes = [(len(ids), bs) + tuple(t.shape[2:]) for t in pools]
        host, bufs = _staging(shapes, pools[0].dtype, self.device)
        for buf, r in zip(bufs, (r for pair in rows for r in pair)):
            buf.view((-1,) + tuple(buf.shape[2:]))[:pos - start_row] = \
                r[start_row:pos]
        idx = torch.tensor(ids, dtype=torch.long).to(self.device)
        for pool, buf in zip(pools, _views(host.to(self.device), shapes)):
            pool.index_copy_(0, idx, buf)

    def _finish_restore(self, slot: int, paused: PreemptedRun) -> bool:
        run = _SlotRun(paused.req, paused.resp, pos=paused.pos,
                       first_token=paused.last_token, key=paused.key)
        run.produced = paused.produced
        paused.req.resumes += 1
        paused.req.paused_seconds += time.monotonic() - paused.preempted_at
        self._slots[slot] = run
        self._batch_dirty = True
        stat_add("STAT_serving_resumes")
        return True

    # ------------------------------------------------------------------
    # paged KV growth and pressure: ensure or preempt, park, resume
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
        the step may write.  A shortfall preempts the newest run of the
        lowest priority class (or, when there is none, the needy run) and
        parks it; each preemption frees blocks."""
        for slot in sorted(self._slots):
            run = self._slots.get(slot)
            if run is None:
                continue
            target = self._oom_target(run.pos, run.req)
            guard = 0
            while (slot in self._slots
                   and not self.kv_pool.ensure(slot, target)):
                victim = self._pick_oom_victim(slot)
                if victim is None:
                    self._oom_evict(slot)
                    break
                self._oom_evict(victim)
                guard += 1
                if guard > self.max_slots + 2:
                    break

    def _oom_evict(self, slot: int):
        """Park the run (preempt it) — or fail it typed when parking would
        never end: its next step cannot fit the pool even alone, or the
        parking budget is full."""
        run = self._slots.get(slot)
        if run is None:
            return
        if (len(self._oom_paused) >= self._max_oom_paused
                or not self.kv_pool.can_ever_fit(
                    self._oom_target(run.pos, run.req))):
            self._oom_fail(slot, run)
            return
        self._oom_paused.append(self.preempt_slot(slot))
        self._oom_preempts += 1
        stat_add("STAT_serving_kv_oom_preempts")

    def _oom_fail(self, slot: int, run: _SlotRun):
        stat_add("STAT_serving_kv_exhausted")
        self._oom_failed += 1
        with self._m_lock:
            self._errored += 1
        run.resp._fail(KVPoolExhaustedError(
            f"request {run.req.id}: KV block pool exhausted mid-decode "
            f"({self.kv_pool.used_blocks()} used of "
            f"{self.kv_pool.capacity()} usable blocks) and the run can no "
            "longer be parked or resumed"))
        self._release(slot)

    def _sweep_oom_paused(self) -> bool:
        """Parked runs honour cancel and deadline, and one that can no
        longer ever fit (the fault cap shrank the pool) fails typed."""
        keep, changed = [], False
        for p in self._oom_paused:
            if p.resp.cancelled:
                stat_add("STAT_serving_cancelled")
                p.resp._fail(RequestCancelled(
                    f"request {p.req.id} cancelled while parked on KV "
                    "pool pressure"))
            elif p.req.deadline is not None and p.req.deadline.expired():
                stat_add("STAT_serving_deadline_expired")
                p.resp._fail(DeadlineExceededError(
                    f"request {p.req.id} deadline "
                    f"({p.req.deadline.seconds}s) expired while parked "
                    "on KV pool pressure"))
            elif not self.kv_pool.can_ever_fit(
                    self._oom_target(p.pos, p.req)):
                stat_add("STAT_serving_kv_exhausted")
                self._oom_failed += 1
                with self._m_lock:
                    self._errored += 1
                p.resp._fail(KVPoolExhaustedError(
                    f"request {p.req.id}: parked on KV pool pressure and "
                    f"the pool ({self.kv_pool.capacity()} usable blocks) "
                    "can no longer hold it"))
            else:
                keep.append(p)
                continue
            changed = True
        self._oom_paused = keep
        return changed

    def _restore_oom_paused(self) -> bool:
        did = False
        while self._oom_paused and self.scheduler.free_slot_count() > 0:
            if not self.restore_run(self._oom_paused[0]):
                break
            self._oom_paused.pop(0)
            self._oom_resumes += 1
            stat_add("STAT_serving_kv_oom_resumes")
            did = True
        return did

    def _host_tables(self) -> np.ndarray:
        """(S, nb) int32 block tables of every slot — sentinel rows for
        unoccupied slots."""
        tables = np.tile(self.kv_pool.sentinel_table(), (self.max_slots, 1))
        for slot in self._slots:
            tables[slot] = self.kv_pool.table_array(slot)
        return tables

    def _sync_tables(self, force: bool):
        """Copy the block tables into the decode programs' buffer when the
        allocator's version (or the batch) changed since the last copy."""
        ver = self.kv_pool.version
        if force or self._tables_ver != ver:
            self._fill(self._programs["decode"].inputs,
                       tables=self._host_tables())
            self._tables_ver = ver

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _rebuild_batch(self):
        """Copy every slot's state into the decode programs' buffers
        (after a join or a leave; otherwise the last step's tokens and
        positions stay on the device as this step's inputs)."""
        s = self.max_slots
        host = {"tokens": np.zeros((s,), np.int64),
                "pos": np.zeros((s,), np.int32),
                "keys": np.zeros((s, 2), np.int64),
                "temp": np.ones((s,), np.float32),
                "top_k": np.zeros((s,), np.int64),
                "top_p": np.ones((s,), np.float32),
                "greedy": np.ones((s,), bool)}
        active = np.zeros((s,), bool)
        for slot, run in self._slots.items():
            host["tokens"][slot] = run.last_token
            host["pos"][slot] = run.pos
            host["keys"][slot] = run.key
            host["temp"][slot] = run.req.temperature
            host["top_k"][slot] = run.req.top_k
            host["top_p"][slot] = run.req.top_p
            host["greedy"][slot] = run.req.greedy
            active[slot] = True
        if self.kv == "paged":
            host["active"] = active
        self._fill(self._programs["decode"].inputs, **host)
        self._all_greedy = bool(host["greedy"].all())
        self._batch_dirty = False

    # ------------------------------------------------------------------
    # the programs (static shapes, no host reads: captured on the card)
    # ------------------------------------------------------------------
    def _decode_logits(self, tokens, pos, tables, active):
        """(S, V) f32 logits of one decode token per slot at device
        positions ``pos``; writes the new KV rows."""
        if self.kv == "paged":
            writes = SlotRowWrites(tables, pos, active,
                                   self.kv_pool.num_blocks, self.block_size,
                                   self._pool_len)
            logits = self.model.forward_paged(tokens[:, None],
                                              self._pool_store, tables, pos,
                                              writes)
        else:
            logits, _ = self.model.forward_fixed(tokens[:, None],
                                                 self._pool_store, pos)
        return logits[:, -1].to(torch.float32)

    def _decode_program(self, tokens, pos, keys, temp, top_k, top_p, greedy,
                        tables=None, active=None, *, sample: bool = True):
        """The decode chunk (reference ``:1279-1316``): ``decode_chunk``
        tokens for every slot, each sampled (``sample``; else the
        all-greedy step) and fed back.  Returns (toks, logps, finites),
        each (chunk, S), and the buffers ``tokens`` / ``pos``, updated in
        place to the last token and the next position."""
        tok, p = tokens, pos
        toks, logps, finites = [], [], []
        for _ in range(self.decode_chunk):
            last = self._decode_logits(tok, p, tables, active)
            finites.append(torch.isfinite(last).all(dim=-1))
            if sample:
                tok, logp = sample_step(last, keys, p, temp, top_k, top_p,
                                        greedy)
            else:
                tok, logp = greedy_step(last)
            toks.append(tok)
            logps.append(logp)
            p = p + 1
        tokens.copy_(tok)
        pos.copy_(p)
        return (torch.stack(toks), torch.stack(logps), torch.stack(finites),
                tokens, pos)

    def _write_prompt(self, pool, rows, target, bucket: int):
        """A prefill's (bucket, ...) KV ``rows`` into the slot's region of
        ``pool``: the slot row over its full length (fixed; ``target``
        the (1,) slot), or the bucket's blocks end to end (paged;
        ``target`` the slot's table)."""
        if self.kv == "paged":
            bs = self.block_size
            nb_b = -(-bucket // bs)
            blocks = torch.zeros((nb_b * bs,) + tuple(rows.shape[1:]),
                                 dtype=pool.dtype, device=pool.device)
            blocks[:bucket] = rows
            write_slot_blocks(pool, target[:nb_b],
                              blocks.reshape((nb_b, bs) + blocks.shape[1:]),
                              self.kv_pool.num_blocks)
        else:
            row = torch.zeros((1,) + tuple(pool.shape[1:]), dtype=pool.dtype,
                              device=pool.device)
            row[0, :bucket] = rows
            pool.index_copy_(0, target, row)

    def _prefill_program(self, bucket: int, ids, prompt_len, target, key,
                         temp, top_k, top_p, greedy):
        """One bucket's prefill (reference ``:1137-1146``): the padded
        prompt through a bucket-sized scratch cache, its KV into the
        slot's region, the first token sampled at ``prompt_len - 1``.
        Returns (token, logp, finite), each (1,)."""
        scratch = self.model.gen_fixed_cache(1, bucket, self._dtype)
        logits, kv = self.model.forward_fixed(ids, scratch, 0)
        for (kp, vp), (kc, vc) in zip(self._pool_store, kv):
            self._write_prompt(kp, kc[0], target, bucket)
            self._write_prompt(vp, vc[0], target, bucket)
        last = prompt_len - 1
        return first_token_at(logits, last, last, key, temp, top_k, top_p,
                              greedy)

    def _prefill_cached_program(self, bucket: int, ids, prompt_len,
                                cached_len, target, key, temp, top_k, top_p,
                                greedy):
        """One bucket's prefill with the prefix cache (reference
        ``_build_prefill_cached``, ``:1167-1217``): the slot's table
        gathered into its contiguous view (the adopted cached blocks give
        rows [0, cached_len)), the prompt's uncached suffix through the
        model at the device offset ``cached_len``, and only the window of
        ``bucket`` rows from there written back through the table
        (entered blocks scrubbed first; the window never clamps: see
        ``_cached_plan``).  It starts at a block boundary unless the
        slot's last block is its private copy-on-write copy, so a shared
        block is never written.  The first token is sampled at
        ``prompt_len - 1 - cached_len``.  ``cached_len == 0`` is the cold
        path.  Returns (token, logp, finite), each (1,)."""
        ctx = [(gather_block_rows(kp, target)[None],
                gather_block_rows(vp, target)[None])
               for kp, vp in self._pool_store]
        logits, kv = self.model.forward_fixed(ids, ctx, cached_len)
        start = cached_len.clamp(max=ctx[0][0].shape[1] - bucket).clamp(min=0)
        writes = SlotRowWrites(
            target[None], start,
            torch.ones((1,), dtype=torch.bool, device=target.device),
            self.kv_pool.num_blocks, self.block_size, self._pool_len,
            n_rows=bucket)
        rows = start + torch.arange(bucket, device=start.device)
        for (kp, vp), (kc, vc) in zip(self._pool_store, kv):
            writes.apply(kp, kc[0].index_select(0, rows))
            writes.apply(vp, vc[0].index_select(0, rows))
        return first_token_at(logits, prompt_len - 1 - cached_len,
                              prompt_len - 1, key, temp, top_k, top_p,
                              greedy)

    def _make_programs(self) -> Dict[object, Program]:
        """Every program with its static input buffers: one prefill per
        bucket (keyed by the bucket; with the prefix cache the
        cached-suffix prefill) and the decode chunk, mixed ("decode") and
        all-greedy ("decode_greedy"), sharing one set of buffers.  The
        buffers start as a warm-up input: sentinel tables and inactive
        slots (paged writes drop), slot 0 (fixed)."""
        dev, s = self.device, self.max_slots

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        dec = {"tokens": full((s,), 0, torch.int64),
               "pos": full((s,), 0, torch.int32),
               "keys": full((s, 2), 0, torch.int64),
               "temp": full((s,), 1.0, torch.float32),
               "top_k": full((s,), 0, torch.int64),
               "top_p": full((s,), 1.0, torch.float32),
               "greedy": full((s,), True, torch.bool)}
        pre = {"prompt_len": full((1,), 1, torch.int64),
               "key": full((1, 2), 0, torch.int64),
               "temp": full((1,), 1.0, torch.float32),
               "top_k": full((1,), 0, torch.int64),
               "top_p": full((1,), 1.0, torch.float32),
               "greedy": full((1,), True, torch.bool)}
        if self.kv == "paged":
            nb = self.kv_pool.max_blocks_per_slot
            sentinel = self.kv_pool.num_blocks
            dec["tables"] = full((s, nb), sentinel, torch.int32)
            dec["active"] = full((s,), False, torch.bool)
            pre["target"] = full((nb,), sentinel, torch.int32)
        else:
            pre["target"] = full((1,), 0, torch.int64)
        programs = {
            "decode": Program(self._decode_program, dec),
            "decode_greedy": Program(
                functools.partial(self._decode_program, sample=False), dec)}
        prefill = self._prefill_program
        if self.prefix_cache is not None:
            prefill = self._prefill_cached_program
            pre["cached_len"] = full((1,), 0, torch.int64)
        for b in self.buckets:
            programs[b] = Program(
                functools.partial(prefill, b),
                dict(pre, ids=full((1, b), self.pad_token_id, torch.int64)))
        return programs

    def _run(self, prog: Program):
        return prog.run(captured=not self._run_uncaptured)

    def _decode_step(self):
        if self.kv == "paged":
            # grow block tables for this chunk's writes (may fail runs
            # under pool pressure — membership can change)
            self._ensure_decode_blocks()
            if not self._slots:
                return
        rebuilt = self._batch_dirty
        if rebuilt:
            self._rebuild_batch()
        if self.kv == "paged":
            self._sync_tables(rebuilt)
        prog = self._programs["decode_greedy" if self._all_greedy
                              else "decode"]
        # one device->host pull for the whole (chunk, slots) burst
        toks, logps, finites = (t.cpu().numpy() for t in self._run(prog)[:3])
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
        return (bool(self._slots) or self.scheduler.has_work()
                or bool(self.kv == "paged" and self._oom_paused))

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
        if self.kv == "paged":
            paused, self._oom_paused = self._oom_paused, []
            for p in paused:
                p.resp._fail(make_exc(p.req))
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
        """Make every program the engine will ever run — one prefill per
        bucket and the decode chunk, all-greedy and mixed — and, on the
        card, build the kernels and capture each program as a CUDA graph,
        all in one memory pool (``step()`` then only replays them).  Each
        capture runs its program once first: paged writes drop into the
        trash blocks, the fixed pool takes junk in slot rows that the
        next prefill overwrites.  A capture that fails raises, and the
        engine stays cold.  After it returns, ``post_warmup_compiles()``
        stays 0 under any traffic.  Safe any time no request is in
        flight; a second call captures nothing new."""
        t0 = time.perf_counter()
        report = {}
        cuda = self.device.type == "cuda"
        if cuda:
            report["kernel_build"] = _build.build_all()["seconds"]
        with torch.inference_mode():
            if not self._programs:
                self._programs = self._make_programs()
            for name, prog in self._programs.items():
                if prog.ready:
                    continue
                if cuda:
                    if self._graph_pool is None:
                        self._graph_pool = torch.cuda.graph_pool_handle()
                    prog.capture(self._graph_pool)
                prog.ready = True
                if isinstance(name, int):
                    self._compiles["prefill"][name] += 1
                else:
                    self._compiles["decode"] += 1
                stat_add("STAT_serving_compiles")
        if cuda:
            torch.cuda.synchronize(self.device)
        # the warm-up runs moved the decode buffers: refill before a step
        self._batch_dirty = True
        self._warm = True
        self._warm_mark = self.compile_counts()["total"]
        report["seconds"] = time.perf_counter() - t0
        report["captured"] = cuda
        report["compile_counts"] = self.compile_counts()
        return report

    def compile_counts(self) -> Dict:
        """Programs made, under the reference's keys: on the card each
        count is one CUDA graph capture, on the CPU one program built.
        The bound is ``len(buckets) + 2``: the decode chunk is captured
        twice, all-greedy and mixed, where the reference branches inside
        one program."""
        total = (self._compiles["decode"]
                 + sum(self._compiles["prefill"].values()))
        return {"decode": self._compiles["decode"],
                "prefill": dict(self._compiles["prefill"]),
                "total": total, "bound": len(self.buckets) + 2}

    def post_warmup_compiles(self) -> int:
        """Programs made since warmup() finished: 0 under any traffic;
        -1 if warmup never ran."""
        if self._warm_mark is None:
            return -1
        return self.compile_counts()["total"] - self._warm_mark

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
                "kv_pool": self._kv_pool_metrics(),
            }

    def _kv_pool_metrics(self) -> Dict:
        """The pool's blocks (used, free, cached), the pressure counters
        (preemptions, resumes, OOM failures, runs parked now) and the
        prefix cache's (hits, misses, hit rate, evictions, copy-on-write
        copies)."""
        if self.kv != "paged":
            return {"kind": "fixed", "max_slots": self.max_slots,
                    "pool_len": self._pool_len}
        out = {"kind": "paged", **self.kv_pool.stats(),
               "oom_preempts": self._oom_preempts,
               "oom_resumes": self._oom_resumes,
               "oom_failed": self._oom_failed,
               "oom_paused": len(self._oom_paused)}
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        return out

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
