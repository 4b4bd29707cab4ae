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

- **Speculative decoding** (``draft_model=``, ``spec_tokens=K``): the
  decode chunk's two programs become the verify tick's (reference
  ``_build_verify`` / ``_build_verify_paged``): K+1 sequential draft
  steps on the draft's own pool (paged: the same block tables, one
  allocator) — step K feeds d_K at pos+K so that an all-accept tick
  leaves the draft KV dense — then one target forward over ``[last,
  d_1..d_K]``, K+1 rows per slot, and the commit of
  ``generation.speculative`` (greedy equality accept, or the keyed
  rejection sampling), 1..K+1 tokens per slot per tick.  On the paged
  pool the verify writes its K+1 rows per slot (``SlotRowWrites``,
  ``n_rows=K+1``) and attends through the paged kernel with the S*(K+1)
  query rows flattened, each through its slot's table up to its own
  position: each slot's KV is read K+1 times.  Each bucket's prefill
  program prefills target and draft.  The pools hold K rows of headroom
  past ``max_len`` (a tick writes pos..pos+K).  Per request ``spec=``
  (default: on when a draft exists); a spec-off slot streams as the
  plain engine.  ``compile_counts()``'s bound stays ``len(buckets) +
  2``.
- **Weight swap** (``swap_weights``): a state dict of the same keys and
  shapes is cast to the served dtypes and copied in place into the
  parameters and buffers the captured graphs read; nothing is captured
  again.  Those are the engine's own copy of the model (reference: the
  engine's own ``_state``), so a swap changes no other engine built on
  the same model and not the model itself.
- **Batched LoRA** (``lora=LoRAConfig(...)``, fixed and paged): forward
  hooks on the target linears (``lora.attach_serving_lora``, attached
  before the programs are made) add each slot's adapter delta; the
  registry's factor stacks are allocated once on the engine's device and
  written in place by ``load_adapter``, and the adapter ids are one more
  program input buffer (decode: ``aids`` (S,), idle slots 0 = the base;
  prefill: ``aid`` (1,)), so heterogeneous adapters decode in one step at
  the unchanged capture bound and a hot load captures nothing.  A request
  pins its adapter from admission to release (and again by name at a
  restore).  Not with ``draft_model=`` or ``prefix_cache=True``, as in the
  reference.
- **Fault hooks**: ``nan_logits`` (read at construction: when armed the
  decode programs take a per-slot ``poison`` buffer and the request of
  that submission number fails with ``NonFiniteLogitsError``; disarmed,
  the program family is unchanged) and ``slow_decode`` (a host sleep
  before every n-th decode call, read live).

- **Telemetry** (reference ``:600-650``, ``:2557``, ``:2796-2820``):
  ``profile=True`` opens a ``serving_prefill`` span around each admission,
  a ``serving_decode`` span around each decode step and a
  ``serving_verify`` span around each speculative tick (host spans of
  ``observability``, each also a ``torch.profiler.record_function``
  range); they enclose the program replays, never a captured function,
  and ``profile=False`` opens none.  Every streamed token is observed by
  the ``serving_ttft_seconds`` or ``serving_inter_token_seconds``
  histogram, and every speculating slot's tick by
  ``serving_spec_accept_rate``.  Each program is registered with the
  program registry (``observability.track``) under the reference's name
  (``serving_prefill_b<bucket>``, ``serving_prefill_spec_b<bucket>``,
  ``serving_prefill_cached_b<bucket>``, ``serving_decode``,
  ``serving_verify``), the all-greedy graphs as ``serving_decode_greedy``
  / ``serving_verify_greedy``.  No telemetry call reads a device value.

- **Program sets** (``programs.program_set``): ``program_set=path``
  boots from a set saved by ``save_program_set``: the manifest is held
  against this engine and runtime, the set's kernel libraries are
  installed (no ``nvcc`` runs), and every program is captured at
  construction and held against its record; a mismatch raises
  ``ProgramSetError``.  ``warmup()`` reports each program's source:
  ``"program_set:recaptured"`` (from a set) or ``"traced"``.

Greedy streams equal a solo ``generation.generate`` run of the same
prompt (the same float ops up to summation order).

- **Tensor parallelism** (``mesh=``, reference ``:67-73``, ``:464-470``,
  ``:761-807``): a ``parallel.Mesh`` whose only axis of more than one
  rank is ``tp``.  Every rank of the line runs this engine in its own
  process over its blocks of the reference's Megatron layout
  (``GPTForPretraining.shard_tensor_parallel``: the rank-local forward,
  one all-reduce after each row-parallel linear, the logits all-gathered
  before sampling) and its own KV pools, allocated with the head axis cut
  to ``heads / tp`` (so K3 attends over the rank's heads).  A head count
  ``tp`` does not divide is refused, for the target and the draft pool
  alike (``_assert_kv_sharded``).  The ranks must never diverge: the
  leader (``tp`` coordinate 0) owns ``submit``; each ``step()`` starts
  with a sync in which it broadcasts, over a gloo group of the line, the
  requests submitted since the last one, the cancels and the expired
  deadlines it saw, and whether to stop; every rank then applies them and
  runs the same deterministic step (admission, buckets, preemption, the
  keyed sampler on identical gathered logits, the speculative commit).  A
  request's ``cancelled`` and a deadline's ``expired()`` change only at a
  sync.  The followers call the same driving methods as the leader
  (``run_until_drained``, ``start`` / ``close``, ``step``, ``warmup``, and
  ``preempt_slot`` / ``restore_run`` / ``swap_weights`` in the same
  order); their ``submit`` raises.  ``swap_weights`` takes whole tensors
  and cuts each to the served layout.  LoRA and the gateway's
  ``try_admit`` are not served under a mesh.
"""
from __future__ import annotations

import contextlib
import copy
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
from ..generation import process_logits_dynamic
from ..generation.keyed import (categorical, first_token_at, greedy_step,
                               request_key, sample_step)
from ..generation.speculative import (commit_speculative_greedy,
                                      commit_speculative_sampled,
                                      draft_proposal_key)
from ..lora.layers import adapter_context, attach_serving_lora
from ..lora.registry import AdapterRegistry
from ..lora.train import base_weights_hash, state_hash
from ..ops import _build
from ..observability import metrics as _obs_m
from ..observability import track
from ..ops.paged_attention import (RowWrites, SlotRowWrites, copy_block,
                                   gather_block_rows, write_slot_blocks)
from ..utils import faults
from ..utils.monitor import stat_add
from ..weights import host_tensor
from .kv_pool import KVPoolExhaustedError, PagedKVPool
from .scheduler import QueueFullError
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
    """One paged decode token (``tokens`` (S,)) or R consecutive tokens
    (``tokens`` (S, R): a verify tick's rows) for every slot, the writes
    planned on the host (``RowWrites``; the engine's programs plan them on
    the device): write each active slot's new K/V rows at pos + [0, R)
    through its table (scrubbing entered blocks, dropping inactive slots
    and rows the table does not back), then attend on the pools.
    ``tables_np`` (S, nb) and ``active`` (S,) are host arrays, ``pos``
    (S,) host positions; ``tables_dev``/``tokens`` device tensors.
    Returns (S, V) f32 logits, or (S, R, V) for (S, R) tokens."""
    ids = tokens[:, None] if tokens.dim() == 1 else tokens
    pos = np.asarray(pos, np.int64)
    rows = pos[:, None] + np.arange(ids.shape[1])             # (S, R)
    bidx = np.clip(rows // block_size, 0, tables_np.shape[1] - 1)
    blk = np.take_along_axis(tables_np, bidx, axis=1)
    ok = active[:, None] & (rows < pool_len)
    writes = RowWrites(np.where(ok, blk, num_blocks), rows % block_size,
                       num_blocks, tokens.device)
    pos_dev = torch.from_numpy(pos.astype(np.int32)).to(tokens.device)
    logits = model.forward_paged(ids, pools, tables_dev, pos_dev,
                                 writes).to(torch.float32)
    return logits[:, 0] if tokens.dim() == 1 else logits


def _draft_propose(dlast, keys, pos, temp, top_k, top_p, greedy, i: int,
                   sample: bool):
    """One draft proposal per slot from (S, V) draft logits (reference
    ``_draft_propose``): greedy rows take the argmax of their processed
    logits, the others draw under ``draft_proposal_key(key, pos, i)``.
    Returns (proposal (S,), q (S, V) the processed probabilities); the
    all-greedy program (``sample=False``) needs no q."""
    if not sample:
        return torch.argmax(dlast, dim=-1), None
    proc = process_logits_dynamic(dlast, temp, top_k, top_p, greedy)
    sampled = categorical(draft_proposal_key(keys, pos, i), proc)
    prop = torch.where(greedy, torch.argmax(proc, dim=-1), sampled)
    return prop, torch.softmax(proc, dim=-1)


def _per_row(a, r: int):
    """(S,) per-slot values repeated for R rows per slot -> (S * R,)."""
    return a[:, None].expand(a.shape[0], r).reshape(-1)


class _SlotRun:
    """Host-side per-slot decode state."""
    __slots__ = ("req", "resp", "pos", "produced", "last_token",
                 "last_token_at", "key", "aid")

    def __init__(self, req: Request, resp: Response, pos: int,
                 first_token: int, key: np.ndarray, aid: int = 0):
        self.req = req
        self.resp = resp
        self.pos = pos              # kv length so far (write offset)
        self.produced = 1           # first token came from prefill
        self.last_token = first_token
        self.last_token_at = time.monotonic()
        self.key = key              # sampling key words (uint32 pair)
        self.aid = aid              # pinned adapter slot id (0 = base)


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
    ``(pos, ...)``; ``draft_kv_rows`` the draft pool's the same way on a
    speculative engine (else None: a resumed run then speculates on a
    cold draft context, which costs accepts, never tokens); the sampling
    state rides along, so decode step ``pos`` folds the same key it would
    have folded uninterrupted."""

    __slots__ = ("req", "resp", "pos", "produced", "last_token", "key",
                 "kv_rows", "draft_kv_rows", "preempted_at",
                 "source_config_hash")

    def __init__(self, run: _SlotRun, kv_rows, draft_kv_rows=None):
        self.req = run.req
        self.resp = run.resp
        self.pos = run.pos
        self.produced = run.produced
        self.last_token = run.last_token
        self.key = run.key
        self.kv_rows = kv_rows
        self.draft_kv_rows = draft_kv_rows
        self.preempted_at = time.monotonic()
        # the source engine's ``transfer.engine_config_hash``, stamped by
        # preempt_slot: it rides every re-encode of the snapshot, so a
        # restore on an engine of another configuration is refused
        self.source_config_hash: Optional[str] = None

    @classmethod
    def from_state(cls, req, resp, pos: int, produced: int,
                   last_token: int, key, kv_rows, draft_kv_rows=None):
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
        paused.draft_kv_rows = draft_kv_rows
        paused.preempted_at = time.monotonic()
        paused.source_config_hash = None
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


class _MeshDeadline:
    """A request's deadline on a tensor-parallel engine: expired from the
    step sync on that says so (the leader reads the clock, ``real``)."""

    def __init__(self, seconds, real=None):
        self.seconds = seconds
        self.real = real
        self.hit = False

    def expired(self) -> bool:
        return self.hit


class _MeshResponse(Response):
    """A tensor-parallel engine's response: cancelled from the step sync
    on that saw the caller's cancel."""

    def __init__(self, request: Request):
        super().__init__(request)
        self._cancel_seen = False

    @property
    def cancelled(self) -> bool:
        return self._cancel_seen


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
    ``set_share_groups``, or ``share_policy(req)`` when given.
    ``draft_model`` (same protocol and vocabulary, on the same device)
    turns on speculative decoding with ``spec_tokens`` proposals per
    tick.  ``lora`` (a ``lora.LoRAConfig``) serves batched LoRA adapters
    on the model (``load_adapter``, ``submit(adapter=)``); it hooks the
    target linears of the engine's copy for good.  The engine serves a
    copy of its own of ``model`` (and of ``draft_model``), made at
    construction on its device: ``swap_weights`` writes that copy, so the
    model passed in and every other engine built on it are left alone.
    ``profile=True`` opens the
    engine's spans (module docstring).  ``program_set`` boots from a
    saved program set (module docstring).  The parameters are the
    reference's, in its order, then ``device``.  ``mesh`` (a
    ``parallel.Mesh`` over ``tp``) serves tensor parallel (module
    docstring)."""

    def __init__(self, model, max_slots: int = 8, max_len: int = 256,
                 prefill_buckets=None, max_queue_depth: int = 64,
                 pad_token_id: int = 0, dtype=None, profile: bool = False,
                 decode_chunk: int = 4, draft_model=None,
                 spec_tokens: int = 4, kv: str = "fixed",
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 mesh=None, program_set=None, prefix_cache: bool = False,
                 share_policy=None, lora=None, *, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        for role, m in (("model", model), ("draft model", draft_model)):
            if m is not None and m.device != self.device:
                raise InvalidArgumentError(
                    f"engine on {self.device}, but the {role} lives on "
                    f"{m.device}")
        # weights of its own, bound to every program: a swap writes them
        # in place, never the caller's model or another engine's
        with torch.no_grad():
            model = copy.deepcopy(model)
            if draft_model is not None:
                draft_model = copy.deepcopy(draft_model)
        self.model = model
        # tensor parallelism: the blocks are cut before any pool or program
        # is made (module docstring)
        self.mesh = mesh
        self._ctl = None          # the tp line's gloo group (tp > 1)
        self._leader = True
        self._tp_specs = None
        if mesh is not None:
            if lora is not None:
                raise InvalidArgumentError(
                    "lora=LoRAConfig(...) is not served under mesh= (the "
                    "adapter stacks are not laid out over tp)")
            self._init_mesh(mesh)
            self._tp_specs = self._shard_state(model, "KV pool")
            if draft_model is not None:
                self._shard_state(draft_model, "draft KV pool")
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.pad_token_id = int(pad_token_id)
        self._dtype = dtype
        self._profile = bool(profile)
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
        # batched LoRA: the hooks go on before any program is made
        self.lora = lora
        self._lora_reg: Optional[AdapterRegistry] = None
        if lora is not None:
            if draft_model is not None:
                raise InvalidArgumentError(
                    "lora=LoRAConfig(...) and draft_model= (speculative "
                    "decoding) cannot be combined on one engine yet: the "
                    "verify program's draft proposals would need their own "
                    "per-slot adapter gathers; drop draft_model= here or "
                    "route speculative traffic to a separate non-LoRA "
                    "engine")
            if prefix_cache:
                raise InvalidArgumentError(
                    "lora=LoRAConfig(...) and prefix_cache=True cannot be "
                    "combined on one engine yet: cached KV blocks are "
                    "computed under ONE adapter's projections, so a warm "
                    "hit served to another adapter would be silently "
                    "wrong; drop prefix_cache=True here or serve "
                    "prefix-heavy base traffic from a non-LoRA engine")
            shapes = attach_serving_lora(model, lora.targets)
            base_sha = (base_weights_hash(model)
                        if lora.check_base_hash and lora.base_sha is None
                        else None)
            self._lora_reg = AdapterRegistry(lora, shapes, base_sha=base_sha,
                                             device=self.device)
        if kv not in ("fixed", "paged"):
            raise InvalidArgumentError(
                f"kv must be 'fixed' or 'paged', got {kv!r}")
        self.kv = kv
        if prefix_cache and kv != "paged":
            raise InvalidArgumentError(
                f"prefix_cache=True cannot be combined with kv={kv!r}: "
                "prefix reuse shares KV blocks between requests, and only "
                "the paged layout has blocks to share; pass kv='paged'")
        self.draft_model = draft_model
        self.spec_tokens = int(spec_tokens)
        spec = draft_model is not None
        if spec:
            if self.spec_tokens < 1:
                raise InvalidArgumentError(
                    f"spec_tokens must be >= 1, got {self.spec_tokens}")
            if self.spec_tokens >= self.max_len:
                raise InvalidArgumentError(
                    f"spec_tokens {self.spec_tokens} must be < max_len "
                    f"{self.max_len}")
            if prefix_cache:
                raise InvalidArgumentError(
                    "prefix_cache=True and draft_model= (speculative "
                    "decoding) cannot be combined on one engine yet: the "
                    "draft pool shares the target's block tables, but a "
                    "cached prefix has no draft KV, so a warm hit would "
                    "leave the draft context incoherent; drop one of the "
                    "two or split the traffic across two engines")
        self.prefix_cache = None
        self._share_policy = share_policy
        self._share_groups: Dict[str, str] = {}
        # a verify tick writes rows pos..pos+K while pos reaches max_len - 2:
        # K rows of headroom keep a full-budget request's last ticks from
        # overwriting committed KV (requests still fit max_len)
        self._pool_len = self.max_len + (self.spec_tokens if spec else 0)
        # rows a tick may write per slot (backed before each paged tick)
        self._rows_per_tick = (self.spec_tokens + 1 if spec
                               else self.decode_chunk)
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
            # drop: a row for each row one program call writes (a decode
            # token per slot, a verify's K+1 per slot, a prefill window's),
            # a block for each prompt block (the uncached prefill)
            rows = self.max_slots * (self.spec_tokens + 1 if spec else 1)
            trash = self.kv_pool.blocks_for(max(rows, self.buckets[-1]))
            self._pool_store = self.kv_pool.build_pools(model, dtype, trash)
            nb = self.kv_pool.num_blocks
            self._pools = [(k[:nb], v[:nb]) for k, v in self._pool_store]
            if spec:
                # the draft pool pages with the target's tables (one
                # allocator): a slot's draft KV sits at the same block ids
                self._draft_store = self.kv_pool.build_pools(
                    draft_model, dtype, trash)
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
            if spec:
                self._draft_store = draft_model.gen_fixed_cache(
                    self.max_slots, self._pool_len, dtype)
        if mesh is not None:
            self._assert_kv_sharded(self._pool_store, "KV pool", model)
            if spec:
                self._assert_kv_sharded(self._draft_store, "draft KV pool",
                                        draft_model)
        if spec:
            # draft_diverge: presence decided now (a clean engine's verify
            # programs carry no fault branch); the tick is an input
            self._diverge_every = faults.draft_diverge_every()
            self._ticks = 0            # lifetime tick count (the fault's)
            self._spec_ticks = 0       # metrics window (reset_metrics)
            self._spec_proposed = 0
            self._spec_accepted = 0
            self._h_accept = _obs_m.histogram(
                "serving_spec_accept_rate",
                "accepted draft proposals / spec_tokens, per slot per tick")
        # nan_logits: presence decided now (a clean engine's decode
        # programs carry no poison input); the request is picked by number
        self._poison_target = faults.nan_logits_request()
        self._decode_calls = 0      # the slow_decode fault's stride counter
        # which weights the engine serves (swap_weights)
        self.weights_sha: Optional[str] = None
        self.refresh_epoch = 0
        self._warm = False
        self._programs: Dict[object, Program] = {}
        self._compiles = {"decode": 0,
                          "prefill": {b: 0 for b in self.buckets}}
        self._warm_marks: Optional[Dict] = None
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
        # latency histograms shared with the unified report and the
        # Prometheus endpoint (handles cached; registry.reset() zeroes
        # values in place)
        self._h_ttft = _obs_m.histogram(
            "serving_ttft_seconds", "submit -> first streamed token")
        self._h_itl = _obs_m.histogram(
            "serving_inter_token_seconds",
            "gap between consecutive tokens of one request")
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
        # a program set: libraries installed, every program captured now
        # and held against its record (ProgramSetError on any mismatch)
        self.program_set_info = None
        self._set_libraries = None
        if program_set is not None:
            from ..programs import program_set as _pset
            loaded = _pset.load_program_set(program_set, self)
            self._make_all()
            _pset.check_captures(loaded, self)
            self.program_set_info = {
                "path": program_set if isinstance(program_set, str)
                else None,
                "kinds": {k: v.kind for k, v in loaded.items()},
                "libraries": self._set_libraries}

    # ------------------------------------------------------------------
    # requests
    # ------------------------------------------------------------------
    def make_request(self, prompt, max_new_tokens: int,
                     decode_strategy: str = "greedy_search", temperature=1.0,
                     top_k=0, top_p=1.0, eos_token_id: Optional[int] = None,
                     seed: Optional[int] = None,
                     deadline: Optional[float] = None, priority: int = 0,
                     tenant: Optional[str] = None,
                     spec: Optional[bool] = None,
                     session: Optional[str] = None,
                     resubmit: bool = False,
                     adapter: Optional[str] = None):
        """Validate and build one (Request, Response) pair without queueing
        it (``submit`` queues it; ``try_admit`` places it directly, as the
        gateway does).
        Raises InvalidArgumentError for a prompt/budget the engine can
        never serve, and ``lora.AdapterNotFoundError`` for an ``adapter``
        that is not loaded (it is pinned at admission).  A sampled request
        draws under a key made from ``seed`` (default: the request id),
        folded in at each token's position: its tokens depend only on the
        seed, the positions and the logits.  ``tenant`` scopes
        prefix-cache sharing.  ``spec``: speculate (None: when the engine
        has a draft model; True without one raises).  ``session`` is the
        fleet's affinity key; ``resubmit=True`` (re-prefill from the prompt
        when a replica is lost) is greedy-only, as in the reference."""
        if self._closed:
            raise UnavailableError("serving engine is closed")
        if self._dead is not None:
            raise UnavailableError(
                f"serving engine loop died: {self._dead!r}")
        if not self._leader:
            raise InvalidArgumentError(
                "a tensor-parallel engine takes requests on its leader (tp "
                "rank 0) only; the other ranks follow its step syncs")
        if decode_strategy not in ("greedy_search", "sampling"):
            raise InvalidArgumentError(
                f"serving supports 'greedy_search' or 'sampling', got "
                f"{decode_strategy!r}")
        if spec is None:
            spec = self.draft_model is not None
        elif spec and self.draft_model is None:
            raise InvalidArgumentError(
                "spec=True requires the engine to be built with a "
                "draft_model (speculative decoding)")
        if resubmit and decode_strategy != "greedy_search":
            raise InvalidArgumentError(
                "resubmit=True (re-prefill-from-prompt crash recovery) is "
                "greedy-only: a replayed sampled stream is not covered by "
                "any engine contract — drop resubmit or use greedy_search")
        if adapter is not None and self.lora is None:
            stat_add("STAT_serving_rejects")
            raise InvalidArgumentError(
                f"adapter={adapter!r} requires the engine to be built "
                "with lora=LoRAConfig(...)")
        if self.lora is not None and adapter is not None:
            try:
                self._lora_reg.resolve(adapter)
            except Exception:
                stat_add("STAT_serving_rejects")
                stat_add("STAT_lora_rejects")
                raise
        with self._submit_lock:
            rid = self._rid
            self._rid += 1
        req = Request(rid, prompt, max_new_tokens,
                      greedy=decode_strategy == "greedy_search",
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      eos_token_id=eos_token_id,
                      seed=seed if seed is not None else rid,
                      deadline=deadline, priority=priority, tenant=tenant,
                      spec=spec, session=session, resubmit=resubmit,
                      adapter=adapter)
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
        if self._poison_target is not None and rid == self._poison_target:
            req.poison = True
        stat_add("STAT_serving_requests")
        if self._ctl is not None:
            if req.deadline is not None:
                req.deadline = _MeshDeadline(req.deadline.seconds,
                                             req.deadline)
            return req, _MeshResponse(req)
        return req, Response(req)

    def submit(self, prompt, max_new_tokens: int,
               decode_strategy: str = "greedy_search", temperature=1.0,
               top_k=0, top_p=1.0, eos_token_id: Optional[int] = None,
               seed: Optional[int] = None, deadline: Optional[float] = None,
               block: bool = False, timeout: Optional[float] = None,
               spec: Optional[bool] = None,
               tenant: Optional[str] = None,
               adapter: Optional[str] = None) -> Response:
        """Enqueue one request (``make_request``'s checks and keys);
        returns its streaming Response.  Raises QueueFullError at
        max_queue_depth (backpressure).  The parameters are the
        reference's, in its order: a priority comes in through the gateway
        (``ServingGateway.submit``) or ``make_request``."""
        req, resp = self.make_request(
            prompt, max_new_tokens, decode_strategy=decode_strategy,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_token_id=eos_token_id, seed=seed, deadline=deadline,
            spec=spec, tenant=tenant, adapter=adapter)
        if self._ctl is not None:
            # delivered to every rank at the next step's sync
            with self._submit_lock:
                if (len(self._inbox) + self.scheduler.queue_depth()
                        >= self.scheduler.max_queue_depth):
                    stat_add("STAT_serving_rejects")
                    raise QueueFullError(
                        f"serving queue full "
                        f"({self.scheduler.max_queue_depth} waiting); "
                        "request rejected")
                self._inbox.append((req, resp))
        else:
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
        if self._ctl is not None:
            if self._mesh_sync()["stop"] == "close":
                return False
        return self._step()

    def _step(self) -> bool:
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
        run = self._slots.pop(slot, None)
        self.scheduler.release(slot)
        if self.kv == "paged":
            # blocks return to the free list (cached ones stay resident);
            # their content is scrubbed when they are re-served
            self.kv_pool.free(slot)
        if run is not None:
            self._unpin(run.aid)   # a ref-0 adapter is evictable again
        self._batch_dirty = True

    def _unpin(self, aid: int):
        if self._lora_reg is not None and aid:
            self._lora_reg.release(aid)

    def _pin_adapter(self, req: Request, resp: Response, slot: int):
        """Resolve and pin the request's adapter for the life of its slot
        (0 without LoRA).  An adapter evicted while the request queued
        fails it typed and frees the slot: returns None."""
        if self._lora_reg is None:
            return 0
        try:
            return self._lora_reg.acquire(req.adapter)
        except Exception as e:  # noqa: BLE001 — typed terminal failure
            stat_add("STAT_lora_rejects")
            with self._m_lock:
                self._errored += 1
            resp._fail(e)
            self.scheduler.release(slot)
            return None

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
                 cached_len: int = 0, aid: int = 0):
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
        if self._lora_reg is not None:
            extra["aid"] = aid
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
        span = self._span("serving_prefill")
        try:
            if self.prefix_cache is not None:
                self._admit_prefix(req, resp, slot)
            else:
                self._admit_plain(req, resp, slot)
        finally:
            if span is not None:
                span.__exit__(None, None, None)

    def _admit_plain(self, req: Request, resp: Response, slot: int):
        aid = self._pin_adapter(req, resp, slot)
        if aid is None:
            return
        bucket = self._bucket_for(req.prompt.shape[0])
        if self.kv == "paged" and not self.kv_pool.alloc(slot, bucket):
            self._unpin(aid)
            return self._admit_exhausted(req, resp, slot, "alloc")
        key = request_key(req.seed)
        tok, logp, finite = self._prefill(req, slot, bucket, key, aid=aid)
        self._start_run(req, resp, slot, key, tok, logp, finite, aid)

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
                   tok: int, logp: float, finite: bool, aid: int = 0):
        """After a prefill: the slot's run, with the first token emitted."""
        stat_add("STAT_serving_prefills")
        if not finite:
            self._unpin(aid)    # no run holds the pin yet
            self._fail_slot(slot, resp, "prefill")
            return
        run = _SlotRun(req, resp, pos=int(req.prompt.shape[0]),
                       first_token=tok, key=key, aid=aid)
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
        pools = self._pool_tensors(draft=True)
        with torch.no_grad():
            if self.kv == "paged":
                idx = torch.tensor(self.kv_pool.block_ids(slot),
                                   dtype=torch.long).to(self.device)
                parts = [t.index_select(0, idx).reshape(
                    (-1,) + tuple(t.shape[2:]))[:run.pos] for t in pools]
            else:
                parts = [t[slot, :run.pos] for t in pools]
            rows = _to_host(parts)
        pairs = list(zip(rows[0::2], rows[1::2]))
        n = len(self._pool_store)
        paused = PreemptedRun(run, pairs[:n], pairs[n:] or None)
        from .transfer import engine_config_hash
        paused.source_config_hash = engine_config_hash(self)
        run.req.preempts += 1
        self._slots.pop(slot, None)
        self.scheduler.release(slot)
        if self.kv == "paged":
            self.kv_pool.free(slot)
        # unpinned while parked: the adapter's name travels with the
        # request and the restore pins it again (or fails typed)
        self._unpin(run.aid)
        self._batch_dirty = True
        stat_add("STAT_serving_preemptions")
        return paused

    def _pool_tensors(self, draft: bool):
        """Every KV pool tensor the programs read, in one list: the
        target's k and v per layer, then (``draft`` on a speculative
        engine) the draft's."""
        pools = [t for pair in self._pool_store for t in pair]
        if draft and self.draft_model is not None:
            pools += [t for pair in self._draft_store for t in pair]
        return pools

    def restore_run(self, paused: PreemptedRun) -> bool:
        """Resume a preempted run in any free slot: its rows (the draft
        pool's too, on a speculative engine) cross in one host-to-device
        copy and are written in place into the pools the programs read
        (paged: into fresh blocks, tails zeroed; with the prefix cache,
        past the prefix it re-pins), and decode continues from the saved
        position with the saved key.  Returns False when no slot is free
        or, paged, when the pool cannot hold the rows yet (the caller
        retries)."""
        slot = self.scheduler.acquire(paused.req, paused.resp)
        if slot is None:
            return False
        draft = (self.draft_model is not None
                 and paused.draft_kv_rows is not None)
        pools = self._pool_tensors(draft)
        rows = [r for pair in paused.kv_rows
                + (paused.draft_kv_rows if draft else []) for r in pair]
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
                self._paged_upload(slot, pools, rows, paused.pos, start)
            else:
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

    def _paged_upload(self, slot: int, pools, rows, pos: int,
                      start_row: int = 0):
        """Write snapshot rows [start_row, pos) (``rows``, one per tensor of
        ``pools``) into the slot's blocks past ``start_row``
        (block-aligned), in place, block tails zero-filled: the upload is
        also the scrub.  Adopted shared blocks before ``start_row`` are
        never written."""
        bs = self.block_size
        ids = self.kv_pool.block_ids(slot)[start_row // bs:]
        if not ids:
            return
        shapes = [(len(ids), bs) + tuple(t.shape[2:]) for t in pools]
        host, bufs = _staging(shapes, pools[0].dtype, self.device)
        for buf, r in zip(bufs, rows):
            buf.view((-1,) + tuple(buf.shape[2:]))[:pos - start_row] = \
                r[start_row:pos]
        idx = torch.tensor(ids, dtype=torch.long).to(self.device)
        for pool, buf in zip(pools, _views(host.to(self.device), shapes)):
            pool.index_copy_(0, idx, buf)

    def _finish_restore(self, slot: int, paused: PreemptedRun) -> bool:
        """The resumed run's bookkeeping.  With LoRA its adapter is pinned
        again by name; one evicted meanwhile fails the run typed (the
        paused run is consumed all the same: returns True)."""
        aid = 0
        if self._lora_reg is not None:
            try:
                aid = self._lora_reg.acquire(paused.req.adapter)
            except Exception as e:  # noqa: BLE001 — typed terminal failure
                stat_add("STAT_lora_rejects")
                with self._m_lock:
                    self._errored += 1
                paused.resp._fail(e)
                self.scheduler.release(slot)
                if self.kv == "paged":
                    self.kv_pool.free(slot)
                self._batch_dirty = True
                return True
        run = _SlotRun(paused.req, paused.resp, pos=paused.pos,
                       first_token=paused.last_token, key=paused.key,
                       aid=aid)
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
        """Rows the next step (chunk or verify tick) actually requires for
        this run."""
        return min(pos + self._rows_per_tick,
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
        if self.draft_model is not None:
            host["spec_on"] = np.zeros((s,), bool)
        if self._lora_reg is not None:
            host["aids"] = np.zeros((s,), np.int32)   # idle slots: the base
        if self._poison_target is not None:
            host["poison"] = np.zeros((s,), bool)
        active = np.zeros((s,), bool)
        for slot, run in self._slots.items():
            host["tokens"][slot] = run.last_token
            host["pos"][slot] = run.pos
            host["keys"][slot] = run.key
            host["temp"][slot] = run.req.temperature
            host["top_k"][slot] = run.req.top_k
            host["top_p"][slot] = run.req.top_p
            host["greedy"][slot] = run.req.greedy
            if self.draft_model is not None:
                host["spec_on"][slot] = run.req.spec
            if self._lora_reg is not None:
                host["aids"][slot] = run.aid
            if self._poison_target is not None:
                host["poison"][slot] = run.req.poison
            active[slot] = True
        if self.kv == "paged":
            host["active"] = active
        self._fill(self._programs["decode"].inputs, **host)
        self._all_greedy = bool(host["greedy"].all())
        self._batch_dirty = False

    # ------------------------------------------------------------------
    # the programs (static shapes, no host reads: captured on the card)
    # ------------------------------------------------------------------
    def _forward_rows(self, model, store, ids, pos, tables, active):
        """(S, R, V) f32 logits of ``model`` for R consecutive tokens per
        slot ``ids`` (S, R) at device positions pos + [0, R), on its pool
        ``store``; writes their KV rows first (paged: through the tables,
        R rows per slot)."""
        if self.kv == "paged":
            writes = SlotRowWrites(tables, pos, active,
                                   self.kv_pool.num_blocks, self.block_size,
                                   self._pool_len, n_rows=ids.shape[1])
            logits = model.forward_paged(ids, store, tables, pos, writes)
        else:
            logits, _ = model.forward_fixed(ids, store, pos)
        return logits.to(torch.float32)

    def _lora_ctx(self, aid):
        """The adapter context of a program body: the registry's stacks
        (allocated once) and the program's id buffer, (S,) or (1,); no
        context without LoRA."""
        if aid is None:
            return contextlib.nullcontext()
        return adapter_context(self._lora_reg.stacks, self._lora_reg.scales,
                               aid)

    def _decode_program(self, tokens, pos, keys, temp, top_k, top_p, greedy,
                        tables=None, active=None, aids=None, poison=None, *,
                        sample: bool = True):
        """The decode chunk (reference ``:1279-1316``): ``decode_chunk``
        tokens for every slot, each sampled (``sample``; else the
        all-greedy step) and fed back.  ``aids`` (S,) int32 are the slots'
        adapter ids on a LoRA engine (reference ``:1239-1265``: each slot
        gathers its own factors); ``poison`` (S,) bool is the nan_logits
        fault's input, present only when it is armed.  Returns (toks,
        logps, finites), each (chunk, S), and the buffers ``tokens`` /
        ``pos``, updated in place to the last token and the next
        position."""
        tok, p = tokens, pos
        toks, logps, finites = [], [], []
        with self._lora_ctx(aids):      # the slots' factors gathered once
            for _ in range(self.decode_chunk):
                last = self._forward_rows(self.model, self._pool_store,
                                          tok[:, None], p, tables,
                                          active)[:, 0]
                if poison is not None:
                    last = faults.poison_logits(last, poison)
                finites.append(torch.isfinite(last).all(dim=-1))
                if sample:
                    tok, logp = sample_step(last, keys, p, temp, top_k,
                                            top_p, greedy)
                else:
                    tok, logp = greedy_step(last)
                toks.append(tok)
                logps.append(logp)
                p = p + 1
        tokens.copy_(tok)
        pos.copy_(p)
        return (torch.stack(toks), torch.stack(logps), torch.stack(finites),
                tokens, pos)

    def _verify_program(self, tokens, pos, keys, temp, top_k, top_p, greedy,
                        spec_on, tables=None, active=None, diverge=None,
                        poison=None, *, sample: bool = True):
        """The speculative tick (reference ``_build_verify`` ``:989-1082``,
        ``_build_verify_paged`` ``:1319-1423``): K+1 draft steps (step K
        only writes d_K's KV, at pos+K), one target forward over ``[last,
        d_1..d_K]`` (K+1 rows per slot), the sampling knobs on every row
        (``sample``; the all-greedy program commits the raw logits), and
        the commit.  ``diverge`` (1,) bool is the draft_diverge fault's
        input and ``poison`` (S,) bool the nan_logits fault's, each present
        only when it is armed.  Returns (out (S, K+1),
        logps (S, K+1), finite (S,), count (S,), accepted (S,), the
        buffers ``tokens`` / ``pos`` updated in place to the last
        committed token and pos + count, and all but the last two as one
        (S, 2K+5) f64 host view: out, count, accepted, finite, logps)."""
        k_spec = self.spec_tokens
        cur, props, qs, dfin = tokens, [], [], None
        for i in range(k_spec + 1):
            dlast = self._forward_rows(self.draft_model, self._draft_store,
                                       cur[:, None], pos + i, tables,
                                       active)[:, 0]
            if diverge is not None:
                dlast = faults.poison_draft_logits(dlast, diverge)
            fin = torch.isfinite(dlast).all(dim=-1)
            dfin = fin if dfin is None else dfin & fin
            if i < k_spec:
                cur, q = _draft_propose(dlast, keys, pos, temp, top_k, top_p,
                                        greedy, i, sample)
                props.append(cur)
                qs.append(q)
        props = torch.stack(props, dim=1)                     # (S, K)
        ids = torch.cat([tokens[:, None], props], dim=1)      # (S, K+1)
        tlog = self._forward_rows(self.model, self._pool_store, ids, pos,
                                  tables, active)             # (S, K+1, V)
        if poison is not None:
            tlog = faults.poison_logits(tlog, poison)
        # the draft's non-finite logits count only where the slot speculates
        finite = torch.isfinite(tlog).all(dim=2).all(dim=1) & (dfin | ~spec_on)
        if sample:
            s, r, v = tlog.shape
            plog = process_logits_dynamic(
                tlog.reshape(s * r, v), _per_row(temp, r), _per_row(top_k, r),
                _per_row(top_p, r), _per_row(greedy, r)).reshape(s, r, v)
            out, count, accepted, last, logps = commit_speculative_sampled(
                props, torch.stack(qs, dim=1), plog, keys, pos, greedy,
                spec_on, self.pad_token_id)
        else:
            out, count, accepted, last, logps = commit_speculative_greedy(
                props, None, tlog, keys, pos, greedy, spec_on,
                self.pad_token_id)
        tokens.copy_(last)
        pos.copy_(pos + count)
        host = torch.cat([out, count[:, None], accepted[:, None],
                          finite[:, None].to(torch.int64)], dim=1)
        host = torch.cat([host.to(torch.float64), logps.to(torch.float64)],
                         dim=1)
        return out, logps, finite, count, accepted, tokens, pos, host

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

    def _prefill_kv(self, model, store, ids, target, bucket: int):
        """``model`` over the padded prompt against a bucket-sized scratch
        cache, its KV into the slot's region of ``store``.  Returns the
        (1, bucket, V) logits."""
        scratch = model.gen_fixed_cache(1, bucket, self._dtype)
        logits, kv = model.forward_fixed(ids, scratch, 0)
        for (kp, vp), (kc, vc) in zip(store, kv):
            self._write_prompt(kp, kc[0], target, bucket)
            self._write_prompt(vp, vc[0], target, bucket)
        return logits

    def _prefill_program(self, bucket: int, ids, prompt_len, target, key,
                         temp, top_k, top_p, greedy, aid=None):
        """One bucket's prefill (reference ``:1137-1163``): the padded
        prompt through a bucket-sized scratch cache (under the adapter
        ``aid`` (1,) on a LoRA engine), its KV into the slot's region (on a
        speculative engine the draft's too, into its pool), the first token
        sampled from the target at ``prompt_len - 1``.  Returns (token,
        logp, finite), each (1,)."""
        with self._lora_ctx(aid):
            logits = self._prefill_kv(self.model, self._pool_store, ids,
                                      target, bucket)
        if self.draft_model is not None:
            self._prefill_kv(self.draft_model, self._draft_store, ids,
                             target, bucket)
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
        cached-suffix prefill) and the decode chunk — on a speculative
        engine the verify tick — mixed ("decode") and all-greedy
        ("decode_greedy"), sharing one set of buffers; a LoRA engine's
        take the adapter ids too, and with nan_logits armed the decode
        pair the poison mask.  The buffers start as a warm-up input:
        sentinel tables and inactive slots (paged writes drop), slot 0
        (fixed), adapter 0."""
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
        tick = self._decode_program
        if self.draft_model is not None:
            tick = self._verify_program
            dec["spec_on"] = full((s,), False, torch.bool)
            if self._diverge_every is not None:
                dec["diverge"] = full((1,), False, torch.bool)
        if self._lora_reg is not None:
            dec["aids"] = full((s,), 0, torch.int32)
            pre["aid"] = full((1,), 0, torch.int32)
        if self._poison_target is not None:
            dec["poison"] = full((s,), False, torch.bool)
        tick_name = ("serving_verify" if self.draft_model is not None
                     else "serving_decode")
        programs = {
            "decode": track(tick_name, Program(tick, dec)),
            "decode_greedy": track(
                tick_name + "_greedy",
                Program(functools.partial(tick, sample=False), dec))}
        prefill = self._prefill_program
        prefill_name = ("serving_prefill_spec_b" if self.draft_model
                        is not None else "serving_prefill_b")
        if self.prefix_cache is not None:
            prefill = self._prefill_cached_program
            prefill_name = "serving_prefill_cached_b"
            pre["cached_len"] = full((1,), 0, torch.int64)
        for b in self.buckets:
            programs[b] = track(f"{prefill_name}{b}", Program(
                functools.partial(prefill, b),
                dict(pre, ids=full((1, b), self.pad_token_id, torch.int64))))
        return programs

    def _run(self, prog: Program):
        return prog.run(captured=not self._run_uncaptured)

    def _decode_step(self):
        span = self._span("serving_verify" if self.draft_model is not None
                          else "serving_decode")
        try:
            self._decode_step_inner()
        finally:
            if span is not None:
                span.__exit__(None, None, None)

    def _decode_step_inner(self):
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
        # slow_decode: a host-side sleep on its stride, read live
        faults.maybe_slow_decode(self._decode_calls)
        self._decode_calls += 1
        if self.draft_model is not None:
            return self._spec_tick(prog)
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

    def _spec_tick(self, prog: Program):
        """One speculative tick on the host (reference ``_spec_step``
        ``:2422-2515``): the verify program, one device-to-host pull, then
        each slot's 1..K+1 tokens committed in order — a deadline that
        expired while the tick was computing stops the stream before the
        next token, and eos or the length budget mid-tick discards the
        tail."""
        tick = self._ticks
        self._ticks += 1
        if self._diverge_every is not None:
            self._fill(prog.inputs, diverge=tick % self._diverge_every == 0)
        host = self._run(prog)[-1].cpu().numpy()
        k1 = self.spec_tokens + 1
        toks = host[:, :k1].astype(np.int64)
        counts, accepts, finites = (host[:, k1 + i].astype(np.int64)
                                    for i in range(3))
        logps = host[:, k1 + 3:].astype(np.float32)
        stat_add("STAT_serving_decode_steps")
        stat_add("STAT_spec_ticks")
        emitted = proposed = accepted = 0
        for slot in list(self._slots):
            run = self._slots[slot]
            if not finites[slot]:
                self._fail_slot(slot, run.resp, "verify")
                continue
            if run.req.spec:
                proposed += self.spec_tokens
                accepted += int(accepts[slot])
                self._h_accept.observe(int(accepts[slot]) / self.spec_tokens)
            for j in range(int(counts[slot])):
                if (run.req.deadline is not None
                        and run.req.deadline.expired()):
                    stat_add("STAT_serving_deadline_expired")
                    run.resp._fail(DeadlineExceededError(
                        f"request {run.req.id} deadline "
                        f"({run.req.deadline.seconds}s) expired mid-decode"))
                    self._release(slot)
                    break
                t = int(toks[slot, j])
                run.pos += 1
                run.produced += 1
                run.last_token = t
                self._emit(run, t, float(logps[slot, j]))
                emitted += 1
                self._maybe_finish(slot, run, t)
                if slot not in self._slots:
                    break  # finished mid-tick: the tail is discarded
        if emitted:
            stat_add("STAT_serving_tokens", emitted)
        if proposed:
            stat_add("STAT_spec_proposed", proposed)
            stat_add("STAT_spec_accepted", accepted)
        with self._m_lock:
            self._spec_ticks += 1
            self._spec_proposed += proposed
            self._spec_accepted += accepted

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
        if first:
            self._h_ttft.observe(run.resp.ttft)
        else:
            self._h_itl.observe(now - run.last_token_at)
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

    def _span(self, name: str):
        """An open host span (a ``RecordEvent``) under ``profile=True``,
        else None."""
        if not self._profile:
            return None
        from ..utils.profiler import RecordEvent
        return RecordEvent(name).__enter__()

    # ------------------------------------------------------------------
    # driving
    # ------------------------------------------------------------------
    def has_work(self) -> bool:
        return (bool(self._slots) or self.scheduler.has_work()
                or bool(self.kv == "paged" and self._oom_paused))

    def run_until_drained(self, timeout: Optional[float] = None):
        """Drive the loop in the caller's thread until queue and slots are
        empty.  Not for use while start() is live.  On a tensor-parallel
        engine every rank calls it and the leader decides, at each sync,
        whether to go on."""
        t0 = time.monotonic()
        if self._ctl is not None:
            def decide(pending: bool):
                if timeout is not None and time.monotonic() - t0 > timeout:
                    return "timeout"
                return None if pending or self.has_work() else "drained"
            while True:
                stop = self._mesh_sync(decide)["stop"]
                if stop == "timeout":
                    raise TimeoutError("serving engine did not drain in "
                                       f"{timeout}s")
                if stop is not None:
                    return
                self._step()
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
            self._unpin(run.aid)
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
        Idempotent and safe under concurrent double-close.  On a
        tensor-parallel engine every rank calls it: the leader's tells the
        followers to stop at their next sync."""
        if self._ctl is not None and not self._leader:
            return self._close_follower()
        self._closed = True
        self._stop.set()
        self._work.set()
        with self._close_lock:
            if self._thread is not None:
                # a tensor-parallel leader's loop may wait in a sync
                self._thread.join(timeout=None if self._ctl else 5.0)
                self._thread = None
            if self._ctl is not None and not self._mesh_done:
                self._mesh_sync(lambda pending: "close")
            self._abort_all(lambda req: RequestCancelled(
                f"request {req.id} aborted: serving engine closed"))

    def _close_follower(self):
        """A follower's close: its loop (or a sync here) runs until the
        leader's close reaches it."""
        with self._close_lock:
            if self._thread is not None:
                self._thread.join()
                self._thread = None
            while not self._mesh_done:
                self._mesh_sync()
            self._closed = True
            self._stop.set()
            self._abort_all(lambda req: RequestCancelled(
                f"request {req.id} aborted: serving engine closed"))

    # ------------------------------------------------------------------
    # tensor parallelism over the mesh
    # ------------------------------------------------------------------
    def _init_mesh(self, mesh):
        """The tp line (every other axis must be of one rank) and, when it
        has more than one rank, the gloo group of its step syncs (made by
        every rank of the world, in one order)."""
        import torch.distributed as dist
        from ..parallel.mesh import Mesh
        if not isinstance(mesh, Mesh):
            raise InvalidArgumentError(
                f"ServingEngine(mesh=) takes a parallel.Mesh, got "
                f"{type(mesh).__name__}")
        others = {a: n for a, n in mesh.shape.items() if a != "tp" and n > 1}
        if others:
            raise InvalidArgumentError(
                f"ServingEngine(mesh=) serves over tp only; the mesh also "
                f"has {others}")
        self._mesh_tp = int(mesh.shape["tp"])
        self._inbox: List = []
        self._mesh_live: Dict[int, tuple] = {}
        self._mesh_done = False
        if self._mesh_tp > 1:
            ranks = mesh.axis_ranks("tp")
            self._ctl = dist.new_group(ranks, backend="gloo")
            self._ctl_src = ranks[0]
            self._leader = mesh.coord("tp") == 0

    def _shard_state(self, model, what: str):
        """``model``'s blocks of the reference's layout (refused when no
        KV leaf's head axis divides tp); returns the specs."""
        if not hasattr(model, "shard_tensor_parallel"):
            raise InvalidArgumentError(
                f"ServingEngine(mesh=): {type(model).__name__} has no "
                "tensor-parallel forward (shard_tensor_parallel)")
        return model.shard_tensor_parallel(self.mesh, what)

    def _assert_kv_sharded(self, pools, what: str, model):
        """The pools hold heads / tp on every leaf (``_shard_state``
        refused the rest); a check that nothing replicated them."""
        heads = model.gpt.config.num_attention_heads
        for k, v in pools:
            if k.shape[2] * self._mesh_tp != heads and self._mesh_tp > 1:
                raise InvalidArgumentError(
                    f"tensor-parallel {what} fully replicated: "
                    f"{k.shape[2]} heads per rank at tp={self._mesh_tp}")

    def _mesh_sync(self, decide=None) -> dict:
        """The step sync (module docstring): the leader broadcasts the
        requests submitted since the last one, the cancels and expired
        deadlines it sees and ``decide(pending)``'s stop (None, "drained",
        "timeout" or "close"); every rank applies them.  Returns the
        message."""
        import torch.distributed as dist
        if self._leader:
            with self._submit_lock:
                inbox, self._inbox = self._inbox, []
            live = self._mesh_live
            msg = {
                "subs": [self._wire(req) for req, _ in inbox],
                "cancel": [rid for rid, (_, r) in live.items()
                           if r._cancel_requested and not r._cancel_seen],
                "expire": [rid for rid, (q, _) in live.items()
                           if q.deadline is not None and not q.deadline.hit
                           and q.deadline.real.expired()],
                "stop": None if decide is None else decide(bool(inbox))}
            dist.broadcast_object_list([msg], src=self._ctl_src,
                                       group=self._ctl)
            pairs = inbox
        else:
            box = [None]
            dist.broadcast_object_list(box, src=self._ctl_src,
                                       group=self._ctl)
            msg = box[0]
            pairs = []
            for req in msg["subs"]:
                if req.deadline is not None:
                    req.deadline = _MeshDeadline(req.deadline)
                pairs.append((req, _MeshResponse(req)))
        for req, resp in pairs:
            self._mesh_live[req.id] = (req, resp)
            self.scheduler.submit(req, resp)
        for rid in msg["cancel"]:
            self._mesh_live[rid][1]._cancel_seen = True
        for rid in msg["expire"]:
            self._mesh_live[rid][0].deadline.hit = True
        for rid in [rid for rid, (_, r) in self._mesh_live.items()
                    if r.done()]:
            del self._mesh_live[rid]
        if msg["stop"] == "close":
            self._mesh_done = True
            self._stop.set()
        return msg

    @staticmethod
    def _wire(req: Request) -> Request:
        """The request as the followers get it: its deadline's seconds in
        place of the deadline."""
        out = copy.copy(req)
        if req.deadline is not None:
            out.deadline = req.deadline.seconds
        return out

    def _free_device(self):
        """Drop every device tensor of a closed engine: its programs (the
        CUDA graphs and the outputs in their memory pool), KV pools,
        weight copies and adapter stacks, so that its card memory returns
        while the engine object may still be referenced (a fleet's
        ``remove``).  The engine serves nothing afterwards."""
        if not self._closed:
            raise InvalidArgumentError("only a closed engine can be released")
        self._programs = {}
        self._graph_pool = None
        self._pool_store = self._pools = None
        self._draft_store = None
        self.model = self.draft_model = None
        if self._lora_reg is not None:
            self._lora_reg.stacks = self._lora_reg.scales = None

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
        flight; a second call captures nothing new.  An engine booted
        from a program set captured its programs at construction, and
        its kernel libraries came from the set."""
        t0 = time.perf_counter()
        report = {}
        if self.device.type == "cuda" and self.program_set_info is None:
            report["kernel_build"] = _build.build_all()["seconds"]
        self._make_all()
        # the warm-up runs moved the decode buffers: refill before a step
        self._batch_dirty = True
        self._warm = True
        self._warm_marks = self._compile_marks()
        report["seconds"] = time.perf_counter() - t0
        report["captured"] = self.device.type == "cuda"
        report["compile_counts"] = self.compile_counts()
        source = ("traced" if self.program_set_info is None
                  else "program_set:recaptured")
        from ..programs.program_set import program_name
        from ..programs.store import store_stats
        report["programs"] = {program_name(k): source
                              for k in self._programs}
        report["store"] = store_stats()
        return report

    def _make_all(self):
        """Make (on the card: capture) every program not made yet."""
        cuda = self.device.type == "cuda"
        with torch.inference_mode():
            if not self._programs:
                self._programs = self._make_programs()
            for name, prog in self._programs.items():
                if prog.ready:
                    continue
                t_made = time.perf_counter()
                if cuda:
                    if self._graph_pool is None:
                        self._graph_pool = torch.cuda.graph_pool_handle()
                    prog.capture(self._graph_pool)
                prog.made(time.perf_counter() - t_made)
                if isinstance(name, int):
                    self._compiles["prefill"][name] += 1
                else:
                    self._compiles["decode"] += 1
                stat_add("STAT_serving_compiles")
        if cuda:
            torch.cuda.synchronize(self.device)

    def save_program_set(self, path: str,
                         extra_meta: Optional[dict] = None) -> str:
        """Write this engine's program family, its manifest and the kernel
        libraries its programs launch as one artifact, loadable by
        ``ServingEngine(program_set=...)`` / ``enable_serving(program_set=
        ...)`` (``programs/program_set.py``).  A cold engine makes its
        programs first.  Returns the artifact's path."""
        from ..programs.program_set import save_program_set as _save
        return _save(self, path, extra_meta)

    def compile_counts(self) -> Dict:
        """Programs made, under the reference's keys: on the card each
        count is one CUDA graph capture, on the CPU one program built.
        The bound is ``len(buckets) + 2``: the decode chunk (on a
        speculative engine the verify tick, counted under "decode") is
        captured twice, all-greedy and mixed, where the reference
        branches inside one program; a bucket's prefill program prefills
        the draft too."""
        total = (self._compiles["decode"]
                 + sum(self._compiles["prefill"].values()))
        return {"decode": self._compiles["decode"],
                "prefill": dict(self._compiles["prefill"]),
                "total": total, "bound": len(self.buckets) + 2}

    def _compile_marks(self) -> Dict:
        """Every serving-compile counter (reference ``:2794-2809``): the
        engine's own counts and the program registry's captures of this
        engine's programs, by name (the reference reads every
        ``serving_*`` record of the process)."""
        reg: Dict[str, int] = {}
        for prog in self._programs.values():
            if prog.tracked_as is not None:
                reg[prog.tracked_as] = (reg.get(prog.tracked_as, 0)
                                        + prog.compiles)
        return {"engine": self.compile_counts()["total"], "registry": reg}

    def post_warmup_compiles(self) -> int:
        """Compiles observed since warmup() finished, engine counts and
        registry captures both: 0 under any traffic; -1 if warmup never
        ran."""
        if self._warm_marks is None:
            return -1
        now = self._compile_marks()
        extra = now["engine"] - self._warm_marks["engine"]
        base = self._warm_marks["registry"]
        for name, compiles in now["registry"].items():
            extra += compiles - base.get(name, 0)
        return extra

    # ------------------------------------------------------------------
    # weight refresh
    # ------------------------------------------------------------------
    def swap_weights(self, state: Dict, weights_sha: Optional[str] = None):
        """Serve the target weights ``state`` (name -> tensor or array, the
        model's ``state_dict`` keys) from the next step on, with nothing
        captured again (reference ``:683-738``).  The exact key set and
        every leaf's shape are checked first, and any mismatch raises
        InvalidArgumentError with nothing written; each leaf is then cast
        to the served tensor's dtype, as the reference casts, and copied
        IN PLACE into the parameter or buffer the captured graphs read (a
        rebind would leave them on the old storage).  Bumps
        ``refresh_epoch``, sets ``weights_sha`` and flushes the prefix
        cache (its KV came from the old weights); a speculative engine's
        draft is left alone.  Loaded adapters stay, and the registry's
        base hash follows the new weights (with ``check_base_hash``), so a
        later ``load_adapter`` checks against the base now served.  Call
        it between steps from the driving thread."""
        own = self.model.state_dict(keep_vars=True)
        missing = sorted(set(own) - set(state))
        unexpected = sorted(set(state) - set(own))
        if missing or unexpected:
            raise InvalidArgumentError(
                f"swap_weights state-dict key mismatch: missing "
                f"{missing[:4]}, unexpected {unexpected[:4]}")
        staged = {}
        for name, cur in own.items():
            new = state[name]
            if not isinstance(new, torch.Tensor):
                new = host_tensor(np.asarray(new))
            if self._tp_specs is not None:
                # the incumbent's layout: this rank's block of the whole
                new = self.model.tp_slice(name, new)
            if tuple(new.shape) != tuple(cur.shape):
                raise InvalidArgumentError(
                    f"swap_weights shape mismatch for {name!r}: "
                    f"{tuple(new.shape)} != {tuple(cur.shape)}")
            staged[name] = new.to(cur.dtype)
        with torch.no_grad():
            for name, cur in own.items():
                cur.copy_(staged[name])
        self.weights_sha = weights_sha
        self.refresh_epoch += 1
        if self.prefix_cache is not None:
            # old-weights KV must never seed a new-weights stream
            self.prefix_cache.evict(self.prefix_cache.stats()["nodes"])
        if self._lora_reg is not None and self.lora.check_base_hash:
            self._lora_reg.base_sha = state_hash(self.model.state_dict())

    def load_adapter(self, name: str, path: str) -> str:
        """Page a tenant's exported LoRA artifact into the registry under
        ``name`` (reference ``:740-756``): its factors are written in place
        into a row of the stacks the captured programs read, so nothing is
        captured, and it is safe while the engine loop serves.  The same
        bytes again are a no-op.  Returns the artifact's file sha256.
        Typed failures: ``AdapterIntegrityError`` (corrupt, wrong base),
        InvalidArgumentError (rank, targets), ``AdapterExhaustedError``
        (every slot pinned)."""
        if self._lora_reg is None:
            raise InvalidArgumentError(
                "load_adapter requires an engine constructed with "
                "lora=LoRAConfig(...) — this engine serves the base "
                "model only")
        idx = self._lora_reg.register(name, path)
        return self._lora_reg.file_sha(idx)

    def adapter_shas(self) -> Optional[Dict[str, str]]:
        """name -> artifact sha256 of every resident adapter, or None on
        an engine without LoRA (or with none loaded)."""
        if self._lora_reg is None:
            return None
        return self._lora_reg.shas() or None

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def metrics(self) -> Dict:
        """Serving metrics snapshot, under the reference's keys (also
        published as the ``STAT_serving_*`` monitor counters and the
        serving histograms)."""
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
                "compile_counts": self.compile_counts(),
                "spec": self._spec_metrics(),
                "warm": self._warm,
                "post_warmup_compiles": (self.post_warmup_compiles()
                                         if self._warm else None),
                "program_set": self.program_set_info,
                "kv_pool": self._kv_pool_metrics(),
                "lora": (None if self._lora_reg is None
                         else self._lora_reg.stats()),
                "mesh": (None if self.mesh is None else {
                    "devices": int(self.mesh.size),
                    "tp": int(self.mesh.shape.get("tp", 1))}),
            }

    def _spec_metrics(self) -> Dict:
        """The reference's speculative counters (``:2905-2916``)."""
        if self.draft_model is None:
            return {"enabled": False}
        return {"enabled": True, "spec_tokens": self.spec_tokens,
                "ticks": self._spec_ticks,
                "proposed": self._spec_proposed,
                "accepted": self._spec_accepted,
                "accept_rate": (self._spec_accepted / self._spec_proposed
                                if self._spec_proposed else None)}

    def reset_metrics(self):
        """Start a new metrics window: TTFTs, token and request counts,
        the rate's clock and the speculative counters."""
        with self._m_lock:
            self._ttfts = []
            self._itl_sum = 0.0
            self._itl_n = 0
            self._tokens_out = 0
            self._completed = 0
            self._errored = 0
            self._started_at = time.monotonic()
            if self.draft_model is not None:
                self._spec_ticks = 0
                self._spec_proposed = 0
                self._spec_accepted = 0

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
