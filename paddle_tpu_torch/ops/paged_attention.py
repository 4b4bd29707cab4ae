"""Paged attention: decode attention against a block-pooled KV cache.

Port of ``paddle_tpu/ops/paged_attention.py``.  The serving engine's
paged pool stores KV as ``(num_blocks, block_size, heads, head_dim)`` per
layer, and each slot owns a table of block ids; the allocator's
``num_blocks`` is the sentinel of an unallocated entry.

- **Block-pool primitives.**  ``gather_block_rows`` clips out-of-range ids
  into the pool (their rows are only read under the attention mask);
  ``scatter_block_rows``, ``scrub_blocks`` and ``write_blocks`` DROP
  out-of-range ids, so inactive slots and warmup write nothing.  These are
  JAX's ``mode="clip"`` / ``mode="drop"`` rules, made explicit: torch
  indexing would raise or read past the pool (a negative id also drops;
  the reference would wrap it, and the allocator never produces one).
  Block ids are host-side allocator state here, so writes filter them on
  the host and upload one index tensor (no device sync); ``RowWrites``
  plans one decode step's
  scrub + scatter once and applies it to every layer's pools.  Writes
  update the pool in place (the reference returns a new array).
- **``paged_attention``** (kernel ``csrc/paged_attention.cu``, CUDA C++ for
  sm_90a): replaces the Pallas kernel
  ``paddle_tpu/ops/paged_attention.py::_kernel``.  Batched over slots:
  q (S, H, D) against the pools through tables (S, nb) with positions
  (S,).  q and the pool pair are each f32 or bf16; like the TPU kernel it
  computes in f32 and writes q's dtype.  It reads only the blocks that
  hold rows <= pos and never materializes the contiguous view; its bound
  is the live K/V bytes, ``sum(pos + 1) * H * D * 2 * E`` (E the pool's
  element size) over 3.35 TB/s (8 slots at pos ~512 of GPT-2 medium in
  f32: 33.5 MB, ~10 us per layer; half that in bf16).  Split-KV: the blocks of a
  thread-block cluster each take a split of one slot's table for a few
  heads, and rank 0 merges their softmax states through distributed
  shared memory in rank order (one kernel, no scratch in device memory,
  bit-repeatable).  ``_plan`` cuts the table from its width alone, so
  the wrapper never reads ``pos`` on the host.  Design notes in the
  source.  The plain version (``_plain``) is the reference's
  ``_fallback``: gather the view, masked softmax in f32, q's dtype out;
  the wrapper takes it only for CPU tensors.

``paged_attention.launches`` counts kernel launches (the plain version never
counts).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import _build

__all__ = ["gather_block_rows", "scatter_block_rows", "scrub_blocks",
           "write_blocks", "RowWrites", "paged_attention"]


# ---------------------------------------------------------------------------
# block-pool primitives
# ---------------------------------------------------------------------------

def _host_ids(ids) -> np.ndarray:
    if isinstance(ids, torch.Tensor):
        ids = ids.detach().cpu().numpy()
    return np.asarray(ids, dtype=np.int64).reshape(-1)


def _live(ids: np.ndarray, num_blocks: int) -> np.ndarray:
    """Positions of the ids that address a real block (sentinel and any
    other out-of-range id is dropped)."""
    return np.flatnonzero((ids >= 0) & (ids < num_blocks))


def gather_block_rows(pool, table):
    """(num_blocks, block_size, *rest) pool + (..., nb) block table ->
    (..., nb * block_size, *rest) contiguous rows.  Out-of-range entries
    clip into [0, num_blocks - 1]; their rows are only ever read under the
    attention mask."""
    ids = table.to(device=pool.device, dtype=torch.long).clamp(
        0, pool.shape[0] - 1)
    blocks = pool[ids]                       # (..., nb, block_size, *rest)
    lead = ids.shape[:-1]
    return blocks.reshape(*lead, ids.shape[-1] * pool.shape[1],
                          *pool.shape[2:])


class RowWrites:
    """One step's scrub + scatter through the block tables, planned on the
    host: rows[i] goes to (block_ids[i], offsets[i]); ids out of range are
    dropped; every block entered at offset 0 is zeroed first (scrub-on-
    recycle: a block's first row is the entering position, so the zeroing
    can only erase a prior tenant's KV).  The index tensors are uploaded
    once and reused for every layer."""

    def __init__(self, block_ids, offsets, num_blocks: int, device,
                 scrub: bool = True):
        ids = _host_ids(block_ids)
        offs = _host_ids(offsets)
        keep = _live(ids, num_blocks)
        enter = ids[keep][offs[keep] == 0] if scrub else ids[:0]
        n, e = len(keep), len(enter)
        packed = torch.from_numpy(np.concatenate(
            [ids[keep], offs[keep], keep, enter])).to(device)
        self.blk = packed[:n]
        self.off = packed[n:2 * n]
        self.sel = packed[2 * n:3 * n]
        self.enter = packed[3 * n:3 * n + e]

    def apply(self, pool, rows):
        """Scrub entered blocks, then write the kept rows, in place."""
        if self.enter.numel():
            pool[self.enter] = 0
        if self.blk.numel():
            pool[self.blk, self.off] = rows[self.sel].to(pool.dtype)
        return pool


def scatter_block_rows(pool, block_ids, offsets, rows):
    """Write rows[i] -> pool[block_ids[i], offsets[i]] in place; out-of-
    range block ids (the allocator's sentinel) are dropped.  Distinct live
    slots never collide: their tables are disjoint by construction."""
    return RowWrites(block_ids, offsets, pool.shape[0], pool.device,
                     scrub=False).apply(pool, rows)


def scrub_blocks(pool, block_ids):
    """Zero whole blocks in place; out-of-range ids are dropped."""
    ids = _host_ids(block_ids)
    keep = ids[_live(ids, pool.shape[0])]
    if len(keep):
        pool[torch.from_numpy(keep).to(pool.device)] = 0
    return pool


def write_blocks(pool, block_ids, blocks):
    """pool[block_ids[i]] = blocks[i] in place (whole-block overwrite, the
    paged prefill's write); out-of-range ids are dropped."""
    ids = _host_ids(block_ids)
    keep = _live(ids, pool.shape[0])
    if len(keep):
        idx = torch.from_numpy(np.stack([ids[keep], keep])).to(pool.device)
        pool[idx[0]] = blocks[idx[1]].to(pool.dtype)
    return pool


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

def _plain(q, kpool, vpool, tables, pos):
    """The reference's gather fallback, batched over slots."""
    k = gather_block_rows(kpool, tables).to(torch.float32)   # (S, T, H, D)
    v = gather_block_rows(vpool, tables).to(torch.float32)
    d = q.shape[-1]
    s = torch.einsum("shd,sthd->sht", q.to(torch.float32), k) / math.sqrt(d)
    t_idx = torch.arange(k.shape[1], device=q.device)
    live = t_idx[None, None, :] <= pos.to(q.device).reshape(-1, 1, 1)
    s = torch.where(live, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("sht,sthd->shd", p, v).to(q.dtype)


def _check_cuda(q, kpool, vpool, tables, pos):
    dev = q.device
    for name, t in (("kpool", kpool), ("vpool", vpool), ("tables", tables),
                    ("pos", pos)):
        if t.device != dev:
            raise ValueError(f"paged_attention: {name} is on {t.device}, "
                             f"q on {dev}")
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool)):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"paged_attention kernel takes float32 or "
                            f"bfloat16 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention kernel needs a contiguous "
                             f"{name}")
    if kpool.dtype != vpool.dtype:
        raise TypeError(f"paged_attention: kpool is {kpool.dtype}, vpool "
                        f"{vpool.dtype}")
    for name, t in (("kpool", kpool), ("vpool", vpool)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention kernel reads {name} in "
                             "16-byte loads: its data must start 16-byte "
                             "aligned")
    for name, t in (("tables", tables), ("pos", pos)):
        if t.dtype != torch.int32:
            raise TypeError(f"paged_attention: {name} must be int32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    s, h, d = q.shape
    if kpool.shape != vpool.shape or kpool.dim() != 4 \
            or tuple(kpool.shape[2:]) != (h, d):
        raise ValueError(f"paged_attention: pools {tuple(kpool.shape)} / "
                         f"{tuple(vpool.shape)} do not match q {(s, h, d)}")
    if tables.dim() != 2 or tables.shape[0] != s or pos.shape != (s,):
        raise ValueError(f"paged_attention: tables {tuple(tables.shape)} / "
                         f"pos {tuple(pos.shape)} do not match {s} slots")
    if d % 32 or d > 256:
        raise ValueError(f"paged_attention kernel needs head_dim % 32 == 0 "
                         f"and <= 256, got {d}")
    if s > 65535:
        raise ValueError(f"paged_attention kernel: {s} slots is past its "
                         "grid (65535)")


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_void_p]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROW = 512     # most elements of one block's row: hpb * head_dim
_TILE_BYTES = 8192  # one staged K (or V) tile (the kernel's)


class Plan(NamedTuple):
    """Launch plan: ``hpb`` heads per block; each slot's live rows are cut
    evenly over ``splits`` blocks (one thread-block cluster; rank r takes
    rows [r * per, (r + 1) * per) with per = ceil(live / splits), from
    pos on the device); K and V are staged in 8 KB tiles of ``tile_rows``
    rows (twice as many in bf16 as in f32)."""
    hpb: int
    splits: int
    tile_rows: int

    def grid(self, s: int, h: int):
        return (self.splits, h // self.hpb, s)


@functools.lru_cache(maxsize=None)  # shapes repeat every call
def _plan(s: int, h: int, d: int, max_blocks: int, sms: int,
          kv_bytes: int = 4) -> Plan:
    """Up to 8 splits, one per table block (the table's width, not pos: no
    host sync), then the most heads per block that still give the card's
    ``sms`` multiprocessors >= 2 blocks each (one head when nothing
    does).  ``kv_bytes``: the pools' element size."""
    splits = min(_build.MAX_CLUSTER, max_blocks)
    fits = [c for c in (8, 4, 2, 1) if h % c == 0 and c * d <= _MAX_ROW]
    hpb = next((c for c in fits if s * (h // c) * splits >= 2 * sms), 1)
    return Plan(hpb, splits, _TILE_BYTES // (kv_bytes * hpb * d))


def _kernel(q, kpool, vpool, tables, pos):
    fn = _build.function("paged_attention", "pdt_paged_attention",
                         _ARGTYPES)
    s, h, d = q.shape
    p = _plan(s, h, d, tables.shape[1], _build.sm_count(q.device.index),
              kpool.element_size())
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
             tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
             _DTYPE_CODE[q.dtype], _DTYPE_CODE[kpool.dtype], s, h, d,
             kpool.shape[0], kpool.shape[1], tables.shape[1], p.hpb,
             p.splits, 1.0 / math.sqrt(d), stream)
    paged_attention.launches += 1
    _build.check(err, "paged_attention")
    return out


def paged_attention(q, kpool, vpool, tables, pos):
    """Decode attention for S slots: query ``q`` (S, H, D) against the
    paged KV ``kpool``/``vpool`` (num_blocks, block_size, H, D) through
    ``tables`` (S, nb) int32 block ids, with ``pos`` (S,) int32 each
    slot's write position (rows > pos are masked; the row at pos must
    already be written).  Out-of-range table entries clamp into the pool.
    q and the pools are each float32 or bfloat16 (the kernel's types);
    the math is f32.  Returns (S, H, D) in q's dtype.  CUDA tensors launch the kernel (or raise on what
    it does not take); CPU tensors take the plain version."""
    if q.device.type == "cuda":
        _check_cuda(q, kpool, vpool, tables, pos)
        if q.shape[0] == 0 or tables.shape[1] == 0:  # no rows to attend
            return torch.zeros_like(q)
        return _kernel(q, kpool, vpool, tables, pos)
    return _plain(q, kpool, vpool, tables, pos)


paged_attention.launches = 0  # kernel launches; the plain version never counts
