"""Fused training BatchNorm + activation + residual-add (+ pool epilogue).

Port of ``paddle_tpu/ops/fused_bn_act.py``.  The conv-net training step is
bound by the bytes that pass through its BatchNorm sites, so the forward
is two passes over an activation (per-channel sums, then one fused
``act(x*a + b [+ residual])``) and the backward two more (the dgamma /
dbeta sums, then one fused dx pass), with the pre-activation and its mask
recomputed from the saved input instead of being stored.

- **Kernels** (``csrc/fused_bn_act.cu``, CUDA C++ for sm_90a), each
  replacing one Pallas kernel of the reference; all are bound by bytes
  (each input read once, each output written once, at 3.35 TB/s); design
  notes in the source:

  ========================  =========================================
  ``bn_stats``  (K5)        ``_stats_kernel``: per-channel sum, sum of
                            squares; partials per chunk of rows summed
                            in a fixed order by a second small kernel
  ``bn_apply``  (K6)        ``_apply_kernel``
  ``bn_bwd_reduce`` (K7)    ``_bwd_reduce_kernel`` (partials as K5)
  ``bn_bwd_dx`` (K8)        ``_bwd_dx_kernel``
  ``bn_pool_apply`` (K9)    ``_pool_apply_kernel``: the ring route
                            streams each image's input rows once
                            through a ring of row slots in shared
                            memory (bulk copies on mbarriers), applies
                            the affine and activation once per element
                            and pools from the slots; rows too large
                            for the ring take the window route, one
                            thread per pooled output
  ========================  =========================================

  Each wrapper launches its kernel for CUDA tensors (or raises on what the
  kernel does not take) and takes its plain PyTorch version (``_plain_*``)
  only for CPU tensors.  ``<wrapper>.launches`` counts kernel launches;
  ``<wrapper>.calls`` counts every call, plain versions included;
  ``bn_pool_apply.routes`` counts K9's launches by route.  Unlike
  the TPU kernels, these take any M and C: the kernels mask the ragged
  edge, so the reference's VMEM gates (``_block_m``'s divisor rule, the
  block-size caps) have no counterpart.
- **Data** is the channels-last ``(M, C) = (N*H*W, C)`` view of an
  activation.  A logical NCHW tensor in ``torch.channels_last`` memory
  gives it without a copy; any other layout is copied once, and the
  entry points count such copies (``bn_act_train.relayouts`` and its two
  siblings), forward and backward.
- **float16** data goes to the plain composites (``bn_act_reference`` and
  its siblings) on every device, as the reference's gates send everything
  but f32 and bf16 to its jnp composite; ``bn_act_train.composite_calls``
  and its siblings' count those calls.
- **Autograd**: ``bn_act_train`` and ``bn2_act_train`` are
  ``torch.autograd.Function``s over K5 + K6 (forward) and K7 + K8
  (backward), folding the gradients of the returned mean and variance into
  the dx coefficients as the reference's ``_bn_act_bwd`` /
  ``_bn2_act_bwd`` do.  ``bn_act_pool_train`` runs K5 + K9 forward; its
  backward recomputes from the saved input through plain differentiable
  tensor code, because the reference's own backward there
  (``_bn_pool_bwd``) is plain jnp, not a Pallas kernel.
- The per-channel math (mean, variance, invstd, the ``(8, C)`` coefficient
  rows) is plain tensor code, as in the reference.  The variance is the
  reference's one-pass ``max(E[x^2] - mean^2, 0)``.
- **Statistics over ranks.** Inside ``stats_group(group)`` (a
  ``torch.distributed`` group; ``parallel.ShardedTrainStep`` and
  ``nn.SyncBatchNorm`` enter it) the statistics are the whole batch's
  over the group's ranks, as the reference's sharded step computes them
  over its global array: K5's column sums, sums of squares and row
  counts are summed over the group (one all-reduce per site, both BNs of
  a dual site together) before K6 or K9 read them, and K7's two sums,
  with the returned mean's and variance's gradients, before K8 reads
  them.  The gamma / beta gradients stay the rank's own sums: the data
  parallel step averages them.  The pooled site's backward recomputes
  through the plain references, whose statistics then go through a
  differentiable all-reduce (its backward all-reduces the gradients).
  Each all-reduce of statistics counts on ``stats_group.all_reduces``.
  The group is kept by each autograd node, so an eager backward outside
  the block still reduces over it.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch
import torch.distributed as dist

from . import _build

__all__ = ["bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx",
           "bn_pool_apply", "bn_act_reference", "bn2_act_reference",
           "bn_act_pool_reference", "bn_act_train", "bn2_act_train",
           "bn_act_pool_train", "fusable_pool_spec", "stats_group"]

_ACTS = (None, "relu", "relu6")
_ACT_CODE = {None: 0, "relu": 1, "relu6": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256                 # threads per block (kThreads in the source)
_TARGET_BLOCKS = 132 * 8       # 132 SMs x 8 resident blocks of 256 threads


# ---------------------------------------------------------------------------
# activations and the per-channel coefficients
# ---------------------------------------------------------------------------

def _act_apply(z, act):
    """The activation as the TPU kernels apply it (``jnp.maximum`` /
    ``jnp.clip``: NaN passes)."""
    if act == "relu":
        return torch.relu(z)
    if act == "relu6":
        return torch.clamp(z, 0.0, 6.0)
    return z


def _act_mask(z, act):
    if act == "relu":
        return z > 0.0
    if act == "relu6":
        return (z > 0.0) & (z < 6.0)
    return None


def _coef(mean, invstd, gamma, beta, A=None, B=None, Cc=None):
    """The (8, C) f32 rows a, b, mean, invstd, A, B, Cc, 0."""
    a = gamma.float() * invstd
    b = beta.float() - mean * a
    zero = torch.zeros_like(mean)
    rows = [a, b, mean, invstd, zero if A is None else A,
            zero if B is None else B, zero if Cc is None else Cc, zero]
    return torch.stack([r.float() for r in rows])


# ---------------------------------------------------------------------------
# statistics over the ranks of a process group
# ---------------------------------------------------------------------------

_STATS_GROUP = None


@contextlib.contextmanager
def stats_group(group):
    """BatchNorm batch statistics over every rank of ``group`` inside the
    block (None: each rank's own)."""
    global _STATS_GROUP
    old, _STATS_GROUP = _STATS_GROUP, group
    try:
        yield
    finally:
        _STATS_GROUP = old


stats_group.all_reduces = 0   # statistics all-reduces launched


def _group_sums(group, *ts):
    """The tensors summed over ``group``: one all-reduce of their f64
    concatenation (the row counts stay exact), each back in f32."""
    flat = torch.cat([t.reshape(-1).double() for t in ts])
    dist.all_reduce(flat, group=group)
    stats_group.all_reduces += 1
    return [v.view(t.shape).float()
            for v, t in zip(flat.split([t.numel() for t in ts]), ts)]


def _count(m: int, like):
    return torch.full((1,), float(m), dtype=torch.float32, device=like.device)


def _site_stats(group, m: int, *sums):
    """(sums, row count) over the group: the rank's own without one."""
    if group is None:
        return list(sums), m
    out = _group_sums(group, *sums, _count(m, sums[0]))
    return out[:-1], out[-1]


def _stats_of(s, sq, m, eps: float):
    """(mean, var, invstd) from the column sums, the reference's one-pass
    variance."""
    mean = s / m
    var = torch.clamp_min(sq / m - mean * mean, 0.0)
    return mean, var, torch.rsqrt(var + eps)


def _dx_coef(c1, sgz, sgzx, invstd, mean, gmean, gvar, m: int):
    """dx = A*gz + B + Cc*x, with the gradients of the returned mean and
    variance folded in (the reference's ``_dx_coef``)."""
    k = -c1 * sgzx * invstd / m + 2.0 * gvar.float() / m
    B = -c1 * sgz / m + gmean.float() / m - k * mean
    return c1, B, k


# ---------------------------------------------------------------------------
# plain versions of the kernels (CPU tensors, and the card's comparisons)
# ---------------------------------------------------------------------------

def _z(x2, coef, res2, coefr):
    z = x2.float() * coef[0] + coef[1]
    if res2 is not None:
        r = res2.float()
        z = z + (r * coefr[0] + coefr[1] if coefr is not None else r)
    return z


def _plain_stats(x2):
    xf = x2.float()
    return xf.sum(0), (xf * xf).sum(0)


def _plain_apply(x2, coef, res2, act, coefr=None):
    return _act_apply(_z(x2, coef, res2, coefr), act).to(x2.dtype)


def _gz(g2, x2, coef, res2, act, coefr):
    gz = g2.float()
    if act is not None:
        gz = torch.where(_act_mask(_z(x2, coef, res2, coefr), act), gz, 0.0)
    return gz


def _plain_bwd_reduce(g2, x2, coef, res2, act, coefr=None):
    gz = _gz(g2, x2, coef, res2, act, coefr)
    out = [gz.sum(0), (gz * ((x2.float() - coef[2]) * coef[3])).sum(0)]
    if coefr is not None:
        out.append((gz * ((res2.float() - coefr[2]) * coefr[3])).sum(0))
    return tuple(out)


def _plain_bwd_dx(g2, x2, coef, res2, act, coefr=None):
    gz = _gz(g2, x2, coef, res2, act, coefr)
    dx = (coef[4] * gz + coef[5] + coef[6] * x2.float()).to(x2.dtype)
    if res2 is None:
        return dx, None
    if coefr is not None:
        dres = coefr[4] * gz + coefr[5] + coefr[6] * res2.float()
    else:
        dres = gz
    return dx, dres.to(res2.dtype)


def _pool2d(y, kind, k, s, p, channel_last):
    """torch pooling of a rank-4 tensor, exclusive avg counting; channel
    axis last when ``channel_last``."""
    if channel_last:
        y = y.permute(0, 3, 1, 2)
    if kind == "max":
        out = torch.nn.functional.max_pool2d(y, k, s, p)
    else:
        out = torch.nn.functional.avg_pool2d(y, k, s, p,
                                             count_include_pad=False)
    return out.permute(0, 2, 3, 1) if channel_last else out


def _plain_pool_apply(x4, coef, act, kind, k, s, p):
    z = _act_apply(x4.float() * coef[0] + coef[1], act)
    return _pool2d(z, kind, k, s, p, channel_last=True).to(x4.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_GRID = [_I] * 7                       # M, C, tpr, rows, c_tiles, chunks,
_STATS_ARGS = [_P] * 3 + [_I] + _GRID + [_I, _P]   # chunk_rows; vec, stream
_APPLY_ARGS = [_P] * 5 + [_I] * 3 + _GRID + [_I, _P]
_REDUCE_ARGS = [_P] * 7 + [_I] * 3 + _GRID + [_I, _P]
_DX_ARGS = [_P] * 7 + [_I] * 3 + _GRID + [_I, _P]
_POOL_ARGS = [_P] * 3 + [_I] * 16 + [_P]
_RING_ARGS = [_P] * 3 + [_I] * 21 + [_P]
POOL_PER_SM = 2           # resident ring blocks per SM (kPoolThreads 256)
_RESERVED = 1024          # shared memory per block taken by the runtime
RING_DEPTH = 6            # row slots, where they fit


def _tiling(m: int, c: int, v: int):
    """(tpr, rows, c_tiles, chunks, chunk_rows) of the 2-D tiling of K5-K8:
    tpr threads of a block walk one row's channel groups of v channels
    (tpr a power of two up to a warp), rows = 256 / tpr rows at a time;
    the rows are cut into chunks so that the grid (c_tiles, chunks) holds
    about _TARGET_BLOCKS blocks."""
    groups = -(-c // v)
    tpr = min(32, 1 << (groups - 1).bit_length())
    rows = _THREADS // tpr
    c_tiles = -(-groups // tpr)
    chunks = max(1, min(-(-m // rows), -(-_TARGET_BLOCKS // c_tiles)))
    chunk_rows = -(-(-(-m // chunks)) // rows) * rows
    return tpr, rows, c_tiles, -(-m // chunk_rows), chunk_rows


def _check(name: str, x2, *others):
    """Raise on what the kernels do not take; returns (dtype code, vec):
    vec when C is a multiple of the 16-byte vector and every row tensor
    starts 16-byte aligned."""
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 data, got "
                        f"{x2.dtype}")
    if x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous (M, C) view")
    if x2.shape[0] == 0 or x2.shape[1] == 0:
        raise ValueError(f"{name} kernel: empty input {tuple(x2.shape)}")
    for t in others:
        if t is None:
            continue
        if t.device != x2.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x2.device}")
        if t.dtype != x2.dtype or t.shape != x2.shape or \
                not t.is_contiguous():
            raise ValueError(f"{name}: every row tensor must be a contiguous "
                             f"{x2.dtype} {tuple(x2.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    v = 16 // x2.element_size()
    vec = x2.shape[1] % v == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x2,) + others if t is not None)
    return _DTYPE_CODE[x2.dtype], vec


def _check_coef(name: str, c: int, dev, *coefs):
    for cf in coefs:
        if cf is None:
            continue
        if cf.dtype != torch.float32 or tuple(cf.shape) != (8, c) or \
                not cf.is_contiguous() or cf.device != dev:
            raise ValueError(f"{name}: coef must be a contiguous float32 "
                             f"(8, {c}) on {dev}")


def _res_mode(res2, coefr) -> int:
    if res2 is None:
        if coefr is not None:
            raise ValueError("a residual coef without a residual")
        return 0
    return 2 if coefr is not None else 1


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _grid_args(x2):
    m, c = x2.shape
    return (m, c) + _tiling(m, c, 16 // x2.element_size())


def _ptr(t):
    return None if t is None else t.data_ptr()


def bn_stats(x2):
    """K5: per-channel (sum, sum of squares) of x2 (M, C), both (C,) f32."""
    bn_stats.calls += 1
    if x2.device.type != "cuda":
        return _plain_stats(x2)
    dt, vec = _check("bn_stats", x2)
    grid = _grid_args(x2)
    c = grid[1]
    part = torch.empty((grid[5], 2, c), dtype=torch.float32,
                       device=x2.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    fn = _build.function("fused_bn_act", "pdt_bn_stats", _STATS_ARGS)
    err = fn(x2.data_ptr(), part.data_ptr(), out.data_ptr(), dt, *grid,
             int(vec), _stream(x2))
    bn_stats.launches += 1
    _build.check(err, "bn_stats")
    return out[0], out[1]


def bn_apply(x2, coef, res2=None, act=None, coefr=None):
    """K6: act(x2*a + b [+ res2 | + res2*ar + br]) in x2's dtype."""
    bn_apply.calls += 1
    if x2.device.type != "cuda":
        return _plain_apply(x2, coef, res2, act, coefr)
    dt, vec = _check("bn_apply", x2, res2)
    _check_coef("bn_apply", x2.shape[1], x2.device, coef, coefr)
    mode = _res_mode(res2, coefr)
    y = torch.empty_like(x2)
    fn = _build.function("fused_bn_act", "pdt_bn_apply", _APPLY_ARGS)
    err = fn(x2.data_ptr(), coef.data_ptr(), _ptr(res2), _ptr(coefr),
             y.data_ptr(), dt, _ACT_CODE[act], mode, *_grid_args(x2),
             int(vec), _stream(x2))
    bn_apply.launches += 1
    _build.check(err, "bn_apply")
    return y


def bn_bwd_reduce(g2, x2, coef, res2=None, act=None, coefr=None):
    """K7: (sum gz, sum gz*xhat[, sum gz*rhat]) as (C,) f32, gz the
    gradient through the activation's mask recomputed from x2 (and
    res2)."""
    bn_bwd_reduce.calls += 1
    if x2.device.type != "cuda":
        return _plain_bwd_reduce(g2, x2, coef, res2, act, coefr)
    dt, vec = _check("bn_bwd_reduce", x2, g2, res2)
    c = x2.shape[1]
    _check_coef("bn_bwd_reduce", c, x2.device, coef, coefr)
    mode = _res_mode(res2, coefr)
    nout = 3 if mode == 2 else 2
    grid = _grid_args(x2)
    part = torch.empty((grid[5], nout, c), dtype=torch.float32,
                       device=x2.device)
    out = torch.empty((nout, c), dtype=torch.float32, device=x2.device)
    fn = _build.function("fused_bn_act", "pdt_bn_bwd_reduce", _REDUCE_ARGS)
    err = fn(g2.data_ptr(), x2.data_ptr(), coef.data_ptr(), _ptr(res2),
             _ptr(coefr), part.data_ptr(), out.data_ptr(), dt,
             _ACT_CODE[act], mode, *grid, int(vec), _stream(x2))
    bn_bwd_reduce.launches += 1
    _build.check(err, "bn_bwd_reduce")
    return tuple(out.unbind(0))


def bn_bwd_dx(g2, x2, coef, res2=None, act=None, coefr=None):
    """K8: (dx, dres): dx = A*gz + B + Cc*x from coef rows 4-6; dres = gz,
    or the residual coef's own A, B, Cc form (dual); None without a
    residual."""
    bn_bwd_dx.calls += 1
    if x2.device.type != "cuda":
        return _plain_bwd_dx(g2, x2, coef, res2, act, coefr)
    dt, vec = _check("bn_bwd_dx", x2, g2, res2)
    _check_coef("bn_bwd_dx", x2.shape[1], x2.device, coef, coefr)
    mode = _res_mode(res2, coefr)
    dx = torch.empty_like(x2)
    dres = None if res2 is None else torch.empty_like(res2)
    fn = _build.function("fused_bn_act", "pdt_bn_bwd_dx", _DX_ARGS)
    err = fn(g2.data_ptr(), x2.data_ptr(), coef.data_ptr(), _ptr(res2),
             _ptr(coefr), dx.data_ptr(), _ptr(dres), dt, _ACT_CODE[act],
             mode, *_grid_args(x2), int(vec), _stream(x2))
    bn_bwd_dx.launches += 1
    _build.check(err, "bn_bwd_dx")
    return dx, dres


def _pool_out(h: int, w: int, k, s, p):
    return ((h + 2 * p[0] - k[0]) // s[0] + 1,
            (w + 2 * p[1] - k[1]) // s[1] + 1)


class PoolPlan(NamedTuple):
    """K9's launch: ``route`` "ring" (``ring`` row slots of
    ``slot_elems`` elements each, ``band`` output rows per work item,
    ``grid`` persistent blocks, POOL_PER_SM of them resident per SM) or
    "window"."""
    route: str
    ring: int = 0
    slot_elems: int = 0
    band: int = 0
    grid: int = 0


def _ring_smem(ring: int, slot_bytes: int, c: int) -> int:
    """Dynamic shared memory of a ring block: the mbarriers (8 bytes a
    slot, in whole 128 bytes: ring_bar_bytes), the slots, the
    coefficients."""
    return -(-8 * ring // 128) * 128 + ring * slot_bytes + 8 * c


@functools.lru_cache(maxsize=None)  # shapes repeat every step
def _pool_plan(n: int, h: int, w: int, c: int, elem: int, kind: str, k, s,
               p, sms: int, smem) -> PoolPlan:
    """The ring needs kh + max(kh, sh) row slots (see the kernel); it
    takes max(RING_DEPTH, that) where they fit POOL_PER_SM blocks into an
    SM's shared memory (``smem``: per SM, most per block), else as many as
    fit, else the window route.  A bf16 average takes the window route:
    the slots hold act(x*a + b) rounded to bf16, and the average must sum
    the unrounded values (the max of rounded values is the rounded max).
    A block takes whole images where there are as many images as resident
    blocks, else bands of rows that give every block work.  (At the stem,
    two blocks of 256 threads with 6 slots and whole images beat blocks of
    128 or 512 threads, one block per SM, deeper rings and bands of 28, 14
    or 8 rows in an A/B on the card.)"""
    if kind == "avg" and elem == 2:
        return PoolPlan("window")
    ho, _ = _pool_out(h, w, k, s, p)
    slot_bytes = -(-w * c * elem // 128) * 128
    budget = min(smem[0] // POOL_PER_SM - _RESERVED, smem[1])
    least = k[0] + max(k[0], s[0])
    depth = max(RING_DEPTH, least)
    while depth >= least and _ring_smem(depth, slot_bytes, c) > budget:
        depth -= 1
    if depth < least:
        return PoolPlan("window")
    blocks = POOL_PER_SM * sms
    band = -(-ho // min(ho, max(1, blocks // n)))
    items = n * -(-ho // band)
    return PoolPlan("ring", depth, slot_bytes // elem, band,
                    min(items, blocks))


def _pool_args(x4, coef, act, kind, k, s, p):
    """Checks; (y, arguments the two routes share, vec, dtype code)."""
    if x4.dim() != 4:
        raise ValueError("bn_pool_apply kernel takes (N, H, W, C)")
    n, h, w, c = x4.shape
    dt, vec = _check("bn_pool_apply", x4.view(-1, c))
    _check_coef("bn_pool_apply", c, x4.device, coef)
    ho, wo = _pool_out(h, w, k, s, p)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"bn_pool_apply: empty output for {h}x{w} and "
                         f"pool {k} {s} {p}")
    y = torch.empty((n, ho, wo, c), dtype=x4.dtype, device=x4.device)
    shape = (n, h, w, c, ho, wo, k[0], k[1], s[0], s[1], p[0], p[1])
    return y, (_ACT_CODE[act], 0 if kind == "max" else 1) + shape, vec, dt


def _pool_window(x4, coef, act, kind, k, s, p):
    """K9's window route: one thread per pooled output."""
    y, args, vec, dt = _pool_args(x4, coef, act, kind, k, s, p)
    fn = _build.function("fused_bn_act", "pdt_bn_pool_apply", _POOL_ARGS)
    err = fn(x4.data_ptr(), coef.data_ptr(), y.data_ptr(), dt, *args,
             int(vec), _stream(x4))
    bn_pool_apply.launches += 1
    bn_pool_apply.routes["window"] += 1
    _build.check(err, "bn_pool_apply")
    return y


def _pool_ring(x4, coef, act, kind, k, s, p, plan: PoolPlan):
    """K9's ring route under ``plan``."""
    y, args, vec, dt = _pool_args(x4, coef, act, kind, k, s, p)
    row_bytes = x4.shape[2] * x4.shape[3] * x4.element_size()
    tma = x4.data_ptr() % 16 == 0 and row_bytes % 16 == 0
    fn = _build.function("fused_bn_act", "pdt_bn_pool_ring", _RING_ARGS)
    err = fn(x4.data_ptr(), coef.data_ptr(), y.data_ptr(), dt, *args,
             plan.ring, plan.slot_elems, plan.band, plan.grid, int(tma),
             int(vec), _stream(x4))
    bn_pool_apply.launches += 1
    bn_pool_apply.routes["ring"] += 1
    _build.check(err, "bn_pool_apply")
    return y


def bn_pool_apply(x4, coef, act, kind, k, s, p):
    """K9: per-image pool(act(x4*a + b)) of x4 (N, H, W, C), max or
    exclusive avg, padding applied after the activation; (N, Ho, Wo, C)
    in x4's dtype.  On the card the ring route, or the window route for
    rows the ring cannot hold and for a bf16 average
    (``bn_pool_apply.routes`` counts both)."""
    bn_pool_apply.calls += 1
    if x4.device.type != "cuda":
        return _plain_pool_apply(x4, coef, act, kind, k, s, p)
    if x4.dim() != 4:
        raise ValueError("bn_pool_apply kernel takes (N, H, W, C)")
    n, h, w, c = x4.shape
    dev = x4.device.index
    plan = _pool_plan(n, h, w, c, x4.element_size(), kind, tuple(k),
                      tuple(s), tuple(p), _build.sm_count(dev),
                      _build.smem_limits(dev))
    if plan.route == "window":
        return _pool_window(x4, coef, act, kind, k, s, p)
    return _pool_ring(x4, coef, act, kind, k, s, p, plan)


for _w in (bn_stats, bn_apply, bn_bwd_reduce, bn_bwd_dx, bn_pool_apply):
    _w.launches = 0   # kernel launches; the plain versions never count
    _w.calls = 0      # every call, plain versions included
bn_pool_apply.routes = {"ring": 0, "window": 0}   # K9 launches by route


# ---------------------------------------------------------------------------
# layouts: the (M, C) rows of a channels-last activation
# ---------------------------------------------------------------------------

def _rows(t, channel_last: bool, counter):
    """The (M, C) view of t's channels-last data: a view when t is laid
    out channels-last (channel_last: t is (N, ..., C) contiguous; else t
    is (N, C, ...) in channels-last memory), else one copy, counted on
    ``counter.relayouts``."""
    moved = t if channel_last else t.movedim(1, -1)
    if not moved.is_contiguous():
        moved = moved.contiguous()
        counter.relayouts += 1
    return moved.view(-1, moved.shape[-1])


def _unrows(t2, shape, channel_last: bool):
    """Inverse of ``_rows`` for a tensor of logical ``shape``."""
    if t2 is None:
        return None
    if channel_last:
        return t2.view(shape)
    moved = list(shape)
    moved.append(moved.pop(1))
    return t2.view(moved).movedim(-1, 1)


# ---------------------------------------------------------------------------
# plain references (pure torch, any channel axis, differentiable): the test
# oracle and the pooled backward's recompute
# ---------------------------------------------------------------------------

def _ref_stats(x, axes):
    xf = x.float()
    if _STATS_GROUP is not None:
        return group_stats(xf, axes, _STATS_GROUP)
    mean = xf.mean(axes)
    return mean, torch.clamp_min((xf * xf).mean(axes) - mean * mean, 0.0)


class _AllReduceSum(torch.autograd.Function):
    """The sum over ``group``; its backward sums the gradients over the
    group as well (every rank's loss depends on every rank's sums)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def group_stats(xf, axes, group):
    """(mean, one-pass variance) of f32 ``xf`` over ``axes`` and over the
    ranks of ``group``: the sums, sums of squares and row count go through
    one differentiable all-reduce (its backward sums the gradients over
    the ranks)."""
    n = 1
    for a in axes:
        n *= xf.shape[a]
    c = xf.numel() // n
    tot = _AllReduceSum.apply(torch.cat([
        xf.sum(axes).reshape(-1).double(),
        (xf * xf).sum(axes).reshape(-1).double(),
        _count(n, xf).double()]), group)
    stats_group.all_reduces += 1
    m = tot[-1].float()
    mean = (tot[:c].float() / m).reshape(xf.sum(axes).shape)
    msq = (tot[c:2 * c].float() / m).reshape(mean.shape)
    return mean, torch.clamp_min(msq - mean * mean, 0.0)


def _bshape(x, ch):
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    return shape


def bn_act_reference(x, gamma, beta, eps=1e-5, act=None, residual=None,
                     channel_axis=-1):
    """(y, batch_mean, batch_var): f32 statistics, biased variance."""
    ch = channel_axis % x.dim()
    axes = tuple(i for i in range(x.dim()) if i != ch)
    mean, var = _ref_stats(x, axes)
    shape = _bshape(x, ch)
    a = (gamma.float() * torch.rsqrt(var + eps)).reshape(shape)
    b = beta.float().reshape(shape) - mean.reshape(shape) * a
    z = x.float() * a + b
    if residual is not None:
        z = z + residual.float()
    return _act_apply(z, act).to(x.dtype), mean, var


def bn2_act_reference(x, gamma_x, beta_x, res, gamma_r, beta_r, eps=1e-5,
                      act=None, channel_axis=-1):
    """(y, mean_x, var_x, mean_r, var_r) of act(bn(x) + bn(res))."""
    ch = channel_axis % x.dim()
    axes = tuple(i for i in range(x.dim()) if i != ch)
    shape = _bshape(x, ch)

    def affine(v, gamma, beta):
        mean, var = _ref_stats(v, axes)
        a = (gamma.float() * torch.rsqrt(var + eps)).reshape(shape)
        b = beta.float().reshape(shape) - mean.reshape(shape) * a
        return v.float() * a + b, mean, var

    zx, mean_x, var_x = affine(x, gamma_x, beta_x)
    zr, mean_r, var_r = affine(res, gamma_r, beta_r)
    return (_act_apply(zx + zr, act).to(x.dtype), mean_x, var_x,
            mean_r, var_r)


def _pool_norm(pool):
    """A pool spec as (kind, (kh, kw), (sh, sw), (ph, pw))."""
    kind, k, s, p = pool

    def pair(v):
        return tuple(int(i) for i in v) if isinstance(v, (tuple, list)) \
            else (int(v), int(v))
    if kind not in ("max", "avg"):
        raise ValueError(f"fused pool: unsupported kind {kind!r}")
    return (kind, pair(k), pair(s if s is not None else k), pair(p))


def fusable_pool_spec(layer, data_format="NCHW"):
    """(kind, kernel, stride, padding) when ``layer`` is a stock MaxPool2D
    the fused BN/act epilogue can express (exact type, no ceil_mode /
    return_mask, no hooks, the norm's data_format, an int or per-axis
    padding), else None: the caller then runs the layer itself."""
    from ..nn.layer.pooling import MaxPool2D
    if type(layer) is not MaxPool2D:
        return None
    if layer.data_format != data_format or layer.ceil_mode or \
            layer.return_mask:
        return None
    if layer._forward_pre_hooks or layer._forward_hooks:
        return None
    p = layer.padding
    if isinstance(p, str) or (isinstance(p, (list, tuple)) and len(p) != 2):
        return None   # "SAME" / "VALID" or [lo, hi, ...]: the layer runs
    return ("max", layer.kernel_size,
            layer.stride if layer.stride is not None else layer.kernel_size,
            layer.padding)


def bn_act_pool_reference(x, gamma, beta, eps, act, pool, channel_axis=-1):
    """(pooled_y, batch_mean, batch_var): plain and differentiable."""
    kind, k, s, p = _pool_norm(pool)
    y, mean, var = bn_act_reference(x, gamma, beta, eps, act, None,
                                    channel_axis)
    channel_last = channel_axis % x.dim() == x.dim() - 1
    # max pool is exact in the storage dtype; avg accumulates in f32
    pdt = torch.float32 if (kind == "avg" or y.dtype == torch.float32) \
        else y.dtype
    yp = _pool2d(y.to(pdt), kind, k, s, p, channel_last)
    return yp.to(x.dtype), mean, var


# ---------------------------------------------------------------------------
# autograd Functions and the public entries
# ---------------------------------------------------------------------------

class _BnAct(torch.autograd.Function):
    """K5 + K6 forward, K7 + K8 backward."""

    @staticmethod
    def forward(ctx, x, gamma, beta, residual, eps, act, channel_last):
        x2 = _rows(x, channel_last, bn_act_train)
        res2 = (None if residual is None
                else _rows(residual, channel_last, bn_act_train))
        group = _STATS_GROUP
        (s, sq), m = _site_stats(group, x2.shape[0], *bn_stats(x2))
        mean, var, invstd = _stats_of(s, sq, m, eps)
        y2 = bn_apply(x2, _coef(mean, invstd, gamma, beta), res2, act)
        ctx.save_for_backward(x2, gamma, beta, res2, mean, invstd)
        ctx.cfg = (act, channel_last, x.shape, group, m)
        return _unrows(y2, x.shape, channel_last), mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x2, gamma, beta, res2, mean, invstd = ctx.saved_tensors
        act, channel_last, shape, group, m = ctx.cfg
        g2 = _rows(gy, channel_last, bn_act_train)
        gammaf = gamma.float()
        coef = _coef(mean, invstd, gammaf, beta)
        sgz, sgzx = bn_bwd_reduce(g2, x2, coef, res2, act)
        tz, tzx, gmean, gvar = ((sgz, sgzx, gmean, gvar) if group is None
                                else _group_sums(group, sgz, sgzx, gmean,
                                                 gvar))
        A, B, Cc = _dx_coef(gammaf * invstd, tz, tzx, invstd, mean, gmean,
                            gvar, m)
        dx2, dres2 = bn_bwd_dx(g2, x2, _coef(mean, invstd, gammaf, beta, A,
                                             B, Cc), res2, act)
        return (_unrows(dx2, shape, channel_last), sgzx.to(gamma.dtype),
                sgz.to(beta.dtype), _unrows(dres2, shape, channel_last),
                None, None, None)


class _Bn2Act(torch.autograd.Function):
    """The dual form: two K5 and one K6 forward, K7 + K8 backward."""

    @staticmethod
    def forward(ctx, x, gamma_x, beta_x, res, gamma_r, beta_r, eps, act,
                channel_last):
        x2 = _rows(x, channel_last, bn2_act_train)
        r2 = _rows(res, channel_last, bn2_act_train)
        group = _STATS_GROUP
        (sx, sqx, sr, sqr), m = _site_stats(group, x2.shape[0],
                                            *bn_stats(x2), *bn_stats(r2))
        mean_x, var_x, inv_x = _stats_of(sx, sqx, m, eps)
        mean_r, var_r, inv_r = _stats_of(sr, sqr, m, eps)
        y2 = bn_apply(x2, _coef(mean_x, inv_x, gamma_x, beta_x), r2, act,
                      _coef(mean_r, inv_r, gamma_r, beta_r))
        ctx.save_for_backward(x2, gamma_x, beta_x, r2, gamma_r, beta_r,
                              mean_x, inv_x, mean_r, inv_r)
        ctx.cfg = (act, channel_last, x.shape, group, m)
        return (_unrows(y2, x.shape, channel_last), mean_x, var_x, mean_r,
                var_r)

    @staticmethod
    def backward(ctx, gy, gmx, gvx, gmr, gvr):
        (x2, gamma_x, beta_x, r2, gamma_r, beta_r, mean_x, inv_x, mean_r,
         inv_r) = ctx.saved_tensors
        act, channel_last, shape, group, m = ctx.cfg
        g2 = _rows(gy, channel_last, bn2_act_train)
        gxf, grf = gamma_x.float(), gamma_r.float()
        coef_x = _coef(mean_x, inv_x, gxf, beta_x)
        coef_r = _coef(mean_r, inv_r, grf, beta_r)
        sgz, sgzx, sgzr = bn_bwd_reduce(g2, x2, coef_x, r2, act, coef_r)
        tz, tzx, tzr = sgz, sgzx, sgzr
        if group is not None:
            tz, tzx, tzr, gmx, gvx, gmr, gvr = _group_sums(
                group, sgz, sgzx, sgzr, gmx, gvx, gmr, gvr)
        Ax, Bx, Cx = _dx_coef(gxf * inv_x, tz, tzx, inv_x, mean_x, gmx,
                              gvx, m)
        Ar, Br, Cr = _dx_coef(grf * inv_r, tz, tzr, inv_r, mean_r, gmr,
                              gvr, m)
        dx2, dr2 = bn_bwd_dx(
            g2, x2, _coef(mean_x, inv_x, gxf, beta_x, Ax, Bx, Cx), r2, act,
            _coef(mean_r, inv_r, grf, beta_r, Ar, Br, Cr))
        return (_unrows(dx2, shape, channel_last), sgzx.to(gamma_x.dtype),
                sgz.to(beta_x.dtype), _unrows(dr2, shape, channel_last),
                sgzr.to(gamma_r.dtype), sgz.to(beta_r.dtype), None, None,
                None)


class _BnPool(torch.autograd.Function):
    """K5 + K9 forward; the backward recomputes from the saved input
    through plain differentiable tensor code, as the reference's
    ``_bn_pool_bwd`` (plain jnp, no Pallas kernel) does."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, act, pool, channel_last):
        kind, k, s, p = pool
        x4 = x if channel_last else x.permute(0, 2, 3, 1)
        if not x4.is_contiguous():
            x4 = x4.contiguous()
            bn_act_pool_train.relayouts += 1
        n, h, w, c = x4.shape
        group = _STATS_GROUP
        (sm, sq), m = _site_stats(group, n * h * w, *bn_stats(x4.view(-1, c)))
        mean, var, invstd = _stats_of(sm, sq, m, eps)
        y4 = bn_pool_apply(x4, _coef(mean, invstd, gamma, beta), act, kind,
                           k, s, p)
        ctx.save_for_backward(x, gamma, beta)
        ctx.cfg = (eps, act, pool, -1 if channel_last else 1, group)
        return (y4 if channel_last else y4.permute(0, 3, 1, 2)), mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        eps, act, pool, ch, group = ctx.cfg
        # a profiler range: the step's profile reports this recompute apart
        with torch.profiler.record_function("bn_pool_backward"), \
                torch.enable_grad(), stats_group(group):
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            outs = bn_act_pool_reference(*ins, eps, act, pool, ch)
            grads = torch.autograd.grad(outs, ins, (gy, gmean, gvar),
                                        allow_unused=True)
        return (*grads, None, None, None, None)


def _check_act(name, act):
    if act not in _ACTS:
        raise ValueError(f"{name}: unsupported activation {act!r}")


def bn_act_train(x, gamma, beta, eps=1e-5, act=None, residual=None,
                 channel_last=True):
    """Fused training BatchNorm + optional residual-add + activation.

    x: (N, ..., C) when channel_last, else (N, C, ...) (the kernels then
    read it through torch.channels_last memory); gamma/beta (C,); residual
    the shape of x or None; act in {None, "relu", "relu6"}.  Returns (y,
    batch_mean_f32, batch_var_f32).  CUDA tensors run the kernels K5-K8,
    CPU tensors their plain versions; data of another dtype than f32 and
    bf16 takes the composite (``bn_act_reference``), as the reference's
    gate does."""
    _check_act("bn_act_train", act)
    if residual is not None:
        if residual.shape != x.shape:
            raise ValueError("bn_act_train: residual shape must match x "
                             f"({tuple(residual.shape)} vs {tuple(x.shape)})")
        residual = residual.to(x.dtype)
    if x.dtype not in _DTYPE_CODE:
        bn_act_train.composite_calls += 1
        return bn_act_reference(x, gamma, beta, eps, act, residual,
                                -1 if channel_last else 1)
    return _BnAct.apply(x, gamma, beta, residual, float(eps), act,
                        bool(channel_last))


def bn2_act_train(x, gamma_x, beta_x, res, gamma_r, beta_r, eps=1e-5,
                  act=None, channel_last=True):
    """Fused dual training-BN + add + activation: act(bn(x) + bn(res)).
    Returns (y, mean_x, var_x, mean_r, var_r).  Data of another dtype than
    f32 and bf16 takes the composite (``bn2_act_reference``)."""
    _check_act("bn2_act_train", act)
    if res.shape != x.shape:
        raise ValueError("bn2_act_train: residual shape must match x "
                         f"({tuple(res.shape)} vs {tuple(x.shape)})")
    if x.dtype not in _DTYPE_CODE:
        bn2_act_train.composite_calls += 1
        return bn2_act_reference(x, gamma_x, beta_x, res.to(x.dtype),
                                 gamma_r, beta_r, eps, act,
                                 -1 if channel_last else 1)
    return _Bn2Act.apply(x, gamma_x, beta_x, res.to(x.dtype), gamma_r,
                         beta_r, float(eps), act, bool(channel_last))


def bn_act_pool_train(x, gamma, beta, eps=1e-5, act=None,
                      pool=("max", 3, 2, 1), channel_last=True):
    """Fused training BatchNorm + activation + 2D max/avg pool.

    x: (N, H, W, C) when channel_last else (N, C, H, W); pool is (kind,
    kernel, stride, padding) with scalar-or-pair ints.  Returns
    (pooled_y, batch_mean_f32, batch_var_f32); only the pooled output is
    written.  Data of another dtype than f32 and bf16 takes the composite
    (``bn_act_pool_reference``)."""
    _check_act("bn_act_pool_train", act)
    if x.dim() != 4:
        raise ValueError("bn_act_pool_train takes a rank-4 input")
    if x.dtype not in _DTYPE_CODE:
        bn_act_pool_train.composite_calls += 1
        return bn_act_pool_reference(x, gamma, beta, float(eps), act,
                                     _pool_norm(pool),
                                     -1 if channel_last else 1)
    return _BnPool.apply(x, gamma, beta, float(eps), act, _pool_norm(pool),
                         bool(channel_last))


for _e in (bn_act_train, bn2_act_train, bn_act_pool_train):
    _e.relayouts = 0   # layout copies made for the kernels, fwd and bwd
    _e.composite_calls = 0   # calls the dtype gate sent to the composite
