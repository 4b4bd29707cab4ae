"""Flash attention, forward (K1) and backward (K2).

Port of ``paddle_tpu/ops/flash_attention.py``.  The kernels
(``csrc/flash_attention.cu``, CUDA C++ for sm_90a) replace the Pallas
kernels ``_fwd_kernel`` and ``_bwd_kernel``; design notes and the bound are
in the source.

- ``flash_attention_bshd(q, k, v, causal, bias, q_segment_ids,
  kv_segment_ids, dropout_p, dropout_seed)`` has the reference's gate and
  returns None where the reference's does (head_dim not in {64, 128, 256},
  a sequence length not a multiple of 128, grouped kv heads, dropout
  without a seed, one segment-id side only).  The reference also returns
  None off the TPU; the port has no such case: CPU tensors take the plain
  versions, CUDA tensors launch the kernels or raise.
- q / k / v are (batch, seq, heads, head_dim) in f32, bf16 or f16 and may be
  strided views (the fused-QKV output's slices are read in place, with no
  ``.contiguous()``).  Softmax state and every sum are f32; p is rounded
  to v's type before the PV product and dS to q's type before the dK / dQ
  products, as the reference does.  Masked scores are -1e30.
- Dropout uses the reference's interpret-mode keep mask (``keep_mask``)
  bit for bit: the same int32 seed gives the same mask as the reference's
  CPU path.  The seed is an int32 tensor of shape (1,) on q's device; the
  forward saves it, so the backward sees the same mask.
- ``_Flash`` is the ``torch.autograd.Function`` (the reference's
  ``custom_vjp``): its forward runs K1 and saves O and the logsumexp, its
  backward runs K2.  With nothing to differentiate (eval, or an exported
  forward) ``flash_attention_bshd`` calls K1 alone.
- K1's wrapper ``flash_fwd`` is the operator
  ``torch.ops.paddle_tpu_torch.flash_fwd`` (``ops/_library.py``), with a
  fake implementation for ``torch.export``.

``flash_fwd.launches`` / ``flash_bwd.launches`` count wrapper calls that
launch kernels (the plain versions never count).  The kernel is picked by
dtype: bf16 and f16 run the tensor-core kernels (one template over the
16-bit type), and one K2 call runs three of
them (delta, dQ, dK/dV; deterministic, no scratch beyond delta); f32 runs
the CUDA-core kernels, and one K2 call runs delta, the merged backward
and the sum of its f32 dQ partials.

Rows that see no key at all (causal with Sq > Sk, or no matching segment)
are not defined by the reference: its output there depends on its block
size.  The port's plain version averages V over every key for such rows,
the kernel returns 0.  Training never has them.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, _library

__all__ = ["flash_attention_bshd", "flash_gate", "flash_fwd", "flash_bwd",
           "keep_mask"]

_NEG_INF = -1e30
_M32 = 0xFFFFFFFF


def flash_gate(q_shape, k_shape, dropout_p=0.0, has_seed=False,
               has_q_segments=False, has_kv_segments=False) -> bool:
    """The reference's shape gate (``flash_attention_bshd``'s None cases
    other than the platform)."""
    _, sq, h, d = q_shape
    sk = k_shape[1]
    if d not in (64, 128, 256):
        return False
    if sq % 128 or sk % 128:
        return False
    if k_shape[2] != h:
        return False
    if dropout_p > 0.0 and not has_seed:
        return False
    return has_q_segments == has_kv_segments


def flash_attention_bshd(q, k, v, causal=False, bias=None, q_segment_ids=None,
                         kv_segment_ids=None, dropout_p=0.0,
                         dropout_seed=None):
    """q/k/v: (batch, seq, heads, head_dim).  Returns the same layout in
    q's type, or None where the reference's gate refuses.

    bias: additive per-key bias (batch, seq_k), taken as f32.
    q_segment_ids / kv_segment_ids: (batch, seq) ids; positions attend only
    within equal ids.  dropout_p with dropout_seed (int32 tensor of shape
    (1,) on q's device): in-kernel attention-probability dropout."""
    if not flash_gate(q.shape, k.shape, dropout_p, dropout_seed is not None,
                      q_segment_ids is not None, kv_segment_ids is not None):
        return None
    if bias is not None:
        bias = bias.to(torch.float32)
    if q_segment_ids is not None:
        q_segment_ids = q_segment_ids.to(torch.int32)
        kv_segment_ids = kv_segment_ids.to(torch.int32)
    seed = (torch.zeros(1, dtype=torch.int32, device=q.device)
            if dropout_seed is None
            else dropout_seed.reshape(1).to(torch.int32))
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias))):
        # nothing to differentiate (eval, an exported forward): K1 alone
        return flash_fwd(q, k, v, bias, q_segment_ids, kv_segment_ids,
                         seed, causal, dropout_p)[0]
    return _Flash.apply(q, k, v, bias, q_segment_ids, kv_segment_ids, seed,
                        bool(causal), float(dropout_p))


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, qseg, kseg, seed, causal, dropout_p):
        o, lse = flash_fwd(q, k, v, bias, qseg, kseg, seed, causal,
                           dropout_p)
        ctx.save_for_backward(q, k, v, bias, qseg, kseg, seed, o, lse)
        ctx.causal, ctx.dropout_p = causal, dropout_p
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, qseg, kseg, seed, o, lse = ctx.saved_tensors
        dq, dk, dv, dbias = flash_bwd(q, k, v, bias, qseg, kseg, seed, o,
                                      lse, do.to(q.dtype), ctx.causal,
                                      ctx.dropout_p)
        if not ctx.needs_input_grad[3]:
            dbias = None
        return dq, dk, dv, dbias, None, None, None, None, None


# ---------------------------------------------------------------------------
# dropout keep mask (the reference's interpret-mode hash, bit for bit)
# ---------------------------------------------------------------------------

def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 x in [0, 2**32): the product is split
    in 16-bit halves so that no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _threshold(dropout_p: float) -> int:
    return min(int(dropout_p * 4294967296.0), 4294967295)


def keep_mask(seed, batch: int, heads: int, sq: int, sk: int,
              dropout_p: float, device=None):
    """(batch, heads, sq, sk) bool keep mask of the reference's
    ``_keep_mask`` hash (uint32 arithmetic done in int64 with masking):
    absolute (row, col), the int32 ``seed`` (tensor (1,) or int; taken as
    its two's-complement uint32) and bh = b * heads + head."""
    if not isinstance(seed, torch.Tensor):   # a fill, not a host copy
        seed = torch.full((1,), int(seed), dtype=torch.int32, device=device)
    dev = seed.device
    s = seed.reshape(()).to(torch.int64) & _M32
    rows = torch.arange(sq, device=dev, dtype=torch.int64)[:, None]
    cols = torch.arange(sk, device=dev, dtype=torch.int64)[None, :]
    bh = torch.arange(batch * heads, device=dev, dtype=torch.int64)
    sb = ((s + _mul32(bh, 0xC2B2AE35)) & _M32)[:, None, None]
    x = _mul32(rows, 0x9E3779B1) ^ _mul32(cols, 0x85EBCA77)   # (sq, sk)
    x = x[None] ^ sb                                           # (bh, sq, sk)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >= _threshold(dropout_p)).reshape(batch, heads, sq, sk)


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, and the card's comparisons)
# ---------------------------------------------------------------------------

def _scores(q, k, bias, qseg, kseg, causal):
    """(B, H, Sq, Sk) f32 scores with every mask, as _masked_scores."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(rows + (sk - sq) >= cols, s, _NEG_INF)
    if qseg is not None:
        same = qseg[:, None, :, None] == kseg[:, None, None, :]
        s = torch.where(same, s, _NEG_INF)
    return s


def _plain_fwd(q, k, v, bias, qseg, kseg, seed, causal, dropout_p):
    s = _scores(q, k, bias, qseg, kseg, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)   # before dropout
    if dropout_p > 0.0:
        b, h = s.shape[0], s.shape[1]
        keep = keep_mask(seed, b, h, s.shape[2], s.shape[3], dropout_p)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_p)), 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _plain_bwd(q, k, v, bias, qseg, kseg, seed, o, lse, do, causal,
               dropout_p):
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, bias, qseg, kseg, causal)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    pd = p
    if dropout_p > 0.0:
        b, h = s.shape[0], s.shape[1]
        keep = keep_mask(seed, b, h, s.shape[2], s.shape[3], dropout_p)
        inv = 1.0 / (1.0 - dropout_p)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)   # (B, H, Sq)
    ds = p * (dp - delta[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", pd.to(dt).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(dt).float(), q.float()) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(dt).float(), k.float()) * scale
    dbias = ds.sum((1, 2)) if bias is not None else None
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype), dbias


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _check_cuda(q, k, v, bias, qseg, kseg, seed, extra=()):
    dev = q.device
    named = [("k", k), ("v", v), ("seed", seed)] + list(extra)
    named += [(n, t) for n, t in (("bias", bias), ("q_segment_ids", qseg),
                                  ("kv_segment_ids", kseg)) if t is not None]
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"flash attention: {name} is on {t.device}, q "
                             f"on {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention kernels take float32, bfloat16 or "
                        f"float16 q/k/v, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(
            (n, t) for n, t in extra if t.dim() == 4):
        if t.dtype != q.dtype:
            raise TypeError(f"flash attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash attention kernels need a 4-d {name} "
                             "with unit stride along head_dim")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or tuple(k.shape[2:]) != (h, d):
        raise ValueError(f"flash attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if d not in (64, 128, 256) or sq % 128 or sk % 128:
        raise ValueError(f"flash attention kernels need head_dim in (64, "
                         f"128, 256) and sequence lengths % 128 == 0, got "
                         f"d={d}, sq={sq}, sk={sk}")
    if seed.dtype != torch.int32 or seed.numel() != 1:
        raise TypeError("flash attention: dropout_seed must be one int32")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (b, sk)
                             or not bias.is_contiguous()):
        raise ValueError(f"flash attention: bias must be contiguous float32 "
                         f"({b}, {sk})")
    for name, t, n in (("q_segment_ids", qseg, sq), ("kv_segment_ids", kseg,
                                                       sk)):
        if t is not None and (t.dtype != torch.int32
                              or tuple(t.shape) != (b, n)
                              or not t.is_contiguous()):
            raise ValueError(f"flash attention: {name} must be contiguous "
                             f"int32 ({b}, {n})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _rows16(t):
    """t itself when every (batch, seq, head) row starts on 16 bytes, as the
    16-bit kernels' 16-byte copies need (the fused-QKV views do); else a
    contiguous copy."""
    if t.data_ptr() % 16 == 0 and all(
            s % 8 == 0 for s in t.stride()[:3]):
        return t
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


def _strides(t):
    return list(t.stride()[:3])


def _scalars(q, causal, dropout_p):
    return [int(bool(causal)), 1.0 / math.sqrt(q.shape[-1]),
            int(dropout_p > 0.0), _threshold(dropout_p),
            1.0 / (1.0 - dropout_p)]


# the C entries' dtype argument: 0 runs the CUDA-core kernels, 1 and 2 the
# tensor-core ones
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I, _L, _F, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float, ctypes.c_uint)
_FWD_ARGTYPES = ([_I] + [_P] * 9 + [_I] * 5 + [_L] * 9
                 + [_I, _F, _I, _U, _F, _P])
_BWD_ARGTYPES = ([_I] + [_P] * 16 + [_I] * 5 + [_L] * 12
                 + [_I, _F, _I, _U, _F, _P])


def _fwd_kernel(q, k, v, bias, qseg, kseg, seed, causal, dropout_p):
    fn = _build.function("flash_attention", "pdt_flash_fwd", _FWD_ARGTYPES)
    code = _DTYPE_CODE[q.dtype]
    if code:
        q, k, v = _rows16(q), _rows16(k), _rows16(v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(code, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), _ptr(bias), _ptr(qseg), _ptr(kseg),
             seed.data_ptr(), o.data_ptr(), lse.data_ptr(), b, sq, sk, h, d,
             *_strides(q), *_strides(k), *_strides(v),
             *_scalars(q, causal, dropout_p), stream)
    flash_fwd.launches += 1
    _build.check(err, "flash attention forward")
    return o, lse


def _bwd_kernel(q, k, v, bias, qseg, kseg, seed, o, lse, do, causal,
                dropout_p):
    fn = _build.function("flash_attention", "pdt_flash_bwd", _BWD_ARGTYPES)
    code = _DTYPE_CODE[q.dtype]
    if code:
        q, k, v, do = _rows16(q), _rows16(k), _rows16(v), _rows16(do)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dev = q.device
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=dev)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=dev)
    dq_part = None   # the f32 route's per-k-tile dQ partials
    if not code:
        tile = _build.function("flash_attention", "pdt_flash_tile", [_I])(d)
        dq_part = torch.empty((sk // tile, b, h, sq, d), dtype=torch.float32,
                              device=dev)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    dbias_part = (torch.empty((b, h, sk), dtype=torch.float32, device=dev)
                  if bias is not None else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(code, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), _ptr(bias), _ptr(qseg), _ptr(kseg),
             seed.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(dbias_part),
             _ptr(dq_part), delta.data_ptr(), b, sq, sk, h, d,
             *_strides(q), *_strides(k), *_strides(v), *_strides(do),
             *_scalars(q, causal, dropout_p), stream)
    flash_bwd.launches += 1
    _build.check(err, "flash attention backward")
    dbias = dbias_part.sum(1) if bias is not None else None
    return dq, dk, dv, dbias


def _fwd_impl(q, k, v, bias, qseg, kseg, seed, causal, dropout_p):
    if q.device.type == "cuda":
        _check_cuda(q, k, v, bias, qseg, kseg, seed)
        return _fwd_kernel(q, k, v, bias, qseg, kseg, seed, causal,
                           dropout_p)
    return _plain_fwd(q, k, v, bias, qseg, kseg, seed, causal, dropout_p)


def _fwd_fake(q, k, v, bias, qseg, kseg, seed, causal, dropout_p):
    b, sq, h, d = q.shape
    return (q.new_empty((b, sq, h, d)),
            q.new_empty((b, h, sq), dtype=torch.float32))


_fwd_op = _library.define(
    "flash_fwd", "(Tensor q, Tensor k, Tensor v, Tensor? bias, "
    "Tensor? q_segment_ids, Tensor? kv_segment_ids, Tensor seed, "
    "bool causal, float dropout_p) -> (Tensor, Tensor)", _fwd_impl,
    _fwd_fake)


def flash_fwd(q, k, v, bias, qseg, kseg, seed, causal, dropout_p):
    """K1: (o (B, Sq, H, D) in q's type, lse (B, H, Sq) f32).  CUDA tensors
    launch the kernel (or raise on what it does not take); CPU tensors take
    the plain version.  It is the operator
    ``torch.ops.paddle_tpu_torch.flash_fwd``, so an exported forward keeps
    it as one node."""
    return _fwd_op(q, k, v, bias, qseg, kseg, seed, bool(causal),
                   float(dropout_p))


def flash_bwd(q, k, v, bias, qseg, kseg, seed, o, lse, do, causal,
              dropout_p):
    """K2: (dq, dk, dv, dbias (B, Sk) f32 or None) from the forward's o and
    lse and the output gradient do."""
    if q.device.type == "cuda":
        if do.stride(-1) != 1:
            do = do.contiguous()
        _check_cuda(q, k, v, bias, qseg, kseg, seed,
                    extra=(("o", o), ("lse", lse), ("do", do)))
        b, sq, h, _ = q.shape
        if not o.is_contiguous() or o.shape != q.shape \
                or do.shape != q.shape or lse.dtype != torch.float32 \
                or not lse.is_contiguous() or lse.shape != (b, h, sq):
            raise ValueError("flash attention backward: o must be the "
                             "forward's contiguous output, do shaped like "
                             "q, and lse the f32 (B, H, Sq) logsumexp")
        return _bwd_kernel(q, k, v, bias, qseg, kseg, seed, o, lse, do,
                           causal, dropout_p)
    return _plain_bwd(q, k, v, bias, qseg, kseg, seed, o, lse, do, causal,
                      dropout_p)


flash_fwd.launches = 0  # kernel launches; the plain version never counts
flash_bwd.launches = 0
