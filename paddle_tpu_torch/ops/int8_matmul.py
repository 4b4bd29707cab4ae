"""Int8 weight-only dequant-matmul: ``x @ (w_int8 * scale)``.

Port of ``paddle_tpu/ops/int8_matmul.py``.  The serving decode step is
weight-bound: every token reads every weight once, so holding Linear
weights as int8 plus a per-output-channel f32 scale cuts the bytes per
step 4x against f32, while the activation stays floating point (f32 or
bf16; the kernel computes in f32 and writes x's dtype, as the TPU
kernel does).

- **Kernel** (``csrc/int8_matmul.cu``, CUDA C++ for sm_90a): replaces the
  Pallas kernel ``paddle_tpu/ops/int8_matmul.py::_kernel``.  Its bound is
  the weight bytes, ``K*N + 4*N`` over 3.35 TB/s (one GPT-2-medium layer,
  12.6 MB: ~3.8 us).  One kernel per call: the blocks of a thread-block
  cluster share an output tile and split K, and add their partial sums
  through distributed shared memory in a fixed order (no partial buffer in
  device memory, no atomics, bit-repeatable); int8 words dequantized by a
  byte permute, the scale applied once per column after the sum; design
  notes in the source.  ``_plan`` picks the tile and the split from the
  shapes alone.
- **Plain version** (``_plain``): ``x @ (w_int8 * scale)`` in f32, cast
  to x's dtype: the TPU kernel's arithmetic (f32 dequantization and
  accumulate; in f32 it is the reference's fallback too).  The wrapper
  takes it only for CPU tensors.

``dequant_matmul.launches`` counts kernel launches (the plain version never
counts).  The wrapper's 2-d core is the operator
``torch.ops.paddle_tpu_torch.dequant_matmul`` (``ops/_library.py``), with
a fake implementation for ``torch.export``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, _library

__all__ = ["dequant_matmul"]


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
THREADS = 128         # threads of a block (the kernel's)
WORDS = {8: 32, 16: 16, 32: 8}  # weight words a thread holds per chunk


def _plain(x2, w_int8, scale_row):
    w = w_int8.to(torch.float32) * scale_row.to(torch.float32)
    return (x2.to(torch.float32) @ w).to(x2.dtype)


class Plan(NamedTuple):
    """Launch plan: output tiles of ``mt`` x ``tn``; each cluster of
    ``splits`` blocks shares a tile and rank r sums K rows
    [r * k_rows, min((r + 1) * k_rows, K)); k_rows is a whole number of
    16-byte x chunks, so x's rows can go by bulk copy."""
    mt: int
    tn: int
    splits: int
    k_rows: int

    def grid(self, m: int, n: int):
        return (self.splits, -(-n // self.tn), -(-m // self.mt))


@functools.lru_cache(maxsize=None)  # shapes repeat every call
def _plan(m: int, k: int, n: int, sms: int, x_bytes: int = 4) -> Plan:
    """Decode (M <= 16): 32-column tiles, K split (<= 8 ways) so that one
    chunk of register words per thread covers its rank: the whole weight
    is in flight at once, in the fewest blocks (more, smaller blocks lost
    on the card).  Prefill: the widest tile up to 64 columns, then the
    fewest splits, that give the card's ``sms`` multiprocessors >= 2
    blocks each.  ``x_bytes``: x's element size."""
    mt = 8 if m <= 8 else 16 if m <= 16 else 32
    if mt < 32:
        tn = 32
        rows = THREADS // (tn // 4) * WORDS[mt]
        splits = max(1, min(_build.MAX_CLUSTER, -(-k // rows)))
    else:
        tiles_m = -(-m // mt)
        most = max(1, min(_build.MAX_CLUSTER, k // 128))
        tn, splits = 16, most
        for cand in (64, 32, 16):
            fit = [s for s in (1, 2, 4, 8)
                   if s <= most and -(-n // cand) * tiles_m * s >= 2 * sms]
            if fit:
                tn, splits = cand, fit[0]
                break
    vec = 16 // x_bytes
    k_rows = -(-(-(-k // splits)) // vec) * vec  # x rows in 16-byte copies
    return Plan(mt, tn, -(-k // k_rows), k_rows)


def _kernel(x2, w_int8, scale_row):
    fn = _build.function("int8_matmul", "pdt_int8_matmul", _ARGTYPES)
    m, k = x2.shape
    n = w_int8.shape[1]
    p = _plan(m, k, n, _build.sm_count(x2.device.index), x2.element_size())
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    err = fn(x2.data_ptr(), w_int8.data_ptr(), scale_row.data_ptr(),
             y.data_ptr(), _DTYPE_CODE[x2.dtype], m, k, n, p.mt, p.tn,
             p.splits, p.k_rows, stream)
    dequant_matmul.launches += 1
    _build.check(err, "int8_matmul")
    return y


def _check_cuda(x2, w_int8, scale_row):
    dev = x2.device
    if w_int8.device != dev or scale_row.device != dev:
        raise ValueError("dequant_matmul: x, w_int8 and scale must share a "
                         "device")
    if x2.dtype not in _DTYPE_CODE or scale_row.dtype != torch.float32:
        raise TypeError("dequant_matmul kernel takes float32, bfloat16 or "
                        f"float16 x and a float32 scale, got {x2.dtype} and "
                        f"{scale_row.dtype}")
    if w_int8.dtype != torch.int8:
        raise TypeError(f"dequant_matmul: w must be int8, got {w_int8.dtype}")
    if w_int8.shape[1] % 16:
        raise ValueError("dequant_matmul kernel needs N % 16 == 0 (16-byte "
                         f"weight rows), got N={w_int8.shape[1]}")
    if not w_int8.is_contiguous():
        raise ValueError("dequant_matmul kernel needs a contiguous weight")
    if w_int8.data_ptr() % 16:
        raise ValueError("dequant_matmul kernel reads the weight in 16-byte "
                         "loads: its data must start 16-byte aligned")
    if x2.shape[0] > 65535 * 32 or w_int8.shape[1] > 65535 * 16:
        raise ValueError("dequant_matmul kernel: M or N is past its grid "
                         f"({x2.shape[0]}, {w_int8.shape[1]})")


def dequant_matmul(x, w_int8, scale):
    """``x (..., K) @ dequant(w_int8 (K, N))`` with ``scale`` the
    per-output-channel multiplier (1, N), or a per-tensor (1, 1) one
    (broadcast).  Returns (..., N) in x's dtype.  CUDA tensors launch the
    kernel (or raise on what it does not take); CPU tensors take the
    plain version."""
    k, n = w_int8.shape
    if x.shape[-1] != k:
        raise ValueError(f"dequant_matmul: x has K={x.shape[-1]}, "
                         f"w has K={k}")
    scale_row = scale
    if scale.dtype != torch.float32 or tuple(scale.shape) != (1, n):
        scale_row = scale.to(torch.float32).reshape(1, -1).expand(1, n)
    lead = x.shape[:-1]
    return _op(x.reshape(-1, k), w_int8, scale_row).reshape(*lead, n)


def _impl(x2, w_int8, scale_row):
    if x2.shape[0] == 0:
        return x2.new_empty((0, w_int8.shape[1]))
    if x2.device.type == "cuda":
        scale_row = scale_row.contiguous()
        _check_cuda(x2, w_int8, scale_row)
        return _kernel(x2.contiguous(), w_int8, scale_row)
    return _plain(x2, w_int8, scale_row)


def _fake(x2, w_int8, scale_row):
    return x2.new_empty((x2.shape[0], w_int8.shape[1]))


_op = _library.define(
    "dequant_matmul", "(Tensor x, Tensor w_int8, Tensor scale) -> Tensor",
    _impl, _fake)


dequant_matmul.launches = 0  # kernel launches; the plain version never counts
