"""Int8 weight-only dequant-matmul: ``x @ (w_int8 * scale)``.

Port of ``paddle_tpu/ops/int8_matmul.py``.  The serving decode step is
weight-bound: every token reads every weight once, so holding Linear
weights as int8 plus a per-output-channel f32 scale cuts the bytes per
step 4x against f32, while the activation stays f32.

- **Kernel** (``csrc/int8_matmul.cu``, CUDA C++ for sm_90a): replaces the
  Pallas kernel ``paddle_tpu/ops/int8_matmul.py::_kernel``.  Its bound is
  the weight bytes, ``K*N + 4*N`` over 3.35 TB/s (one GPT-2-medium layer,
  12.6 MB: ~3.8 us).  Split-K over 128-column tiles so a decode-sized M
  still fills the card, 16-byte int8 loads dequantized in registers
  against the scale slice, f32 accumulation; design notes in the source.
- **Plain version** (``_plain``): ``x @ (w_int8.to(x.dtype) * scale)``,
  the reference's fallback.  The wrapper takes it only for CPU tensors.

``dequant_matmul.launches`` counts kernel launches (the plain version never
counts).  One launch is one call of the C entry, which runs two
``__global__`` kernels on the stream: ``dequant_matmul_partial`` and the
split-K sum ``dequant_matmul_reduce``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["dequant_matmul"]


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _plain(x2, w_int8, scale_row):
    return x2 @ (w_int8.to(x2.dtype) * scale_row.to(x2.dtype))


def _split_k(m: int, k: int, n: int) -> int:
    """Rows of K per block: the largest multiple of 32 that divides K
    into chunks and still gives the card >= 264 blocks (two per SM), or
    32 when even that cannot."""
    tiles = -(-n // 128) * -(-m // 8)
    units = -(-k // 32)
    best = units
    for c in range(units, 0, -1):
        if units % c == 0:
            best = c
            if tiles * (units // c) >= 264:
                break
    return 32 * best


def _kernel(x2, w_int8, scale_row):
    fn = _build.function("int8_matmul", "pdt_int8_matmul_f32", _ARGTYPES)
    m, k = x2.shape
    n = w_int8.shape[1]
    k_chunk = _split_k(m, k, n)
    splits = -(-k // k_chunk)
    y = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    part = torch.empty((splits, m, n), dtype=torch.float32, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    err = fn(x2.data_ptr(), w_int8.data_ptr(), scale_row.data_ptr(),
             y.data_ptr(), part.data_ptr(), m, k, n, k_chunk, splits, stream)
    dequant_matmul.launches += 1
    _build.check(err, "int8_matmul")
    return y


def _check_cuda(x2, w_int8, scale_row):
    dev = x2.device
    if w_int8.device != dev or scale_row.device != dev:
        raise ValueError("dequant_matmul: x, w_int8 and scale must share a "
                         "device")
    if x2.dtype != torch.float32 or scale_row.dtype != torch.float32:
        raise TypeError("dequant_matmul kernel takes float32 x and scale, "
                        f"got {x2.dtype} and {scale_row.dtype}")
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
    x2 = x.reshape(-1, k)
    if x2.shape[0] == 0:
        out = x2.new_empty((0, n))
    elif x2.device.type == "cuda":
        scale_row = scale_row.contiguous()
        _check_cuda(x2, w_int8, scale_row)
        out = _kernel(x2.contiguous(), w_int8, scale_row)
    else:
        out = _plain(x2, w_int8, scale_row)
    return out.reshape(*lead, n)


dequant_matmul.launches = 0  # kernel launches; the plain version never counts
