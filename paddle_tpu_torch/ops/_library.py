"""The kernels' wrappers as PyTorch operators (``torch.ops.paddle_tpu_torch``).

A wrapper that an exported forward reaches (``jit.save`` runs
``torch.export``) is defined here as an operator with a schema, one
implementation for CPU and CUDA tensors (the wrapper's body: the kernel on
the card, its plain version on the CPU) and a fake implementation that
gives the output shapes and dtypes.  ``torch.export`` traces with fake
tensors, which have no data pointer for a ``ctypes`` launch: with the
operator it keeps one opaque node per call instead, and running the
exported program calls the same implementation, so a launch there is
counted as any other.

The operators are defined with ``torch.library.Library`` rather than the
``torch.library.custom_op`` decorator, which wraps every call in further
Python layers: an eager loop (beam search, an uncaptured engine) calls
these wrappers a hundred times per token.
"""
from __future__ import annotations

import torch

__all__ = ["define"]

NAMESPACE = "paddle_tpu_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name: str, schema: str, impl, fake):
    """Define operator ``paddle_tpu_torch::<name><schema>`` with ``impl``
    for CPU and CUDA tensors and ``fake`` for fake and meta tensors;
    returns the operator's overload to call."""
    _LIB.define(name + schema)
    for key in ("CPU", "CUDA"):
        _LIB.impl(name, impl, key)
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
