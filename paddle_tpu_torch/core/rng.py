"""Explicit random generators (counterpart of paddle_tpu/core/rng.py).

The reference keeps a global key and splits a fresh subkey per draw; its
compiled training step takes one key per step and folds it per call site.
The port never draws from torch's global generator.  Instead:

- ``seed(s)`` resets the port's seed stream, a CPU ``torch.Generator``
  that hands out 63-bit integers (``next_seed``) with no device sync;
- ``step_generator(device)`` is the per-step generator that takes the
  place of ``next_key()`` in ``TrainStep``: a new ``torch.Generator`` on
  the step's device, seeded from the stream;
- ``generator_scope(gen)`` makes ``gen`` the one that dropout masks and
  attention-dropout seeds (``current_generator`` / ``draw_seed``) draw
  from while it is active.  Outside a scope each device has a default
  generator, seeded from the stream on first use.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["seed", "next_seed", "step_generator", "generator_scope",
           "current_generator", "draw_seed"]

_lock = threading.Lock()
_stream = torch.Generator().manual_seed(0)
_defaults: dict = {}
_scope = threading.local()


def seed(s: int):
    """Reset the seed stream (paddle.seed); per-device default generators
    are drawn anew from it."""
    with _lock:
        _stream.manual_seed(int(s))
        _defaults.clear()
    return _stream


def next_seed() -> int:
    """The next 63-bit seed of the stream (a host draw, no device sync)."""
    with _lock:
        return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=_stream))


def step_generator(device) -> torch.Generator:
    """A fresh generator on ``device``, seeded from the stream."""
    return torch.Generator(device=torch.device(device)).manual_seed(
        next_seed())


@contextlib.contextmanager
def generator_scope(gen: torch.Generator):
    """Draw every mask and seed from ``gen`` inside the block."""
    prev = getattr(_scope, "gen", None)
    _scope.gen = gen
    try:
        yield gen
    finally:
        _scope.gen = prev


def _indexed(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def current_generator(device) -> torch.Generator:
    """The scope's generator when it lives on ``device``, else the
    device's default generator."""
    device = _indexed(device)
    gen = getattr(_scope, "gen", None)
    if gen is not None and _indexed(gen.device) == device:
        return gen
    key = str(device)
    with _lock:
        gen = _defaults.get(key)
    if gen is None:
        gen = step_generator(device)
        with _lock:
            gen = _defaults.setdefault(key, gen)
    return gen


def draw_seed(device) -> torch.Tensor:
    """An int32 seed of shape (1,) on ``device``, drawn from the current
    generator (the attention-dropout seed the flash kernels read)."""
    return torch.randint(-2 ** 31, 2 ** 31, (1,), dtype=torch.int32,
                         device=device, generator=current_generator(device))
