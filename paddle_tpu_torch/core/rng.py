"""Explicit random generators (counterpart of paddle_tpu/core/rng.py).

The reference keeps a global key and splits a fresh subkey per draw; its
compiled training step takes one key per step and folds it per call site.
The port never draws from torch's global generator.  Instead:

- ``seed(s)`` resets the port's seed stream, a CPU ``torch.Generator``
  that hands out 63-bit integers (``next_seed``) with no device sync;
- ``step_generator(device)`` makes a generator on ``device`` seeded from
  the stream: ``jit.TrainStep`` holds one for all its steps (a captured
  step graph replays its draws, advancing the generator's offset as an
  eager step would), and each device's default generator is one;
- ``generator_scope(gen)`` makes ``gen`` the one that dropout masks and
  attention-dropout seeds (``current_generator`` / ``draw_seed``) draw
  from while it is active.  Outside a scope each device has a default
  generator, seeded from the stream on first use.
- ``mark(gen)`` / ``rewound(gen, token)``: a recompute region
  (``core.recompute``) marks the generator when it is entered and draws
  its recomputation again from the mark, so the recomputed dropout masks
  and seeds equal the first forward's.  Eagerly a mark is the generator's
  state (``get_state`` / ``set_state``).  Inside a CUDA graph capture the
  generator's position lives on the device and ``set_state`` is refused,
  so ``ProgramMarks`` (one per captured program) does it the way a graph
  replays it: the warm run before the capture records each region's entry
  offset from the program's start, the capture gives each region a twin
  generator registered with the graph, the recomputation draws from the
  twin (``graphsafe_set_state``), and before each replay ``position()``
  sets every twin to the step generator's offset plus its region's.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["seed", "next_seed", "step_generator", "generator_scope",
           "scope_generator", "current_generator", "draw_seed", "bernoulli",
           "keyed_scope", "mark",
           "rewound", "ProgramMarks"]

_lock = threading.Lock()
_stream = torch.Generator().manual_seed(0)
_defaults: dict = {}
_scope = threading.local()
_MARKS = None   # the ProgramMarks of a program being warmed or captured


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
    """A new generator on ``device``, seeded from the stream."""
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


def scope_generator():
    """The generator of the innermost ``generator_scope``, or None."""
    return getattr(_scope, "gen", None)


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


_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 x in [0, 2**32), in 16-bit halves so
    that no int64 product overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """murmur3's 32-bit finalizer on int64 tensors holding uint32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


@contextlib.contextmanager
def keyed_scope(key: torch.Tensor):
    """Draw every dropout mask and attention-dropout seed inside the block
    from ``key`` (an int64 tensor of two uint32 words) and a per-draw
    counter, by a counter hash in tensor ops: no generator state, so a
    traced program (``jit.save_train_program``'s export) takes the key as
    an input and draws new masks for each key."""
    prev = getattr(_scope, "keyed", None)
    _scope.keyed = [key, 0]
    try:
        yield
    finally:
        _scope.keyed = prev


def _keyed_bits(n: int, device):
    """n uint32 values (int64) of the active keyed scope's next draw."""
    st = _scope.keyed
    key, st[1] = st[0].to(device), st[1] + 1
    salt = _mix32(key[0] ^ _mix32(key[1] ^ _mul32(
        torch.full((), st[1], dtype=torch.int64, device=device),
        0x632BE5AB)))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return _mix32(_mul32(idx, 0x9E3779B1) ^ salt)


def bernoulli(shape, keep: float, device) -> torch.Tensor:
    """A bool mask of ``shape``, True with probability ``keep``: from the
    current generator, or in a keyed scope from its key."""
    if getattr(_scope, "keyed", None) is not None:
        n = 1
        for d in shape:
            n *= int(d)
        u = (_keyed_bits(n, device) >> 8).to(torch.float32) / 16777216.0
        return (u < keep).reshape(tuple(shape))
    return torch.empty(tuple(shape), device=device).bernoulli_(
        keep, generator=current_generator(device)).bool()


def draw_seed(device) -> torch.Tensor:
    """An int32 seed of shape (1,) on ``device``, drawn from the current
    generator, or in a keyed scope from its key (the attention-dropout
    seed the flash kernels read)."""
    if getattr(_scope, "keyed", None) is not None:
        bits = _keyed_bits(1, device)
        return (bits - ((bits >> 31) << 32)).to(torch.int32)
    return torch.randint(-2 ** 31, 2 ** 31, (1,), dtype=torch.int32,
                         device=device, generator=current_generator(device))


def mark(gen: torch.Generator):
    """A token for ``gen``'s position, for ``rewound``."""
    if _MARKS is not None and gen is _MARKS.gen:
        return _MARKS.mark()
    return gen.get_state()


@contextlib.contextmanager
def rewound(gen: torch.Generator, token):
    """Inside the block ``gen`` draws from the position ``token`` marked;
    after it, ``gen`` is where it was before the block."""
    if isinstance(token, torch.Generator):      # a captured region's twin
        main = gen.graphsafe_get_state()
        gen.graphsafe_set_state(token)
        try:
            yield
        finally:
            gen.graphsafe_set_state(main)
        return
    cur = gen.get_state()
    gen.set_state(token)
    try:
        yield
    finally:
        gen.set_state(cur)


@contextlib.contextmanager
def _active(marks):
    global _MARKS
    prev, _MARKS = _MARKS, marks
    try:
        yield
    finally:
        _MARKS = prev


class ProgramMarks:
    """The recompute regions' marks of one CUDA-graph program that draws
    from ``gen`` (see the module docstring): ``recording()`` around the
    eager warm run, ``register(graph)`` before the capture,
    ``capturing()`` around it, ``position()`` before each replay."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen
        self.offsets = []   # region entries, offsets from the run's start
        self.twins = []     # one generator per region, in entry order
        self._start = None  # recording: the run's start offset
        self._next = None   # capturing: the next region's index

    def mark(self):
        if self._next is None:                  # the warm run: eager
            self.offsets.append(self.gen.get_offset() - self._start)
            return self.gen.get_state()
        if self._next >= len(self.twins):
            raise RuntimeError(
                "recompute regions: the capture entered more regions than "
                f"its warm run ({len(self.twins)})")
        self._next += 1
        return self.twins[self._next - 1]

    @contextlib.contextmanager
    def recording(self):
        self.offsets, self._start = [], self.gen.get_offset()
        try:
            with _active(self):
                yield
        finally:
            self._start = None

    def register(self, graph):
        """Register the generator and one twin per recorded region with
        ``graph`` (a graph can only draw from generators registered before
        its capture begins)."""
        self.twins = [self.gen.clone_state() for _ in self.offsets]
        graph.register_generator_state(self.gen)
        for twin in self.twins:
            graph.register_generator_state(twin)

    @contextlib.contextmanager
    def capturing(self):
        self._next = 0
        try:
            with _active(self):
                yield
            if self._next != len(self.twins):
                raise RuntimeError(
                    f"recompute regions: the capture entered {self._next} "
                    f"regions, its warm run {len(self.twins)}")
        finally:
            self._next = None

    def position(self):
        """Before a replay: each twin at the step generator's offset plus
        its region's (the graph's replay reads them from here)."""
        base = self.gen.get_offset()
        for twin, off in zip(self.twins, self.offsets):
            twin.set_offset(base + off)
