"""Stateless keyed sampling: the reference serving engine's sampler
(``paddle_tpu/serving/engine.py``, ``_first_token_at`` ``:111-130``,
``_sample_step`` ``:143-171``, ``_request_key`` ``:1739-1744``) on device
tensors.

A sampled token depends only on the request's key, its position and its
logits: the draw for the token decoded at position ``pos`` uses the key
folded in at ``pos`` (the first token at ``prompt_len - 1``).  It never
depends on the slot, the chunk or the other requests of the batch, and
reading nothing from the host, the functions run inside a captured CUDA
graph.

The reference draws with ``jax.random`` (threefry-2x32,
``jax_threefry_partitionable`` on, the "low" gumbel mode).  Those are
integer and float arithmetic that PyTorch reproduces:

- ``threefry2x32`` is the 20-round Threefry-2x32 hash on int64 tensors
  that hold uint32 values, masked to 32 bits after every add and shift;
- ``fold_in(keys, data)`` hashes the counter pair (0, data) under each
  key, as ``jax.random.fold_in`` does for a 32-bit datum;
- ``random_bits(keys, n)`` hashes the counter pairs (0, i), i < n, and
  xors the two words: the partitionable ``jax.random.bits``;
- ``uniform(keys, n)`` maps 23 of those bits into [1, 2) and subtracts 1:
  ``jax.random.uniform``'s f32 values, bit for bit (the speculative
  commit's accept draws);
- ``gumbel(keys, n)`` lifts those uniforms' 0 to the smallest normal f32
  and takes ``-log(-log(u))``; the ``log`` of the two libraries may
  differ in the last bit;
- ``categorical(keys, logits)`` is ``argmax(logits + gumbel)``.

Keys and fold-in results are bit-equal to the reference's; a gumbel value
is within one f32 unit of it.  ``request_key(seed)`` turns a request's
seed into its two key words on the host, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from . import process_logits_dynamic

__all__ = ["request_key", "threefry2x32", "fold_in", "random_bits",
           "uniform", "gumbel", "categorical", "sample_step", "greedy_step",
           "first_token_at"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


def request_key(seed) -> np.ndarray:
    """The request's two key words (uint32) from its seed, on the host."""
    rs = np.random.RandomState(np.uint32(seed))
    return rs.randint(0, 2 ** 32, size=2, dtype=np.uint64).astype(np.uint32)


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the
    key words (k0, k1); int64 tensors holding uint32 values, broadcast
    together.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def fold_in(keys, data):
    """(S, 2) keys folded in at (S,) integer ``data``, or at one Python
    int for every row -> (S, 2) keys."""
    k0, k1 = keys[:, 0], keys[:, 1]
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _MASK
    else:   # a fill on the device, never a host-to-card copy
        data = torch.full_like(k0, int(data) & _MASK)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(k0), data)
    return torch.stack([y0, y1], dim=1)


def random_bits(keys, n: int):
    """(S, n) uint32 values (in int64) per (S, 2) key."""
    count = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(count),
                          count)
    return y0 ^ y1


def uniform(keys, n: int):
    """(S, n) f32 uniforms in [0, 1) per (S, 2) key."""
    mant = (random_bits(keys, n) >> 9) | 0x3F800000       # [1, 2) as bits
    return mant.to(torch.int32).view(torch.float32) - 1.0


def gumbel(keys, n: int):
    """(S, n) f32 Gumbel(0, 1) noise per (S, 2) key ("low" mode)."""
    u = torch.clamp_min(uniform(keys, n) * (1.0 - _TINY) + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def categorical(keys, logits):
    """One draw from softmax(logits) per row of (S, V) f32 logits."""
    return torch.argmax(logits + gumbel(keys, logits.shape[-1]), dim=-1)


def _logp(proc, tok):
    return torch.gather(torch.log_softmax(proc, dim=-1), -1,
                        tok[:, None])[:, 0]


def sample_step(last, keys, pos, temp, top_k, top_p, greedy):
    """One sampling decision per row of (S, V) f32 logits: greedy rows
    take the argmax of their raw logits, the others draw under their key
    folded in at ``pos`` after temperature / top-k / top-p.  Returns
    (tokens (S,) int64, logp (S,) under the distribution drawn from)."""
    proc = process_logits_dynamic(last, temp, top_k, top_p, greedy)
    sampled = categorical(fold_in(keys, pos), proc)
    tok = torch.where(greedy, torch.argmax(proc, dim=-1), sampled)
    return tok, _logp(proc, tok)


def greedy_step(last):
    """``sample_step`` of a batch whose rows are all greedy: the same
    tokens, without the sampling pipeline."""
    tok = torch.argmax(last, dim=-1)
    return tok, _logp(last, tok)


def first_token_at(logits, idx, fold_pos, key, temp, top_k, top_p, greedy):
    """The first generated token from the (1, T, V) prefill ``logits`` at
    row ``idx`` (a (1,) tensor), drawn under ``key`` (1, 2) folded in at
    ``fold_pos`` (1,); the knobs are (1,) tensors.  Returns (token (1,),
    logp (1,), finite (1,): whether that logits row is finite)."""
    last = logits[0].index_select(0, idx).to(torch.float32)
    finite = torch.isfinite(last).all(dim=-1)
    tok, logp = sample_step(last, key, fold_pos, temp, top_k, top_p, greedy)
    return tok, logp, finite
