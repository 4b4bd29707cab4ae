"""Text generation: greedy, sampling and beam search (port of
paddle_tpu/generation/__init__.py).

The reference runs the whole decode loop as one compiled XLA program; the
port runs it eagerly: one prefill through ``model.forward_fixed`` against
a preallocated cache, then one ``forward_fixed`` per token.  Model
protocol: ``model.gen_fixed_cache(batch, max_len)`` and
``model.forward_fixed(ids, caches, pos) -> (logits, caches)``.

``generate``'s random draws come from a ``torch.Generator`` seeded by
``seed`` (its own contract: sampled tokens differ from the reference's
``generate`` while greedy tokens agree).  The serving engine samples
statelessly instead, with the reference engine's keyed threefry draws
reproduced in ``generation.keyed``, so its sampled tokens equal the
reference engine's; its speculative ticks commit through
``generation.speculative`` (exported here, as the reference does).

Beam search (``decode_strategy="beam_search"``, reference ``:268-327``):
hypotheses on a (B*K) leading axis, one cache of B*K rows; each step
``beam_step`` picks the K best (token, parent) pairs per batch row, the
token history and the caches' live rows [0, pos) are reordered by a
gather (the rows past pos are never read before they are written),
finished beams extend with ``pad`` at zero cost, and the best beam is
ranked by score / ((5 + len) / 6) ** length_penalty.  ``torch.topk``
promises no order among equal values, where ``jax.lax.top_k`` takes the
lower index first; ``beam_step`` selects by a stable descending sort, so
ties (frequent once a -1e9 mask is added: the f32 spacing there is 64)
go to the lower index as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.errors import InvalidArgumentError

__all__ = ["generate", "beam_step", "apply_top_k", "apply_top_p",
           "apply_top_k_dynamic", "apply_top_p_dynamic",
           "process_logits_dynamic",
           "commit_speculative_greedy", "commit_speculative_sampled"]

_NEG = -1e9


def _masked(cond, logits):
    return torch.where(cond, torch.full_like(logits, _NEG), logits)


def apply_top_k(logits, k: int):
    """Mask all but the k largest logits per row."""
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return _masked(logits < kth, logits)


def _nucleus_cutoff(logits, p):
    """Per-row logit cutoff for nucleus filtering: the smallest logit in
    the shortest sorted prefix whose cumulative probability exceeds p
    (scalar or per-row (B,)); the top token always survives."""
    sort = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sort, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    p = torch.as_tensor(p, dtype=probs.dtype, device=probs.device)
    keep = (cum - probs) < p[..., None]
    keep[..., 0] = True
    inf = torch.full_like(sort, float("inf"))
    return torch.where(keep, sort, inf).amin(dim=-1, keepdim=True)


def apply_top_p(logits, p: float):
    """Nucleus filtering with one p for every row."""
    if p >= 1.0:
        return logits
    return _masked(logits < _nucleus_cutoff(logits, p), logits)


def apply_top_k_dynamic(logits, k):
    """apply_top_k with a per-row (B,) k; rows with k <= 0 pass through."""
    v = logits.shape[-1]
    sort = torch.sort(logits, dim=-1, descending=True).values
    idx = (k.to(torch.long) - 1).clamp(0, v - 1)[..., None]
    kth = torch.gather(sort, -1, idx)
    return _masked((k > 0)[..., None] & (logits < kth), logits)


def apply_top_p_dynamic(logits, p):
    """apply_top_p with a per-row (B,) p; rows with p >= 1.0 keep all."""
    return _masked(logits < _nucleus_cutoff(logits, p), logits)


def process_logits_dynamic(logits, temperature, top_k, top_p, greedy):
    """Every sampling knob per row: temperature (B,) f32, top_k (B,) int
    (0 = off), top_p (B,) f32 (1.0 = off), greedy (B,) bool (True rows
    keep their raw logits).  Lets one serving decode step mix requests."""
    proc = logits / temperature[..., None]
    proc = apply_top_k_dynamic(proc, top_k)
    proc = apply_top_p_dynamic(proc, top_p)
    return torch.where(greedy[..., None], logits, proc)


def gumbel(shape, generator, device):
    """Gumbel(0, 1) noise from ``generator``: ``argmax(logits + noise)``
    draws from softmax(logits), the categorical rule the reference's
    ``jax.random.categorical`` uses (and, unlike ``torch.multinomial``,
    it takes any logits, non-finite ones included, without a check)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u))


def _process_logits(logits, temperature, top_k, top_p, greedy):
    if greedy:
        return logits
    if temperature not in (None, 1.0):
        logits = logits / float(temperature)
    if top_k:
        logits = apply_top_k(logits, int(top_k))
    if top_p is not None and top_p < 1.0:
        logits = apply_top_p(logits, float(top_p))
    return logits


def top_k_first(x, k: int):
    """(values, indices) of the k largest entries along the last axis,
    equal values in ascending index order (``jax.lax.top_k``'s rule)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_step(logp, scores, finished, keep_token):
    """One beam-search selection step (shared by ``generate`` and
    ``nn.decode.BeamSearchDecoder``; reference ``:111-131``).

    logp: (B, K, V) per-beam next-token log-probs; scores: (B, K) running
    totals; finished: (B, K) bool.  Finished beams may only extend with
    ``keep_token`` at zero added cost.  Returns (new_scores, token,
    parent, flat_src, parent_finished), where flat_src are (B*K,) gather
    indices for reordering any per-hypothesis state (KV caches, cell
    states)."""
    b, k, vocab = logp.shape
    fin_row = torch.full((vocab,), _NEG, dtype=torch.float32,
                         device=logp.device)
    fin_row[keep_token] = 0.0
    logp = torch.where(finished[:, :, None], fin_row, logp)
    cand = scores[:, :, None] + logp
    new_scores, top_ix = top_k_first(cand.reshape(b, k * vocab), k)
    parent = top_ix // vocab
    token = (top_ix % vocab).to(torch.int32)
    parent_finished = torch.gather(finished, 1, parent)
    flat_src = (torch.arange(b, device=logp.device)[:, None] * k
                + parent).reshape(-1)
    return new_scores, token, parent, flat_src, parent_finished


def generate(model, input_ids, max_length=None, max_new_tokens=None,
             decode_strategy: str = "greedy_search", temperature=1.0,
             top_k=0, top_p=1.0, num_beams=1, length_penalty=0.0,
             eos_token_id: Optional[int] = None, pad_token_id: int = 0,
             bos_token_id=None, seed=None, *, device=DEFAULT_DEVICE):
    """Decode continuations of ``input_ids`` (B, S) with ``model`` on
    ``device`` (default the card; the model must already live there).

    Returns (ids, scores): ids (B, max_new) int32 generated tokens (pad
    after eos), scores (B,) the sequence log-prob of the emitted tokens
    (for sampling, under the tempered/filtered distribution they were
    drawn from; for beam search, the best beam's score after the length
    penalty).  decode_strategy: "greedy_search" | "sampling" |
    "beam_search" (``num_beams``, ``length_penalty``)."""
    if decode_strategy not in ("greedy_search", "sampling", "beam_search"):
        raise ValueError(
            f"unknown decode_strategy {decode_strategy!r}: expected "
            "'greedy_search', 'sampling' or 'beam_search'")
    dev = resolve_device(device)
    if model.device != dev:
        raise InvalidArgumentError(
            f"generate on {dev}, but the model lives on {model.device}")
    ids = torch.as_tensor(input_ids, device=dev).to(torch.long)
    if ids.dim() == 1:
        ids = ids[None]
    b, prompt_len = ids.shape
    if max_new_tokens is None:
        if max_length is None:
            raise ValueError("pass max_new_tokens or max_length")
        max_new_tokens = int(max_length) - prompt_len
    max_new = int(max_new_tokens)
    if max_new <= 0:
        raise ValueError("nothing to generate")
    if decode_strategy == "beam_search":
        eos = -1 if eos_token_id is None else int(eos_token_id)
        with torch.inference_mode():
            return _beam_search(model, ids, max_new, int(num_beams), eos,
                                int(pad_token_id), float(length_penalty))
    greedy = decode_strategy == "greedy_search"
    gen = torch.Generator(device=dev)
    if seed is None:
        gen.seed()
    else:
        gen.manual_seed(int(seed))
    pad = int(pad_token_id)
    with torch.inference_mode():
        caches = model.gen_fixed_cache(b, prompt_len + max_new)
        logits, caches = model.forward_fixed(ids, caches, 0)
        last = logits[:, -1, :].to(torch.float32)
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        score = torch.zeros(b, dtype=torch.float32, device=dev)
        out = []
        for step in range(max_new):
            proc = _process_logits(last, temperature, top_k, top_p, greedy)
            if greedy:
                nxt = torch.argmax(proc, dim=-1)
            else:
                nxt = torch.argmax(proc + gumbel(proc.shape, gen, dev),
                                   dim=-1)
            logp = torch.log_softmax(proc, dim=-1)
            step_lp = torch.gather(logp, -1, nxt[:, None])[:, 0]
            score = score + torch.where(finished, 0.0, step_lp)
            nxt = torch.where(finished, torch.full_like(nxt, pad), nxt)
            out.append(nxt)
            if eos_token_id is not None:
                finished = finished | (nxt == int(eos_token_id))
                if bool(finished.all()):
                    out.extend([torch.full_like(nxt, pad)]
                               * (max_new - step - 1))
                    break
            if step + 1 < max_new:
                logits, caches = model.forward_fixed(
                    nxt[:, None], caches, prompt_len + step)
                last = logits[:, -1, :].to(torch.float32)
    return torch.stack(out, dim=1).to(torch.int32), score


# after process_logits_dynamic: speculative imports keyed, which imports it
from .speculative import (commit_speculative_greedy,  # noqa: E402,F401
                          commit_speculative_sampled)


def _beam_search(model, ids, max_new: int, k: int, eos: int, pad: int,
                 length_penalty: float):
    """Batched beam search (reference ``_beam_search``): see the module
    docstring.  Returns (ids (B, max_new) int32, scores (B,))."""
    b, prompt_len = ids.shape
    dev = ids.device
    caches = model.gen_fixed_cache(b * k, prompt_len + max_new)
    logits, caches = model.forward_fixed(ids.repeat_interleave(k, dim=0),
                                         caches, 0)
    last = logits[:, -1, :].to(torch.float32)
    vocab = last.shape[-1]
    # beam 0 live, the others at -1e9, so step 1 picks distinct tokens
    scores = torch.full((b, k), _NEG, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    tok_buf = torch.full((b, k, max_new), pad, dtype=torch.int32, device=dev)
    for step in range(max_new):
        logp = torch.log_softmax(last, dim=-1).reshape(b, k, vocab)
        scores, tok, src_beam, flat_src, finished = beam_step(
            logp, scores, finished, keep_token=pad)
        tok_buf = torch.gather(tok_buf, 1,
                               src_beam[:, :, None].expand(b, k, max_new))
        tok = torch.where(finished, torch.full_like(tok, pad), tok)
        tok_buf[:, :, step] = tok
        finished = finished | (tok == eos)
        if step + 1 == max_new:
            break
        pos = prompt_len + step
        for kbuf, vbuf in caches:          # reorder the live rows only
            for buf in (kbuf, vbuf):
                buf[:, :pos] = buf[:, :pos].index_select(0, flat_src)
        logits, caches = model.forward_fixed(
            tok.reshape(-1, 1).to(torch.long), caches, pos)
        last = logits[:, -1, :].to(torch.float32)
    if length_penalty:
        lens = (tok_buf != pad).to(torch.float32).sum(dim=-1).clamp(min=1.0)
        ranked = scores / torch.pow((5.0 + lens) / 6.0, length_penalty)
    else:
        ranked = scores
    best = torch.argmax(ranked, dim=1)
    rows = torch.arange(b, device=dev)
    return tok_buf[rows, best], ranked[rows, best]
