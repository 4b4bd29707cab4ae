"""Speculative decoding: the accept/reject of draft proposals inside the
serving engine's verify program (port of
paddle_tpu/generation/speculative.py).

A cheap draft model proposes K tokens; the target scores the last
committed token and the K proposals in one forward of K+1 rows per slot;
the longest prefix of proposals the target agrees with is committed, plus
one corrected (or bonus) token drawn from the target.  A tick therefore
commits 1..K+1 tokens per target forward (Leviathan et al. 2023, Chen et
al. 2023).

Everything here is torch ops on device tensors with no host read, so the
functions run inside a captured CUDA graph.

- **Greedy** (``commit_speculative_greedy``): a proposal is accepted iff
  it equals the target's argmax at its row, the correction is the argmax
  at the first disagreement: the committed stream is the target-only
  greedy chain, whatever the draft proposes.
- **Sampling** (``commit_speculative_sampled``): proposal x_i ~ q_i (the
  draft's processed distribution) is accepted with probability
  min(1, p_i(x_i) / q_i(x_i)); the correction at the first rejection is
  drawn from norm(max(p - q, 0)), the bonus after K accepts from p_K (q
  padded with a zero row).  Greedy rows take the argmax route; a
  sampling row with speculation off draws its one token from p_0 under
  the plain decode step's key fold, so it streams as the plain engine.

Keys: all draws derive from ``kbase = fold_in(key, pos)`` (pos the slot's
KV length at the tick) salted by stage: draft proposals fold
``(SALT_DRAFT, i)``, accept uniforms ``SALT_ACCEPT``, corrections
``(SALT_RESIDUAL, n)``.  With ``generation.keyed``'s threefry the keys,
the accept uniforms and therefore the tokens equal the reference's.
"""
from __future__ import annotations

import torch

from .keyed import categorical, fold_in, uniform

__all__ = ["SALT_DRAFT", "SALT_ACCEPT", "SALT_RESIDUAL",
           "draft_proposal_key", "commit_speculative_greedy",
           "commit_speculative_sampled"]

# fold_in salts: one draw stream per stage (the plain decode step folds
# the key at pos unsalted; spec-off rows reuse exactly that)
SALT_DRAFT = 0x5D
SALT_ACCEPT = 0x5A
SALT_RESIDUAL = 0x5E


def draft_proposal_key(keys, pos, i: int):
    """(S, 2) keys of the draft's i-th proposal at KV lengths ``pos``."""
    return fold_in(fold_in(fold_in(keys, pos), SALT_DRAFT), i)


def _accept_count(acc):
    """(S, K) bool accept flags -> (S,) length of the accepted prefix."""
    return torch.cumprod(acc.to(torch.int64), dim=1).sum(dim=1)


def _emit(props, plog, n, corr, pad_token: int):
    """The committed block: accepted proposals, the correction at n, then
    pad.  Returns (out (S, K+1) int64, count (S,), logp (S, K+1) under the
    processed target, 0 past the correction)."""
    s, k1 = plog.shape[0], plog.shape[1]
    j = torch.arange(k1, device=plog.device)[None, :]
    props_ext = torch.cat([props, torch.zeros_like(props[:, :1])], dim=1)
    pad = torch.full_like(props_ext, pad_token)
    out = torch.where(j < n[:, None], props_ext,
                      torch.where(j == n[:, None], corr[:, None], pad))
    lp = torch.gather(torch.log_softmax(plog, dim=-1), 2,
                      out[..., None])[..., 0]
    lp = torch.where(j <= n[:, None], lp, torch.zeros_like(lp))
    return out, n + 1, lp


def commit_speculative_greedy(props, qs, plog, keys, pos, greedy, spec_on,
                              pad_token: int):
    """The all-greedy commit: argmax comparison, no draws.  props (S, K)
    proposals, plog (S, K+1, V) target logits (for greedy rows the
    processing is the identity), spec_on (S,) bool; qs, keys, pos and
    greedy are ignored (the sampled commit's signature).  Returns (out
    (S, K+1), count (S,), accepted (S,), last (S,), logp (S, K+1)):
    ``out[:, :count]`` are the committed tokens, ``last`` the new last
    committed token, ``accepted`` the accepted-proposal count."""
    del qs, keys, pos, greedy
    k = props.shape[1]
    tops = torch.argmax(plog, dim=-1)                       # (S, K+1)
    acc = (props == tops[:, :k]) & spec_on[:, None]
    n = _accept_count(acc)
    corr = torch.gather(tops, 1, n[:, None])[:, 0]
    out, count, lp = _emit(props, plog, n, corr, pad_token)
    return out, count, n, corr, lp


def commit_speculative_sampled(props, qs, plog, keys, pos, greedy, spec_on,
                               pad_token: int):
    """The commit of a batch with sampling rows: props (S, K) drawn from
    qs (S, K, V), the draft's processed probabilities; plog (S, K+1, V)
    processed target logits; keys (S, 2); pos (S,) KV lengths; greedy /
    spec_on (S,) bool.  Greedy rows take the argmax route, sampling rows
    the rejection scheme of the module docstring.  Returns the tuple of
    ``commit_speculative_greedy``."""
    s, k1, v = plog.shape
    k = k1 - 1
    pprob = torch.softmax(plog, dim=-1)
    tops = torch.argmax(plog, dim=-1)
    p_d = torch.gather(pprob[:, :k], 2, props[..., None])[..., 0]
    q_d = torch.gather(qs, 2, props[..., None])[..., 0]
    kbase = fold_in(keys, pos)
    u = uniform(fold_in(kbase, SALT_ACCEPT), k)
    # accept iff u < p/q, as u*q < p: q == 0 rejects instead of dividing
    acc_sample = u * q_d < p_d
    acc_greedy = props == tops[:, :k]
    acc = torch.where(greedy[:, None], acc_greedy, acc_sample) \
        & spec_on[:, None]
    n = _accept_count(acc)
    # correction at the first rejection (bonus at K after K accepts): the
    # residual of p_n against q_n, q padded with a zero row so that n == K
    # gives p_K itself
    take = n[:, None, None].expand(s, 1, v)
    p_n = torch.gather(pprob, 1, take)[:, 0]
    q_pad = torch.cat([qs, torch.zeros_like(qs[:, :1])], dim=1)
    q_n = torch.gather(q_pad, 1, take)[:, 0]
    resid = torch.clamp_min(p_n - q_n, 0.0)
    tot = resid.sum(dim=-1, keepdim=True)
    # q == p (a draft equal to the target): an empty residual, any draw
    # is right; take p_n
    resid = torch.where(tot > 0, resid / torch.clamp_min(tot, 1e-38), p_n)
    kres = fold_in(fold_in(kbase, SALT_RESIDUAL), n)
    corr_resid = categorical(kres, torch.log(resid))
    corr_greedy = torch.gather(tops, 1, n[:, None])[:, 0]
    # spec-off sampling rows: the plain decode step's draw, bit for bit
    corr_plain = categorical(kbase, plog[:, 0])
    corr = torch.where(greedy, corr_greedy,
                       torch.where(spec_on, corr_resid, corr_plain))
    out, count, lp = _emit(props, plog, n, corr, pad_token)
    return out, count, n, corr, lp
