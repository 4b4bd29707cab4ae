"""RNN-cell-shaped decoding API: Decoder / BeamSearchDecoder /
dynamic_decode (port of paddle_tpu/nn/decode.py).

Beams are a dense (batch*beam) leading axis, hypothesis reordering is a
gather, and backtracking (``gather_tree``) walks the steps backwards.
The loop is host-stepped like the reference's (it stops when every lane
has finished, a host read of the finished flags per step); the
fixed-budget path for serving is ``generation.generate``.  Beam selection
is ``generation.beam_step`` (ties to the lower index, as the reference's
``jax.lax.top_k``).  ``SampleEmbeddingHelper`` draws with the reference's
keyed categorical (``generation.keyed``: the key of ``seed`` folded in at
the step), so its samples equal the reference's up to a near tie.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..core.errors import InvalidArgumentError

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode", "gather_tree",
           "DecodeHelper", "TrainingHelper", "GreedyEmbeddingHelper",
           "SampleEmbeddingHelper", "BasicDecoder", "beam_search",
           "beam_search_decode"]

_NEG = -1e9


def _map(fn, tree):
    """``fn`` on every tensor of a tree of tuples, lists, namedtuples and
    dicts."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map(fn, t) for t in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def _map_many(fn, trees):
    """``fn(*leaves)`` across trees of one structure (per-step outputs)."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*[_map_many(fn, [t[i] for t in trees])
                             for i in range(len(first))])
    if isinstance(first, (tuple, list)):
        return type(first)(_map_many(fn, [t[i] for t in trees])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _map_many(fn, [t[k] for t in trees]) for k in first}
    return first


def gather_tree(ids, parents):
    """Backtrack beam parents into full sequences.

    ids / parents: (max_time, batch, beam) integer tensors (the stacked
    per-step predicted ids and parent beams of a beam search).  Returns
    the same shape with each beam's ancestry resolved (reference:
    gather_tree op)."""
    ids = torch.as_tensor(ids)
    parents = torch.as_tensor(parents, device=ids.device).to(torch.long)
    t, b, k = ids.shape
    batch_ix = torch.arange(b, device=ids.device)[:, None]
    beam_ix = torch.arange(k, device=ids.device).expand(b, k)
    out = torch.empty_like(ids)
    for step in range(t - 1, -1, -1):
        out[step] = ids[step][batch_ix, beam_ix]
        beam_ix = parents[step][batch_ix, beam_ix]
    return out


class Decoder:
    """Abstract decoder interface (reference fluid/layers/rnn.py Decoder):
    initialize() -> (initial_inputs, initial_states, initial_finished)
    step(time, inputs, states, **kwargs) ->
        (outputs, next_states, next_inputs, finished)
    finalize(outputs, final_states, sequence_lengths) -> (outputs, states)
    """

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        return outputs, final_states

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam-search wrapper over a single-step ``cell`` (reference
    BeamSearchDecoder).

    cell: callable (inputs, states) -> (cell_out, next_states), e.g. an
      RNN cell.
    output_fn: maps cell_out -> (B*K, vocab) logits (e.g. the projection
      layer); defaults to identity.
    embedding_fn: maps token ids -> cell inputs; defaults to identity.
    """

    OutputWrapper = collections.namedtuple(
        "OutputWrapper", ("scores", "predicted_ids", "parent_ids"))
    StateWrapper = collections.namedtuple(
        "StateWrapper", ("cell_states", "log_probs", "finished", "lengths"))

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """(B, ...) -> (B*K, ...) by repeating each batch entry K times."""
        return torch.as_tensor(x).repeat_interleave(int(beam_size), dim=0)

    def initialize(self, initial_cell_states):
        k = self.beam_size
        states = _map(lambda s: s.repeat_interleave(k, dim=0),
                      initial_cell_states)
        leaf = []
        _map(leaf.append, states)
        bk, dev = leaf[0].shape[0], leaf[0].device
        b = bk // k
        log_probs = torch.full((b, k), _NEG, dtype=torch.float32, device=dev)
        log_probs[:, 0] = 0.0
        finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
        lengths = torch.zeros((b, k), dtype=torch.int32, device=dev)
        init_inputs = torch.full((bk,), self.start_token, dtype=torch.int32,
                                 device=dev)
        if self.embedding_fn is not None:
            init_inputs = self.embedding_fn(init_inputs)
        return init_inputs, self.StateWrapper(states, log_probs, finished,
                                              lengths), finished

    def step(self, time, inputs, states, **kwargs):
        from ..generation import beam_step
        cell_out, next_cell = self.cell(inputs, states.cell_states, **kwargs)
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        logits = cell_out.to(torch.float32)                  # (B*K, V)
        k = self.beam_size
        vocab = logits.shape[-1]
        b = logits.shape[0] // k
        logp = torch.log_softmax(logits, dim=-1).reshape(b, k, vocab)
        # finished beams extend only with end_token at zero added cost
        top_sc, token, parent, flat_parent, finished = beam_step(
            logp, states.log_probs, states.finished,
            keep_token=self.end_token)
        lengths = torch.gather(states.lengths, 1, parent)
        lengths = torch.where(finished, lengths, lengths + 1)
        finished = finished | (token == self.end_token)
        next_cell = _map(lambda s: s.index_select(0, flat_parent), next_cell)
        outputs = self.OutputWrapper(top_sc, token, parent)
        next_states = self.StateWrapper(next_cell, top_sc, finished, lengths)
        next_inputs = token.reshape(-1)
        if self.embedding_fn is not None:
            next_inputs = self.embedding_fn(next_inputs)
        return outputs, next_states, next_inputs, finished

    def finalize(self, outputs, final_states, sequence_lengths):
        """Stacked per-step outputs -> backtracked (T, B, K) sequences."""
        predicted_ids = gather_tree(outputs.predicted_ids,
                                    outputs.parent_ids)
        return predicted_ids, final_states

    @property
    def tracks_own_finished(self):
        return True


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Step ``decoder`` until every lane finishes or max_step_num is hit
    (reference fluid/layers/rnn.py dynamic_decode).  Host-stepped: the
    finished flags are read on the host once per step."""
    inputs, states, finished = decoder.initialize(inits)
    step_outputs = []
    time = 0
    done = finished.cpu().numpy().astype(bool)
    while True:
        if max_step_num is not None and time >= max_step_num:
            break
        outputs, states, inputs, finished = decoder.step(
            time, inputs, states, **kwargs)
        step_outputs.append(outputs)
        time += 1
        # a lane that finished once stays finished (a helper's per-step
        # flag may flip back)
        done = done | finished.cpu().numpy().astype(bool)
        if bool(np.all(done)):
            break
    stacked = _map_many(lambda *xs: torch.stack(xs, dim=0), step_outputs)
    seq_lens = getattr(states, "lengths", None)
    final_outputs, final_states = decoder.finalize(stacked, states, seq_lens)
    if not output_time_major:
        final_outputs = _map(
            lambda x: x.permute([1, 0] + list(range(2, x.dim()))),
            final_outputs)
    if return_length:
        return final_outputs, final_states, seq_lens
    return final_outputs, final_states


# ---------------------------------------------------------------------------
# the seq2seq helper family (reference fluid/layers/rnn.py:
# DecodeHelper / TrainingHelper / GreedyEmbeddingHelper /
# SampleEmbeddingHelper / BasicDecoder), plugged into dynamic_decode


class DecodeHelper:
    """initialize() -> (initial_inputs, initial_finished);
    sample(time, outputs, states) -> sample_ids;
    next_inputs(time, outputs, states, sample_ids) ->
        (finished, next_inputs, next_states)."""

    def initialize(self):
        raise NotImplementedError

    def sample(self, time, outputs, states):
        raise NotImplementedError

    def next_inputs(self, time, outputs, states, sample_ids):
        raise NotImplementedError


class TrainingHelper(DecodeHelper):
    """Feed ground-truth inputs step by step (teacher forcing); sample is
    argmax over the cell outputs."""

    def __init__(self, inputs, sequence_length=None, time_major=False):
        x = torch.as_tensor(inputs)
        self._inputs = x if time_major else x.transpose(0, 1)   # (T, B, .)
        self._seq_len = (torch.as_tensor(sequence_length)
                         if sequence_length is not None else None)

    def initialize(self):
        t0 = self._inputs[0]
        b = t0.shape[0]
        finished = (torch.zeros((b,), dtype=torch.bool, device=t0.device)
                    if self._seq_len is None else self._seq_len < 1)
        return t0, finished

    def sample(self, time, outputs, states):
        return torch.argmax(outputs, dim=-1).to(torch.int32)

    def next_inputs(self, time, outputs, states, sample_ids):
        tt = int(time) + 1
        nmax = self._inputs.shape[0]
        nxt = self._inputs[min(max(tt, 0), nmax - 1)]
        if self._seq_len is None:
            finished = torch.full((nxt.shape[0],), tt >= nmax,
                                  dtype=torch.bool, device=nxt.device)
        else:
            finished = tt >= self._seq_len
        return finished, nxt, states


class GreedyEmbeddingHelper(DecodeHelper):
    """Feed embedding(argmax) each step (greedy inference)."""

    def __init__(self, embedding_fn, start_tokens, end_token):
        self._embed = embedding_fn
        self._start = torch.as_tensor(start_tokens).to(torch.int32)
        self._end = int(end_token)

    def initialize(self):
        b = self._start.shape[0]
        return (self._embed(self._start),
                torch.zeros((b,), dtype=torch.bool,
                            device=self._start.device))

    def sample(self, time, outputs, states):
        return torch.argmax(outputs, dim=-1).to(torch.int32)

    def next_inputs(self, time, outputs, states, sample_ids):
        return sample_ids == self._end, self._embed(sample_ids), states


class SampleEmbeddingHelper(GreedyEmbeddingHelper):
    """Feed embedding(categorical sample) each step: one draw per row
    under the key of ``seed`` folded in at the step (the reference's
    ``jax.random`` draw, reproduced by ``generation.keyed``)."""

    def __init__(self, embedding_fn, start_tokens, end_token,
                 softmax_temperature=None, seed=None):
        super().__init__(embedding_fn, start_tokens, end_token)
        self._temp = softmax_temperature
        self._seed = seed or 0

    def sample(self, time, outputs, states):
        from ..generation import keyed
        logits = outputs.to(torch.float32)
        if self._temp is not None:
            logits = logits / self._temp
        key = torch.from_numpy(
            np.array([[0, int(self._seed) & 0xFFFFFFFF]], np.int64)).to(
                logits.device)
        key = keyed.fold_in(key, int(time))
        noise = keyed.gumbel(key, logits.numel()).reshape(logits.shape)
        return torch.argmax(logits + noise, dim=-1).to(torch.int32)


class BasicDecoder(Decoder):
    """cell + helper + optional output layer, driven by dynamic_decode
    (reference BasicDecoder).  Step outputs are (cell_outputs,
    sample_ids) namedtuples."""

    Output = collections.namedtuple("BasicDecoderOutput",
                                    ("cell_outputs", "sample_ids"))

    def __init__(self, cell, helper, initial_states=None, output_fn=None):
        self._cell = cell
        self._helper = helper
        self._inits = initial_states
        self._output_fn = output_fn

    def initialize(self, inits=None):
        first_inputs, finished = self._helper.initialize()
        return first_inputs, (inits if inits is not None
                              else self._inits), finished

    def step(self, time, inputs, states, **kwargs):
        cell_out, next_states = self._cell(inputs, states)
        if self._output_fn is not None:
            cell_out = self._output_fn(cell_out)
        sample_ids = self._helper.sample(time, cell_out, next_states)
        finished, next_inputs, next_states = self._helper.next_inputs(
            time, cell_out, next_states, sample_ids)
        return (self.Output(cell_out, sample_ids), next_states,
                next_inputs, finished)


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, return_parent_idx=False,
                name=None):
    """One beam-search expansion step (reference fluid/layers/rnn.py
    beam_search) on dense (batch*beam, V) score rows.

    Returns (selected_ids (B*K, 1), selected_scores (B*K, 1)
    [, parent_idx (B*K,)]): the top-K (token, beam) pairs per batch
    element; finished beams (pre_ids == end_id) only propagate end_id."""
    from ..generation import top_k_first
    sc = torch.as_tensor(scores).to(torch.float32)
    pid = torch.as_tensor(pre_ids, device=sc.device).reshape(-1)
    psc = torch.as_tensor(pre_scores, device=sc.device).reshape(-1).to(
        torch.float32)
    bk, v = sc.shape
    k = int(beam_size)
    b = bk // k
    total = (sc if is_accumulated
             else psc[:, None] + torch.log(sc.clamp(min=1e-20)))
    finished = pid == end_id
    only_end = torch.full_like(total, _NEG)
    only_end[:, end_id] = psc
    total = torch.where(finished[:, None], only_end, total)
    top_s, top_i = top_k_first(total.reshape(b, k * v), k)     # (B, K)
    beam = top_i // v
    token = top_i % v
    parent = (beam + torch.arange(b, device=sc.device)[:, None] * k
              ).reshape(-1)
    res = (token.reshape(-1, 1).to(torch.int64), top_s.reshape(-1, 1))
    if return_parent_idx:
        res += (parent.to(torch.int64),)
    return res


def beam_search_decode(ids, scores, beam_size, end_id, parents=None,
                       name=None):
    """Backtrack a finished beam search (reference beam_search_decode):
    ``ids`` / ``scores`` are per-step stacked (T, B*K) selections whose
    parent pointers are resolved by gather_tree.  Takes lists of ((B*K, 1)
    ids, parent_idx) tuples, or stacked tensors with an explicit
    ``parents`` (T, B*K) — without the parent pointers the beams'
    reordering cannot be reconstructed, so omitting them raises."""
    if isinstance(ids, (list, tuple)):
        id_steps = torch.stack([torch.as_tensor(x).reshape(-1)
                                for x, _ in ids])
        parents = torch.stack([torch.as_tensor(p).reshape(-1)
                               for _, p in ids])
        sc_steps = torch.stack([torch.as_tensor(s).reshape(-1)
                                for s in scores])
    else:
        if parents is None:
            raise InvalidArgumentError(
                "beam_search_decode: stacked-array input needs `parents` "
                "(the per-step parent_idx from beam_search) — without it "
                "the backtrack would silently assume no beam reordering")
        id_steps = torch.as_tensor(ids)
        parents = torch.as_tensor(parents)
        sc_steps = torch.as_tensor(scores)
    t, bk = id_steps.shape
    k = int(beam_size)
    b = bk // k
    # beam_search emits flat parent rows (beam + batch*k, right for state
    # gathering); gather_tree wants per-batch beam slots in [0, k)
    par = (parents % k).reshape(t, b, k).to(torch.int32)
    full = gather_tree(id_steps.reshape(t, b, k), par)
    # the scores follow the same ancestry: backtrack the slot indices,
    # then index the raw scores with them
    slots = torch.arange(k, dtype=torch.int32).reshape(1, 1, k).expand(
        t, b, k).contiguous()
    anc = gather_tree(slots, par)
    sc = torch.gather(sc_steps.reshape(t, b, k), 2, anc.to(torch.long))
    return full, sc
