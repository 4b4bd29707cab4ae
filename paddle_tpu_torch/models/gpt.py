"""GPT-2 model family (port of paddle_tpu/models/gpt.py, serving path).

Pre-LN decoder blocks with fused QKV and a tied LM head; parameter names
match the reference's state keys.  Three decode protocols:

- ``forward(ids, cache=...)``: growing (k, v) cache, the reference's
  eager path;
- ``gen_fixed_cache`` / ``forward_fixed``: preallocated (B, T, H, D)
  buffers written at ``pos`` (an int, or a (B,) tensor of per-row
  positions — the serving engine's fixed pool and ``generate`` use it).
  Buffers are updated in place (the reference returns new arrays);
- ``forward_paged``: R consecutive tokens per slot (one decode token, or
  a speculative verify's K+1) against the paged block pool — each layer
  writes its new K/V rows through ``writes`` (an
  ``ops.paged_attention.RowWrites`` planned on the host, or the serving
  engine's ``SlotRowWrites`` planned on the device) and attends with the
  paged attention kernel straight on the pool, never gathering a view:
  the S * R query rows go to the kernel as rows of their own, each with
  its slot's table and its own position, so row j sees rows <= pos + j.

Training: in training mode ``attend`` reaches the flash kernels K1/K2
through ``F.scaled_dot_product_attention`` whenever the reference would
(causal, no mask, head_dim 64/128/256, seq % 128 == 0), with q/k/v passed
as strided views of the fused-QKV output (no copy).  ``forward(ids,
labels=...)`` returns per-token losses through the fused tied-head
cross-entropy; ``GPTPretrainingCriterion`` is the logits + cross-entropy
loss the benchmark's training step uses.

Tensor parallelism (``GPTForPretraining.shard_tensor_parallel(mesh)``,
the serving engine's ``mesh=``): the model keeps this rank's blocks of
the reference's Megatron layout (``parallel.sharding.param_specs(...,
tensor_parallel=True)``) and its forward is the rank-local one GSPMD
makes of that layout: column-parallel qkv / ffn_in (the qkv block is the
rank's heads of q, k and v), row-parallel proj / ffn_out each followed by
one all-reduce (their biases added after it), the vocabulary-sharded
embeddings looked up as the rank's rows, masked and all-reduced (exact:
one owner's row plus zeros), and the tied head's logits sharded over the
vocabulary and all-gathered.  The KV caches hold the rank's heads.  A
linear whose weight no rule shards (an int8 weight-only model's
``w_int8``) runs whole on every rank (a sharded bias of it is gathered
first): its output is cut to the rank's heads (qkv) or its input gathered
whole (proj, ffn_out).

Constructors take ``device`` (default ``"cuda"``; raises without a card)
and ``seed`` for the weight draw.
"""
from __future__ import annotations

import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.errors import InvalidArgumentError
from ..nn import functional as F
from ..nn.layer.common import Dropout, Embedding, Linear
from ..nn.layer.container import LayerList
from ..nn.layer.norm import LayerNorm
from ..nn.layer_base import Layer
from ..ops.fused_ce import fused_linear_cross_entropy
from ..ops.int8_matmul import dequant_matmul
from ..ops.paged_attention import paged_attention
from ..tensor.linalg import matmul

__all__ = ["GPTConfig", "gpt2_small_config", "gpt2_medium_config",
           "gpt2_large_config", "GPTBlock", "GPTModel", "GPTForPretraining",
           "GPTPretrainingCriterion"]


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=None,
                 hidden_act="gelu", hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1,
                 max_position_embeddings=1024, initializer_range=0.02):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.initializer_range = initializer_range


def gpt2_small_config(**kw):
    return GPTConfig(**kw)


def gpt2_medium_config(**kw):
    base = dict(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16)
    base.update(kw)
    return GPTConfig(**base)


def gpt2_large_config(**kw):
    base = dict(hidden_size=1280, num_hidden_layers=36, num_attention_heads=20)
    base.update(kw)
    return GPTConfig(**base)


def _positions(pos, b: int, s: int, device):
    """(b, s) absolute positions pos + [0, s) from an int or a (b,) tensor
    (an int never becomes a device tensor by a host copy: the serving
    engine's programs run as captured CUDA graphs)."""
    steps = torch.arange(s, device=device)
    if not isinstance(pos, torch.Tensor):
        return (steps + int(pos)).expand(b, s)
    return (pos.to(device=device, dtype=torch.long).reshape(-1, 1)
            .expand(b, 1) + steps)


class GPTBlock(Layer):
    """Pre-LN transformer decoder block with fused QKV."""

    def __init__(self, cfg: GPTConfig, *, device=None, generator=None):
        super().__init__()
        self._remat_stage = True  # jit.recompute_policy("stages") boundary
        std = cfg.initializer_range
        h = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.heads = self.num_heads     # this rank's (tensor parallel)
        self.head_dim = h // cfg.num_attention_heads
        self.hidden_size = h
        self._tp = None                 # parallel.tensor_parallel context
        self._tp_split = frozenset()    # the local names it shards
        self.ln1 = LayerNorm(h, epsilon=1e-5, device=device)
        self.qkv = Linear(h, 3 * h, std=std, device=device,
                          generator=generator)
        self.proj = Linear(h, h, std=std, device=device, generator=generator)
        self.ln2 = LayerNorm(h, epsilon=1e-5, device=device)
        self.ffn_in = Linear(h, cfg.intermediate_size, std=std, device=device,
                             generator=generator)
        self.ffn_out = Linear(cfg.intermediate_size, h, std=std,
                              device=device, generator=generator)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.attn_dropout = cfg.attention_probs_dropout_prob
        self.act = cfg.hidden_act

    def _split_qkv(self, x):
        b, s = x.shape[0], x.shape[1]
        if self._tp is None or "qkv.weight" in self._tp_split:
            qkv = self.qkv(x).reshape(b, s, 3, self.heads, self.head_dim)
        else:   # whole weight: whole output, then this rank's heads
            qkv = self._whole(self.qkv, x, "qkv").reshape(
                b, s, 3, self.num_heads, self.head_dim)
            hl, r = self.heads, self._tp.rank
            qkv = qkv[:, :, :, r * hl:(r + 1) * hl]
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    # -- tensor parallel (module docstring) ----------------------------------
    def _whole(self, lin, x, name):
        """A replicated linear's whole output (its sharded bias, if any,
        gathered whole)."""
        if f"{name}.bias" not in self._tp_split:
            return lin(x)
        tp = self._tp
        bias = (tp.gather_qkv_bias(lin.bias, self.num_heads)
                if name == "qkv" else tp.all_gather(lin.bias, 0))
        return _no_bias(lin, x) + bias

    def _row(self, lin, x, name):
        """Row-parallel ``lin`` over the rank's part ``x`` of its input:
        the partial product all-reduced, then the bias; a replicated one
        over the input gathered whole."""
        if f"{name}.weight" not in self._tp_split:
            return lin(self._tp.all_gather(x, -1))
        y = self._tp.all_reduce(_no_bias(lin, x))
        return y if lin.bias is None else y + lin.bias

    def _proj(self, ctx):
        if self._tp is None:
            return self.proj(ctx)
        return self._row(self.proj, ctx, "proj")

    def _mlp(self, x):
        act = getattr(F, self.act)
        if self._tp is None:
            return self.ffn_out(act(self.ffn_in(self.ln2(x))))
        tp, split = self._tp, self._tp_split
        if "ffn_in.weight" in split:
            hid = act(self.ffn_in(self.ln2(x)))
        else:
            hid = act(self._whole(self.ffn_in, self.ln2(x), "ffn_in"))
            if "ffn_out.weight" in split:
                n = hid.shape[-1] // tp.n
                hid = hid[..., tp.rank * n:(tp.rank + 1) * n]
        if "ffn_out.weight" not in split and "ffn_in.weight" not in split:
            return self.ffn_out(hid)
        return self._row(self.ffn_out, hid, "ffn_out")

    def attend(self, x, cache=None):
        b, s = x.shape[0], x.shape[1]
        q, k, v = self._split_qkv(x)
        new_cache = None
        if cache is not None:
            pk, pv = cache
            if pk.shape[1]:
                k = torch.cat([pk, k], dim=1)
                v = torch.cat([pv, v], dim=1)
            new_cache = (k, v)
        ctx = F.scaled_dot_product_attention(
            q, k, v, is_causal=(s > 1), dropout_p=self.attn_dropout,
            training=self.training)
        return self._proj(ctx.reshape(b, s, -1)), new_cache

    def forward(self, x, cache=None):
        a, new_cache = self.attend(self.ln1(x), cache)
        x = x + self.dropout(a)
        x = x + self.dropout(self._mlp(x))
        return x if cache is None else (x, new_cache)

    def attend_fixed(self, x, kbuf, vbuf, pos):
        """Decode attention against a fixed-size (B, T, H, D) buffer,
        writing this chunk's k/v at [pos, pos+s) (per row when pos is a
        (B,) tensor).  Like the reference's dynamic_update_slice, a write
        start past T - s clamps; the mask uses the unclamped position."""
        b, s = x.shape[0], x.shape[1]
        q, k, v = self._split_qkv(x)
        t = kbuf.shape[1]
        q_idx = _positions(pos, b, s, x.device)              # (b, s)
        start = q_idx[:, :1].clamp(0, t - s)
        rows = start + torch.arange(s, device=x.device)
        bidx = torch.arange(b, device=x.device)[:, None]
        kbuf[bidx, rows] = k.to(kbuf.dtype)
        vbuf[bidx, rows] = v.to(vbuf.dtype)
        key_idx = torch.arange(t, device=x.device)
        mask = torch.where(key_idx[None, None, :] <= q_idx[:, :, None],
                           0.0, -1e30).to(q.dtype)[:, None]  # (b, 1, s, t)
        ctx = F.scaled_dot_product_attention(
            q, kbuf.to(q.dtype), vbuf.to(q.dtype), attn_mask=mask,
            dropout_p=0.0, training=False)
        return self._proj(ctx.reshape(b, s, -1)), kbuf, vbuf

    def forward_fixed(self, x, kbuf, vbuf, pos):
        a, kbuf, vbuf = self.attend_fixed(self.ln1(x), kbuf, vbuf, pos)
        x = x + a
        return x + self._mlp(x), kbuf, vbuf

    def forward_paged(self, x, kpool, vpool, tables, pos, writes):
        """R tokens per slot: x (S, R, hidden).  The new K/V rows go
        through ``writes`` into the pools (scrub, then scatter; inactive
        slots are dropped), then the paged kernel attends on the pools for
        the S * R query rows, ``tables`` (S * R, nb) and ``pos`` (S * R,)
        given per row."""
        s, r = x.shape[0], x.shape[1]
        q, k, v = self._split_qkv(self.ln1(x))
        flat = (s * r, self.heads, self.head_dim)
        writes.apply(kpool, k.reshape(flat))
        writes.apply(vpool, v.reshape(flat))
        ctx = paged_attention(q.reshape(flat).contiguous(), kpool, vpool,
                              tables, pos)
        x = x + self._proj(ctx.reshape(s, r, -1))
        return x + self._mlp(x)


class GPTModel(Layer):
    def __init__(self, cfg: GPTConfig = None, device=DEFAULT_DEVICE,
                 seed: int = 0, **kw):
        super().__init__()
        self.config = cfg or GPTConfig(**kw)
        cfg = self.config
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        std = cfg.initializer_range
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         std=std, device=dev, generator=gen)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, std=std,
                                             device=dev, generator=gen)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.blocks = LayerList([GPTBlock(cfg, device=dev, generator=gen)
                                 for _ in range(cfg.num_hidden_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, epsilon=1e-5, device=dev)
        self._tp = None
        self._tp_split = frozenset()

    def _kv_heads(self) -> int:
        cfg = self.config
        h = cfg.num_attention_heads
        return h if self._tp is None else h // self._tp.n

    def _embed_at(self, input_ids, position_ids):
        # out-of-range positions clamp, as the reference's gather does
        # (only decode-chunk tail iterations past max_len reach them)
        position_ids = position_ids.clamp(
            0, self.config.max_position_embeddings - 1)
        if self._tp is None:
            return (self.word_embeddings(input_ids)
                    + self.position_embeddings(position_ids))
        # the sharded tables' masked rows summed over the ranks: one
        # owner's row plus exact zeros, the single-device values
        parts, whole = [], []
        for emb, ids, name in ((self.word_embeddings, input_ids, "word"),
                               (self.position_embeddings, position_ids,
                                "position")):
            if f"{name}_embeddings.weight" in self._tp_split:
                parts.append(_local_rows(emb.weight, ids, self._tp.rank))
            else:
                whole.append(emb(ids))
        if not parts:
            return whole[0] + whole[1]
        h = self._tp.all_reduce(parts[0] if len(parts) == 1
                                else parts[0] + parts[1])
        return h if not whole else (
            whole[0] + h if "word_embeddings.weight" not in self._tp_split
            else h + whole[0])

    def embed(self, input_ids, position_ids=None, past_len=0):
        if position_ids is None:
            position_ids = _positions(past_len, input_ids.shape[0],
                                      input_ids.shape[-1], input_ids.device)
        return self.dropout(self._embed_at(input_ids, position_ids))

    def forward(self, input_ids, position_ids=None, cache=None):
        past_len = 0 if cache is None else cache[0][0].shape[1]
        h = self.embed(input_ids, position_ids, past_len)
        new_caches = []
        for i, blk in enumerate(self.blocks):
            if cache is not None:
                h, c = blk(h, cache[i])
                new_caches.append(c)
            else:
                h = blk(h)
        h = self.ln_f(h)
        return h if cache is None else (h, new_caches)

    def gen_cache(self, batch_size=1):
        cfg = self.config
        hd = cfg.hidden_size // cfg.num_attention_heads
        shape = (batch_size, 0, self._kv_heads(), hd)
        return [(torch.zeros(shape, device=self.device),
                 torch.zeros(shape, device=self.device))
                for _ in range(cfg.num_hidden_layers)]

    def gen_fixed_cache(self, batch_size, max_length, dtype=None):
        """Preallocated (k, v) buffers per layer, each
        (B, max_length, H, D)."""
        cfg = self.config
        hd = cfg.hidden_size // cfg.num_attention_heads
        shape = (batch_size, max_length, self._kv_heads(), hd)
        dt = dtype or torch.float32
        return [(torch.zeros(shape, dtype=dt, device=self.device),
                 torch.zeros(shape, dtype=dt, device=self.device))
                for _ in range(cfg.num_hidden_layers)]

    def forward_fixed(self, input_ids, caches, pos):
        """Fixed-cache forward: caches [(kbuf, vbuf)], pos the write offset
        (int or per-row (B,) tensor).  Returns (h, caches)."""
        b, s = input_ids.shape
        h = self._embed_at(input_ids, _positions(pos, b, s, input_ids.device))
        new_caches = []
        for blk, (kbuf, vbuf) in zip(self.blocks, caches):
            h, kbuf, vbuf = blk.forward_fixed(h, kbuf, vbuf, pos)
            new_caches.append((kbuf, vbuf))
        return self.ln_f(h), new_caches

    def forward_paged(self, input_ids, pools, tables, pos, writes):
        """Paged decode: input_ids (S, R) at positions pos + [0, R), pools
        [(kpool, vpool)] of (num_blocks, block_size, H, D), tables (S, nb)
        int32, pos (S,) int32 device positions, writes the step's row
        writes (R rows per slot).  With R > 1 each query row attends
        through its slot's table, repeated per row (a copy, no host
        read), up to its own position."""
        s, r = input_ids.shape
        q_pos = pos.to(torch.long)[:, None] + torch.arange(
            r, device=pos.device)                            # (S, R)
        h = self._embed_at(input_ids, q_pos)
        if r > 1:
            tables = tables[:, None].expand(s, r, tables.shape[1]).reshape(
                s * r, tables.shape[1])
            pos = q_pos.reshape(-1).to(torch.int32)
        for blk, (kp, vp) in zip(self.blocks, pools):
            h = blk.forward_paged(h, kp, vp, tables, pos, writes)
        return self.ln_f(h)


class GPTForPretraining(Layer):
    """Causal-LM head with tied embedding weights."""

    def __init__(self, cfg: GPTConfig = None, device=DEFAULT_DEVICE,
                 seed: int = 0, **kw):
        super().__init__()
        self.gpt = GPTModel(cfg, device=device, seed=seed, **kw)
        self._tp = None
        self._tp_specs = None

    def _logits(self, h):
        logits = matmul(h, self.gpt.word_embeddings.weight, transpose_y=True)
        if "word_embeddings.weight" in self.gpt._tp_split:
            logits = self.gpt._tp.all_gather(logits, -1)
        return logits

    # -- tensor parallel (module docstring) -----------------------------------
    def shard_tensor_parallel(self, mesh, what: str = "KV pool"):
        """Keep this rank's blocks of the reference's layout over
        ``mesh``'s ``tp`` axis and run the rank-local forward from now on;
        returns the specs by state name (a replicated one is ``P()``).
        Refuses (InvalidArgumentError) a head count that ``tp`` does not
        divide: every KV leaf would be replicated."""
        from ..parallel.sharding import param_specs, tp_spec
        from ..parallel.tensor_parallel import TensorParallel
        tp = TensorParallel(mesh)
        cfg = self.gpt.config
        if tp.n > 1 and cfg.num_attention_heads % tp.n:
            raise InvalidArgumentError(
                f"tensor-parallel {what} fully replicated: no KV "
                f"leaf's head axis ({cfg.num_attention_heads} heads) divides "
                f"tp={tp.n} — fix the head count or the mesh (a replicated "
                "pool costs tp x the memory and defeats the sharding)")
        state = self.state_dict(keep_vars=True)
        specs = param_specs({k: tuple(v.shape) for k, v in state.items()},
                            mesh, tensor_parallel=True)
        self._tp_specs = specs
        # at tp=1 the specs replicate everything (the reference's rule);
        # the rank-local forward still runs the rules' layout there, its
        # collectives over the one-rank group
        split = {k for k, spec in specs.items()
                 if ("tp" in tuple(spec) if tp.n > 1 else
                     tp_spec(k, tuple(state[k].shape)) is not None)}
        with torch.no_grad():
            for k in split:
                state[k].data = tp.block(k, state[k].data, specs[k],
                                         cfg.num_attention_heads).clone()
        self._tp = tp
        gpt = self.gpt
        gpt._tp = tp
        gpt._tp_split = frozenset(k[len("gpt."):] for k in split
                                  if k.count(".") == 2)
        for i, blk in enumerate(gpt.blocks):
            pre = f"gpt.blocks.{i}."
            blk._tp = tp
            blk._tp_split = frozenset(k[len(pre):] for k in split
                                      if k.startswith(pre))
            blk.heads = blk.num_heads // tp.n
        return specs

    def tp_slice(self, name: str, whole):
        """This rank's block of the whole state tensor ``name`` (as
        ``shard_tensor_parallel`` cut it); a replicated one unchanged."""
        spec = self._tp_specs[name]
        if "tp" not in tuple(spec):
            return whole
        return self._tp.block(name, whole, spec,
                              self.gpt.config.num_attention_heads)

    def forward(self, input_ids, position_ids=None, cache=None, labels=None):
        """With ``labels``, per-token losses through the fused tied-head
        cross-entropy (the (B, S, V) logits are never kept for the
        backward); without, the logits."""
        out = self.gpt(input_ids, position_ids, cache)
        h = out[0] if isinstance(out, tuple) else out
        if labels is not None:
            if cache is not None:
                raise InvalidArgumentError(
                    "[gpt] labels with cache is unsupported: the fused CE "
                    "is a training path; compute losses from the returned "
                    "logits when decoding")
            return fused_linear_cross_entropy(
                h, self.gpt.word_embeddings.weight, labels)
        logits = self._logits(h)
        return logits if cache is None else (logits, out[1])

    # --- decode protocols (generation.generate, serving.ServingEngine) ---
    def gen_fixed_cache(self, batch_size, max_length, dtype=None):
        return self.gpt.gen_fixed_cache(batch_size, max_length, dtype)

    def forward_fixed(self, input_ids, caches, pos):
        h, caches = self.gpt.forward_fixed(input_ids, caches, pos)
        return self._logits(h), caches

    def forward_paged(self, input_ids, pools, tables, pos, writes):
        return self._logits(self.gpt.forward_paged(input_ids, pools, tables,
                                                   pos, writes))

    def generate(self, input_ids, **kwargs):
        """Greedy / sampling decoding — see paddle_tpu_torch.generation."""
        from ..generation import generate
        kwargs.setdefault("device", self.device)
        return generate(self, input_ids, **kwargs)


def _no_bias(lin, x):
    """``lin``'s product without its bias (a Linear or an int8
    weight-only one)."""
    if hasattr(lin, "w_int8"):
        return dequant_matmul(x, lin.w_int8, lin.w_scale)
    return F.linear(x, lin.weight, None)


def _local_rows(block, ids, rank: int):
    """Rows ``ids`` of the table whose rows ``[rank * n, (rank + 1) * n)``
    are ``block`` (n, width): the rank's own, zeros elsewhere."""
    n = block.shape[0]
    local = ids - rank * n
    mine = (local >= 0) & (local < n)
    rows = block[local.clamp(0, n - 1)]
    return torch.where(mine[..., None], rows, torch.zeros(
        (), dtype=rows.dtype, device=rows.device))


class GPTPretrainingCriterion(Layer):
    """Mean token cross-entropy of (B, S, V) logits against (B, S) labels,
    or the ``loss_mask``-weighted mean."""

    def forward(self, logits, labels, loss_mask=None):
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1), reduction="none")
        if loss_mask is not None:
            m = loss_mask.reshape(-1).to(loss.dtype)
            return (loss * m).sum() / m.sum()
        return loss.mean()
