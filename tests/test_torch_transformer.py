"""paddle_tpu_torch's Transformer layers against the JAX package on the
CPU: ``MultiHeadAttention`` (self and cross, with the padding mask as the
flash kernels' per-key bias), the encoder, the decoder and ``Transformer``
at d_model 128, 2 heads (head_dim 64), sequences of 128 and 256, so that
the flash route is taken (the reference running its Pallas kernels
through the interpreter); a 2 + 2-layer translation model (shared
embedding, tied output projection, label smoothing, Adam under
NoamDecay) through ``jit.TrainStep`` for 3 steps; the reference's
(B, Sk) rule at B == S; incremental decoding with ``gen_cache`` against a
full recompute; the cloned layers' independence.  Weights come from the
reference by state name (``load_paddle_state``); inputs from numpy seeds.

Tolerances: f32 outputs, gradients and losses within 1e-5 (relative,
plus 1e-5 of the tensor's largest |value|: sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit import functional_call, state_arrays
from paddle_tpu.ops import flash_attention as jfa

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

D, H, FF, B, S = 128, 2, 256, 2, 128
VOCAB, STEPS, LR_SCALE = 256, 3, 2.0
PAD, BOS = 0, 1


@pytest.fixture(autouse=True)
def interpret():
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = False


def _f(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=tol, atol=tol * max(float(np.abs(want).max()), 1.0))


def _state(jl):
    return {k: np.asarray(v) for k, v in state_arrays(jl).items()}


def _pad_mask(lens, s):
    """(B, 1, 1, s) additive f32 mask: 0 on the first lens[b] keys, -1e9
    past them."""
    keep = np.arange(s)[None, :] < np.asarray(lens)[:, None]
    return np.where(keep, 0.0, -1e9).astype(np.float32)[:, None, None, :]


def _causal(s):
    return np.where(np.tril(np.ones((s, s), bool)), 0.0, -1e9).astype(
        np.float32)


@pytest.fixture
def plain_calls(monkeypatch):
    """A list that grows by one at each call of the port's flash forward
    (on the CPU, the kernel's plain version)."""
    calls = []
    orig = tfa._plain_fwd

    def counting(*a):
        calls.append(1)
        return orig(*a)
    monkeypatch.setattr(tfa, "_plain_fwd", counting)
    return calls


def _wrapped(pkg, inner, fn):
    """``inner`` called as ``fn(inner, *inputs)``, as a layer of ``pkg``
    (its state under ``inner.``)."""
    class Wrap(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.inner = inner

        def forward(self, *xs):
            return fn(self.inner, *xs)
    return Wrap()


def _parity(make, fn, inputs, n_float, seed=1):
    """``make(pkg)`` built in both packages (the reference's weights
    loaded into the port's), run as ``fn(layer, *inputs)``: the outputs
    and the gradients of sum(out * cot) for every parameter and the first
    ``n_float`` inputs agree."""
    paddle.seed(seed)
    jl = _wrapped(paddle, make(paddle), fn)
    tl = _wrapped(pt, make(pt), fn)
    state = _state(jl)
    pt.load_paddle_state(tl, state)
    consts = [Tensor(jnp.asarray(a)) for a in inputs[n_float:]]

    def ref_loss(st, xs):
        out = functional_call(jl, st, *[Tensor(x) for x in xs], *consts)
        cot = jnp.asarray(np.random.RandomState(97).randn(*out.shape),
                          out.dtype)
        return (out * cot).sum(), out
    (_, rout), (rgs, rgx) = jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in state.items()},
        [jnp.asarray(a) for a in inputs[:n_float]])
    ins = [torch.tensor(a, requires_grad=i < n_float)
           for i, a in enumerate(inputs)]
    out = tl(*ins)
    cot = torch.from_numpy(np.random.RandomState(97).randn(
        *out.shape).astype(np.float32))
    (out * cot).sum().backward()
    _close(out.detach().numpy(), rout)
    params = dict(tl.named_parameters())
    assert set(params) == set(state)
    for k in state:
        _close(params[k].grad.numpy(), rgs[k])
    for t, g in zip(ins[:n_float], rgx):
        _close(t.grad.numpy(), g)


# --------------------------------------------------------------- the layers

@pytest.mark.parametrize("sk", [S, 2 * S], ids=["self", "cross"])
def test_multi_head_attention_matches_reference(sk, plain_calls):
    """Self-attention (Sq = Sk = 128) and cross-attention (Sk = 256, keys
    and values from another input), each with its (B, 1, 1, Sk) padding
    mask, on the flash route (the port's kernel forward once)."""
    q = _f(B, S, D, seed=2)
    kv = q if sk == S else _f(B, sk, D, seed=3)
    _parity(lambda pkg: pkg.nn.MultiHeadAttention(D, H),
            lambda m, q, kv, mask: m(q, kv, kv, mask),
            [q, kv, _pad_mask([sk - 40, sk], sk)], 2)
    assert len(plain_calls) == 1


def _enc_layer(pkg, **kw):
    return pkg.nn.TransformerEncoderLayer(D, H, FF, dropout=0.0, **kw)


def _dec_layer(pkg, **kw):
    return pkg.nn.TransformerDecoderLayer(D, H, FF, dropout=0.0, **kw)


STACKS = {
    "encoder": (lambda pkg: pkg.nn.TransformerEncoder(_enc_layer(pkg), 2),
                lambda m, src, mask: m(src, mask), 2),
    "encoder_prenorm_gelu": (
        lambda pkg: pkg.nn.TransformerEncoder(
            _enc_layer(pkg, activation="gelu", normalize_before=True), 2,
            pkg.nn.LayerNorm(D)),
        lambda m, src, mask: m(src, mask), 2),
    "decoder": (lambda pkg: pkg.nn.TransformerDecoder(_dec_layer(pkg), 2),
                lambda m, tgt, mem, tmask, mmask: m(tgt, mem, tmask, mmask),
                4),
    "transformer": (lambda pkg: pkg.nn.Transformer(
        D, H, 2, 2, FF, dropout=0.0),
        lambda m, src, tgt, smask, tmask: m(src, tgt, smask, tmask, smask),
        4),
}


@pytest.mark.parametrize("name", list(STACKS))
def test_stacks_match_reference(name, plain_calls):
    """The encoder (post- and pre-norm), the decoder (causal (S, S) self
    mask: naive; cross-attention with the padding mask: flash) and the
    whole Transformer, 2 layers each: outputs and every gradient."""
    make, fn, kind = STACKS[name]
    src, tgt = _f(B, S, D, seed=4), _f(B, S, D, seed=5)
    smask = _pad_mask([S - 30, S], S)
    if kind == 2:
        inputs, n_float, want = [src, smask], 1, 2
    elif name == "decoder":
        inputs, n_float, want = [tgt, src, _causal(S), smask], 2, 2
    else:
        inputs, n_float, want = [src, tgt, smask, _causal(S)], 2, 4
    _parity(make, fn, inputs, n_float)
    assert len(plain_calls) == want


# ----------------------------------------------------- the translation model

def seq2seq(pkg, vocab, d_model, nhead, layers, d_ff, max_len, dropout,
            **kw):
    """The translation model of the card's seq2seq phase, in ``pkg``: a
    token embedding (Normal(0, d_model^-0.5)) shared by source, target and
    the tied output projection, scaled by sqrt(d_model), a learned
    position embedding, dropout on their sum, and ``nn.Transformer``."""
    nn, F = pkg.nn, pkg.nn.functional
    matmul = pkg.tensor.linalg.matmul

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(
                vocab, d_model, weight_attr=pkg.ParamAttr(
                    initializer=nn.initializer.Normal(0.0, d_model ** -0.5)),
                **kw)
            self.pos = nn.Embedding(max_len, d_model, **kw)
            self.transformer = nn.Transformer(d_model, nhead, layers, layers,
                                              d_ff, dropout, **kw)

        def embed_at(self, ids, start=0):
            x = (self.embed(ids) * d_model ** 0.5
                 + self.pos.weight[start:start + ids.shape[1]])
            return F.dropout(x, dropout, training=self.training)

        def logits(self, h):
            return matmul(h, self.embed.weight, transpose_y=True)

        def forward(self, src, tgt, src_mask, tgt_mask):
            h = self.transformer(self.embed_at(src), self.embed_at(tgt),
                                 src_mask, tgt_mask, src_mask)
            return self.logits(h)
    return Seq2Seq()


def seq2seq_loss(pkg, vocab, epsilon=0.1):
    """Label-smoothed soft cross-entropy, the mean over the target's
    non-padding positions."""
    F = pkg.nn.functional

    def loss(logits, labels):
        onehot = F.one_hot(labels, vocab)
        mask = 1.0 - onehot[..., PAD]
        ce = F.cross_entropy(logits, F.label_smooth(onehot, epsilon=epsilon),
                             soft_label=True, reduction="none")
        return (ce * mask).sum() / mask.sum()
    return loss


def seq2seq_batch(seed, b, s, vocab, lo, hi):
    """(src, tgt_in, src_mask, tgt_mask, labels): lengths in [lo, hi],
    padding id 0 past them, the target shifted right behind BOS."""
    rng = np.random.RandomState(seed)
    pos = np.arange(s)[None, :]
    src_len, tgt_len = (rng.randint(lo, hi + 1, b) for _ in range(2))
    src = np.where(pos < src_len[:, None], rng.randint(2, vocab, (b, s)),
                   PAD)
    tgt = np.where(pos < tgt_len[:, None], rng.randint(2, vocab, (b, s)),
                   PAD)
    tgt_in = np.concatenate([np.full((b, 1), BOS), tgt[:, :-1]], 1)
    return (src.astype(np.int64), tgt_in.astype(np.int64),
            _pad_mask(src_len, s), _causal(s), tgt.astype(np.int64))


def _noam_adam(pkg, params):
    sched = pkg.optimizer.lr.NoamDecay(D, 4000, learning_rate=LR_SCALE)
    return sched, pkg.optimizer.Adam(learning_rate=sched, beta1=0.9,
                                     beta2=0.98, epsilon=1e-9,
                                     parameters=params)


@pytest.fixture(scope="module")
def reference_seq2seq():
    """The reference's 2 + 2-layer model trained 3 steps (dropout 0), with
    its initial state and the batches."""
    jfa._INTERPRET = True
    try:
        paddle.seed(11)
        jm = seq2seq(paddle, VOCAB, D, H, 2, FF, S, 0.0)
        init = _state(jm)
        sched, opt = _noam_adam(paddle, jm.parameters())
        step = JTrainStep(jm, seq2seq_loss(paddle, VOCAB), opt)
        batches = [seq2seq_batch(20 + i, B, S, VOCAB, 64, S)
                   for i in range(STEPS)]
        losses = []
        for batch in batches:
            losses.append(float(step(*[paddle.to_tensor(a)
                                       for a in batch]).numpy()))
            sched.step()
        return dict(init=init, batches=batches, losses=losses,
                    final=_state(jm))
    finally:
        jfa._INTERPRET = False


def _port_seq2seq(state):
    tm = seq2seq(pt, VOCAB, D, H, 2, FF, S, 0.0, device="cpu")
    pt.load_paddle_state(tm, state)
    return tm


def test_seq2seq_train_step_matches_reference(reference_seq2seq,
                                              plain_calls):
    """3 TrainSteps of the 2 + 2-layer translation model (Adam 0.9 / 0.98
    / 1e-9 under NoamDecay, label smoothing 0.1, the loss masked on target
    padding): losses within 1e-5; K1 ran 4 times per step (2 encoder
    self-attentions, 2 cross-attentions), the decoder's self-attention on
    the naive path."""
    ref = reference_seq2seq
    tm = _port_seq2seq(ref["init"])
    sched, opt = _noam_adam(pt, tm.parameters())
    step = TrainStep(tm, seq2seq_loss(pt, VOCAB), opt)
    losses = []
    for batch in ref["batches"]:
        losses.append(float(step(*[torch.from_numpy(a) for a in batch])))
        sched.step()
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5, atol=1e-5)
    assert len(plain_calls) == 4 * STEPS
    got = tm.state_dict()
    for k in ("transformer.encoder.layers.1.linear2.weight",
              "transformer.decoder.layers.0.cross_attn.q_proj.weight",
              "embed.weight"):
        _close(got[k].numpy(), ref["final"][k], 1e-4)


def _greedy(model, src, smask, steps, cached):
    """Greedy tokens from BOS: through ``gen_cache`` (one position per
    step) or recomputing the whole target each step."""
    pkg = pt if isinstance(model, torch.nn.Module) else paddle
    tf = model.transformer
    memory = tf.encoder(model.embed_at(src), smask)
    ys = np.full((src.shape[0], 1), BOS, np.int64)
    cache = tf.decoder.gen_cache(memory) if cached else None
    for t in range(steps):
        if cached:
            y = model.embed_at(_to(pkg, ys[:, -1:]), t)
            h, cache = tf.decoder(y, memory, None, smask, cache)
        else:
            y = model.embed_at(_to(pkg, ys))
            mask = pkg.nn.Transformer.generate_square_subsequent_mask(t + 1)
            h = tf.decoder(y, memory, mask, smask)
        logits = np.asarray(model.logits(h).numpy())[:, -1]
        ys = np.concatenate([ys, logits.argmax(-1)[:, None]], 1)
    return ys[:, 1:]


def _to(pkg, a):
    return torch.from_numpy(a) if pkg is pt else paddle.to_tensor(a)


def test_gen_cache_decoding_equals_full_recompute(reference_seq2seq):
    """Greedy decoding of 4 sources for 12 tokens: the port's cached
    decode (caches from length 0, growing by one: the naive path; the
    cross-attention recomputed from memory each step) equals its full
    recompute and the reference's cached decode, token for token."""
    ref = reference_seq2seq
    src, _, smask, _, _ = seq2seq_batch(30, 4, S, VOCAB, 64, S)
    tm = _port_seq2seq(ref["final"]).eval()
    paddle.seed(11)
    jm = seq2seq(paddle, VOCAB, D, H, 2, FF, S, 0.0)
    jm.set_state_dict({k: paddle.to_tensor(v)
                       for k, v in ref["final"].items()})
    jm.eval()
    with torch.no_grad():
        cached = _greedy(tm, torch.from_numpy(src), torch.from_numpy(smask),
                         12, True)
        full = _greedy(tm, torch.from_numpy(src), torch.from_numpy(smask),
                       12, False)
    jcached = _greedy(jm, paddle.to_tensor(src), paddle.to_tensor(smask),
                      12, True)
    np.testing.assert_array_equal(cached, full)
    np.testing.assert_array_equal(cached, jcached)
    cache = tm.transformer.decoder.gen_cache(torch.zeros(4, S, D))
    assert len(cache) == 2 and cache[0][0][0].shape == (4, 0, H, D // H)


def test_cloned_layers_start_equal_and_stay_independent():
    """Every layer of a stack is a deep copy of the first: equal values,
    no shared tensor; one Adam step on a loss that reaches only layer 0's
    FFN moves layer 0 alone."""
    enc = pt.nn.TransformerEncoder(_enc_layer(pt), 3)
    ptrs = {}
    for i, layer in enumerate(enc.layers):
        for k, p in layer.named_parameters():
            first = dict(enc.layers[0].named_parameters())[k]
            assert torch.equal(p, first)
            assert i == 0 or p.data_ptr() != first.data_ptr()
            ptrs.setdefault(p.data_ptr(), []).append((i, k))
    assert all(len(v) == 1 for v in ptrs.values())
    opt = pt.optimizer.Adam(1e-2, parameters=enc.parameters())
    enc.layers[0].linear1(torch.ones(2, D)).sum().backward()
    opt.step()
    l0, l1, l2 = (dict(layer.named_parameters()) for layer in enc.layers)
    assert not torch.equal(l0["linear1.weight"], l1["linear1.weight"])
    assert torch.equal(l1["linear1.weight"], l2["linear1.weight"])


def test_square_mask_at_batch_equal_to_length_is_read_as_a_bias(
        plain_calls):
    """The reference's rule, kept: at B == S == 128 the decoder's (S, S)
    causal mask has the (B, Sk) shape of a per-key bias, so both packages
    take the flash route and add row b of the mask to every query of batch
    b (not the causal mask): the outputs agree with each other and differ
    from the masked attention."""
    n = 128
    q, k, v = (_f(n, n, H, 64, seed=s) for s in (40, 41, 42))
    mask = _causal(n)
    want = np.asarray(JF.scaled_dot_product_attention(
        *[paddle.to_tensor(a) for a in (q, k, v, mask)]).numpy())
    got = TF.scaled_dot_product_attention(
        *[torch.from_numpy(a) for a in (q, k, v, mask)]).numpy()
    _close(got, want)
    assert len(plain_calls) == 1
    causal = TF.scaled_dot_product_attention(
        *[torch.from_numpy(a) for a in (q, k, v)],
        attn_mask=torch.from_numpy(mask)[None, None].expand(n, 1, n, n))
    assert np.abs(causal.numpy() - got).max() > 1e-2


def test_set_flash_attention_false_takes_the_naive_path(plain_calls):
    """``set_flash_attention(False)``: the padding-masked self-attention
    no longer runs the kernel; its output is the reference's naive one."""
    q = _f(B, S, H, 64, seed=43)
    mask = _pad_mask([S - 20, S], S)
    JF.set_flash_attention(False)
    TF.set_flash_attention(False)
    try:
        want = np.asarray(JF.scaled_dot_product_attention(
            *[paddle.to_tensor(a) for a in (q, q, q, mask)]).numpy())
        got = TF.scaled_dot_product_attention(
            *[torch.from_numpy(a) for a in (q, q, q, mask)]).numpy()
    finally:
        JF.set_flash_attention(True)
        TF.set_flash_attention(True)
    assert not plain_calls
    _close(got, want)


def test_subsequent_mask_is_the_references():
    got = pt.nn.Transformer.generate_square_subsequent_mask(5)
    want = np.asarray(
        paddle.nn.Transformer.generate_square_subsequent_mask(5).numpy())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() == -1e9
