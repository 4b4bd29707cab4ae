"""paddle_tpu_torch flash attention (K1/K2 plain versions) against the JAX
package's ``flash_attention_bshd`` run through the Pallas interpreter on
the CPU: the dropout keep mask bit for bit, outputs and gradients (dq, dk,
dv, dbias) over the masking variants, the dispatch gate, and the explicit
dropout generators.  Inputs are drawn with numpy from a seed and handed to
both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional import attention as jattn
from paddle_tpu.ops import flash_attention as jfa

from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.nn import Dropout
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.ops import flash_attention as tfa

# tiny shapes gain nothing from intra-op threads, and idle OpenMP threads
# spinning would take cores from the test files running beside this one
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret():
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = False


@pytest.mark.parametrize("seed", [0, 12345, -7, 2 ** 31 - 1, -2 ** 31])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_mask_is_the_references_bit_for_bit(seed, p):
    full = tfa.keep_mask(seed, 2, 3, 256, 384, p)
    for bh in (0, 4, 5):
        for qi, ki in ((0, 0), (1, 2)):
            want = np.asarray(jfa._keep_mask(
                jnp.array([seed], jnp.int32), jnp.int32(bh), qi, ki, 128,
                128, p))
            got = full[bh // 3, bh % 3, qi * 128:(qi + 1) * 128,
                       ki * 128:(ki + 1) * 128].numpy()
            np.testing.assert_array_equal(got, want)


# (b, sq, sk, h, d, causal, bias, seg, dropout_p, dtype).  Tolerances: f32
# 2e-5 (sums in another order); bf16 outputs and gradients are rounded to
# bf16 by both, one bf16 unit apart at most: 1e-2 + 1e-2 * |reference|.
CASES = {
    "noncausal": (2, 256, 256, 2, 64, False, False, False, 0.0, "f32"),
    "causal_multiblock": (1, 384, 384, 2, 64, True, False, False, 0.0, "f32"),
    "sk_ne_sq": (2, 128, 256, 2, 64, True, False, False, 0.0, "f32"),
    "bias": (2, 256, 256, 2, 128, False, True, False, 0.0, "f32"),
    "segments": (2, 256, 256, 2, 64, False, False, True, 0.0, "f32"),
    "dropout": (2, 256, 256, 2, 64, True, False, False, 0.1, "f32"),
    "dropout_bf16": (2, 256, 256, 2, 64, True, False, False, 0.1, "bf16"),
    "bias_bf16": (1, 256, 256, 2, 64, False, True, False, 0.0, "bf16"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_flash_matches_reference_interpret(case):
    b, sq, sk, h, d, causal, bias, seg, p, dt = CASES[case]
    rng = np.random.RandomState(sq + sk + d)
    q, do = (rng.randn(b, sq, h, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, sk, h, d).astype(np.float32) for _ in range(2))
    bi = rng.randn(b, sk).astype(np.float32) if bias else None
    qs = ks = None
    if seg:   # packed segments; every query row sees keys of its segment
        qs = np.zeros((b, sq), np.int32)
        ks = np.zeros((b, sk), np.int32)
        qs[:, sq // 2:] = 1
        ks[:, sk // 3:] = 1
    seed = np.array([-98765], np.int32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dt == "bf16"
                else (jnp.float32, torch.float32))

    def jf(q_, k_, v_, b_):
        return jfa.flash_attention_bshd(
            q_, k_, v_, causal=causal, bias=b_,
            q_segment_ids=None if qs is None else jnp.asarray(qs),
            kv_segment_ids=None if ks is None else jnp.asarray(ks),
            dropout_p=p, dropout_seed=jnp.asarray(seed) if p else None)
    jin = [jnp.asarray(x).astype(jdt) for x in (q, k, v)]
    jin.append(None if bi is None else jnp.asarray(bi))
    jo, vjp = jax.vjp(jf, *jin)
    jgrads = [g for g in vjp(jnp.asarray(do).astype(jdt)) if g is not None]

    tin = [torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v)]
    tb = None if bi is None else torch.tensor(bi).requires_grad_()
    to = tfa.flash_attention_bshd(
        *tin, causal=causal, bias=tb,
        q_segment_ids=None if qs is None else torch.tensor(qs),
        kv_segment_ids=None if ks is None else torch.tensor(ks),
        dropout_p=p, dropout_seed=torch.tensor(seed) if p else None)
    assert to.dtype == tdt
    to.backward(torch.tensor(do).to(tdt))
    tgrads = [t.grad for t in tin] + ([tb.grad] if bias else [])
    tol = (dict(rtol=1e-2, atol=1e-2) if dt == "bf16"
           else dict(rtol=2e-5, atol=2e-5))
    np.testing.assert_allclose(to.detach().float().numpy(),
                               np.asarray(jo.astype(jnp.float32)), **tol)
    assert len(tgrads) == len(jgrads)
    for tg, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(
            tg.float().numpy(),
            np.asarray(jg.astype(jnp.float32)).reshape(tg.shape), **tol)


@pytest.mark.parametrize("shape,kshape,p,seed,seg", [
    ((1, 128, 2, 64), (1, 128, 2, 64), 0.0, False, (False, False)),
    ((1, 256, 2, 128), (1, 384, 2, 128), 0.0, False, (False, False)),
    ((1, 128, 2, 256), (1, 128, 2, 256), 0.1, True, (True, True)),
    ((1, 128, 2, 32), (1, 128, 2, 32), 0.0, False, (False, False)),
    ((1, 100, 2, 64), (1, 100, 2, 64), 0.0, False, (False, False)),
    ((1, 128, 2, 64), (1, 200, 2, 64), 0.0, False, (False, False)),
    ((1, 128, 4, 64), (1, 128, 2, 64), 0.0, False, (False, False)),
    ((1, 128, 2, 64), (1, 128, 2, 64), 0.1, False, (False, False)),
    ((1, 128, 2, 64), (1, 128, 2, 64), 0.0, False, (True, False)),
])
def test_gate_decides_as_the_reference(shape, kshape, p, seed, seg):
    q, k = np.zeros(shape, np.float32), np.zeros(kshape, np.float32)
    sid = np.zeros(shape[:2], np.int32)
    kid = np.zeros(kshape[:2], np.int32)
    kw = dict(dropout_p=p)
    jout = jfa.flash_attention_bshd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
        q_segment_ids=jnp.asarray(sid) if seg[0] else None,
        kv_segment_ids=jnp.asarray(kid) if seg[1] else None,
        dropout_seed=jnp.zeros((1,), jnp.int32) if seed else None, **kw)
    tout = tfa.flash_attention_bshd(
        torch.tensor(q), torch.tensor(k), torch.tensor(k),
        q_segment_ids=torch.tensor(sid) if seg[0] else None,
        kv_segment_ids=torch.tensor(kid) if seg[1] else None,
        dropout_seed=torch.zeros(1, dtype=torch.int32) if seed else None,
        **kw)
    assert (jout is None) == (tout is None)


@pytest.mark.parametrize("mask_shape,dtype", [
    (None, None), ((2, 256), "bool"), ((2, 1, 1, 256), "f32"),
    ((2, 1, 128, 256), "f32"), ((2, 2, 1, 256), "bool"), ((1, 256), "f32"),
])
def test_sdpa_dispatch_and_output_match_reference(mask_shape, dtype):
    """The mask rule (``_flash_kv_bias``) takes the flash path where the
    reference does, and the outputs agree either way (sq 128, sk 256)."""
    rng = np.random.RandomState(11)
    q = rng.randn(2, 128, 2, 64).astype(np.float32)
    k, v = (rng.randn(2, 256, 2, 64).astype(np.float32) for _ in range(2))
    mask = None
    if mask_shape is not None:
        mask = (rng.rand(*mask_shape) > 0.3 if dtype == "bool"
                else rng.randn(*mask_shape).astype(np.float32))
        mask.reshape(-1)[0] = True if dtype == "bool" else 0.0

    def decided(fn, m, b, sk):
        try:
            return fn(m, b, sk) is not None
        except ValueError:
            return False
    if mask is not None:
        assert decided(jattn._flash_kv_bias, jnp.asarray(mask), 2, 256) == \
            decided(tattn._flash_kv_bias, torch.tensor(mask), 2, 256)
    jout = jattn._sdpa_raw(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           None if mask is None else jnp.asarray(mask), 0.0,
                           True, None)
    tout = tattn.scaled_dot_product_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        attn_mask=None if mask is None else torch.tensor(mask),
        is_causal=True, training=False)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=2e-5,
                               atol=2e-5)


def test_dropout_draws_from_an_explicit_generator():
    """The repair: Dropout's mask comes from the scope's explicit
    generator (a TrainStep's per-step one), never torch's global one."""
    x = torch.ones(64, 64)

    def drop(seed):
        torch.manual_seed(seed + 1000)   # the global generator must not matter
        with trng.generator_scope(torch.Generator().manual_seed(seed)):
            return Dropout(0.3)(x)
    assert torch.equal(drop(5) != 0, drop(5) != 0)
    assert not torch.equal(drop(5) != 0, drop(6) != 0)
    assert 0.6 < float((drop(5) != 0).float().mean()) < 0.8
    assert set(torch.unique(drop(5)).tolist()) <= {0.0, float(x[0, 0] / 0.7)}
    assert torch.equal(Dropout(0.3).eval()(x), x)


def test_attention_dropout_seed_repeats_with_the_generator():
    """The attention-dropout seed is drawn from the scope's generator: the
    same generator seed gives the same seed, hence the same mask."""
    def seed_of(s):
        with trng.generator_scope(torch.Generator().manual_seed(s)):
            return int(trng.draw_seed("cpu"))
    assert seed_of(3) == seed_of(3) != seed_of(4)
    trng.seed(9)
    a = [trng.next_seed() for _ in range(3)]
    trng.seed(9)
    assert a == [trng.next_seed() for _ in range(3)]


@pytest.mark.parametrize("offset,in_place", [(0, True), (8, True),
                                             (4, False), (1, False)])
def test_bf16_rows_are_read_in_place_or_copied(offset, in_place):
    """The bf16 kernels copy 16-byte row chunks: a view whose (batch, seq,
    head) rows start on 16 bytes (the fused-QKV slices) is passed as it
    is, any other is copied to a contiguous tensor with the same values.
    `offset` is the view's first element in its storage."""
    flat = torch.arange(offset + 2 * 128 * 3 * 2 * 64).to(torch.bfloat16)
    fused = flat[offset:].view(2, 128, 3, 2, 64)
    view = fused[:, :, 1]
    got = tfa._rows16(view)
    assert (got.data_ptr() == view.data_ptr()) == in_place
    assert torch.equal(got, view)
    if not in_place:
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
