"""float16 through paddle_tpu_torch's kernels against the JAX package on
the CPU: K1-K4's wrappers admit float16 (their CUDA checks, run on CPU
tensors, and their dtype codes), the float16 plain versions of K1 / K2
against the reference's Pallas kernels in interpret mode, a tiny GPT
trained by ``TrainStep(amp_dtype="float16")`` against the reference's,
the fused BatchNorm entry points, which send float16 to their plain
composites as the reference's gates do, and count it, and a GPT decorated
to float16 (O2) and quantized to int8, served by both engines (paged
through K3 / K4's plain versions, and fixed): equal greedy streams.  Inputs are drawn
with numpy from a seed and handed to both.

Tolerances, with their reasons: float16 outputs and gradients are
rounded to float16 by both frameworks from f32 values computed in
another order, so they may differ by a float16 unit (2**-11 relative) or
two: 2e-3 + 2e-3 * |reference|.  f32 statistics 1e-5.  The O1 float16
GPT's losses 1e-3 (the two frameworks round the float16 activations at
other places), as the bf16 O1 comparison in test_torch_train.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import models as jmodels
from paddle_tpu.jit import TrainStep as JTrainStep, state_arrays
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu.ops import fused_bn_act as jbn
from paddle_tpu.quantization import quantize_for_serving as jquantize
from paddle_tpu.serving import ServingEngine as JEngine

import paddle_tpu_torch as pt
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import fused_bn_act as tbn
from paddle_tpu_torch.ops import int8_matmul as tim
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.quantization import (quantize_for_serving,
                                           quantize_weight_int8)
from paddle_tpu_torch.serving import ServingEngine
from torch_parity import TINY, jax_state

torch.set_num_threads(1)

F16_TOL = dict(rtol=2e-3, atol=2e-3)
FLASH_GPT = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                 num_attention_heads=2, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0,
                 max_position_embeddings=128)


# ---------------------------------------------------------------------------
# K1-K4 take float16
# ---------------------------------------------------------------------------

def test_flash_kernels_admit_float16():
    """The checks a CUDA call runs before K1 / K2 pass a float16 q/k/v
    (float64 is still refused), and the C entry's dtype code is the
    tensor-core route's float16 one."""
    q = torch.zeros(1, 128, 2, 64, dtype=torch.float16)
    seed = torch.zeros(1, dtype=torch.int32)
    tfa._check_cuda(q, q, q, None, None, None, seed)
    tfa._check_cuda(q, q, q, None, None, None, seed,
                    extra=(("o", q), ("do", q)))
    assert tfa._DTYPE_CODE[torch.float16] == 2
    with pytest.raises(TypeError):
        tfa._check_cuda(q.double(), q.double(), q.double(), None, None,
                        None, seed)


def test_paged_attention_admits_float16():
    """K3's checks take float16 q and pools (and the mixed pairs), and the
    plan sizes a float16 tile as a bf16 one (8 KB of 2-byte elements)."""
    q = torch.zeros(2, 4, 64, dtype=torch.float16)
    pool = torch.zeros(8, 16, 4, 64, dtype=torch.float16)
    tables = torch.zeros(2, 4, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    for qd, kvd in ((torch.float16, torch.float16),
                    (torch.float32, torch.float16),
                    (torch.float16, torch.bfloat16)):
        tpa._check_cuda(q.to(qd), pool.to(kvd), pool.to(kvd), tables, pos)
    assert tpa._DTYPE_CODE[torch.float16] == 2
    assert tpa._plan(8, 16, 64, 64, 132, 2) == tpa._plan(8, 16, 64, 64, 132,
                                                          pool.element_size())


def test_int8_matmul_admits_float16():
    """K4's checks take a float16 x; its plan stages 8-element x chunks
    for it as for bf16."""
    x = torch.zeros(8, 64, dtype=torch.float16)
    wi, s = quantize_weight_int8(torch.randn(64, 128))
    tim._check_cuda(x, wi, s.reshape(1, -1).contiguous())
    assert tim._DTYPE_CODE[torch.float16] == 2
    assert tim._plan(8, 1024, 1024, 132, 2).k_rows % 8 == 0
    got = tim.dequant_matmul(x, wi, s)
    assert got.dtype == torch.float16 and got.shape == (8, 128)


# ---------------------------------------------------------------------------
# K1 / K2 float16 plain versions against the reference's kernels
# ---------------------------------------------------------------------------

@pytest.fixture
def interpret():
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = False


# (b, sq, sk, h, d, causal, bias, seg, dropout_p)
FLASH_CASES = {
    "causal": (1, 256, 256, 2, 64, True, False, False, 0.0),
    "bias_dropout": (1, 256, 256, 2, 64, False, True, False, 0.1),
    "segments_d128": (1, 128, 256, 2, 128, False, False, True, 0.0),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_float16_matches_reference_interpret(case, interpret):
    b, sq, sk, h, d, causal, bias, seg, p = FLASH_CASES[case]
    rng = np.random.RandomState(sq + sk + d + 16)
    q, do = (rng.randn(b, sq, h, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, sk, h, d).astype(np.float32) for _ in range(2))
    bi = rng.randn(b, sk).astype(np.float32) if bias else None
    qs = ks = None
    if seg:
        qs = np.zeros((b, sq), np.int32)
        ks = np.zeros((b, sk), np.int32)
        qs[:, sq // 2:] = 1
        ks[:, sk // 3:] = 1
    seed = np.array([4242], np.int32)

    def jf(q_, k_, v_, b_):
        return jfa.flash_attention_bshd(
            q_, k_, v_, causal=causal, bias=b_,
            q_segment_ids=None if qs is None else jnp.asarray(qs),
            kv_segment_ids=None if ks is None else jnp.asarray(ks),
            dropout_p=p, dropout_seed=jnp.asarray(seed) if p else None)
    jin = [jnp.asarray(x).astype(jnp.float16) for x in (q, k, v)]
    jin.append(None if bi is None else jnp.asarray(bi))
    jo, vjp = jax.vjp(jf, *jin)
    assert jo.dtype == jnp.float16
    jgrads = [g for g in vjp(jnp.asarray(do).astype(jnp.float16))
              if g is not None]

    tin = [torch.tensor(x).half().requires_grad_() for x in (q, k, v)]
    tb = None if bi is None else torch.tensor(bi).requires_grad_()
    to = tfa.flash_attention_bshd(
        *tin, causal=causal, bias=tb,
        q_segment_ids=None if qs is None else torch.tensor(qs),
        kv_segment_ids=None if ks is None else torch.tensor(ks),
        dropout_p=p, dropout_seed=torch.tensor(seed) if p else None)
    assert to.dtype == torch.float16
    to.backward(torch.tensor(do).half())
    tgrads = [t.grad for t in tin] + ([tb.grad] if bias else [])
    np.testing.assert_allclose(to.detach().float().numpy(),
                               np.asarray(jo.astype(jnp.float32)), **F16_TOL)
    assert len(tgrads) == len(jgrads)
    for tg, jg in zip(tgrads, jgrads):
        assert tg.dtype == (torch.float16 if tg.dim() == 4
                            else torch.float32)
        np.testing.assert_allclose(
            tg.float().numpy(),
            np.asarray(jg.astype(jnp.float32)).reshape(tg.shape), **F16_TOL)


# ---------------------------------------------------------------------------
# TrainStep(amp_dtype="float16") on a tiny GPT
# ---------------------------------------------------------------------------

def _gpt_batches(n=3):
    rng = np.random.RandomState(18)
    return [(rng.randint(0, 256, (2, 128)).astype(np.int32),
             rng.randint(0, 256, (2, 128)).astype(np.int32))
            for _ in range(n)]


def test_trainstep_float16_o1_matches_reference(interpret):
    """Three O1 float16 steps of the tiny flash GPT (head_dim 64, S 128:
    the flash gate admits it) give the reference's losses; attention
    takes the flash path in float16 at every layer."""
    paddle.seed(5)
    jm = jmodels.GPTForPretraining(jmodels.GPTConfig(**FLASH_GPT))
    init = {k: np.asarray(v) for k, v in state_arrays(jm).items()}
    jcrit = jmodels.GPTPretrainingCriterion()
    jstep = JTrainStep(jm, lambda lg, y: jcrit(lg, y),
                       paddle.optimizer.AdamW(1e-3,
                                              parameters=jm.parameters()),
                       amp_level="O1", amp_dtype="float16")
    want = [float(jstep(paddle.to_tensor(i), paddle.to_tensor(y)).numpy())
            for i, y in _gpt_batches()]

    tm = tmodels.GPTForPretraining(tmodels.GPTConfig(**FLASH_GPT),
                                   device="cpu")
    pt.load_paddle_state(tm, init)
    tcrit = tmodels.GPTPretrainingCriterion()
    tstep = TrainStep(tm, lambda lg, y: tcrit(lg, y),
                      pt.optimizer.AdamW(1e-3, parameters=tm.parameters()),
                      amp_level="O1", amp_dtype="float16")
    seen = []
    orig = tfa._plain_fwd

    def counting(q, *a):
        seen.append(q.dtype)
        return orig(q, *a)
    tfa._plain_fwd = counting
    try:
        got = [float(tstep(torch.from_numpy(i).long(),
                           torch.from_numpy(y).long()))
               for i, y in _gpt_batches()]
    finally:
        tfa._plain_fwd = orig
    assert seen == [torch.float16] * 3 * FLASH_GPT["num_hidden_layers"]
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# the fused BatchNorm gate
# ---------------------------------------------------------------------------

def _bn_inputs(seed, shape=(2, 6, 6, 8)):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    r = rng.randn(*shape).astype(np.float32)
    g = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    b = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    return x, r, g, b


def _compare(jouts, touts):
    for j, t in zip(jouts, touts):
        tol = F16_TOL if t.dtype == torch.float16 else dict(rtol=1e-5,
                                                            atol=1e-5)
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(j.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("entry", ["bn_act_train", "bn2_act_train",
                                   "bn_act_pool_train"])
def test_fused_bn_float16_takes_the_composite(entry):
    """float16 goes to the plain composite, counted once per call, with
    the reference's outputs and gradients; f32 and bf16 still take the
    kernel path (their plain versions here) and count nothing."""
    x, r, g, b = _bn_inputs(19)
    jx, jr = (jnp.asarray(a).astype(jnp.float16) for a in (x, r))
    tx, tr = (torch.tensor(a).half().requires_grad_() for a in (x, r))
    jg, jb = jnp.asarray(g), jnp.asarray(b)
    tg, tb = (torch.tensor(a).requires_grad_() for a in (g, b))
    fn = getattr(tbn, entry)
    before = fn.composite_calls
    if entry == "bn_act_train":
        jf = lambda x_, g_, b_, r_: jbn.bn_act_train(  # noqa: E731
            x_, g_, b_, 1e-5, "relu", r_)
        tout = fn(tx, tg, tb, 1e-5, "relu", tr)
    elif entry == "bn2_act_train":
        jf = lambda x_, g_, b_, r_: jbn.bn2_act_train(  # noqa: E731
            x_, g_, b_, r_, g_, b_, 1e-5, "relu")
        tout = fn(tx, tg, tb, tr, tg, tb, 1e-5, "relu")
    else:
        jf = lambda x_, g_, b_, r_: jbn.bn_act_pool_train(  # noqa: E731
            x_, g_, b_, 1e-5, "relu", ("max", 3, 2, 1))
        tout = fn(tx, tg, tb, 1e-5, "relu", ("max", 3, 2, 1))
    assert fn.composite_calls == before + 1
    jout, vjp = jax.vjp(jf, jx, jg, jb, jr)
    assert tout[0].dtype == torch.float16
    _compare(jout, tout)
    cot = np.random.RandomState(20).randn(*tout[0].shape).astype(np.float32)
    jgrads = vjp((jnp.asarray(cot).astype(jnp.float16),)
                 + tuple(jnp.zeros_like(o) for o in jout[1:]))
    tout[0].backward(torch.tensor(cot).half())
    wants = [jgrads[0], jgrads[1], jgrads[2]]
    gots = [tx.grad, tg.grad, tb.grad]
    if entry == "bn_act_train":
        wants.append(jgrads[3])
        gots.append(tr.grad)
    _compare(wants, gots)

    calls = tbn.bn_stats.calls
    for dt in (torch.float32, torch.bfloat16):
        if entry == "bn_act_train":
            fn(tx.detach().to(dt), tg, tb, 1e-5, "relu", tr.detach().to(dt))
        elif entry == "bn2_act_train":
            fn(tx.detach().to(dt), tg, tb, tr.detach().to(dt), tg, tb)
        else:
            fn(tx.detach().to(dt), tg, tb)
    assert fn.composite_calls == before + 1
    assert tbn.bn_stats.calls > calls


# ---------------------------------------------------------------------------
# serving a float16 GPT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["paged", "fixed"])
def test_float16_int8_serving_streams_match_reference(kv):
    """The reference's engine serves a GPT decorated amp.decorate(level=
    "O2", dtype="float16") and quantized to int8; the port's engine serves
    the same weights with the same greedy streams."""
    paddle.seed(1)
    jm = jmodels.GPTForPretraining(jmodels.GPTConfig(**TINY))
    jm.eval()
    tm = tmodels.GPTForPretraining(tmodels.GPTConfig(**TINY),
                                   device="cpu").eval()
    jamp.decorate(models=jm, level="O2", dtype="float16")
    pt.amp.decorate(models=tm, level="O2", dtype="float16")
    jquantize(jm)
    quantize_for_serving(tm)
    pt.load_paddle_state(tm, jax_state(jm))
    assert next(tm.parameters()).dtype == torch.float16
    cfg = dict(max_slots=3, max_len=48, prefill_buckets=(8, 16),
               decode_chunk=4, block_size=8)
    rng = np.random.RandomState(21)
    prompts = [rng.randint(0, 128, (n,)) for n in (4, 11, 14)]
    jeng = JEngine(jm, kv=kv, dtype=jnp.float16, **cfg)
    want = [jeng.submit(p, max_new_tokens=12) for p in prompts]
    jeng.run_until_drained()
    teng = ServingEngine(tm, kv=kv, dtype=torch.float16, device="cpu", **cfg)
    got = [teng.submit(p, max_new_tokens=12) for p in prompts]
    teng.run_until_drained()
    if kv == "paged":
        assert teng._pools[0][0].dtype == torch.float16
    assert [list(r.tokens()) for r in got] == [list(r.tokens())
                                               for r in want]
