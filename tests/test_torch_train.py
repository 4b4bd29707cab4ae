"""paddle_tpu_torch's training path against the JAX package on the CPU:
cross-entropy and the fused tied-head CE, the AdamW update, gradient
clipping, the O1 output types, and ``jit.TrainStep`` on a tiny GPT that
the flash gate accepts (hidden 128, 2 heads so head_dim 64, seq 128, 2
layers, vocab 256, dropout 0), the reference running its flash kernels
through the Pallas interpreter.  Inputs are drawn with numpy from a seed
and handed to both.

Tolerances, with their reasons:
- f32 losses, gradients and updates: 1e-5 relative (sums in another
  order).
- Weights after Adam steps are compared in units of the learning rate:
  Adam's first steps move each weight by about lr * sign(g), so where a
  gradient sits at rounding noise (the key third of the fused QKV bias has
  an exactly zero gradient) the two frameworks may step apart.  f32 after
  3 steps: every weight within 0.25 lr, at most 5% of a tensor's entries
  more than 0.01 lr apart.  O1 (bf16 rounds at other places in the two
  frameworks): losses within 1e-3, at most 5% of a tensor's entries more
  than 0.1 lr apart (the QKV bias excepted, whose noise third steps either
  way), none more than 10 lr (a few steps of opposite sign).
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
from paddle_tpu.nn import clip as jclip
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu.ops import fused_ce as jfce
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer.functional import apply_updates as japply

import paddle_tpu_torch as pt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import fused_ce as tfce
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer.functional import (apply_updates,
                                                   decay_flags)

# tiny shapes gain nothing from intra-op threads, and idle OpenMP threads
# spinning would take cores from the test files running beside this one
torch.set_num_threads(1)

FLASH_GPT = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                 num_attention_heads=2, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0,
                 max_position_embeddings=128)
LR = 1e-3
STEPS = 3


def _np_state(model):
    return {k: np.asarray(v) for k, v in state_arrays(model).items()}


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_entropy_matches_reference(reduction, dtype):
    rng = np.random.RandomState(1)
    logits = (3 * rng.randn(6, 7, 50)).astype(np.float32)
    labels = rng.randint(0, 50, (6, 7)).astype(np.int32)
    labels[0, :3] = -100                       # ignored positions
    ct = rng.randn(6, 7).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))

    def jloss(x):
        out = JF.cross_entropy(x, jnp.asarray(labels), reduction=reduction)
        return jnp.sum(out * ct) if reduction == "none" else out
    jx = jnp.asarray(logits).astype(jdt)
    want, jgrad = jax.value_and_grad(jloss)(jx)
    tx = torch.tensor(logits).to(tdt).requires_grad_()
    out = TF.cross_entropy(tx, torch.tensor(labels), reduction=reduction)
    assert out.dtype == torch.float32
    got = (out * torch.tensor(ct)).sum() if reduction == "none" else out
    got.backward()
    assert tx.grad.dtype == tdt
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(jgrad.astype(jnp.float32)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bias,ignore", [(False, None), (True, 3)])
def test_fused_linear_cross_entropy_matches_reference(bias, ignore):
    """Values and the h, W (and bias) gradients; chunk 24 over 60 tokens
    (the chunk rounds down to 20, a divisor of 60, in both)."""
    rng = np.random.RandomState(2)
    h = rng.randn(3, 20, 32).astype(np.float32)
    w = (0.3 * rng.randn(40, 32)).astype(np.float32)
    b = rng.randn(40).astype(np.float32) if bias else None
    labels = rng.randint(0, 40, (3, 20)).astype(np.int32)
    ct = rng.randn(3, 20).astype(np.float32)

    def jloss(hv, wv, bv):
        out = jfce.fused_linear_cross_entropy(
            hv, wv, jnp.asarray(labels), chunk_size=24, bias=bv,
            ignore_index=ignore)
        return jnp.sum(out * ct), out
    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2) if bias else (0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(w), None if b is None else jnp.asarray(b))
    th, tw = (torch.tensor(x).requires_grad_() for x in (h, w))
    tb = None if b is None else torch.tensor(b).requires_grad_()
    out = tfce.fused_linear_cross_entropy(th, tw, torch.tensor(labels),
                                          chunk_size=24, bias=tb,
                                          ignore_index=ignore)
    (out * torch.tensor(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    tgrads = [th.grad, tw.grad] + ([tb.grad] if bias else [])
    for tg, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# optimizer, clipping, AMP types
# ---------------------------------------------------------------------------

def test_adamw_apply_updates_with_decay_flags_matches_reference():
    rng = np.random.RandomState(3)
    names = ["a.weight", "a.bias", "b.weight"]
    params = {n: rng.randn(5, 4).astype(np.float32) for n in names}
    moments = {n: {"moment1": 0.1 * rng.randn(5, 4).astype(np.float32),
                   "moment2": np.abs(rng.randn(5, 4)).astype(np.float32)}
               for n in names}
    grads = {n: rng.randn(5, 4).astype(np.float32) for n in names}
    fn = lambda n: not n.endswith("bias")       # noqa: E731
    jopt = JAdamW(learning_rate=0.01, weight_decay=0.1,
                  apply_decay_param_fun=fn)
    topt = AdamW(learning_rate=0.01, weight_decay=0.1,
                 apply_decay_param_fun=fn)
    assert decay_flags(topt, names) == {"a.weight": True, "a.bias": False,
                                        "b.weight": True}
    jp, js = japply(jopt, {k: jnp.asarray(v) for k, v in params.items()},
                    {k: jnp.asarray(v) for k, v in grads.items()},
                    jax.tree_util.tree_map(jnp.asarray, moments),
                    jnp.asarray(0.01, jnp.float32), jnp.asarray(7, jnp.int32),
                    {n: fn(n) for n in names})
    tp, ts = apply_updates(topt, {k: torch.tensor(v) for k, v in params.items()},
                           {k: torch.tensor(v) for k, v in grads.items()},
                           {k: {s: torch.tensor(a) for s, a in v.items()}
                            for k, v in moments.items()},
                           0.01, 7, decay_flags(topt, names))
    for n in names:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-7)
        for s in ("moment1", "moment2"):
            np.testing.assert_allclose(ts[n][s].numpy(),
                                       np.asarray(js[n][s]), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("which", ["global", "norm", "value"])
def test_grad_clips_match_reference(which):
    rng = np.random.RandomState(4)
    gs = [rng.randn(6, 3).astype(np.float32) * s for s in (0.1, 2.0, 5.0)]
    jc = {"global": jclip.ClipGradByGlobalNorm(1.5),
          "norm": jclip.ClipGradByNorm(1.0),
          "value": jclip.ClipGradByValue(0.7)}[which]
    tc = {"global": tclip.ClipGradByGlobalNorm(1.5),
          "norm": tclip.ClipGradByNorm(1.0),
          "value": tclip.ClipGradByValue(0.7)}[which]
    want = jc([(None, paddle.to_tensor(g)) for g in gs])
    got = tc([(None, torch.tensor(g)) for g in gs])
    for (_, w), (_, g) in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()),
                                   rtol=1e-6, atol=1e-7)


def test_eager_step_with_grad_clip_matches_reference():
    """Optimizer.step after loss.backward(), with a global-norm clip, two
    steps on a Linear (weights carried across by name)."""
    paddle.seed(5)
    jlin = paddle.nn.Linear(8, 4)
    tlin = pt.nn.Linear(8, 4, device="cpu")
    pt.load_paddle_state(tlin, _np_state(jlin))
    jopt = paddle.optimizer.AdamW(learning_rate=0.05,
                                  parameters=jlin.parameters(),
                                  grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5))
    topt = AdamW(learning_rate=0.05, parameters=tlin.parameters(),
                 grad_clip=tclip.ClipGradByGlobalNorm(0.5))
    x = np.random.RandomState(6).randn(5, 8).astype(np.float32)
    for _ in range(2):
        jloss = (jlin(paddle.to_tensor(x)) ** 2).sum()
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        tloss = (tlin(torch.tensor(x)) ** 2).sum()
        tloss.backward()
        topt.step()
        topt.clear_grad()
        np.testing.assert_allclose(float(tloss), float(jloss.numpy()),
                                   rtol=1e-5)
    assert topt._step_count == 2 and tlin.weight.grad is None
    for k, v in _np_state(jlin).items():
        np.testing.assert_allclose(tlin.state_dict()[k].numpy(), v,
                                   rtol=1e-5, atol=1e-6)


def test_o1_output_types_match_reference():
    """Under O1 each white-listed op returns bf16 and each black-listed one
    f32, in both frameworks (a Linear's bias add included)."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 128, 64).astype(np.float32)
    w = rng.randn(64, 64).astype(np.float32)
    b = rng.randn(64).astype(np.float32)
    q = rng.randn(1, 128, 1, 64).astype(np.float32)
    lab = rng.randint(0, 64, (2, 128)).astype(np.int32)
    J, T = paddle.to_tensor, torch.tensor
    jops = {
        "linear": lambda: JF.linear(J(x), J(w), J(b)),
        "matmul": lambda: paddle.matmul(J(x), J(w)),
        "sdpa": lambda: JF.scaled_dot_product_attention(J(q), J(q), J(q)),
        "layer_norm": lambda: JF.layer_norm(J(x).astype("bfloat16"), 64,
                                            J(b), J(b)),
        "softmax": lambda: JF.softmax(J(x).astype("bfloat16")),
        "cross_entropy": lambda: JF.cross_entropy(J(x).astype("bfloat16"),
                                                  J(lab)),
    }
    tops = {
        "linear": lambda: TF.linear(T(x), T(w), T(b)),
        "matmul": lambda: TF.matmul(T(x), T(w)),
        "sdpa": lambda: TF.scaled_dot_product_attention(T(q), T(q), T(q)),
        "layer_norm": lambda: TF.layer_norm(T(x).bfloat16(), 64, T(b), T(b)),
        "softmax": lambda: TF.softmax(T(x).bfloat16()),
        "cross_entropy": lambda: TF.cross_entropy(T(x).bfloat16(),
                                                  T(lab).long()),
    }
    with jamp.auto_cast(level="O1"):
        want = {k: str(f().dtype) for k, f in jops.items()}
    with tamp.auto_cast(level="O1"):
        got = {k: str(f().dtype).replace("torch.", "") for k, f in
               tops.items()}
    assert got == want
    assert got["linear"] == "bfloat16" and got["layer_norm"] == "float32"
    assert str(TF.linear(T(x), T(w), T(b)).dtype) == "torch.float32"


# ---------------------------------------------------------------------------
# TrainStep against the reference's
# ---------------------------------------------------------------------------

def _batches():
    rng = np.random.RandomState(8)
    return [(rng.randint(0, 256, (2, 128)).astype(np.int32),
             rng.randint(0, 256, (2, 128)).astype(np.int32))
            for _ in range(STEPS)]


@pytest.fixture(scope="module", params=[None, "O1"], ids=["f32", "O1"])
def reference_run(request):
    """The reference's TrainStep for 3 steps on the tiny flash GPT, with
    the state after step 2 kept for the resume test."""
    jfa._INTERPRET = True
    try:
        paddle.seed(3)
        jm = jmodels.GPTForPretraining(jmodels.GPTConfig(**FLASH_GPT))
        init = _np_state(jm)
        crit = jmodels.GPTPretrainingCriterion()
        opt = paddle.optimizer.AdamW(learning_rate=LR,
                                     parameters=jm.parameters())
        step = JTrainStep(jm, lambda logits, y: crit(logits, y), opt,
                          amp_level=request.param)
        losses, mid = [], None
        for i, (ids, lab) in enumerate(_batches()):
            losses.append(float(step(paddle.to_tensor(ids),
                                     paddle.to_tensor(lab)).numpy()))
            if i == STEPS - 2:
                mid = (_np_state(jm), jax.tree_util.tree_map(
                    np.asarray, step._opt_state), opt._step_count)
        return dict(amp=request.param, init=init, losses=losses, mid=mid,
                    final=_np_state(jm))
    finally:
        jfa._INTERPRET = False


def _port(state, amp):
    tm = tmodels.GPTForPretraining(tmodels.GPTConfig(**FLASH_GPT),
                                   device="cpu")
    pt.load_paddle_state(tm, state)
    crit = tmodels.GPTPretrainingCriterion()
    opt = AdamW(learning_rate=LR, parameters=tm.parameters())
    return tm, TrainStep(tm, lambda logits, y: crit(logits, y), opt,
                         amp_level=amp)


def _step(step, ids, lab):
    return float(step(torch.from_numpy(ids).long(),
                      torch.from_numpy(lab).long()))


def _assert_weights(tm, want, amp):
    for k, v in want.items():
        diff = np.abs(tm.state_dict()[k].float().numpy() - v) / LR
        if amp is None:
            assert diff.max() <= 0.25, (k, diff.max())
            assert (diff > 0.01).mean() <= 0.05, (k, (diff > 0.01).mean())
            continue
        assert diff.max() <= 10.0, (k, diff.max())
        if not k.endswith("qkv.bias"):
            assert (diff > 0.1).mean() <= 0.05, (k, (diff > 0.1).mean())


def test_trainstep_matches_reference(reference_run):
    run = reference_run
    tm, step = _port(run["init"], run["amp"])
    n_plain = []
    orig = tfa._plain_fwd

    def counting(*a):
        n_plain.append(1)
        return orig(*a)
    tfa._plain_fwd = counting
    try:
        losses = [_step(step, ids, lab) for ids, lab in _batches()]
    finally:
        tfa._plain_fwd = orig
    assert len(n_plain) == STEPS * FLASH_GPT["num_hidden_layers"]
    tol = 1e-5 if run["amp"] is None else 1e-3
    np.testing.assert_allclose(losses, run["losses"], rtol=tol, atol=tol)
    assert losses[-1] < losses[0] or run["amp"] is not None
    _assert_weights(tm, run["final"], run["amp"])


@pytest.mark.parametrize("reference_run", [None], ids=["f32"],
                         indirect=True)
def test_resume_from_reference_optimizer_state(reference_run):
    """load_paddle_opt_state carries the reference's moments and step
    count: one more port step from the reference's f32 state after step 2
    lands on the reference's state after step 3."""
    run = reference_run
    weights, moments, count = run["mid"]
    tm, step = _port(weights, None)
    pt.load_paddle_opt_state(step, moments, step_count=count)
    ids, lab = _batches()[-1]
    np.testing.assert_allclose(_step(step, ids, lab), run["losses"][-1],
                               rtol=1e-5)
    _assert_weights(tm, run["final"], None)


def _tiny_port(seed=4):
    pt.seed(0)
    tm = tmodels.GPTForPretraining(tmodels.GPTConfig(**FLASH_GPT),
                                   device="cpu", seed=seed)
    return tm, tmodels.GPTPretrainingCriterion()


def test_guard_skips_a_nan_batch_with_state_unchanged():
    tm, crit = _tiny_port()
    opt = AdamW(learning_rate=LR, parameters=tm.parameters())

    def loss_fn(logits, y):   # y[..., 0] labels, y[..., 1] a loss factor
        return crit(logits, y[..., 0].long()) * y[..., 1].mean()
    step = TrainStep(tm, loss_fn, opt, guard=True)
    rng = np.random.RandomState(9)
    ids = torch.from_numpy(rng.randint(0, 256, (2, 128)))
    y = torch.stack([torch.from_numpy(rng.randint(0, 256, (2, 128))).float(),
                     torch.ones(2, 128)], -1)
    step(ids, y)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    moments = {k: {s: t.clone() for s, t in v.items()}
               for k, v in step._opt_state.items()}
    bad = y.clone()
    bad[0, 0, 1] = float("nan")
    loss = step(ids, bad)
    assert not torch.isfinite(loss) and not bool(step.last_guard[1])
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in step._opt_state.items():
        for s, t in v.items():
            assert torch.equal(t, moments[k][s]), (k, s)
    step(ids, y)
    assert bool(step.last_guard[1])
    assert not torch.equal(tm.state_dict()["gpt.ln_f.weight"],
                           before["gpt.ln_f.weight"])


def test_accum_steps_matches_the_full_batch():
    """accum_steps=2 over a batch of 4 (two micro-batches of 2, f32 grads
    averaged) against one step on the full batch: equal token counts, so
    the mean loss and the update agree to f32 rounding."""
    rng = np.random.RandomState(10)
    ids = torch.from_numpy(rng.randint(0, 256, (4, 128)))
    lab = torch.from_numpy(rng.randint(0, 256, (4, 128)))
    out = []
    for k in (1, 2):
        tm, crit = _tiny_port()
        opt = AdamW(learning_rate=LR, parameters=tm.parameters())
        step = TrainStep(tm, lambda logits, y: crit(logits, y), opt,
                         accum_steps=k)
        out.append(([float(step(ids, lab)) for _ in range(2)],
                    {n: v.clone() for n, v in tm.state_dict().items()}))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    for n, v in out[0][1].items():
        assert float((v - out[1][1][n]).abs().max()) <= 0.05 * LR, n
    with pytest.raises(ValueError):
        TrainStep(tm, lambda logits, y: crit(logits, y), opt,
                  accum_steps=3)(ids, lab)


def test_labels_path_is_the_fused_ce_of_the_logits():
    """GPTForPretraining(ids, labels=...) per-token losses equal the
    criterion's cross-entropy of the logits (bf16 dots in the fused CE)."""
    tm, crit = _tiny_port()
    rng = np.random.RandomState(12)
    ids = torch.from_numpy(rng.randint(0, 256, (2, 128)))
    lab = torch.from_numpy(rng.randint(0, 256, (2, 128)))
    with torch.no_grad():
        per_token = tm(ids, labels=lab)
        ref = crit(tm(ids), lab)
    assert per_token.shape == (2, 128)
    np.testing.assert_allclose(float(per_token.mean()), float(ref),
                               rtol=5e-3)
