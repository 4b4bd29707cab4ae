"""paddle_tpu_torch's activation recompute (``jit.recompute_policy``,
``TrainStep(remat=True)``) on the CPU, mirroring the reference's
tests/test_recompute.py and holding the port against the reference's
``TrainStep`` under the same policy.

Models: a tiny GPT that takes the flash path (hidden 128, 2 heads so
head_dim 64, 2 layers, seq 128, vocab 256) and ResNet-18 (6 classes, a
batch of 8 x 3 x 64 x 64, so the last stage's BatchNorms see 32 rows).
Inputs are drawn with numpy from a seed.

Tolerances, with their reasons:
- inside the port, recompute changes what is kept, never the arithmetic,
  and a region draws its dropout masks and attention-dropout seeds again
  from the generator position it was entered at: losses and running
  statistics bit-equal to the same steps without recompute, gradients and
  updated parameters within 1e-6 of each tensor's largest |value| (the
  recomputed forward is the same float ops; the bound leaves room only
  for a kernel that sums in another order on another call);
- against the reference (f32, dropout 0, 3 steps): the existing
  ``TrainStep`` parity tolerances, losses within 1e-5 relative for GPT
  (test_torch_train.py) and 1e-4 for ResNet-18 (test_torch_resnet.py).
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit import recompute_policy as jrecompute_policy
from paddle_tpu.jit import state_arrays
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu.vision import models as jvm

import paddle_tpu_torch as pt
from paddle_tpu_torch import nn
from paddle_tpu_torch.core import recompute as rc
from paddle_tpu_torch.jit import TrainStep, recompute_policy
from paddle_tpu_torch.models import (GPTConfig, GPTForPretraining,
                                     GPTPretrainingCriterion)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import fused_bn_act as TK
from paddle_tpu_torch.optimizer import AdamW, Momentum
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.vision import models as tvm
from paddle_tpu_torch.vision.models.resnet import BasicBlock

from torch_parity import tiny_pair, torch_solo

# tiny shapes gain nothing from intra-op threads, and idle OpenMP threads
# spinning would take cores from the test files running beside this one
# (one thread also keeps the CPU's dropout draws in one order)
torch.set_num_threads(1)

GPT = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
           num_attention_heads=2, hidden_dropout_prob=0.1,
           attention_probs_dropout_prob=0.1, max_position_embeddings=128)
STEPS = 3
LR = 1e-3
CLASSES = 6
MODES = {"remat": (True, None),
         "stages_dots": (False, ("stages", "dots_saveable")),
         "stages_nothing": (False, ("stages", "nothing_saveable"))}


@pytest.fixture(autouse=True)
def _clear_policy():
    yield
    recompute_policy(None)


def _policy(spec_policy):
    return (recompute_policy(*spec_policy) if spec_policy
            else contextlib.nullcontext())


def _np_state(model):
    return {k: np.asarray(v) for k, v in state_arrays(model).items()}


def _gpt_batch(seed=8):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randint(0, 256, (2, 128)))
                 for _ in range(2))


def _gpt_step(remat=False, state=None, dropout=0.1):
    pt.seed(0)
    cfg = GPTConfig(**dict(GPT, hidden_dropout_prob=dropout,
                           attention_probs_dropout_prob=dropout))
    tm = GPTForPretraining(cfg, device="cpu", seed=4)
    if state is not None:
        pt.load_paddle_state(tm, state)
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=LR, parameters=tm.parameters())
    return tm, TrainStep(tm, lambda lg, y: crit(lg, y), opt, remat=remat)


def _resnet_batch(seed=0):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(8, 3, 64, 64).astype(np.float32)),
            torch.from_numpy(rng.randint(0, CLASSES, (8,))))


def _resnet_step(state=None):
    tm = tvm.resnet18(num_classes=CLASSES, device="cpu", seed=2)
    if state is not None:
        pt.load_paddle_state(tm, state)
    opt = Momentum(learning_rate=0.01, momentum=0.9,
                   parameters=tm.parameters())
    return tm, TrainStep(tm, lambda lg, y: TF.cross_entropy(lg, y), opt)


def _worst(got, want):
    return max(float((got[k].float() - want[k].float()).abs().max()
                     / want[k].float().abs().max().clamp_min(1e-30))
               for k in want)


# ---------------------------------------------------------------------------
# policy plumbing
# ---------------------------------------------------------------------------

def test_policy_spec_forms():
    blk = tvm.resnet18(device="cpu").layer1[0]
    lin = nn.Linear(4, 4, device="cpu")
    recompute_policy("stages")
    assert rc._matches(blk)       # blocks ship pre-tagged
    assert not rc._matches(lin)
    recompute_policy(BasicBlock)
    assert rc._matches(blk) and not rc._matches(lin)
    recompute_policy((BasicBlock, nn.Linear))
    assert rc._matches(lin)
    recompute_policy({"BasicBlock"})
    assert rc._matches(blk) and not rc._matches(lin)
    recompute_policy(lambda layer: isinstance(layer, nn.Linear))
    assert rc._matches(lin) and not rc._matches(blk)
    recompute_policy(None)
    assert rc.policy() is None
    gpt = GPTForPretraining(GPTConfig(**GPT), device="cpu")
    recompute_policy("stages")
    assert all(rc._matches(b) for b in gpt.gpt.blocks)
    assert not rc._matches(gpt.gpt)


def test_unknown_checkpoint_policy_rejected_eagerly():
    with pytest.raises(ValueError, match="unknown checkpoint policy"):
        recompute_policy("stages", policy="definitely_not_a_policy")
    with pytest.raises(ValueError, match="unknown checkpoint policy"):
        rc.checkpoint(lambda x: x, policy="definitely_not_a_policy")
    assert rc.policy() is None


def test_policy_context_manager_restores():
    assert rc.policy() is None
    with recompute_policy("stages"):
        assert rc.policy() is not None
        with recompute_policy(None):
            assert rc.policy() is None
        assert rc.policy() is not None
    assert rc.policy() is None


def _count_regions(monkeypatch):
    regions = []
    run = rc._run

    def counting(fn, args, policy, layer):
        regions.append(type(layer).__name__)
        return run(fn, args, policy, layer)
    monkeypatch.setattr(rc, "_run", counting)
    return regions


def test_eager_execution_never_wrapped(monkeypatch):
    """Eager calls, with grad enabled, outside a TrainStep, in eval and in
    train mode: no region is made and the outputs are unchanged."""
    regions = _count_regions(monkeypatch)
    m = tvm.resnet18(num_classes=CLASSES, device="cpu", seed=1).eval()
    x, _ = _resnet_batch()
    base = m(x[:2]).detach()
    with recompute_policy("stages", policy="nothing_saveable"):
        out = m(x[:2])
        m.train()
        out.sum().backward()      # the eager tape, not a region
        m(x[:2]).sum().backward()
    assert torch.equal(out.detach(), base)
    assert regions == []


def test_serving_streams_unchanged_with_policy_active(monkeypatch):
    """GPT blocks ship tagged: an active policy changes no served token,
    makes no region (the engine's programs run without grad) and keeps
    the engine's captures at its bound."""
    _, model = tiny_pair()

    def serve(policy):
        with _policy(("stages", "nothing_saveable") if policy else None):
            eng = ServingEngine(model, max_slots=2, max_len=32,
                                prefill_buckets=(8,), decode_chunk=2,
                                device="cpu")
            eng.warmup()
            r = eng.submit(np.arange(5) % 13, max_new_tokens=6)
            eng.run_until_drained(timeout=120)
            toks = r.tokens(timeout=5)
            assert eng.post_warmup_compiles() == 0
        return toks

    regions = _count_regions(monkeypatch)
    assert serve(True) == serve(False) == torch_solo(
        model, list(np.arange(5) % 13), 6)
    assert regions == []


# ---------------------------------------------------------------------------
# recompute changes what is kept, never the result
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plain_gpt_run():
    """Three steps of the tiny GPT with dropout 0.1, no recompute: the
    losses, the first step's gradients and the final state."""
    return _gpt_run(False, None)


def _gpt_run(remat, spec_policy):
    batch = _gpt_batch()
    tm, step = _gpt_step(remat)
    with _policy(spec_policy):
        step._setup()
        state = tm.state_dict(keep_vars=True)
        gen = step._gen.get_state()
        _, grads, _, _ = step._grads(
            {k: state[k] for k in step._trainable}, batch)
        step._gen.set_state(gen)        # the steps draw from the start
        launches = []
        orig = tfa._plain_fwd

        def counting(*a):
            launches.append(1)
            return orig(*a)
        tfa._plain_fwd = counting
        try:
            losses = [float(step(*batch)) for _ in range(STEPS)]
        finally:
            tfa._plain_fwd = orig
    return dict(losses=losses, grads={k: g.detach() for k, g in grads.items()},
                final={k: v.clone() for k, v in tm.state_dict().items()},
                k1=len(launches))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_recompute_gpt_steps_bit_equal_with_dropout(plain_gpt_run, mode):
    """remat=True and recompute_policy("stages") under both policies:
    three steps with dropout 0.1 give the losses of the steps without
    recompute bit for bit (the recomputed masks are the first forward's),
    the gradients and updated parameters within 1e-6 of each tensor's
    largest value; K1 (its plain version here) runs twice per layer."""
    base = plain_gpt_run
    got = _gpt_run(*MODES[mode])
    assert got["losses"] == base["losses"]
    assert _worst(got["grads"], base["grads"]) <= 1e-6
    assert _worst(got["final"], base["final"]) <= 1e-6
    layers = GPT["num_hidden_layers"]
    assert base["k1"] == STEPS * layers
    assert got["k1"] == 2 * STEPS * layers


def test_recompute_resnet_running_stats_equal():
    """A ResNet-18 step under "stages": the same loss and the same running
    statistics as the step without recompute (a recomputation's
    running-statistic updates are dropped, not applied twice), while the
    blocks' BatchNorm forwards do run again."""
    x, y = _resnet_batch()
    out = []
    for spec_policy in (None, ("stages", "dots_saveable")):
        tm, step = _resnet_step()
        n0 = TK.bn_stats.calls
        with _policy(spec_policy):
            loss = float(step(x, y))
        out.append((loss, {k: v.clone() for k, v in tm.state_dict().items()},
                    TK.bn_stats.calls - n0))
    (l0, s0, n0), (l1, s1, n1) = out
    assert l1 == l0
    stats = [k for k in s0 if k.endswith(("_mean", "_variance"))]
    assert len(stats) == 2 * 20
    for k in stats:
        assert torch.equal(s1[k], s0[k]), k
    assert not torch.equal(s0["bn1._variance"], torch.ones(64))
    assert _worst({k: s1[k] for k in s0 if k not in stats},
                  {k: s0[k] for k in s0 if k not in stats}) <= 1e-6
    # K5 at the stem and at every block site, again at the block sites
    assert n0 == 1 + 16 + 3 and n1 == n0 + 16 + 3


def test_fused_bn_stays_inside_regions():
    """The port's deliberate deviation from the reference (which falls
    back to plain composites inside a region): the fused BatchNorm
    Functions run inside the blocks' regions; the stem, in no block, runs
    outside every region."""
    seen = []
    orig_act, orig_pool = TK.bn_act_train, TK.bn_act_pool_train

    def spy(orig):
        def f(*a, **kw):
            seen.append(rc.inside_checkpoint())
            return orig(*a, **kw)
        f.relayouts = 0       # the entries' counter, bumped by name
        return f
    x, y = _resnet_batch()
    tm, step = _resnet_step()
    TK.bn_act_train, TK.bn_act_pool_train = spy(orig_act), spy(orig_pool)
    try:
        with recompute_policy("stages"):
            step(x, y)
    finally:
        TK.bn_act_train, TK.bn_act_pool_train = orig_act, orig_pool
    assert seen[0] is False and True in seen


# ---------------------------------------------------------------------------
# against the reference's TrainStep under the same policy
# ---------------------------------------------------------------------------

def test_gpt_under_stages_matches_reference():
    jfa._INTERPRET = True
    try:
        paddle.seed(3)
        cfg = dict(GPT, hidden_dropout_prob=0.0,
                   attention_probs_dropout_prob=0.0)
        jm = jmodels.GPTForPretraining(jmodels.GPTConfig(**cfg))
        init = _np_state(jm)
        crit = jmodels.GPTPretrainingCriterion()
        jstep = JTrainStep(jm, lambda lg, y: crit(lg, y),
                           paddle.optimizer.AdamW(learning_rate=LR,
                                                  parameters=jm.parameters()))
        batch = _gpt_batch()
        with jrecompute_policy("stages"):
            want = [float(jstep(*[paddle.to_tensor(b.numpy().astype(np.int32))
                                  for b in batch]).numpy())
                    for _ in range(STEPS)]
    finally:
        jfa._INTERPRET = False
    tm, step = _gpt_step(state=init, dropout=0.0)
    with recompute_policy("stages"):
        got = [float(step(*batch)) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_resnet18_under_stages_matches_reference():
    paddle.seed(0)
    jm = jvm.resnet18(num_classes=CLASSES)
    init = _np_state(jm)
    jstep = JTrainStep(jm, lambda lg, y: JF.cross_entropy(lg, y),
                       paddle.optimizer.Momentum(
                           learning_rate=0.01, momentum=0.9,
                           parameters=jm.parameters()))
    x, y = _resnet_batch()
    with jrecompute_policy("stages"):
        want = [float(jstep(paddle.to_tensor(x.numpy()),
                            paddle.to_tensor(y.numpy())).numpy())
                for _ in range(STEPS)]
    tm, step = _resnet_step(init)
    with recompute_policy("stages"):
        got = [float(step(x, y)) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
