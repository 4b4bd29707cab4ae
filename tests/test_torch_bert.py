"""paddle_tpu_torch's BERT / ERNIE against the JAX package on the CPU.

Two tiny configurations, one per attention route: the naive route (hidden
32, 2 heads, S 16: head_dim 16, which the flash gate refuses) and the
flash route (hidden 128, 2 heads so head_dim 64, S 128), where the port
runs K1/K2's plain versions with the padding mask as their (B, Sk) bias
and the reference its Pallas kernels through the interpreter
(``fa._INTERPRET = True``).  Weights go across by ``load_paddle_state``;
inputs are drawn with numpy from a seed and handed to both.  Dropout 0.

Tolerances: f32 logits and NSP scores 1e-4 (sums in another order);
losses 1e-5 relative over 3 f32 ``TrainStep`` steps, 1e-3 under O1 (the
bf16 rounding sits at other places in the two frameworks), as
``test_torch_train.py`` holds GPT.  Padded rows are compared like any
other: every row sees at least its real keys.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import models as jmodels
from paddle_tpu.jit import TrainStep as JTrainStep, state_arrays
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import flash_attention as jfa

import paddle_tpu_torch as pt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

VOCAB = 64
ROUTES = {
    "naive": dict(hidden_size=32, num_attention_heads=2, intermediate_size=64,
                  max_position_embeddings=16),
    "flash": dict(hidden_size=128, num_attention_heads=2,
                  intermediate_size=256, max_position_embeddings=128),
}
KINDS = ("bert", "ernie")


def _cfg(route, kind):
    kw = dict(vocab_size=VOCAB, num_hidden_layers=2, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0, **ROUTES[route])
    return (jmodels.BertConfig(**kw), tmodels.BertConfig(**kw)) \
        if kind == "bert" else \
        (jmodels.ErnieConfig(**kw), tmodels.ErnieConfig(**kw))


def _np_state(model):
    return {k: np.asarray(v) for k, v in state_arrays(model).items()}


def _inputs(route, seed=0, b=2):
    s = ROUTES[route]["max_position_embeddings"]
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (b, s)).astype(np.int32)
    tt = (np.arange(s)[None] >= s // 3).astype(np.int32).repeat(b, 0)
    mask = np.ones((b, s), np.int32)
    mask[1, s // 2 + 3:] = 0                        # a padded row
    task = rng.randint(0, 3, (b, s)).astype(np.int32)
    lab = np.where(rng.rand(b, s) < 0.3, ids, -100).astype(np.int32)
    nsp = rng.randint(0, 2, (b,)).astype(np.int32)
    return dict(ids=ids, tt=tt, mask=mask, task=task, lab=lab, nsp=nsp)


class _Plain:
    """Counts the port's calls of K1's plain version (the flash route)."""

    def __enter__(self):
        self.n, self._orig = 0, tfa._plain_fwd

        def counting(*a):
            self.n += 1
            return self._orig(*a)
        tfa._plain_fwd = counting
        return self

    def __exit__(self, *exc):
        tfa._plain_fwd = self._orig


@pytest.fixture(scope="module")
def pair():
    """One reference / port pair per (model class, route, kind), built
    once: the reference's weights loaded into the port's model."""
    made = {}

    def get(cls_name, route, kind, **kw):
        key = (cls_name, route, kind, tuple(sorted(kw.items())))
        if key not in made:
            jcfg, tcfg = _cfg(route, kind)
            paddle.seed(7)
            jm = getattr(jmodels, cls_name)(jcfg, **kw)
            tm = getattr(tmodels, cls_name)(tcfg, device="cpu", **kw)
            pt.load_paddle_state(tm, _np_state(jm))
            jm.eval()
            tm.eval()
            made[key] = (jm, tm)
        return made[key]
    return get


def _run_both(jm, tm, args_np):
    J = [None if a is None else paddle.to_tensor(a) for a in args_np]
    T = [None if a is None else torch.from_numpy(a).long() for a in args_np]
    jfa._INTERPRET = True
    try:
        jout = jm(*J)
    finally:
        jfa._INTERPRET = False
    with torch.no_grad(), _Plain() as plain:
        tout = tm(*T)
    return jout, tout, plain.n


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("kind", KINDS)
def test_pretraining_logits_match_reference(pair, kind, route, masked):
    """MLM logits and NSP scores (ERNIE with task ids when masked); the
    flash route takes K1 once per layer in the port."""
    cls = "BertForPretraining" if kind == "bert" else "ErnieForPretraining"
    jm, tm = pair(cls, route, kind)
    x = _inputs(route)
    args = [x["ids"], x["tt"], None, x["mask"] if masked else None]
    if kind == "ernie" and masked:
        args.append(x["task"])
    (jl, jn), (tl, tn), n_plain = _run_both(jm, tm, args)
    assert n_plain == (2 if route == "flash" else 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl.numpy()),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn.numpy()),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_sequence_classification_matches_reference(pair, kind):
    cls = ("BertForSequenceClassification" if kind == "bert"
           else "ErnieForSequenceClassification")
    jm, tm = pair(cls, "flash", kind, num_classes=3)
    x = _inputs("flash", seed=1)
    jout, tout, n_plain = _run_both(jm, tm,
                                    [x["ids"], x["tt"], None, x["mask"]])
    assert n_plain == 2 and tuple(tout.shape) == (2, 3)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout.numpy()),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_state_keys_and_the_tie_match_reference(pair, kind):
    """Every reference key is the port's, the tied decoder weight once
    (under the embedding's name), and it is the embedding's Parameter
    itself: one parameter, one gradient for both uses."""
    cls = "BertForPretraining" if kind == "bert" else "ErnieForPretraining"
    jm, tm = pair(cls, "naive", kind)
    body = tm.bert if kind == "bert" else tm.ernie
    want = set(state_arrays(jm))
    assert set(tm.state_dict()) == want
    assert not any("decoder_weight" in k for k in want)
    word = body.embeddings.word_embeddings.weight
    assert tm.cls.decoder_weight is word
    assert len(list(tm.parameters())) == len(want)
    assert (kind == "ernie") == any("task_type" in k for k in want)
    x = _inputs("naive")
    tm.zero_grad()
    logits, _ = tm(torch.from_numpy(x["ids"]).long())
    logits.sum().backward()
    emb_only = torch.zeros_like(word)
    emb_only.index_add_(0, torch.from_numpy(x["ids"]).long().reshape(-1),
                        torch.ones(x["ids"].size, word.shape[1]))
    # the head's use adds a gradient to every row, the lookup's only to
    # the looked-up rows: both reached the one tensor
    assert word.grad is not None
    untouched = emb_only.sum(1) == 0
    assert bool((word.grad[untouched].abs().sum(1) > 0).all())
    tm.zero_grad()


@pytest.mark.parametrize("with_nsp", [False, True], ids=["mlm", "mlm+nsp"])
def test_pretraining_criterion_matches_reference(with_nsp):
    rng = np.random.RandomState(3)
    scores = (2 * rng.randn(2, 16, VOCAB)).astype(np.float32)
    rel = rng.randn(2, 2).astype(np.float32)
    lab = np.where(rng.rand(2, 16) < 0.3, rng.randint(0, VOCAB, (2, 16)),
                   -100).astype(np.int32)
    nsp = np.array([1, 0], np.int32)
    jargs = [paddle.to_tensor(scores), paddle.to_tensor(rel),
             paddle.to_tensor(lab)]
    targs = [torch.from_numpy(scores).requires_grad_(), torch.from_numpy(rel),
             torch.from_numpy(lab).long()]
    if with_nsp:
        jargs.append(paddle.to_tensor(nsp))
        targs.append(torch.from_numpy(nsp).long())
    want = jmodels.BertPretrainingCriterion()(*jargs)
    got = tmodels.ErniePretrainingCriterion()(*targs)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want.numpy()),
                               rtol=1e-5)
    g = targs[0].grad.numpy()
    assert np.all(g[lab == -100] == 0) and np.any(g[lab != -100] != 0)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_tanh_amp_types_match_reference(level):
    x = np.random.RandomState(4).randn(3, 5).astype(np.float32)
    with jamp.auto_cast(level=level):
        want = str(JF.tanh(paddle.to_tensor(x)).dtype)
    with tamp.auto_cast(level=level):
        got = TF.tanh(torch.from_numpy(x))
        layer = pt.nn.Tanh()(torch.from_numpy(x))
    assert str(got.dtype).replace("torch.", "") == want == str(
        layer.dtype).replace("torch.", "")
    np.testing.assert_allclose(got.float().numpy(), np.tanh(x), atol=1e-2)


# ---------------------------------------------------------------------------
# TrainStep against the reference's, flash route with the padding bias
# ---------------------------------------------------------------------------

STEPS, LR = 3, 1e-3


def _batches():
    out = []
    for i in range(STEPS):
        x = _inputs("flash", seed=10 + i)
        pos = np.broadcast_to(np.arange(128, dtype=np.int32), (2, 128))
        out.append((x["ids"], x["tt"], np.ascontiguousarray(pos), x["mask"],
                    x["lab"]))
    return out


def _decay(n):
    return "bias" not in n and "norm" not in n


@pytest.fixture(scope="module", params=[None, "O1"], ids=["f32", "O1"])
def reference_run(request):
    """The reference's TrainStep, 3 steps of BERT on the flash route with a
    padded row, AdamW with decay off for biases and norms."""
    jfa._INTERPRET = True
    try:
        jcfg, _ = _cfg("flash", "bert")
        paddle.seed(11)
        jm = jmodels.BertForPretraining(jcfg)
        init = _np_state(jm)
        crit = jmodels.BertPretrainingCriterion()
        opt = paddle.optimizer.AdamW(learning_rate=LR,
                                     parameters=jm.parameters(),
                                     apply_decay_param_fun=_decay)
        step = JTrainStep(jm, lambda lg, nsp, y: crit(lg, nsp, y), opt,
                          amp_level=request.param)
        losses = [float(step(*[paddle.to_tensor(a) for a in b]).numpy())
                  for b in _batches()]
        return dict(amp=request.param, init=init, losses=losses,
                    final=_np_state(jm))
    finally:
        jfa._INTERPRET = False


def test_trainstep_matches_reference(reference_run):
    run = reference_run
    _, tcfg = _cfg("flash", "bert")
    tm = tmodels.BertForPretraining(tcfg, device="cpu")
    pt.load_paddle_state(tm, run["init"])
    crit = tmodels.BertPretrainingCriterion()
    opt = pt.optimizer.AdamW(learning_rate=LR, parameters=tm.parameters(),
                             apply_decay_param_fun=_decay)
    step = TrainStep(tm, lambda lg, nsp, y: crit(lg, nsp, y), opt,
                     amp_level=run["amp"])
    with _Plain() as plain:
        losses = [float(step(*[torch.from_numpy(a).long() for a in b]))
                  for b in _batches()]
    assert plain.n == STEPS * 2
    tol = 1e-5 if run["amp"] is None else 1e-3
    np.testing.assert_allclose(losses, run["losses"], rtol=tol, atol=tol)
    if run["amp"] is None:
        for k, v in run["final"].items():
            diff = np.abs(tm.state_dict()[k].numpy() - v) / LR
            assert diff.max() <= 0.25, (k, diff.max())
