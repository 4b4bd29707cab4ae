"""``jit.TrainStep``'s step programs (one per batch signature) on the CPU,
where each program function runs directly: what a CUDA graph capture of
it needs (no host reads, no scalar frozen at the first step, results that
the next run does not overwrite, a warm-up that moves nothing) and what
the reference's compiled step offers (``run_steps``, ``with_outputs``, one
program per batch signature).

Models: the tiny flash GPT of test_torch_train.py (hidden 128, 2 heads, 2
layers, seq 128, vocab 256) and ResNet-18 (6 classes, 8 x 3 x 64 x 64).
The program and the eager arithmetic it is held against are the same
float ops in the same order on one CPU thread, so updates are compared
bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.jit import TrainStep, forward_loss, recompute_policy
from paddle_tpu_torch.models import (GPTConfig, GPTForPretraining,
                                     GPTPretrainingCriterion)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import AdamW, Momentum
from paddle_tpu_torch.optimizer import functional
from paddle_tpu_torch.optimizer.functional import (apply_updates,
                                                   decay_flags,
                                                   update_in_place)
from paddle_tpu_torch.vision import models as tvm

from test_torch_serving_programs import _no_host_reads

torch.set_num_threads(1)

GPT = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
           num_attention_heads=2, hidden_dropout_prob=0.1,
           attention_probs_dropout_prob=0.1, max_position_embeddings=128)
CLASSES = 6


@pytest.fixture(autouse=True)
def _clear_policy():
    yield
    recompute_policy(None)


def _gpt_batch(b=2, seed=8):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randint(0, 256, (b, 128)))
                 for _ in range(2))


def _gpt(dropout=0.1, **kw):
    pt.seed(0)
    cfg = GPTConfig(**dict(GPT, hidden_dropout_prob=dropout,
                           attention_probs_dropout_prob=dropout))
    tm = GPTForPretraining(cfg, device="cpu", seed=4)
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=1e-3, weight_decay=0.1,
                parameters=tm.parameters())
    return tm, TrainStep(tm, lambda lg, y: crit(lg, y), opt, **kw)


def _resnet_batch(n=8, seed=0):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(n, 3, 64, 64).astype(np.float32)),
            torch.from_numpy(rng.randint(0, CLASSES, (n,))))


def _resnet(**kw):
    pt.seed(0)
    tm = tvm.resnet18(num_classes=CLASSES, device="cpu", seed=2)
    opt = Momentum(learning_rate=0.01, momentum=0.9,
                   parameters=tm.parameters())
    return tm, TrainStep(tm, lambda lg, y: TF.cross_entropy(lg, y), opt,
                         **kw)


def _state(tm, step):
    return ({k: v.clone() for k, v in tm.state_dict().items()},
            {k: {s: t.clone() for s, t in v.items()}
             for k, v in step._opt_state.items()},
            step._gen.get_state().clone())


def _assert_same_state(a, b):
    (pa, oa, ga), (pb, ob, gb) = a, b
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    for k in oa:
        for s in oa[k]:
            assert torch.equal(oa[k][s], ob[k][s]), (k, s)
    assert torch.equal(ga, gb)


@pytest.mark.parametrize("model,policy", [
    ("gpt", None), ("gpt", "stages"), ("gpt_guard", None),
    ("resnet", None), ("resnet", "stages")])
def test_step_program_reads_nothing_on_the_host(model, policy,
                                                monkeypatch):
    """The step program with every host read of a tensor (and every
    tensor made from host data) patched to raise, as a CUDA graph capture
    would refuse them: GPT with dropout, under the guard and under
    recompute, and ResNet-18 with its running statistics."""
    if model.startswith("gpt"):
        tm, step = _gpt(guard=model == "gpt_guard")
        batch = _gpt_batch()
    else:
        tm, step = _resnet()
        batch = _resnet_batch()
    with recompute_policy(policy) if policy else recompute_policy(None):
        step.warmup(*batch)
        prog = next(iter(step._programs.values()))
        with monkeypatch.context() as m:
            _no_host_reads(m)
            out = prog.run(captured=False)
    assert out[0].shape == () and bool(torch.isfinite(out[0]))


def test_scalars_follow_set_lr_and_the_step_count():
    """The program is made once; between runs the learning rate changes
    (set_lr) and the step number grows: each run's update equals the eager
    apply_updates with that run's values (AdamW: lr, both bias
    corrections and the decoupled decay read them)."""
    tm, step = _gpt(dropout=0.0)
    batch = _gpt_batch()
    step.warmup(*batch)
    for i, lr in enumerate((1e-3, 3e-3, 5e-4)):
        step.optimizer.set_lr(lr)
        state = tm.state_dict(keep_vars=True)
        params = {k: state[k] for k in step._trainable}
        _, grads, _, _ = step._grads(params, batch)
        want, want_opt = apply_updates(
            step.optimizer, {k: p.detach().clone() for k, p in params.items()},
            grads, {k: dict(v) for k, v in step._opt_state.items()}, lr,
            i + 1, step._decay)
        step(*batch)
        assert step.optimizer._step_count == i + 1
        for k in want:
            assert torch.equal(state[k].detach(), want[k]), (i, k)
            for s, t in want_opt[k].items():
                assert torch.equal(step._opt_state[k][s], t), (i, k, s)
    assert step.compile_counts()["total"] == 1


def test_returned_losses_are_tensors_of_their_own():
    """A graph overwrites its outputs at each replay: every call's loss
    (and last_outputs / last_guard) is a tensor of its own."""
    tm, step = _gpt(guard=True, with_outputs=True)
    batch = _gpt_batch()
    losses, outs, guards = [], [], []
    for _ in range(3):
        losses.append(step(*batch))
        outs.append(step.last_outputs[0])
        guards.append(step.last_guard)
    ptrs = {t.data_ptr() for t in losses + outs}
    ptrs |= {t.data_ptr() for g in guards for t in g}
    assert len(ptrs) == 3 * 4
    assert len({float(x) for x in losses}) == 3
    assert not torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("model", ["gpt", "resnet"])
def test_warmup_moves_nothing(model):
    """warmup() of a new signature after a real step: parameters,
    optimizer state, running statistics and the generator unchanged; the
    next step equals a twin's that never warmed up, bit for bit."""
    if model == "gpt":
        make, batch, other = _gpt, _gpt_batch(), _gpt_batch(b=4, seed=3)
    else:
        make, batch, other = _resnet, _resnet_batch(), _resnet_batch(4, 3)
    runs = []
    for warm in (True, False):
        tm, step = make()
        step(*batch)
        before = _state(tm, step)
        if warm:
            rep = step.warmup(*other)
            assert rep["compiled"] and rep["seconds"] >= 0
            _assert_same_state(before, _state(tm, step))
            assert not step.warmup(*other)["compiled"]
            assert step.optimizer._step_count == 1
        runs.append((float(step(*other)), _state(tm, step)))
    assert runs[0][0] == runs[1][0]
    _assert_same_state(runs[0][1], runs[1][1])


def test_run_steps_equals_k_calls():
    stacked = tuple(torch.stack(t) for t in zip(
        *[_gpt_batch(seed=s) for s in (1, 2, 3)]))
    tm, step = _gpt()
    losses = step.run_steps(*stacked)
    tm2, step2 = _gpt()
    want = [step2(*(b[i] for b in stacked)) for i in range(3)]
    assert losses.shape == (3,)
    assert torch.equal(losses, torch.stack(want))
    _assert_same_state(_state(tm, step), _state(tm2, step2))
    assert step.compile_counts() == step2.compile_counts()


def test_run_steps_refuses_guard_and_accum():
    stacked = tuple(b[None] for b in _gpt_batch())
    for kw in (dict(guard=True), dict(accum_steps=2)):
        _, step = _gpt(**kw)
        with pytest.raises(NotImplementedError):
            step.run_steps(*stacked)


def test_with_outputs_keeps_the_forward_outputs():
    """with_outputs: last_outputs holds the step's forward outputs (the
    logits of the parameters before the update), and composes with
    neither accum_steps > 1."""
    tm, step = _gpt(dropout=0.0, with_outputs=True)
    batch = _gpt_batch()
    with torch.no_grad():
        want = tm(batch[0])
    loss = step(*batch)
    (got,) = step.last_outputs
    assert torch.equal(got, want)
    crit = GPTPretrainingCriterion()
    assert torch.equal(loss, crit(want, batch[1]))
    with pytest.raises(ValueError, match="with_outputs"):
        _gpt(with_outputs=True, accum_steps=2)


def test_one_program_per_batch_signature():
    tm, step = _gpt()
    a, b = _gpt_batch(), _gpt_batch(b=4)
    assert step.compile_counts() == {"step": {}, "total": 0}
    step(*a)
    step(*a)
    assert step.warmup(*b)["compiled"]
    step(*b)
    step(*a)
    assert not step.warmup(*a)["compiled"]
    counts = step.compile_counts()
    assert counts["total"] == 2 and set(counts["step"].values()) == {1}
    assert (((2, 128), "int64"), ((2, 128), "int64")) in counts["step"]


def test_forward_loss_returns_outputs():
    tm, _ = _gpt(dropout=0.0)
    crit = GPTPretrainingCriterion()
    batch = _gpt_batch()
    loss, (logits,) = forward_loss(tm, lambda lg, y: crit(lg, y), batch,
                                   return_outputs=True)
    assert torch.equal(loss, crit(logits, batch[1]))


@pytest.mark.parametrize("ok", [None, True, False])
@pytest.mark.parametrize("make", ["adamw", "momentum"])
def test_update_in_place_equals_apply_updates_by_chunks(make, ok,
                                                        monkeypatch):
    """The step's in-place update, cut into chunks of a few elements (each
    parameter larger than a chunk is one), writes what the functional
    update returns, element for element; under a False guard verdict
    nothing moves."""
    opt = (AdamW(learning_rate=1e-2, weight_decay=0.1,
                 apply_decay_param_fun=lambda n: n != "b")
           if make == "adamw" else Momentum(learning_rate=0.1, momentum=0.9))
    gen = torch.Generator().manual_seed(3)
    names = ["a", "b", "c", "d"]
    params = {n: torch.randn(5, i + 1, generator=gen)
              for i, n in enumerate(names)}
    grads = {n: torch.randn(p.shape, generator=gen) for n, p in params.items()}
    state = {n: {s: t + 0.5 for s, t in opt.init_state(p).items()}
             for n, p in params.items()}
    decay = decay_flags(opt, names)
    want_p, want_s = apply_updates(opt, params, grads, state, 0.01, 3, decay)
    got_p = {n: p.clone() for n, p in params.items()}
    got_s = {n: {s: t.clone() for s, t in v.items()}
             for n, v in state.items()}
    monkeypatch.setattr(functional, "_CHUNK", 12)
    update_in_place(opt, got_p, grads, got_s, 0.01, 3, decay,
                    None if ok is None else torch.tensor(ok))
    moved = ok is not False
    for n in names:
        assert torch.equal(got_p[n], want_p[n] if moved else params[n]), n
        for s, t in got_s[n].items():
            assert torch.equal(t, want_s[n][s] if moved else state[n][s])


def _mlp_pair(seed=0):
    """(reference model, port model): Linear 6 -> 16 -> relu -> 3 with the
    same weights."""
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    from paddle_tpu.jit import state_arrays
    from paddle_tpu_torch import load_paddle_state
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(6, 16), jnn.ReLU(), jnn.Linear(16, 3))
    tm = pt.nn.Sequential(pt.nn.Linear(6, 16, device="cpu"), pt.nn.ReLU(),
                          pt.nn.Linear(16, 3, device="cpu"))
    load_paddle_state(tm, {k: np.asarray(v)
                           for k, v in state_arrays(jm).items()})
    return jm, tm


def test_nan_grads_window_skips_the_reference_steps():
    """PDTPU_FAULT_NAN_GRADS="2:4", armed before the first step: both
    guarded steps skip steps 2 and 3 (gradients NaN inside the program,
    compared with the device step number), their losses agree within
    1e-5, and a skipped step leaves the parameters and both moments
    bit-equal; the window was read when the program was made."""
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.jit import TrainStep as JStep
    from paddle_tpu.utils import faults as jfaults
    from paddle_tpu_torch.utils import faults
    jm, tm = _mlp_pair()
    rng = np.random.RandomState(3)
    batches = [(rng.randn(8, 6).astype(np.float32),
                rng.randint(0, 3, (8,)).astype(np.int64)) for _ in range(5)]
    jopt = paddle.optimizer.AdamW(learning_rate=0.05,
                                  parameters=jm.parameters())
    topt = AdamW(learning_rate=0.05, parameters=tm.parameters())
    jstep = JStep(jm, lambda o, y: JF.cross_entropy(o, y), jopt, guard=True)
    tstep = TrainStep(tm, lambda o, y: TF.cross_entropy(o, y), topt,
                      guard=True)
    jfaults.enable("nan_grads", "2:4")     # the environment arms both
    try:
        assert faults.nan_grads_window() == (2, 4)
        tstep.warmup(*(torch.from_numpy(a) for a in batches[0]))
        jl, tl, jok, tok, moved = [], [], [], [], []
        for x, y in batches:
            loss = jstep(paddle.to_tensor(x), paddle.to_tensor(y))
            jl.append(float(loss.numpy()))
            jok.append(bool(np.asarray(jstep.last_guard[1])))
            before = [t.clone() for t in tstep._state_tensors()[:-2]]
            tl.append(float(tstep(torch.from_numpy(x), torch.from_numpy(y))))
            tok.append(bool(tstep.last_guard[1]))
            after = tstep._state_tensors()[:-2]
            moved.append(not all(torch.equal(a, b)
                                 for a, b in zip(before, after)))
    finally:
        jfaults.reset()
        faults.reset()
    assert jok == tok == [True, False, False, True, True]
    assert moved == tok
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    # disarmed now, but the program was made with the window: it stays
    assert tstep._programs[next(iter(tstep._programs))].fn.keywords[
        "nan_window"] == (2, 4)
    got = tm.state_dict()
    for k, v in jm.state_dict().items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v.numpy()),
                                   rtol=1e-5, atol=1e-6)


def test_nan_grads_step_program_reads_nothing_on_the_host(monkeypatch):
    """The armed window's comparison runs on the device step scalar."""
    from paddle_tpu_torch.utils import faults
    _, tm = _mlp_pair()
    step = TrainStep(tm, lambda o, y: TF.cross_entropy(o, y),
                     AdamW(learning_rate=0.05, parameters=tm.parameters()),
                     guard=True)
    x, y = torch.randn(8, 6), torch.randint(0, 3, (8,))
    faults.enable("nan_grads", "1")
    try:
        step.warmup(x, y)
    finally:
        faults.reset()
    prog = next(iter(step._programs.values()))
    with monkeypatch.context() as m:
        _no_host_reads(m)
        prog.run(captured=False)
    assert not bool(step._ok)
