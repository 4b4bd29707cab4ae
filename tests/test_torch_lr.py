"""paddle_tpu_torch's learning-rate schedulers against the JAX package's.

Every scheduler of ``paddle_tpu/optimizer/lr.py``: 30 steps of learning
rates equal to the reference's (1e-12: the same host float arithmetic),
``state_dict`` equal to the reference's and a ``set_state_dict`` round
trip that resumes the sequence.  Then optimizers under a scheduler: the
eager state dict's ``"LR_Scheduler"``, ``set_lr`` refused, and a tiny BERT
``TrainStep`` (naive attention route, dropout 0) whose losses equal the
reference ``TrainStep``'s under the same schedule (1e-5), with no new
program made as the learning rate moves.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.jit import TrainStep as JTrainStep, state_arrays
from paddle_tpu.optimizer import lr as jlr

import paddle_tpu_torch as pt
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import lr as tlr

torch.set_num_threads(1)

STEPS = 30
# name -> scheduler built from a module (the reference's or the port's)
SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=5,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([4, 11, 20],
                                                 [0.1, 0.05, 0.02, 0.01]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, decay_steps=12,
                                                   end_lr=0.001, power=2.0),
    "PolynomialDecay-cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=7, end_lr=0.001, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=20), warmup_steps=6, start_lr=0.0,
        end_lr=0.1),
    "LinearWarmup-float": lambda m: m.LinearWarmup(0.3, warmup_steps=8,
                                                   start_lr=0.01, end_lr=0.3),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.2, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.2, milestones=[5, 9, 22],
                                                 gamma=0.5),
    "StepDecay": lambda m: m.StepDecay(0.2, step_size=4, gamma=0.7),
    "LambdaDecay": lambda m: m.LambdaDecay(0.2, lambda e: 0.95 ** e),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, T_max=13, eta_min=0.002),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=4, T_mult=2, eta_min=0.001),
    "OneCycleLR": lambda m: m.OneCycleLR(0.5, total_steps=25),
    "OneCycleLR-linear": lambda m: m.OneCycleLR(
        0.5, total_steps=25, anneal_strategy="linear", phase_pct=0.4),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=3,
                                     step_size_down=5),
    "CyclicLR-triangular2": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                                 mode="triangular2"),
    "CyclicLR-exp_range": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                               mode="exp_range",
                                               exp_gamma=0.97),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(0.1, factor=0.5,
                                                   patience=2, cooldown=1),
}
# a metric that stalls, so ReduceOnPlateau reduces more than once
METRICS = [1.0, 0.9, 0.8, 0.85, 0.86, 0.87, 0.88, 0.7, 0.71, 0.72, 0.73,
           0.74, 0.75] * 3


def _step(s, i):
    if isinstance(s, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
        s.step(METRICS[i])
    else:
        s.step()


def _run(s, n, start=0):
    out = []
    for i in range(start, start + n):
        out.append(s())
        _step(s, i)
    return out


def test_every_reference_scheduler_is_ported():
    names = {n for n, v in vars(jlr).items()
             if isinstance(v, type) and issubclass(v, jlr.LRScheduler)}
    assert names == set(tlr.__all__)
    assert {n.split("-")[0] for n in SCHEDULERS} == names - {"LRScheduler"}


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_matches_reference(name):
    make = SCHEDULERS[name]
    ref, port = make(jlr), make(tlr)
    want, got = _run(ref, STEPS), _run(port, STEPS)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert len(set(got)) > 1, "the schedule never moved"
    # the state: the reference's keys and values; a fresh scheduler that
    # takes it continues the sequence
    state = port.state_dict()
    assert state == ref.state_dict()
    assert all(isinstance(v, (int, float, bool, str, list))
               for v in state.values())
    fresh = make(tlr)
    fresh.set_state_dict(state)
    np.testing.assert_allclose(_run(fresh, 5, STEPS), _run(port, 5, STEPS),
                               rtol=0, atol=0)


def test_optimizer_under_a_scheduler():
    """get_lr follows the scheduler, set_lr is refused, and the eager
    state dict carries the step count, the slots and "LR_Scheduler" as
    the reference's."""
    paddle.seed(2)
    jlin = paddle.nn.Linear(4, 3)
    tlin = pt.nn.Linear(4, 3, device="cpu")
    pt.load_paddle_state(tlin, {k: np.asarray(v)
                                for k, v in state_arrays(jlin).items()})
    jopt = paddle.optimizer.AdamW(learning_rate=SCHEDULERS["StepDecay"](jlr),
                                  parameters=jlin.parameters())
    topt = pt.optimizer.AdamW(learning_rate=SCHEDULERS["StepDecay"](tlr),
                              parameters=tlin.parameters())
    x = np.random.RandomState(3).randn(5, 4).astype(np.float32)
    for _ in range(6):
        (jlin(paddle.to_tensor(x)) ** 2).sum().backward()
        jopt.step()
        jopt.clear_grad()
        (tlin(torch.from_numpy(x)) ** 2).sum().backward()
        topt.step()
        topt.clear_grad()
        jopt._learning_rate.step()
        topt._lr_scheduler.step()
        assert topt.get_lr() == jopt.get_lr()
    with pytest.raises(RuntimeError):
        topt.set_lr(0.5)
    want, got = jopt.state_dict(), topt.state_dict()
    assert set(got) == set(want)
    assert got["LR_Scheduler"] == want["LR_Scheduler"]
    assert got["_step_count"] == want["_step_count"] == 6
    for k in got:
        if k.startswith("param"):
            np.testing.assert_allclose(got[k].numpy(),
                                       np.asarray(want[k].numpy()),
                                       rtol=1e-5, atol=1e-7)
    again = pt.optimizer.AdamW(learning_rate=SCHEDULERS["StepDecay"](tlr),
                               parameters=tlin.parameters())
    again.set_state_dict(got)
    assert again.get_lr() == topt.get_lr() and again._step_count == 6
    assert set(again.state_dict()) == set(got)


def test_trainstep_follows_the_schedule_without_new_programs():
    cfg = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=64,
               max_position_embeddings=16, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    steps = 6
    rng = np.random.RandomState(5)
    batches = [(rng.randint(0, 64, (2, 16)).astype(np.int32),
                rng.randint(0, 64, (2, 16)).astype(np.int32))
               for _ in range(steps)]

    def schedule(m):
        return m.LinearWarmup(m.PolynomialDecay(5e-3, decay_steps=4),
                              warmup_steps=2, start_lr=0.0, end_lr=5e-3)
    paddle.seed(6)
    jm = jmodels.BertForPretraining(jmodels.BertConfig(**cfg))
    init = {k: np.asarray(v) for k, v in state_arrays(jm).items()}
    jcrit = jmodels.BertPretrainingCriterion()
    jsched = schedule(jlr)
    jstep = JTrainStep(jm, lambda lg, nsp, y: jcrit(lg, nsp, y),
                       paddle.optimizer.AdamW(learning_rate=jsched,
                                              parameters=jm.parameters()))
    want = []
    for ids, lab in batches:
        want.append(float(jstep(paddle.to_tensor(ids),
                                paddle.to_tensor(lab)).numpy()))
        jsched.step()

    tm = tmodels.BertForPretraining(tmodels.BertConfig(**cfg), device="cpu")
    pt.load_paddle_state(tm, init)
    tcrit = tmodels.BertPretrainingCriterion()
    tsched = schedule(tlr)
    tstep = TrainStep(tm, lambda lg, nsp, y: tcrit(lg, nsp, y),
                      pt.optimizer.AdamW(learning_rate=tsched,
                                         parameters=tm.parameters()))
    got, lrs, made = [], [], []
    for ids, lab in batches:
        lrs.append(tstep.optimizer.get_lr())
        got.append(float(tstep(torch.from_numpy(ids).long(),
                               torch.from_numpy(lab).long())))
        made.append(tstep.compile_counts()["total"])
        tsched.step()
    assert lrs[0] == 0.0 and len(set(lrs)) == steps   # a new lr each step
    assert made == [1] * steps
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
