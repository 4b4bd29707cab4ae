"""paddle_tpu_torch's GradScaler and GuardedTrainStep against the JAX
package's on the CPU: the loss scale's trajectory over a scripted run of
finite and non-finite gradients, a GAN-style interleave of two
optimizers (each gradient divided once), state_dict round trips, a
checkpoint's scaler crossing between the frameworks both ways, and the
guarded step's skip, decay, quarantine records, spike detection,
rollback and failed rollback.  Weights, batches and gradients are drawn
with numpy from a seed and handed to both.

Tolerances: f32 weights and losses 1e-5 relative and 1e-6 absolute (the
same f32 arithmetic); scales, counters and record fields exactly.
"""
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Parameter as JParam
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.utils.guarded import GuardedTrainStep as JGuarded

import paddle_tpu_torch as pt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.utils import faults as tfaults
from paddle_tpu_torch.utils import monitor as tmonitor
from paddle_tpu_torch.utils.guarded import GuardedTrainStep

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(seed, shapes=((3, 4), (4,))):
    rng = np.random.RandomState(seed)
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    return ([JParam(jnp.asarray(w)) for w in ws],
            [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in ws])


def _set_grads(jp, tp, grads):
    for a, b, g in zip(jp, tp, grads):
        a.grad = paddle.to_tensor(g)
        b.grad = torch.from_numpy(g.copy())


def _assert_params(jp, tp):
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a._data),
                                   **TOL)


# ---------------------------------------------------------------------------
# the scale's state machine
# ---------------------------------------------------------------------------

def test_scale_trajectory_matches_reference():
    """finite / inf / nan gradients in a scripted order, with increase
    every 2 good steps and decrease after 2 bad ones: the scale, the
    counters and the weights follow the reference step by step, and the
    scale never goes below 1.0."""
    kw = dict(init_loss_scaling=4.0, incr_ratio=2.0, decr_ratio=0.25,
              incr_every_n_steps=2, decr_every_n_nan_or_inf=2)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    jp, tp = _pair(1)
    jo, to = jopt.SGD(0.1, jp), topt.SGD(0.1, tp)
    rng = np.random.RandomState(2)
    script = "ggbgbbbbbbggggbg"   # g finite, b inf or nan
    for i, kind in enumerate(script):
        grads = [(rng.randn(*p.shape) * js.get_init_loss_scaling()
                  ).astype(np.float32) for p in jp]
        if kind == "b":
            grads[i % 2].flat[0] = np.inf if i % 3 else np.nan
        _set_grads(jp, tp, grads)
        js.step(jo)
        ts.step(to)
        jo.clear_grad()
        to.clear_grad()
        assert ts.get_init_loss_scaling() == js.get_init_loss_scaling(), i
        assert ts.state_dict() == js.state_dict(), i
        assert ts._found_inf == js._found_inf
        _assert_params(jp, tp)
    assert ts.get_init_loss_scaling() >= 1.0
    assert min(ts.get_init_loss_scaling(), 4.0) >= 1.0


def test_scale_minimize_and_record_skip():
    """scale / minimize on a real loss, then record_skip: the scale halves
    and STAT_amp_skipped_steps counts it."""
    js, ts = jamp.GradScaler(init_loss_scaling=8.0), tamp.GradScaler(
        init_loss_scaling=8.0)
    jp, tp = _pair(3)
    jo, to = jopt.Adam(0.01, parameters=jp), topt.Adam(0.01, parameters=tp)
    x = np.random.RandomState(4).randn(3).astype(np.float32)
    jloss = (paddle.to_tensor(x) @ jp[0]).sum() + jp[1].sum()
    tloss = (torch.from_numpy(x) @ tp[0]).sum() + tp[1].sum()
    np.testing.assert_allclose(float(ts.scale(tloss).detach()),
                               float(js.scale(jloss).numpy()), **TOL)
    js.minimize(jo, js.scale(jloss))
    ts.minimize(to, ts.scale(tloss))
    assert all(p.grad is None for p in tp)
    _assert_params(jp, tp)
    before = tmonitor.stat_get("STAT_amp_skipped_steps")
    js.record_skip()
    ts.record_skip()
    assert ts.get_init_loss_scaling() == js.get_init_loss_scaling() == 4.0
    assert tmonitor.stat_get("STAT_amp_skipped_steps") == before + 1
    assert ts.is_enable() and ts.is_use_dynamic_loss_scaling()
    off = tamp.GradScaler(enable=False)
    assert off.scale(tloss) is tloss and off.get_init_loss_scaling() == 1.0


def test_gan_interleave_divides_once():
    """Discriminator and generator share a scaler: scale(loss_d),
    unscale_(opt_d) (clipping would go here), scale(loss_g), unscale_
    (opt_g), then both steps.  Each gradient is divided once: the weights
    equal an unscaled SGD run's, on both sides."""
    js, ts = jamp.GradScaler(init_loss_scaling=64.0), tamp.GradScaler(
        init_loss_scaling=64.0)
    jd, td = _pair(5)
    jg, tg = _pair(6)
    jod, tod = jopt.SGD(0.1, jd), topt.SGD(0.1, td)
    jog, tog = jopt.SGD(0.1, jg), topt.SGD(0.1, tg)
    rng = np.random.RandomState(7)
    gd = [rng.randn(*p.shape).astype(np.float32) for p in jd]
    gg = [rng.randn(*p.shape).astype(np.float32) for p in jg]
    _set_grads(jd, td, [g * 64 for g in gd])
    js.unscale_(jod)
    ts.unscale_(tod)
    js.unscale_(jod)      # a second unscale_ in the cycle divides nothing
    ts.unscale_(tod)
    js.scale(paddle.to_tensor(1.0))
    ts.scale(torch.tensor(1.0))
    _set_grads(jg, tg, [g * 64 for g in gg])
    js.unscale_(jog)
    ts.unscale_(tog)
    for s, o in ((js, jod), (js, jog), (ts, tod), (ts, tog)):
        s.step(o)
    _assert_params(jd, td)
    _assert_params(jg, tg)
    want_d, _ = _pair(5)
    for p, g, w in zip(td, gd, want_d):
        np.testing.assert_allclose(p.detach().numpy(),
                                   w.detach().numpy() - 0.1 * g, **TOL)
    assert ts.state_dict() == js.state_dict()


def test_state_dict_round_trip():
    ts = tamp.GradScaler(init_loss_scaling=32.0, incr_every_n_steps=3)
    ts._update(False)
    ts._update(True)
    ts._update(False)
    sd = ts.state_dict()
    back = tamp.GradScaler()
    back.set_state_dict(sd)
    assert back.get_init_loss_scaling() == sd["scale"] == 16.0
    assert (back._good_steps, back._bad_steps) == (1, 0)
    js = jamp.GradScaler()
    js.load_state_dict(sd)
    assert js.state_dict()["scale"] == 16.0
    assert tamp.GradScaler().load_state_dict is not None
    assert set(sd) == set(jamp.GradScaler().state_dict())


# ---------------------------------------------------------------------------
# checkpoints carry the scaler both ways
# ---------------------------------------------------------------------------

def _linear_steps(seed):
    paddle.seed(seed)
    jl = jnn.Linear(4, 3)
    tl = tnn.Linear(4, 3, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.array(jl.weight._data)))
        tl.bias.copy_(torch.from_numpy(np.array(jl.bias._data)))

    def loss(out, y):
        return ((out - y) ** 2).mean()
    js = JTrainStep(jl, loss, jopt.Momentum(0.1, 0.9, jl.parameters()),
                    guard=True)
    ts = TrainStep(tl, loss, topt.Momentum(0.1, 0.9, tl.parameters()),
                   guard=True)
    return jl, tl, js, ts


def _batch(rng, scale=1.0):
    x = rng.randn(6, 4).astype(np.float32)
    y = (scale * rng.randn(6, 3)).astype(np.float32)
    return x, y


def _run(step, x, y):
    if isinstance(step, (JTrainStep, JGuarded)):
        return step(paddle.to_tensor(x), paddle.to_tensor(y))
    return step(torch.from_numpy(x), torch.from_numpy(y))


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_checkpoint_scaler_crosses_frameworks(direction, tmp_path):
    jl, tl, js, ts = _linear_steps(8)
    rng = np.random.RandomState(9)
    for _ in range(2):
        x, y = _batch(rng)
        _run(js, x, y)
        _run(ts, x, y)
    saved = dict(scale=512.0, good=3, bad=1)
    jsc = jamp.GradScaler(init_loss_scaling=saved["scale"])
    tsc = tamp.GradScaler(init_loss_scaling=saved["scale"])
    for s in (jsc, tsc):
        s._good_steps, s._bad_steps = saved["good"], saved["bad"]
    if direction == "port_to_reference":
        ts.save_checkpoint(str(tmp_path), scaler=tsc)
        back = jamp.GradScaler()
        meta = js.restore_checkpoint(str(tmp_path), scaler=back)
    else:
        js.save_checkpoint(str(tmp_path), scaler=jsc)
        back = tamp.GradScaler()
        meta = ts.restore_checkpoint(str(tmp_path), scaler=back)
    assert meta["step"] == 2
    assert back.state_dict() == tsc.state_dict() == jsc.state_dict()
    with open(os.path.join(str(tmp_path), "step-000000002",
                           "manifest.json")) as f:
        assert json.load(f)["extra"]["__scaler__"]["scale"] == 512.0


# ---------------------------------------------------------------------------
# GuardedTrainStep
# ---------------------------------------------------------------------------

def _record(rec):
    """A quarantine record without its wall time and its f32 readings."""
    return {k: v for k, v in rec.items()
            if k not in ("time", "loss", "grad_norm")}


def _same_records(got, want):
    """The records' fields equal, the loss and gradient norm within f32
    rounding (NaN where the reference has NaN)."""
    assert [_record(r) for r in got] == [_record(r) for r in want]
    for a, b in zip(got, want):
        for k in ("loss", "grad_norm"):
            if math.isnan(b[k]):
                assert math.isnan(a[k]), k
            else:
                np.testing.assert_allclose(a[k], b[k], **TOL)


def _guarded_pair(seed, ckpt_j=None, ckpt_t=None, **kw):
    jl, tl, js, ts = _linear_steps(seed)
    jsc, tsc = (jamp.GradScaler(init_loss_scaling=1024.0),
                tamp.GradScaler(init_loss_scaling=1024.0))
    return (jl, tl, JGuarded(js, ckpt_j, jsc, **kw),
            GuardedTrainStep(ts, ckpt_t, tsc, **kw))


def _drive(jg, tg, tl, batches, save_at=None, check=None):
    """Both guarded steps over the batches; returns the port's weights
    after each step."""
    weights = []
    for i, (x, y) in enumerate(batches, 1):
        jloss = float(_run(jg, x, y).numpy())
        tloss = float(_run(tg, x, y))
        if not (math.isnan(jloss) and math.isnan(tloss)):
            np.testing.assert_allclose(tloss, jloss, **TOL)
        assert tg.last_skipped == jg.last_skipped
        assert tg.last_reason == jg.last_reason
        weights.append(tl.weight.detach().clone())
        if save_at == i:
            jg.save_checkpoint()
            tg.save_checkpoint()
    return weights


def test_guarded_skip_and_decay(monkeypatch, tmp_path):
    """A NaN gradient at step 3 (the nan_grads fault): the step is skipped
    on the device (weights and moments bit-equal), the scaler halves once,
    and one quarantine record with the reference's fields is written."""
    tfaults.reset()
    monkeypatch.setenv("PDTPU_FAULT_NAN_GRADS", "3")
    jl, tl, jg, tg = _guarded_pair(10, str(tmp_path / "j"),
                                   str(tmp_path / "t"))
    rng = np.random.RandomState(11)
    batches = [_batch(rng) for _ in range(5)]
    before = tmonitor.stat_get("STAT_guarded_bad_steps")
    moments = None
    weights = []
    for i, (x, y) in enumerate(batches, 1):
        if i == 3:
            moments = {k: {s: t.clone() for s, t in v.items()}
                       for k, v in tg.step._opt_state.items()}
        weights += _drive(jg, tg, tl, [(x, y)])
        if i == 3:
            for k, v in tg.step._opt_state.items():
                assert all(torch.equal(t, moments[k][s])
                           for s, t in v.items())
    assert torch.equal(weights[1], weights[2])
    assert not torch.equal(weights[2], weights[3])
    assert tg.scaler.get_init_loss_scaling() == 512.0
    assert jg.scaler.get_init_loss_scaling() == 512.0
    assert tmonitor.stat_get("STAT_guarded_bad_steps") == before + 1
    _same_records(tg.quarantine, jg.quarantine)
    (rec,) = tg.quarantine
    assert rec["reason"] == "nonfinite" and rec["skipped_on_device"]
    assert rec["loss_scale"] == 512.0 and rec["step"] == 3
    with open(tmp_path / "t" / "quarantine.jsonl") as f:
        lines = [json.loads(line) for line in f]
    _same_records(lines, [rec])
    for a, b in ((jl.weight, tl.weight), (jl.bias, tl.bias)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a._data),
                                   **TOL)


def test_guarded_loss_spike():
    """A finite loss far above the window's median is a spike: recorded,
    applied (not skipped), as in the reference."""
    tfaults.reset()
    jl, tl, jg, tg = _guarded_pair(12, min_window=2, spike_factor=4.0)
    rng = np.random.RandomState(13)
    batches = [_batch(rng) for _ in range(3)] + [_batch(rng, 50.0)]
    _drive(jg, tg, tl, batches)
    assert tg.last_reason == "loss_spike" and not tg.last_skipped
    _same_records(tg.quarantine, jg.quarantine)
    assert len(tg.quarantine) == 1


def test_guarded_rollback(monkeypatch, tmp_path):
    """NaN gradients at steps 3, 4 and 5 with max_bad_steps 3: the third
    bad step rolls back to the checkpoint saved after step 2 (weights
    bit-equal to those saved, the scaler's state the saved one), inside a
    guarded_rollback span, and the streak restarts."""
    tfaults.reset()
    monkeypatch.setenv("PDTPU_FAULT_NAN_GRADS", "3:6")
    jl, tl, jg, tg = _guarded_pair(14, str(tmp_path / "j"),
                                   str(tmp_path / "t"))
    rng = np.random.RandomState(15)
    batches = [_batch(rng) for _ in range(5)]
    before = tmonitor.stat_get("STAT_guarded_rollbacks")
    weights = _drive(jg, tg, tl, batches, save_at=2)
    assert tmonitor.stat_get("STAT_guarded_rollbacks") == before + 1
    assert torch.equal(weights[4], weights[1])   # after the rollback
    _same_records(tg.quarantine, jg.quarantine)
    assert tg.quarantine[-1]["rolled_back_to"] == 2
    assert tg.bad_streak == 0
    assert tg.scaler.state_dict() == jg.scaler.state_dict()
    assert tg.scaler.get_init_loss_scaling() == 1024.0   # the saved one
    for a, b in ((jl.weight, tl.weight), (jl.bias, tl.bias)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a._data),
                                   **TOL)


def test_guarded_rollback_without_a_checkpoint(monkeypatch, tmp_path):
    """max_bad_steps bad steps and no checkpoint in the directory: the
    record says rollback_failed, the streak and the window survive."""
    tfaults.reset()
    monkeypatch.setenv("PDTPU_FAULT_NAN_GRADS", "1:4")
    jl, tl, jg, tg = _guarded_pair(16, str(tmp_path / "j"),
                                   str(tmp_path / "t"), max_bad_steps=2)
    rng = np.random.RandomState(17)
    before = tmonitor.stat_get("STAT_guarded_rollback_failures")
    _drive(jg, tg, tl, [_batch(rng) for _ in range(3)])
    _same_records(tg.quarantine, jg.quarantine)
    assert tg.quarantine[-1]["rollback_failed"] == "no restorable checkpoint"
    assert tg.quarantine[-1]["rolled_back_to"] is None
    assert tg.bad_streak == 3
    assert tmonitor.stat_get("STAT_guarded_rollback_failures") == before + 2
    assert pt.observability.report()["train"]["guard_bad_steps"] >= 3
