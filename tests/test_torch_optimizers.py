"""paddle_tpu_torch's optimizers against the JAX package's on the CPU: the
eleven optimizer classes this slice adds, the reference's constructor
signatures, AdamW's positional ``apply_decay_param_fun``, the L1 / L2
regularizers, ``ParamAttr`` regularizers and learning-rate multipliers
(eager step and ``TrainStep``), ``minimize`` / ``clear_gradients`` /
``set_dict``, the averaging classes and DGCMomentum past its ramp-up.
Weights and gradients are drawn with numpy from a seed and handed to
both.

Tolerances, with their reasons: f32 updates 1e-5 relative and 1e-6
absolute (the same f32 arithmetic; reductions such as Lamb's norms sum in
another order).  Dpsgd's noise is not the reference's stream: its
comparison runs at sigma 0, and its noise is checked for seeding and for
its standard deviation (within 15% over 1,280 draws: the standard error
of a sample deviation over n draws is about 1 / sqrt(2 n), 2%).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.core.tensor import Parameter as JParam
from paddle_tpu.jit import TrainStep as JTrainStep

import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.jit import TrainStep

torch.set_num_threads(1)

SHAPES = [(4, 3), (3,), (2, 2, 5)]
TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(seed, shapes=SHAPES):
    """The same weights as reference Parameters and torch Parameters, both
    named p0, p1, ... (ParamAttr names on the port's side)."""
    rng = np.random.RandomState(seed)
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    jp = [JParam(jnp.asarray(w), name=f"p{i}") for i, w in enumerate(ws)]
    tp = []
    for i, w in enumerate(ws):
        t = torch.nn.Parameter(torch.from_numpy(w.copy()))
        t.param_name = f"p{i}"
        tp.append(t)
    return jp, tp


def _grads(rng, jp, tp, scale=1.0):
    for a, b in zip(jp, tp):
        g = (scale * rng.randn(*a.shape)).astype(np.float32)
        a.grad = paddle.to_tensor(g)
        b.grad = torch.from_numpy(g.copy())


def _steps(jo, to, jp, tp, n=3, seed=0):
    rng = np.random.RandomState(seed + 100)
    for _ in range(n):
        _grads(rng, jp, tp)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()


def _assert_params(jp, tp, tol=TOL):
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a._data),
                                   **tol)


def _assert_states(jo, to):
    js, ts = jo.state_dict(), to.state_dict()
    assert sorted(js) == sorted(ts)
    for k, v in js.items():
        if k == "_step_count":
            assert ts[k] == v
            continue
        np.testing.assert_allclose(np.asarray(ts[k]), np.asarray(v._data),
                                   **TOL)
        assert ts[k].dtype == torch.float32


# (class name, constructor keywords): the ten optimizers of optimizer.py
# and DGCMomentum, past its ramp-up
CASES = [
    ("SGD", dict(learning_rate=0.1)),
    ("Adamax", dict(learning_rate=0.05, beta1=0.8, beta2=0.99)),
    ("Adagrad", dict(learning_rate=0.1, initial_accumulator_value=0.1)),
    ("RMSProp", dict(learning_rate=0.05, rho=0.9, momentum=0.5,
                     centered=True)),
    ("Adadelta", dict(learning_rate=1.0, rho=0.9)),
    ("Lamb", dict(learning_rate=0.05, lamb_weight_decay=0.02)),
    ("LarsMomentum", dict(learning_rate=0.1, momentum=0.9,
                          lars_coeff=0.01)),
    ("DecayedAdagrad", dict(learning_rate=0.1, decay=0.9)),
    ("Dpsgd", dict(learning_rate=0.1, clip=1.0, batch_size=4.0, sigma=0.0)),
    ("Ftrl", dict(learning_rate=0.1, l1=0.01, l2=0.02)),
    ("DGCMomentum", dict(learning_rate=0.1, momentum=0.9, sparsity=0.75,
                         rampup_begin_step=1)),
]


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_new_optimizers_match_reference(name, kw):
    """Three eager updates: the weights and every slot (the reference's
    state_dict keys, f32) agree."""
    jp, tp = _pair(1)
    jo = getattr(jopt, name)(parameters=jp, **kw)
    to = getattr(topt, name)(parameters=tp, **kw)
    _steps(jo, to, jp, tp)
    _assert_params(jp, tp)
    _assert_states(jo, to)


def test_rmsprop_uncentered_and_weight_decay():
    jp, tp = _pair(2)
    jo = jopt.RMSProp(0.05, 0.9, 1e-6, 0.0, False, jp, 0.01)
    to = topt.RMSProp(0.05, 0.9, 1e-6, 0.0, False, tp, 0.01)
    _steps(jo, to, jp, tp)
    _assert_params(jp, tp)
    _assert_states(jo, to)


OPTIMIZER_CLASSES = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW",
                     "Adamax", "Adagrad", "RMSProp", "Adadelta", "Lamb",
                     "LarsMomentum", "DecayedAdagrad", "Dpsgd", "Ftrl",
                     "DGCMomentum", "ExponentialMovingAverage",
                     "ModelAverage", "Lookahead"]


@pytest.mark.parametrize("name", OPTIMIZER_CLASSES)
def test_signatures_are_the_reference(name):
    """The reference's parameters in its order; anything the port adds
    comes after them, keyword-only."""
    def params(cls):
        return list(inspect.signature(cls.__init__).parameters.values())[1:]
    want = [(p.name, p.default) for p in params(getattr(jopt, name))]
    got = params(getattr(topt, name))
    assert [(p.name, p.default) for p in got[:len(want)]] == want
    assert all(p.kind == p.KEYWORD_ONLY for p in got[len(want):])


def test_adamw_positional_apply_decay_param_fun():
    """AdamW(1e-3, 0.9, 0.999, 1e-8, params, 0.01, None, fn): fn is
    apply_decay_param_fun (lr_ratio before it), so only what it selects
    decays, on both sides."""
    def fn(name):
        return name != "p1"
    jp, tp = _pair(3)
    jo = jopt.AdamW(0.1, 0.9, 0.999, 1e-8, jp, 0.5, None, fn)
    to = topt.AdamW(0.1, 0.9, 0.999, 1e-8, tp, 0.5, None, fn)
    assert to._apply_decay_param_fun is fn and to._grad_clip is None
    _steps(jo, to, jp, tp)
    _assert_params(jp, tp)
    # p1 moved as plain Adam would have moved it
    ap, bp = _pair(3)
    plain = topt.Adam(0.1, 0.9, 0.999, 1e-8, bp)
    _steps(jopt.Adam(0.1, parameters=ap), plain, ap, bp)
    np.testing.assert_allclose(tp[1].detach().numpy(),
                               bp[1].detach().numpy(), rtol=0, atol=0)
    assert not np.allclose(tp[0].detach().numpy(), bp[0].detach().numpy())


@pytest.mark.parametrize("decay", ["L1", "L2", "float"])
@pytest.mark.parametrize("name", ["Momentum", "Adam", "SGD"])
def test_weight_decay_objects(decay, name):
    """weight_decay=L1Decay / L2Decay / a float: g + c * sign(w) or
    g + c * w before the update."""
    def wd(mod):
        return {"L1": lambda: mod.L1Decay(0.05), "L2": lambda: mod.L2Decay(
            0.05), "float": lambda: 0.05}[decay]()
    jp, tp = _pair(4)
    jo = getattr(jopt, name)(learning_rate=0.1, parameters=jp,
                             weight_decay=wd(jreg))
    to = getattr(topt, name)(learning_rate=0.1, parameters=tp,
                             weight_decay=wd(treg))
    assert to._wd_mode == jo._wd_mode and to._wd == jo._wd
    _steps(jo, to, jp, tp)
    _assert_params(jp, tp)


def _linear_pair(seed, attr_j, attr_t):
    """A Linear(4, 3) on each side with the same weights and attributes
    on its weight."""
    paddle.seed(seed)
    jl = jnn.Linear(4, 3, weight_attr=attr_j)
    tl = tnn.Linear(4, 3, weight_attr=attr_t, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.array(jl.weight._data)))
        tl.bias.copy_(torch.from_numpy(np.array(jl.bias._data)))
    return jl, tl


@pytest.mark.parametrize("reg", ["L1", "L2", None])
def test_param_attr_regularizer_and_lr_in_the_eager_step(reg):
    """ParamAttr(regularizer=, learning_rate=) on the weight: its own
    decay replaces the optimizer's, its multiplier scales its step; the
    bias keeps the optimizer's L2 decay and the base rate."""
    def attr(mod, base):
        r = None if reg is None else getattr(mod, f"{reg}Decay")(0.1)
        return base.ParamAttr(regularizer=r, learning_rate=0.5)
    jl, tl = _linear_pair(5, attr(jreg, paddle), attr(treg, pt))
    jo = jopt.Momentum(0.1, 0.9, jl.parameters(), weight_decay=0.02)
    to = topt.Momentum(0.1, 0.9, tl.parameters(), weight_decay=0.02)
    rng = np.random.RandomState(6)
    for _ in range(3):
        x = rng.randn(5, 4).astype(np.float32)
        jloss = (jl(paddle.to_tensor(x)) ** 2).sum()
        jloss.backward()
        tloss = (tl(torch.from_numpy(x)) ** 2).sum()
        tloss.backward()
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
    for a, b in ((jl.weight, tl.weight), (jl.bias, tl.bias)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a._data),
                                   rtol=1e-5, atol=1e-6)


def test_train_step_ignores_param_attrs_as_the_reference():
    """Inside TrainStep neither framework applies a parameter's
    regularizer or learning-rate multiplier (the reference's functional
    core reads neither): the losses and the weights after two steps
    agree."""
    jl, tl = _linear_pair(7, paddle.ParamAttr(
        regularizer=jreg.L2Decay(0.5), learning_rate=3.0), pt.ParamAttr(
        regularizer=treg.L2Decay(0.5), learning_rate=3.0))
    jstep = JTrainStep(jl, lambda out, y: ((out - y) ** 2).mean(),
                       jopt.Momentum(0.1, 0.9, jl.parameters()))
    tstep = TrainStep(tl, lambda out, y: ((out - y) ** 2).mean(),
                      topt.Momentum(0.1, 0.9, tl.parameters()))
    rng = np.random.RandomState(8)
    for _ in range(2):
        x = rng.randn(6, 4).astype(np.float32)
        y = rng.randn(6, 3).astype(np.float32)
        jl_loss = float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)))
        tl_loss = float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(tl_loss, jl_loss, rtol=1e-5)
    for a, b in ((jl.weight, tl.weight), (jl.bias, tl.bias)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a._data),
                                   rtol=1e-5, atol=1e-6)


def test_minimize_clear_gradients_set_dict():
    jp, tp = _pair(9)
    jo = jopt.Adam(0.1, parameters=jp)
    to = topt.Adam(0.1, parameters=tp)
    for _ in range(2):
        jloss = sum((p * p).sum() for p in jp)
        tloss = sum((p * p).sum() for p in tp)
        jout = jo.minimize(jloss)
        tout = to.minimize(tloss)
        assert tout[0] is None and jout[0] is None
        assert [p for p, _ in tout[1]] == tp
        for (_, jg), (_, tg) in zip(jout[1], tout[1]):
            np.testing.assert_allclose(tg.numpy(), np.asarray(jg._data),
                                       **TOL)
        to.clear_gradients()
        jo.clear_gradients()
        assert all(p.grad is None for p in tp)
    _assert_params(jp, tp)
    # set_dict (the set_state_dict alias) carries the moments across
    jp2, tp2 = _pair(9)
    to2 = topt.Adam(0.1, parameters=tp2)
    to2.set_dict(to.state_dict())
    assert to2._step_count == 2
    for p_src, p_dst in zip(tp, tp2):
        s, d = to._states[id(p_src)], to2._states[id(p_dst)]
        assert all(torch.equal(s[k], d[k]) for k in s)


def test_clear_grad_takes_set_to_zero():
    _, tp = _pair(10)
    to = topt.SGD(0.1, tp)
    for p in tp:
        p.grad = torch.ones_like(p)
    to.clear_grad(set_to_zero=True)
    assert all(p.grad is None for p in tp)
    topt.Adam(0.1, parameters=tp, lazy_mode=True, multi_precision=True,
              name="adam")
    topt.Momentum(0.1, 0.9, tp, multi_precision=True, name="m")
    topt.Optimizer(0.1, tp, None, None, "o", True)


def test_dpsgd_noise_is_seeded_and_scaled():
    """Dpsgd's noise: the same port seed gives the same draws, another
    seed others; with zero gradients the update is -lr * noise /
    batch_size, noise ~ N(0, sigma^2), one draw per tensor and step."""
    sigma, bs, lr = 0.7, 2.0, 1.0

    def run(seed):
        pt.seed(seed)
        ps = [torch.nn.Parameter(torch.zeros(3)) for _ in range(64)]
        o = topt.Dpsgd(lr, clip=1.0, batch_size=bs, sigma=sigma,
                       parameters=ps)
        moves = []
        for _ in range(20):
            before = torch.stack([p.detach()[0].clone() for p in ps])
            for p in ps:
                p.grad = torch.zeros(3)
            o.step()
            after = torch.stack([p.detach()[0] for p in ps])
            assert all(torch.all(p.detach() == p.detach()[0]) for p in ps)
            moves.append(after - before)
        return torch.cat(moves)
    a, b, c = run(11), run(11), run(12)
    assert torch.equal(a, b) and not torch.equal(a, c)
    std = float((-a * bs / lr).std())
    assert abs(std - sigma) < 0.15 * sigma, std


def test_dgc_quantile_matches_jnp_on_a_large_tensor():
    """The threshold from kthvalue equals jnp.quantile's (linear
    interpolation) on more elements than torch.quantile takes."""
    from paddle_tpu_torch.optimizer.dgc import quantile
    rng = np.random.RandomState(13)
    x = np.abs(rng.randn((1 << 24) + 5)).astype(np.float32)
    qs = (0.999, 0.75, 0.5)
    wants = np.asarray(jnp.quantile(jnp.asarray(x), jnp.asarray(qs)))
    for q, want in zip(qs, wants):
        got = float(quantile(torch.from_numpy(x), q))
        assert got == float(want), (q, got, want)


def test_dgc_ramp_up_then_sparse():
    """Before rampup_begin_step every element moves (plain momentum);
    after it only the top quarter of each tensor's |velocity| does, and
    the sent velocity is cleared."""
    jp, tp = _pair(14, [(8, 8), (16,)])
    kw = dict(learning_rate=0.1, momentum=0.9, sparsity=0.75,
              rampup_begin_step=2)
    jo, to = jopt.DGCMomentum(parameters=jp, **kw), topt.DGCMomentum(
        parameters=tp, **kw)
    rng = np.random.RandomState(15)
    for step in range(1, 5):
        before = [p.detach().clone() for p in tp]
        _grads(rng, jp, tp)
        jo.step()
        to.step()
        moved = [float((p.detach() != b).float().mean())
                 for p, b in zip(tp, before)]
        if step <= 2:
            assert all(m == 1.0 for m in moved)
        else:
            assert all(0.2 <= m <= 0.3 for m in moved), moved
    _assert_params(jp, tp)
    _assert_states(jo, to)


def test_ema_model_average_lookahead():
    """EMA with thres_steps, ModelAverage's window rotation and Lookahead's
    slow weights, each over SGD steps, against the reference; apply()
    swaps the averages in and restores on exit."""
    jp, tp = _pair(16)
    jo, to = jopt.SGD(0.1, jp), topt.SGD(0.1, tp)
    jema = jopt.ExponentialMovingAverage(0.9, True, jp)
    tema = topt.ExponentialMovingAverage(0.9, True, tp)
    jma = jopt.ModelAverage(0.5, jp, 2, 3)
    tma = topt.ModelAverage(0.5, tp, 2, 3)
    rng = np.random.RandomState(17)
    for _ in range(5):
        _grads(rng, jp, tp)
        jo.step()
        to.step()
        jema.update()
        tema.update()
        jma.step()
        tma.step()
    before = [p.detach().clone() for p in tp]
    for javg, tavg in ((jema, tema), (jma, tma)):
        with javg.apply(), tavg.apply():
            _assert_params(jp, tp)
            assert not all(torch.equal(p.detach(), b)
                           for p, b in zip(tp, before))
        assert all(torch.equal(p.detach(), b) for p, b in zip(tp, before))
    st = tema.state_dict()
    assert st["step"] == 5
    for a, b in zip(st["shadow"], jema.state_dict()["shadow"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    jp, tp = _pair(18)
    jla = jopt.Lookahead(jopt.Momentum(0.1, 0.9, jp), alpha=0.5, k=2)
    tla = topt.Lookahead(topt.Momentum(0.1, 0.9, tp), alpha=0.5, k=2)
    rng = np.random.RandomState(19)
    for _ in range(5):
        _grads(rng, jp, tp)
        jla.step()
        tla.step()
        jla.clear_grad()
        tla.clear_grad()
    _assert_params(jp, tp)
    assert tla.get_lr() == jla.get_lr()
