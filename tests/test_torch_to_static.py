"""``jit``'s to_static surface of paddle_tpu_torch against the JAX
package's on the CPU: ``to_static`` on a layer, a bound method and a
function (equal to eager and to the reference's ``StaticFunction``), one
program per input signature, ``TracedLayer`` through
``save_inference_model`` and ``jit.load``, ``functional_call`` with a
swapped state and ``buffer_updates``, ``declarative`` /
``not_to_static`` / ``enable_to_static`` / ``ProgramTranslator``,
``warm_step_program`` and the verbosity knobs; signatures are the
reference's.  Layers carry the reference's weights (``load_paddle_state``),
inputs come from a numpy seed.

Tolerance 1e-5 (the same f32 arithmetic, summed in another order); the
port's static result equals its eager one bit for bit (the same ops).
"""
import inspect
import logging

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.jit as jjit
import paddle_tpu.nn as jnn

import paddle_tpu_torch as pt
import paddle_tpu_torch.jit as tjit
import paddle_tpu_torch.nn as tnn

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


class JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(8, 16)
        self.norm = jnn.LayerNorm(16)
        self.out = jnn.Linear(16, 4)

    def forward(self, x):
        return self.out(jnn.functional.relu(self.norm(self.fc(x))))

    def scaled(self, x, scale):
        return self.forward(x) * scale


class TNet(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(8, 16, device="cpu")
        self.norm = tnn.LayerNorm(16, device="cpu")
        self.out = tnn.Linear(16, 4, device="cpu")

    def forward(self, x):
        return self.out(tnn.functional.relu(self.norm(self.fc(x))))

    def scaled(self, x, scale):
        return self.forward(x) * scale


def _pair():
    paddle.seed(0)
    jm = JNet()
    tm = TNet()
    pt.load_paddle_state(tm, {k: np.asarray(v.numpy())
                              for k, v in jm.state_dict().items()})
    return jm, tm


def _x(b=4, seed=0):
    return np.random.RandomState(seed).randn(b, 8).astype(np.float32)


def test_to_static_layer_method_and_function_equal_eager_and_reference():
    jm, tm = _pair()
    x = _x()
    cases = [
        (tjit.to_static(tm), jjit.to_static(jm), (x,), lambda: tm(
            torch.from_numpy(x))),
        (tjit.to_static(tm.scaled), jjit.to_static(jm.scaled), (x, 0.5),
         lambda: tm.scaled(torch.from_numpy(x), 0.5)),
    ]

    def fn(a, b):
        return torch.tanh(a) + b * 2

    def jfn(a, b):
        return paddle.tanh(a) + b * 2
    y = _x(seed=1)
    cases.append((tjit.declarative(fn), jjit.declarative(jfn), (x, y),
                  lambda: fn(torch.from_numpy(x), torch.from_numpy(y))))
    for sf, jsf, args, eager in cases:
        assert isinstance(sf, tjit.StaticFunction)
        targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for a in args]
        jargs = [paddle.to_tensor(a) if isinstance(a, np.ndarray) else a
                 for a in args]
        got = sf(*targs)
        assert not got.requires_grad
        with torch.no_grad():
            assert torch.equal(got, eager())
        np.testing.assert_allclose(got.numpy(), jsf(*jargs).numpy(), **TOL)
        assert sf.forward is sf and sf.concrete_program(*targs) is sf


def test_one_program_per_signature_reading_the_current_weights():
    _, tm = _pair()
    sf = tjit.to_static(tm)
    outs = [sf(torch.from_numpy(_x(b, s))) for b, s in
            ((4, 0), (4, 1), (2, 2), (4, 3))]
    assert sf.compile_counts()["total"] == 2
    assert outs[0].shape == (4, 4) and outs[2].shape == (2, 4)
    assert not torch.equal(outs[0], outs[1])   # each call its own tensor
    with torch.no_grad():
        tm.out.bias.add_(1.0)
        np.testing.assert_array_equal(
            sf(torch.from_numpy(_x(4, 0))).numpy(),
            tm(torch.from_numpy(_x(4, 0))).numpy())
    assert sf.compile_counts()["total"] == 2
    from paddle_tpu_torch import observability as obs
    assert any(k.startswith("to_static:TNet")
               for k in obs.get_program_registry().snapshot())


def test_traced_layer_save_and_load_round_trip(tmp_path):
    jm, tm = _pair()
    x = torch.from_numpy(_x())
    out, traced = tjit.TracedLayer.trace(tm, [x])
    jout, _ = jjit.TracedLayer.trace(jm, [paddle.to_tensor(_x())])
    np.testing.assert_allclose(out.detach().numpy(), jout.numpy(), **TOL)
    (got,) = traced([x])
    assert torch.equal(got, out.detach())
    traced.set_strategy(build_strategy=None, exec_strategy=None)
    with pytest.raises(NotImplementedError, match="feed"):
        traced.save_inference_model(str(tmp_path / "m"), feed=[1])
    with pytest.raises(NotImplementedError, match="fetch"):
        traced.save_inference_model(str(tmp_path / "m"), fetch=[0, 1])
    traced.save_inference_model(str(tmp_path / "m"))
    loaded = tjit.load(str(tmp_path / "m"), device="cpu")
    np.testing.assert_allclose(loaded(x).numpy(), out.detach().numpy(),
                               rtol=1e-6, atol=1e-6)


def test_functional_call_swapped_state_and_buffer_updates():
    paddle.seed(0)
    jbn = jnn.BatchNorm2D(3)
    tbn = tnn.BatchNorm2D(3, device="cpu")
    r = np.random.RandomState(0)
    state = {k: r.randn(*v.shape).astype(np.float32) if "variance" not in k
             else np.abs(r.randn(*v.shape)).astype(np.float32) + 0.5
             for k, v in jbn.state_dict().items()}
    x = r.randn(2, 3, 4, 4).astype(np.float32)
    jupd, tupd = {}, {}
    ref = jjit.functional_call(jbn, {k: paddle.to_tensor(v)._data
                                     for k, v in state.items()},
                               paddle.to_tensor(x)._data, training=True,
                               buffer_updates=jupd)
    before = {k: v.clone() for k, v in tbn.state_dict().items()}
    got = tjit.functional_call(tbn, {k: torch.from_numpy(v)
                                     for k, v in state.items()},
                               torch.from_numpy(x), training=True,
                               buffer_updates=tupd)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    assert sorted(tupd) == sorted(jupd) == ["_mean", "_variance"]
    for k in jupd:
        np.testing.assert_allclose(tupd[k].numpy(), np.asarray(jupd[k]),
                                   err_msg=k, **TOL)
    for k, v in tbn.state_dict().items():   # the layer's own: untouched
        assert torch.equal(v, before[k]), k
    assert tbn.training
    # eval mode with the swapped running statistics
    ref = jjit.functional_call(jbn, {k: paddle.to_tensor(v)._data
                                     for k, v in state.items()},
                               paddle.to_tensor(x)._data, training=False)
    got = tjit.functional_call(tbn, {k: torch.from_numpy(v)
                                     for k, v in state.items()},
                               torch.from_numpy(x), training=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    jm, tm = _pair()
    sd = {k: v * 2 for k, v in tm.state_dict().items()}
    got = tjit.functional_call(tm, sd, torch.from_numpy(_x()),
                               torch.tensor(3.0), method="scaled")
    ref = jjit.functional_call(jm, {k: v._data * 2 for k, v in
                                    jm.state_dict().items()},
                               paddle.to_tensor(_x())._data, 3.0,
                               method="scaled")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_translator_knobs_and_warm_step_program():
    fn = tjit.not_to_static(len)
    assert fn is len
    assert tjit.declarative is tjit.to_static
    tr = tjit.ProgramTranslator.get_instance()
    assert tr is tjit.ProgramTranslator.get_instance()
    tr.enable(False)
    tjit.enable_to_static(False)
    _, tm = _pair()
    assert isinstance(tjit.to_static()(tm), tjit.StaticFunction)
    step = tjit.TrainStep(tm, lambda out, y: ((out - y) ** 2).mean(),
                          pt.optimizer.SGD(0.1, parameters=tm.parameters()))
    batch = (torch.from_numpy(_x()), torch.zeros(4, 4))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    assert tjit.warm_step_program(step, None, None, step.optimizer, batch)
    assert not tjit.warm_step_program(step, None, None, step.optimizer,
                                      batch)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_verbosity_round_trip():
    logger = logging.getLogger("torch")
    saved = logger.level
    try:
        for start in (0, logging.WARNING):
            logger.setLevel(start)
            tjit.set_verbosity(2)
            assert tjit.get_verbosity() == 2
            assert logger.level == logging.DEBUG
            tjit.set_verbosity(3)
            tjit.set_verbosity(0)
            assert tjit.get_verbosity() == 0 and logger.level == start
        tjit.set_code_level(5)
        assert tjit.get_code_level() == 5
        tjit.set_code_level()
        assert tjit.get_code_level() == 100
    finally:
        tjit.set_code_level(-1)
        logger.setLevel(saved)


@pytest.mark.parametrize("name", [
    "functional_call", "to_static", "declarative", "not_to_static",
    "enable_to_static", "warm_step_program", "set_verbosity",
    "get_verbosity", "set_code_level", "get_code_level",
    "StaticFunction.__init__", "TracedLayer.__init__", "TracedLayer.trace",
    "TracedLayer.__call__", "TracedLayer.set_strategy",
    "TracedLayer.save_inference_model", "ProgramTranslator.enable"])
def test_signatures_are_the_reference(name):
    def get(mod):
        obj = mod
        for part in name.split("."):
            obj = getattr(obj, part)
        return list(inspect.signature(obj).parameters)
    assert get(tjit) == get(jjit)
