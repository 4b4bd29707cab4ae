"""paddle_tpu_torch's quantization training side against the JAX package on
the CPU: the fake quantizers and their straight-through gradients, a QAT
model's ``act_scale`` trajectory over 3 eager steps, ``Int8Linear`` /
``Int8Conv2D`` bytes, PTQ ``prepare`` / ``convert`` and a
``save_quantized_model`` round trip.  Weights are the reference's
(``load_paddle_state``); inputs are drawn with numpy from a seed.

Tolerances: quantized values, straight-through gradients, int8 weights
and scales bit-equal (both round half to even, the same f32 operations in
the same order); losses, act_scale values and outputs within 1e-5
relative (a convolution's sums run in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.quantization as JQ
from paddle_tpu.jit import state_arrays

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.quantization as TQ
from paddle_tpu_torch import jit as tjit

torch.set_num_threads(1)


def _f(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np_state(model):
    return {k: np.asarray(v) for k, v in state_arrays(model).items()}


@pytest.mark.parametrize("kind", ["abs_max", "channel_wise_0",
                                  "channel_wise_1"])
@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_values_and_straight_through_gradient(kind, bits):
    x, cot = _f(6, 5, seed=1), _f(6, 5, seed=2)
    if kind == "abs_max":
        jf = lambda t: JQ.fake_quantize_dequantize_abs_max(t, bits)
        tf = lambda t: TQ.fake_quantize_dequantize_abs_max(t, bits)
    else:
        axis = int(kind[-1])
        jf = lambda t: JQ.fake_quantize_dequantize_channel_wise_abs_max(
            t, axis, bits)
        tf = lambda t: TQ.fake_quantize_dequantize_channel_wise_abs_max(
            t, axis, bits)

    jx = paddle.to_tensor(x)      # the reference's own tape: its
    jx.stop_gradient = False      # detach is a stop_gradient there
    want = jf(jx)
    (want * paddle.to_tensor(cot)).sum().backward()
    want, wgrad = want.numpy(), jx.grad.numpy()
    xt = torch.tensor(x, requires_grad=True)
    got = tf(xt)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(wgrad))
    np.testing.assert_array_equal(xt.grad.numpy(), cot)   # straight through


def test_qdq_with_a_never_observed_scale_is_the_identity():
    x = torch.from_numpy(_f(3, 4))
    assert torch.equal(TQ._qdq_with_scale(x, 0.0, 8), x)
    np.testing.assert_array_equal(
        TQ._qdq_with_scale(x, 2.0, 8).numpy(),
        np.asarray(JQ._qdq_with_scale(paddle.to_tensor(x.numpy()),
                                      jnp.float32(2.0), 8).numpy()))


def _net(mod, **kw):
    class Net(mod.Layer):
        def __init__(self):
            super().__init__()
            self.conv = mod.Conv2D(3, 6, 3, padding=1, **kw)
            self.fc = mod.Linear(6, 5, **kw)

        def forward(self, x):
            h = self.conv(x)
            h = h * (h > 0)   # relu, in either framework's tensors
            return self.fc(h.mean(axis=(2, 3)) if mod is jnn
                           else h.mean(dim=(2, 3)))
    return Net()


@pytest.fixture(scope="module")
def ref_net():
    paddle.seed(3)
    jm = _net(jnn)
    return jm, _np_state(jm)


def test_qat_state_names_and_act_scale_trajectory(ref_net):
    """ImperativeQuantAware over a conv + linear net, 3 eager Momentum
    steps in each framework from the same weights: the state names, the
    losses and both act_scale buffers after every step agree."""
    _, init = ref_net
    jm, tm = _net(jnn), _net(tnn)
    jm.set_state_dict(init)
    pt.load_paddle_state(tm, init)
    JQ.ImperativeQuantAware().quantize(jm)
    TQ.ImperativeQuantAware().quantize(tm)
    assert isinstance(tm.conv, TQ.QuantedConv2D)
    assert isinstance(tm.fc, TQ.QuantedLinear)
    assert set(tm.state_dict()) == set(_np_state(jm)) == {
        "conv.act_scale", "conv._layer.weight", "conv._layer.bias",
        "fc.act_scale", "fc._layer.weight", "fc._layer.bias"}
    jo = paddle.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                   parameters=jm.parameters())
    to = pt.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                               parameters=tm.parameters())
    y = np.random.RandomState(4).randint(0, 5, (4,))
    scales = []
    for step in range(3):
        x = _f(4, 3, 6, 6, seed=10 + step)
        jl = paddle.nn.functional.cross_entropy(jm(paddle.to_tensor(x)),
                                                paddle.to_tensor(y))
        tl = pt.nn.functional.cross_entropy(tm(torch.from_numpy(x)),
                                            torch.from_numpy(y))
        np.testing.assert_allclose(float(tl), float(jl.numpy()), rtol=1e-5)
        jl.backward()
        tl.backward()
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        want = _np_state(jm)
        for k in ("conv.act_scale", "fc.act_scale"):
            np.testing.assert_allclose(float(tm.state_dict()[k]),
                                       float(want[k]), rtol=1e-5)
        scales.append(float(tm.conv.act_scale))
    assert len(set(scales)) == 3 and scales[0] > 0   # the buffer moves


def test_int8_layers_hold_the_reference_bytes(ref_net):
    jm, init = ref_net
    tm = _net(tnn)
    pt.load_paddle_state(tm, init)
    x = _f(2, 3, 6, 6, seed=5)
    for name, act in (("conv", 2.5), ("fc", None)):
        jcls = JQ.Int8Conv2D if name == "conv" else JQ.Int8Linear
        tcls = TQ.Int8Conv2D if name == "conv" else TQ.Int8Linear
        jl = jcls(getattr(jm, name), 8,
                  None if act is None else jnp.float32(act))
        tl = tcls(getattr(tm, name), 8, act)
        for buf in ("w_int8", "w_scale"):
            got, want = getattr(tl, buf).numpy(), np.asarray(
                getattr(jl, buf).numpy())
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes(), (name, buf)
        assert tl.bias is getattr(tm, name).bias
        inp = x if name == "conv" else x[:, :, 0, :]
        np.testing.assert_allclose(
            tl(torch.from_numpy(inp)).detach().numpy(),
            jl(paddle.to_tensor(inp)).numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        TQ.Int8Linear(tm.fc, bits=9)


def test_int8_conv_takes_the_wrapped_layer_padding():
    paddle.seed(6)
    jc = jnn.Conv2D(3, 4, 3, stride=2, padding="SAME", groups=1)
    tc = tnn.Conv2D(3, 4, 3, stride=2, padding="SAME")
    pt.load_paddle_state(tc, _np_state(jc))
    x = _f(2, 3, 7, 7, seed=7)
    want = JQ.Int8Conv2D(jc)(paddle.to_tensor(x)).numpy()
    got = TQ.Int8Conv2D(tc)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ptq_prepare_calibrate_convert(ref_net):
    _, init = ref_net
    jm, tm = _net(jnn), _net(tnn)
    jm.set_state_dict(init)
    pt.load_paddle_state(tm, init)
    jp, tp = JQ.PostTrainingQuantization(), TQ.PostTrainingQuantization()
    jp.prepare(jm)
    tp.prepare(tm)
    jm.eval()
    tm.eval()
    for seed in (20, 21):
        x = _f(4, 3, 6, 6, seed=seed)
        jm(paddle.to_tensor(x))
        tm(torch.from_numpy(x))
    jp.convert(jm)
    tp.convert(tm)
    assert isinstance(tm.conv, TQ.Int8Conv2D)
    assert isinstance(tm.fc, TQ.Int8Linear)
    assert not tm.conv._forward_pre_hooks
    np.testing.assert_allclose(tm.conv._act_scale,
                               float(jm.conv._act_scale), rtol=1e-6)
    assert set(tm.state_dict()) == set(_np_state(jm))
    x = _f(3, 3, 6, 6, seed=22)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               jm(paddle.to_tensor(x)).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_save_quantized_model_round_trip(ref_net, tmp_path):
    """save_quantized_model exports the QAT model's eval forward with
    jit.save; jit.load gives the same logits, and the npz holds the
    reference's state names."""
    _, init = ref_net
    tm = _net(tnn)
    pt.load_paddle_state(tm, init)
    qat = TQ.ImperativeQuantAware()
    qat.quantize(tm)
    tm.train()
    tm(torch.from_numpy(_f(4, 3, 6, 6, seed=30)))   # observe a scale
    path = str(tmp_path / "qat")
    qat.save_quantized_model(tm, path, input_spec=[
        tjit.InputSpec([-1, 3, 6, 6], "float32")])
    assert not tm.training
    loaded = tjit.load(path, device="cpu")
    x = torch.from_numpy(_f(2, 3, 6, 6, seed=31))
    np.testing.assert_array_equal(loaded(x).detach().numpy(),
                                  tm(x).detach().numpy())
    with np.load(path + ".pdiparams.npz") as npz:
        assert set(npz.files) == set(tm.state_dict())
