"""The ``nn`` basics' Paddle surface of paddle_tpu_torch held against the
JAX package on the CPU: ``ParamAttr``, the initializers, ``Layer``'s
Paddle methods, the reference's signatures of ``Linear``, ``Conv2D``,
``LayerNorm``, ``BatchNorm2D`` and ``Embedding``, and ``F.interpolate``
/ the ``Upsample`` layers.  Inputs come from numpy seeds; forwards on the
reference's weights agree within 1e-5 (absolute and relative), and
deterministic initializers are bit-equal."""
import copy
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.nn import initializer as JI

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.nn import initializer as TI

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t.numpy()


def _load_reference(tlayer, jlayer):
    """The port layer takes the reference's ``state_dict()`` as it is."""
    missing, unexpected = tlayer.set_state_dict(jlayer.state_dict())
    assert missing == [] and unexpected == []


# ---------------------------------------------------------- signatures

@pytest.mark.parametrize("name", ["Linear", "Conv2D", "LayerNorm",
                                  "BatchNorm2D", "Embedding", "Upsample"])
def test_layer_takes_the_reference_parameters_in_order(name):
    ref = list(inspect.signature(getattr(jnn, name).__init__).parameters)
    port = inspect.signature(getattr(tnn, name).__init__).parameters
    assert list(port)[:len(ref)] == ref
    assert all(p.kind is p.KEYWORD_ONLY
               for p in list(port.values())[len(ref):])


def test_linear_positional_bias_attr_false_is_the_reference_layer():
    """``Linear(4, 8, None, False)``: no bias, an XavierNormal weight."""
    jl = jnn.Linear(4, 8, None, False)
    tl = tnn.Linear(4, 8, None, False)
    assert list(tl.state_dict()) == list(jl.state_dict()) == ["weight"]
    assert tl.bias is None and tuple(tl.weight.shape) == (4, 8)
    big = tnn.Linear(256, 256, None, False)
    want = (2.0 / 512) ** 0.5
    assert abs(float(big.weight.std()) / want - 1) < 0.05
    assert tnn.Linear(4, 8, bias_attr=False).bias is None
    assert torch.equal(tnn.Linear(4, 8).bias.detach(), torch.zeros(8))


def test_std_keeps_the_models_draws():
    """``std=`` with a generator draws exactly what ``normal_`` draws
    from that generator (the port's models pass both), zero bias."""
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    tl = tnn.Linear(16, 24, std=0.02, generator=g1)
    want = torch.empty(16, 24).normal_(0.0, 0.02, generator=g2)
    assert torch.equal(tl.weight.detach(), want)
    te = tnn.Embedding(10, 4, 0, std=0.02, generator=g1)
    want = torch.empty(10, 4).normal_(0.0, 0.02, generator=g2)
    want[0] = 0.0
    assert torch.equal(te.weight.detach(), want)


# -------------------------------------------------------- initializers

@pytest.mark.parametrize("shape", [(3, 4), (2, 3, 3, 3), (7,)])
def test_constant_and_assign_are_bit_equal(shape):
    rng = np.random.RandomState(0)
    value = rng.randn(*shape).astype(np.float32)
    pairs = [(JI.Constant(0.37), TI.Constant(0.37)),
             (JI.Assign(value), TI.Assign(value)),
             (JI.Assign(value.tolist()), TI.Assign(value.tolist()))]
    for ji, ti in pairs:
        np.testing.assert_array_equal(_np(ti(shape)), np.asarray(ji(shape)))


@pytest.mark.parametrize("shape", [(2, 4, 3, 3), (6, 2, 5, 5)])
def test_dirac_and_bilinear_are_bit_equal(shape):
    for ji, ti in ((JI.Dirac(), TI.Dirac()), (JI.Dirac(2), TI.Dirac(2)),
                   (JI.Bilinear(), TI.Bilinear())):
        np.testing.assert_array_equal(_np(ti(shape)), np.asarray(ji(shape)))


RANDOM = ["Normal", "TruncatedNormal", "Uniform", "XavierNormal",
          "XavierUniform", "KaimingNormal", "KaimingUniform", "Orthogonal"]


@pytest.mark.parametrize("name", RANDOM)
@pytest.mark.parametrize("shape", [(512, 512), (64, 32, 3, 3)])
def test_random_initializer_matches_the_reference_draw(name, shape):
    """Same shape and fans; the sample std at 512 x 512 (and over a conv
    weight of 18,432 values) within 5% of the reference's draw."""
    paddle.seed(11)
    pt.seed(11)
    kw = {"Normal": dict(mean=0.0, std=0.3),
          "TruncatedNormal": dict(mean=0.0, std=0.3),
          "Uniform": dict(low=-0.2, high=0.2)}.get(name, {})
    ref = np.asarray(getattr(JI, name)(**kw)(shape))
    got = _np(getattr(TI, name)(**kw)(shape))
    assert got.shape == ref.shape and got.dtype == np.float32
    assert JI._fan_in_out(shape) == TI._fan_in_out(shape)
    assert abs(got.std() / ref.std() - 1) < 0.05


def test_initializers_take_a_generator_and_the_seed():
    g = torch.Generator().manual_seed(3)
    a = TI.Normal()((4, 4), generator=g)
    b = TI.Normal()((4, 4), generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    pt.seed(9)
    c = TI.XavierUniform()((4, 4))
    pt.seed(9)
    assert torch.equal(c, TI.XavierUniform()((4, 4)))
    for nl, p in (("relu", None), ("tanh", None), ("leaky_relu", 0.2),
                  ("selu", None), ("conv2d", None)):
        assert TI.calculate_gain(nl, p) == JI.calculate_gain(nl, p)


# ----------------------------------------------------- ParamAttr, Layer

def test_param_attr_and_create_parameter_precedence():
    assert pt.ParamAttr is tnn.ParamAttr
    ref = inspect.signature(paddle.ParamAttr.__init__).parameters
    assert list(inspect.signature(pt.ParamAttr.__init__).parameters) == \
        list(ref)
    layer = tnn.Layer()
    attr = pt.ParamAttr(name="w0", initializer=TI.Constant(2.0),
                        learning_rate=0.5, trainable=False)
    p = layer.create_parameter((2, 3), attr=attr,
                               default_initializer=TI.Constant(7.0))
    assert p.param_name == "w0" and not p.requires_grad
    assert p.optimize_attr["learning_rate"] == 0.5 and p.regularizer is None
    assert torch.equal(p.detach(), torch.full((2, 3), 2.0))
    assert layer.create_parameter((2,), attr=False) is None
    try:
        TI.set_global_initializer(TI.Constant(3.0), TI.Constant(4.0))
        q = layer.create_parameter((2,), default_initializer=TI.Constant(7.))
        b = layer.create_parameter((2,), is_bias=True)
        assert q.tolist() == [3.0, 3.0] and b.tolist() == [4.0, 4.0]
        # an attribute's own initializer still wins
        r = layer.create_parameter((2,), attr=pt.ParamAttr(
            initializer=TI.Constant(5.0)))
        assert r.tolist() == [5.0, 5.0]
    finally:
        TI.set_global_initializer(None)
    d = layer.create_parameter((2,), default_initializer=TI.Constant(7.0))
    assert d.tolist() == [7.0, 7.0]
    assert layer.create_parameter((2,), is_bias=True).tolist() == [0.0, 0.0]


def _tree(nn_mod, **kw):
    blocks = nn_mod.LayerList([nn_mod.Linear(4, 4, **kw),
                               nn_mod.Sequential(nn_mod.Linear(4, 6, **kw),
                                                 nn_mod.ReLU())])
    return nn_mod.Sequential(nn_mod.Linear(3, 4, **kw), blocks,
                             nn_mod.LayerNorm(6, **kw))


def test_sublayers_and_state_follow_the_reference():
    paddle.seed(2)
    jm, tm = _tree(jnn), _tree(tnn, device="cpu")
    for inc in (False, True):
        assert ([n for n, _ in tm.named_sublayers(include_self=inc)]
                == [n for n, _ in jm.named_sublayers(include_self=inc)])
        assert ([type(m).__name__ for m in tm.sublayers(inc)]
                == [type(m).__name__ for m in jm.sublayers(inc)])
    assert ([n for n, _ in tm.named_sublayers(prefix="m")]
            == [n for n, _ in jm.named_sublayers(prefix="m")])
    assert list(tm.state_dict()) == list(jm.state_dict())
    for kw in (dict(include_sublayers=False), dict(
            structured_name_prefix="net."), dict(include_sublayers=True)):
        assert list(tm.state_dict(**kw)) == list(jm.state_dict(**kw)), kw
    _load_reference(tm, jm)
    x = np.random.RandomState(1).randn(5, 3).astype(np.float32)

    def run(m, h):
        return m[2](m[1][1](m[1][0](m[0](h))))
    np.testing.assert_allclose(_np(run(tm, torch.as_tensor(x))),
                               _np(run(jm, paddle.to_tensor(x))), **TOL)
    assert len(tm.parameters()) == len(jm.parameters())
    assert len(tm.parameters(include_sublayers=False)) == 0
    assert next(tm.parameters()) is tm[0].weight
    # torch's own spellings keep torch's answers
    assert len(list(tm.parameters(recurse=False))) == 0
    assert list(tm.state_dict(prefix="a.")) == [
        "a." + k for k in tm.state_dict()]
    assert all(v.requires_grad for v in
               tm.state_dict(keep_vars=True).values())
    with pytest.raises(ValueError, match="shape mismatch"):
        tm.set_state_dict({"0.weight": np.zeros((2, 2), np.float32)})
    missing, unexpected = tm.set_dict({"nope": np.zeros(1)})
    assert unexpected == ["nope"] and len(missing) == len(tm.state_dict())


def test_buffers_hooks_and_the_other_methods():
    layer = tnn.Linear(2, 3)
    layer.register_buffer("kept", torch.ones(2))
    layer.register_buffer("scratch", torch.zeros(2), persistable=False)
    layer.register_buffer("scratch2", torch.zeros(2), persistent=False)
    assert list(layer.state_dict()) == ["weight", "bias", "kept"]
    assert list(layer.state_dict(structured_name_prefix="x")) == [
        "x.weight", "x.bias", "x.kept"]
    assert len(layer.buffers()) == 3
    seen = []
    pre = layer.register_forward_pre_hook(
        lambda m, inp: seen.append("pre") or (inp[0] * 0,))
    post = layer.register_forward_post_hook(
        lambda m, inp, out: seen.append("post") or out + 1)
    out = layer(torch.ones(1, 2))
    assert seen == ["pre", "post"]
    assert torch.allclose(out, layer.bias + 1)
    pre.remove()
    post.remove()
    assert torch.allclose(layer(torch.zeros(1, 2)), layer.bias)
    assert seen == ["pre", "post"]
    layer(torch.ones(1, 2)).sum().backward()
    assert layer.weight.grad is not None
    layer.clear_gradients()
    assert layer.weight.grad is None
    assert layer.full_name() == "linear"
    assert tnn.Layer("blk").full_name() == "blk"
    layer.astype("bfloat16")
    assert layer.weight.dtype == torch.bfloat16
    extra = tnn.Layer()
    extra.add_parameter("w", layer.create_parameter((2,)))
    extra.add_sublayer("0", tnn.ReLU())
    assert [n for n, _ in extra.named_parameters()] == ["w"]
    assert [n for n, _ in extra.named_sublayers()] == ["0"]


@pytest.mark.parametrize("opt", ["Momentum", "Adam", "AdamW"])
def test_optimizers_refuse_regularizers_and_lr_multipliers(opt):
    """Once refused, now ported: the optimizers take parameters that carry
    a ParamAttr regularizer or learning-rate multiplier, and the eager
    step applies them (a multiplier of 2.0 doubles the first step; a
    zero-coefficient regularizer replaces the optimizer's decay).
    tests/test_torch_optimizers.py holds both against the reference."""
    cls = getattr(pt.optimizer, opt)
    kw = dict(learning_rate=0.1, weight_decay=0.0)
    moves = []
    for attr in (pt.ParamAttr(regularizer=pt.regularizer.L2Decay(0.0)),
                 pt.ParamAttr(learning_rate=2.0),
                 pt.ParamAttr(learning_rate=1.0)):
        torch.manual_seed(0)
        layer = tnn.Linear(2, 2, weight_attr=attr, device="cpu")
        o = cls(parameters=layer.parameters(), **kw)
        before = layer.weight.detach().clone()
        layer.weight.grad = torch.ones(2, 2)
        o.step()
        moves.append(layer.weight.detach() - before)
    torch.testing.assert_close(moves[1], 2 * moves[2])
    torch.testing.assert_close(moves[0], moves[2])


# ------------------------------------------------------- layers' maths

@pytest.mark.parametrize("mode", ["zeros", "reflect", "replicate",
                                  "circular"])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_conv2d_padding_modes_on_the_reference_weights(mode, fmt):
    """``Conv2D(3, 8, 3, 1, 1, 1, 1, mode)``: "zeros" against the
    reference's Conv2D, the others against the reference's ``F.pad`` in
    that mode then its unpadded ``F.conv2d``."""
    paddle.seed(4)
    jc = jnn.Conv2D(3, 8, 3, 1, 1, 1, 1, "zeros", data_format=fmt)
    tc = tnn.Conv2D(3, 8, 3, 1, 1, 1, 1, mode, data_format=fmt)
    assert tc.padding_mode == mode
    _load_reference(tc, jc)
    shape = (2, 3, 6, 7) if fmt == "NCHW" else (2, 6, 7, 3)
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    jx = paddle.to_tensor(x)
    if mode == "zeros":
        ref = jc(jx)
    else:
        padded = JF.pad(jx, [1, 1, 1, 1], mode=mode, data_format=fmt)
        ref = JF.conv2d(padded, jc.weight, jc.bias, 1, 0, 1, 1, fmt)
    np.testing.assert_allclose(_np(tc(torch.as_tensor(x))), _np(ref), **TOL)
    with pytest.raises(Exception, match="padding_mode"):
        tnn.Conv2D(3, 8, 3, padding_mode="mirror")


def test_layer_norm_list_shape_and_batch_norm_attrs():
    paddle.seed(6)
    rng = np.random.RandomState(6)
    jn, tn = jnn.LayerNorm([8, 16]), tnn.LayerNorm([8, 16])
    assert list(tn.state_dict()) == list(jn.state_dict())
    w = rng.randn(128).astype(np.float32)
    b = rng.randn(128).astype(np.float32)
    jn.set_state_dict({"weight": w, "bias": b})
    _load_reference(tn, jn)
    x = rng.randn(3, 8, 16).astype(np.float32)
    np.testing.assert_allclose(_np(tn(torch.as_tensor(x))),
                               _np(jn(paddle.to_tensor(x))), **TOL)
    for ln in (tnn.LayerNorm(4, 1e-5, False, False), jnn.LayerNorm(
            4, 1e-5, False, False)):
        assert ln.weight is None and ln.bias is None
    tb = tnn.BatchNorm2D(4, weight_attr=pt.ParamAttr(
        initializer=TI.Constant(2.0)), bias_attr=False)
    jb = jnn.BatchNorm2D(4, weight_attr=paddle.ParamAttr(
        initializer=JI.Constant(2.0)), bias_attr=False)
    assert tb.bias is None and jb.bias is None
    np.testing.assert_array_equal(_np(tb.weight), _np(jb.weight))
    assert list(tb.state_dict()) == list(jb.state_dict())


def test_embedding_weight_attr_and_default_draw():
    paddle.seed(8)
    value = np.random.RandomState(8).randn(10, 4).astype(np.float32)
    je = jnn.Embedding(10, 4, 2, weight_attr=paddle.ParamAttr(
        initializer=JI.Assign(value)))
    te = tnn.Embedding(10, 4, 2, weight_attr=pt.ParamAttr(
        initializer=TI.Assign(value)))
    np.testing.assert_array_equal(_np(te.weight), _np(je.weight))
    big = tnn.Embedding(512, 512)
    assert abs(float(big.weight.std()) - 1.0) < 0.05


INTERP = [("nearest", False), ("bilinear", False), ("bilinear", True),
          ("bicubic", False), ("bicubic", True), ("area", False)]


@pytest.mark.parametrize("mode,corners", INTERP)
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_interpolate_matches_the_reference(mode, corners, fmt):
    rng = np.random.RandomState(12)
    x = rng.randn(2, 3, 5, 6).astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    for kw in (dict(scale_factor=2), dict(size=[7, 4]),
               dict(scale_factor=[0.5, 1.5]), dict(size=[5, 6])):
        args = dict(kw, mode=mode, align_corners=corners, data_format=fmt)
        ref = JF.interpolate(paddle.to_tensor(x), **args)
        got = TF.interpolate(torch.as_tensor(x), **args)
        np.testing.assert_allclose(_np(got), _np(ref), **TOL)
        up = TF.upsample(torch.as_tensor(x), **args)
        np.testing.assert_allclose(_np(up), _np(ref), **TOL)


def test_upsample_layers_match_the_reference():
    x = np.random.RandomState(13).randn(1, 2, 4, 4).astype(np.float32)
    jx, tx = paddle.to_tensor(x), torch.as_tensor(x)
    pairs = [(jnn.Upsample(scale_factor=3, mode="bicubic"),
              tnn.Upsample(scale_factor=3, mode="bicubic")),
             (jnn.UpsamplingNearest2D(size=[6, 10]),
              tnn.UpsamplingNearest2D(size=[6, 10])),
             (jnn.UpsamplingBilinear2D(scale_factor=2),
              tnn.UpsamplingBilinear2D(scale_factor=2))]
    for jl, tl in pairs:
        np.testing.assert_allclose(_np(tl(tx)), _np(jl(jx)), **TOL)
    x3 = np.random.RandomState(14).randn(1, 2, 3, 4, 5).astype(np.float32)
    ref = JF.interpolate(paddle.to_tensor(x3), scale_factor=2,
                         mode="trilinear", data_format="NCDHW")
    got = TF.interpolate(torch.as_tensor(x3), scale_factor=2,
                         mode="trilinear", data_format="NCDHW")
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


# ------------------------------------ torch's machinery on the new surface

class _Net(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.conv = tnn.Conv2D(3, 4, 3, 1, 1, 1, 1, "reflect")
        self.norm = tnn.LayerNorm([4, 4, 4])
        self.fc = tnn.Linear(64, 5, weight_attr=pt.ParamAttr(
            initializer=TI.KaimingUniform()))
        self.register_buffer("scale", torch.full((1,), 2.0))
        self.register_buffer("tmp", torch.zeros(1), persistable=False)

    def forward(self, x):
        h = TF.interpolate(self.norm(self.conv(x)), scale_factor=1)
        return self.fc(h.flatten(1)) * self.scale


def test_deepcopy_capture_and_export_of_the_new_surface(tmp_path):
    pt.seed(15)
    net = _Net()
    x = torch.as_tensor(np.random.RandomState(15).randn(
        2, 3, 4, 4).astype(np.float32))
    want = net(x)
    twin = copy.deepcopy(net)
    assert torch.equal(twin(x), want)
    assert sorted(twin.state_dict()) == sorted([
        "conv.weight", "conv.bias", "norm.weight", "norm.bias", "fc.weight",
        "fc.bias", "scale"])
    # a captured training step (on the CPU: the same program, run)
    opt = pt.optimizer.Adam(learning_rate=1e-2,
                            parameters=twin.parameters())
    step = pt.jit.TrainStep(twin, lambda out, y: ((out - y) ** 2).mean(),
                            opt)
    y = torch.zeros(2, 5)
    losses = [float(step(x, y)) for _ in range(3)]
    assert losses[2] < losses[0]
    # torch.export through jit.save / jit.load
    prefix = str(tmp_path / "net")
    pt.jit.save(net, prefix, input_spec=[x])
    loaded = pt.jit.load(prefix, device="cpu")
    np.testing.assert_allclose(_np(loaded(x)), _np(want), **TOL)
