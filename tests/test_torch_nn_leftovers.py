"""paddle_tpu_torch's ``nn`` leftovers against the JAX package on the CPU:
the activation functionals and layers, the common functionals and
layers (pads, shuffles, one_hot / label_smooth, bilinear, fold /
unfold, the dropouts), ``ParameterList`` / ``LayerDict`` /
``HookRemoveHelper``, ``clip_grad_norm_`` / ``set_gradient_clip`` /
``ErrorClipByValue``, ``nn.utils``' weight and spectral norms and
``F.sequence_mask``.  Each deterministic case is a parametrised
comparison on the same numpy inputs (and the reference's weights, by
``load_paddle_state``): outputs and the gradients of sum(out * cot)
within 1e-6 (relative, plus 1e-6 of the tensor's largest |value|).
The random ones (rrelu, gumbel_softmax, the dropouts) are checked for
their laws and for seeding through ``core.rng``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor, unwrap
from paddle_tpu.jit import functional_call, state_arrays
from paddle_tpu.nn import clip as jclip
from paddle_tpu.nn import utils as jutils

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.nn import utils as tutils

torch.set_num_threads(1)

TOL = 1e-6


def _f(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got.astype(np.float64), want.astype(np.float64), rtol=tol,
        atol=tol * max(float(np.abs(want).max()) if want.size else 0, 1.0))


def _ref_grads(fn, floats, consts=()):
    def loss(*xs):
        out = unwrap(fn(*[Tensor(x) for x in xs],
                        *[Tensor(jnp.asarray(c)) for c in consts]))
        cot = jnp.asarray(np.random.RandomState(13).randn(*out.shape),
                          out.dtype)
        return (out * cot).sum(), out
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(floats))), has_aux=True))(
        *[jnp.asarray(a) for a in floats])
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_grads(fn, floats, consts=()):
    ins = [torch.tensor(a, requires_grad=True) for a in floats]
    out = fn(*ins, *[torch.from_numpy(np.asarray(c)) for c in consts])
    cot = torch.from_numpy(np.random.RandomState(13).randn(
        *out.shape).astype(np.float32))
    (out * cot).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ins]


def _same(make, floats, consts=()):
    want, wgrads = _ref_grads(make(JF), floats, consts)
    got, grads = _port_grads(make(TF), floats, consts)
    _close(got, want)
    for g, w in zip(grads, wgrads):
        _close(g, w)


X = (2, 6, 5)   # values around every activation's thresholds (x 3)


ACTIVATIONS = [
    ("sigmoid", lambda F: F.sigmoid), ("silu", lambda F: F.silu),
    ("swish", lambda F: F.swish), ("mish", lambda F: F.mish),
    ("softsign", lambda F: F.softsign),
    ("tanhshrink", lambda F: F.tanhshrink),
    ("hardswish", lambda F: F.hardswish),
    ("hardsigmoid", lambda F: F.hardsigmoid),
    ("log_sigmoid", lambda F: F.log_sigmoid),
    ("leaky_relu", lambda F: lambda x: F.leaky_relu(x, 0.2)),
    ("elu", lambda F: lambda x: F.elu(x, 0.7)),
    ("selu", lambda F: F.selu), ("celu", lambda F: lambda x: F.celu(x, 1.5)),
    ("hardtanh", lambda F: lambda x: F.hardtanh(x, -0.5, 2.0)),
    ("hardshrink", lambda F: lambda x: F.hardshrink(x, 0.6)),
    ("softshrink", lambda F: lambda x: F.softshrink(x, 0.6)),
    ("softplus", lambda F: lambda x: F.softplus(x, 2.0, 5.0)),
    ("thresholded_relu", lambda F: lambda x: F.thresholded_relu(x, 0.5)),
    ("log_softmax", lambda F: lambda x: F.log_softmax(x, 1)),
    ("log_softmax_dtype", lambda F: lambda x: F.log_softmax(x, -1,
                                                           "float32")),
    ("maxout", lambda F: lambda x: F.maxout(x, 3, 1)),
    ("glu", lambda F: lambda x: F.glu(x, 1)),
    ("gelu_tanh", lambda F: lambda x: F.gelu(x, True)),
    ("rrelu_eval", lambda F: lambda x: F.rrelu(x, 0.1, 0.3, False)),
]


@pytest.mark.parametrize("name,make", ACTIVATIONS,
                         ids=[a[0] for a in ACTIVATIONS])
def test_activations_and_their_gradients(name, make):
    _same(make, [_f(*X, seed=1, scale=3.0)])


@pytest.mark.parametrize("fmt,w", [("NCHW", 1), ("NCHW", 6), ("NHWC", 5)])
def test_prelu_and_its_weight_gradient(fmt, w):
    _same(lambda F: lambda x, a: F.prelu(x.reshape((2, 6, 5, 1)), a, fmt),
          [_f(*X, seed=2, scale=3.0), _f(w, seed=3)])


@pytest.mark.parametrize("fn", ["softmax_", "tanh_", "relu_"])
def test_inplace_activations_write_into_x(fn):
    x = _f(*X, seed=4, scale=3.0)
    jx = paddle.to_tensor(x)
    getattr(JF, fn)(jx)
    tx = torch.from_numpy(x.copy())
    assert getattr(TF, fn)(tx) is tx
    _close(tx.numpy(), jx.numpy())


def test_rrelu_training_draws_slopes_from_the_step_generator():
    x = torch.from_numpy(-np.abs(_f(4, 100, seed=5)) - 0.1)
    outs = []
    for _ in range(2):
        with trng.generator_scope(torch.Generator().manual_seed(7)):
            outs.append(TF.rrelu(x, 0.1, 0.3))
    assert torch.equal(outs[0], outs[1])
    slope = outs[0] / x
    assert slope.min() >= 0.1 and slope.max() < 0.3
    assert slope.std() > 0.03
    pos = torch.from_numpy(np.abs(_f(5, seed=6)))
    assert torch.equal(TF.rrelu(pos), pos)


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_rows_and_seeding(hard):
    x = torch.from_numpy(_f(6, 10, seed=8)).requires_grad_()
    with trng.generator_scope(torch.Generator().manual_seed(3)):
        y = TF.gumbel_softmax(x, 0.5, hard)
    with trng.generator_scope(torch.Generator().manual_seed(3)):
        y2 = TF.gumbel_softmax(x, 0.5, hard)
    assert torch.equal(y, y2)
    torch.testing.assert_close(y.sum(-1), torch.ones(6))
    if hard:
        assert set(y.detach().unique().tolist()) <= {0.0, 1.0}
    (y * torch.arange(10.0)).sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0


LAYERS = [
    ("ReLU6", ()), ("GELU", (True,)), ("Sigmoid", ()), ("LeakyReLU", (0.3,)),
    ("ELU", (0.5,)), ("CELU", (2.0,)), ("SELU", ()), ("Silu", ()),
    ("Swish", ()), ("Mish", ()), ("Hardswish", ()), ("Hardsigmoid", ()),
    ("Hardtanh", (-2.0, 1.0)), ("Hardshrink", (0.4,)),
    ("Softshrink", (0.4,)), ("Softplus", (1.5, 4.0)), ("Softsign", ()),
    ("Tanhshrink", ()), ("ThresholdedReLU", (0.8,)), ("LogSigmoid", ()),
    ("Softmax", (1,)), ("LogSoftmax", (2,)), ("Maxout", (2, 1)),
    ("PReLU", (6, 0.1)), ("GLU", (1,)), ("ReLU", ()), ("Tanh", ()),
]
# the tanh-form GELU's far negative tail: 1 + tanh(z) cancels, and the
# reference's XLA CPU tanh (a rational approximation) is off there by
# about 1.6e-6 of the layer's largest |output|
LAYER_TOL = {"GELU": 2e-6}


def _layer_same(name, args, inputs, n_float=1, tol=TOL):
    """The reference's layer ``name`` and the port's on its weights (moved
    off their initial values): outputs, and the gradients of the
    parameters and the first ``n_float`` inputs."""
    paddle.seed(0)
    jl = getattr(jnn, name)(*args)
    tl = getattr(tnn, name)(*args)
    state = {k: np.asarray(v) + _f(*v.shape, seed=len(k)) * 0.1
             for k, v in state_arrays(jl).items()}
    pt.load_paddle_state(tl, state)
    consts = inputs[n_float:]

    def ref_loss(st, xs):
        out = functional_call(jl, st, *[Tensor(x) for x in xs],
                              *[Tensor(jnp.asarray(c)) for c in consts])
        cot = jnp.asarray(np.random.RandomState(13).randn(*out.shape),
                          out.dtype)
        return (out * cot).sum(), out
    (_, rout), (rgs, rgx) = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in state.items()},
        [jnp.asarray(a) for a in inputs[:n_float]])
    ins = [torch.tensor(a, requires_grad=i < n_float)
           for i, a in enumerate(inputs)]
    out = tl(*ins)
    cot = torch.from_numpy(np.random.RandomState(13).randn(
        *out.shape).astype(np.float32))
    (out * cot).sum().backward()
    _close(out.detach().numpy(), rout, tol)
    params = dict(tl.named_parameters())
    assert set(params) == set(state)
    for k in state:
        _close(params[k].grad.numpy(), rgs[k], tol)
    for t, g in zip(ins[:n_float], rgx):
        _close(t.grad.numpy(), g, tol)


@pytest.mark.parametrize("name,args", LAYERS, ids=[a[0] for a in LAYERS])
def test_activation_layers(name, args):
    _layer_same(name, args, [_f(2, 6, 5, 4, seed=9, scale=3.0)],
                tol=LAYER_TOL.get(name, TOL))


def test_rrelu_layer_follows_training_mode():
    x = torch.from_numpy(-np.abs(_f(3, 40, seed=10)) - 0.1)
    layer = tnn.RReLU(0.1, 0.3)
    layer.eval()
    torch.testing.assert_close(layer(x), 0.2 * x)
    layer.train()
    assert not torch.allclose(layer(x), 0.2 * x)


# ---------------------------------------------------------------- common

COMMON = [
    ("pad_constant", lambda F: lambda x: F.pad(x, [1, 2, 0, 3], value=0.5),
     (2, 3, 4, 5)),
    ("pad_reflect", lambda F: lambda x: F.pad(x, [2, 1, 1, 2], "reflect"),
     (2, 3, 4, 5)),
    ("pad_replicate", lambda F: lambda x: F.pad(x, [2, 1, 1, 2],
                                                "replicate"), (2, 3, 4, 5)),
    ("pad_circular", lambda F: lambda x: F.pad(x, [2, 1, 1, 2], "circular"),
     (2, 3, 4, 5)),
    ("pad_full_rank", lambda F: lambda x: F.pad(x, [0, 1, 2, 0, 1, 1]),
     (2, 3, 4)),
    ("pad_nhwc", lambda F: lambda x: F.pad(x, [1, 0, 2, 1], "reflect",
                                           data_format="NHWC"),
     (2, 4, 5, 3)),
    ("pad_1d", lambda F: lambda x: F.pad(x, [2, 3], "replicate",
                                         data_format="NCL"), (2, 3, 6)),
    ("zeropad2d", lambda F: lambda x: F.zeropad2d(x, [1, 1, 2, 0]),
     (2, 3, 4, 5)),
    ("cosine_similarity", lambda F: lambda x: F.cosine_similarity(
        x[:, :3], x[:, 3:], axis=1), (4, 6, 5)),
    ("pairwise_distance", lambda F: lambda x: F.pairwise_distance(
        x[0], x[1], 3.0, 1e-6, True), (2, 5, 7)),
    ("pixel_shuffle", lambda F: lambda x: F.pixel_shuffle(x, 2),
     (2, 8, 3, 4)),
    ("pixel_shuffle_nhwc", lambda F: lambda x: F.pixel_shuffle(
        x, 2, "NHWC"), (2, 3, 4, 8)),
    ("pixel_unshuffle", lambda F: lambda x: F.pixel_unshuffle(x, 2),
     (2, 3, 4, 6)),
    ("pixel_unshuffle_nhwc", lambda F: lambda x: F.pixel_unshuffle(
        x, 2, "NHWC"), (2, 4, 6, 3)),
    ("channel_shuffle", lambda F: lambda x: F.channel_shuffle(x, 3),
     (2, 6, 3, 4)),
    ("channel_shuffle_nhwc", lambda F: lambda x: F.channel_shuffle(
        x, 2, "NHWC"), (2, 3, 4, 6)),
    ("unfold", lambda F: lambda x: F.unfold(x, [3, 2], [2, 1], [1, 0],
                                            [1, 2]), (2, 3, 7, 6)),
    ("unfold_4pad", lambda F: lambda x: F.unfold(x, 2, 1, [1, 0, 0, 1]),
     (1, 2, 5, 5)),
    ("fold", lambda F: lambda x: F.fold(x, [5, 6], [2, 3], 1, [1, 1]),
     (2, 12, 36)),
    ("label_smooth", lambda F: lambda x: F.label_smooth(x, epsilon=0.2),
     (3, 4, 7)),
    ("label_smooth_prior", lambda F: lambda x: F.label_smooth(
        x[0], x[1, 0:1], epsilon=0.3), (2, 4, 7)),
]


@pytest.mark.parametrize("name,make,shape", COMMON,
                         ids=[c[0] for c in COMMON])
def test_common_functionals_and_their_gradients(name, make, shape):
    _same(make, [_f(*shape, seed=11)])


def test_bilinear_and_its_gradients():
    _same(lambda F: F.bilinear,
          [_f(4, 3, seed=12), _f(4, 5, seed=13), _f(2, 3, 5, seed=14),
           _f(2, seed=15)])


def test_one_hot_zeroes_out_of_range_ids():
    ids = np.array([[0, 3, 5], [2, -1, 4]], np.int64)
    want = JF.one_hot(paddle.to_tensor(ids), 5).numpy()
    got = TF.one_hot(torch.from_numpy(ids), 5)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn,fmt,shape", [
    ("dropout2d", "NCHW", (4, 6, 3, 3)), ("dropout2d", "NHWC", (4, 3, 3, 6)),
    ("dropout3d", "NCDHW", (4, 6, 2, 3, 3))])
def test_channel_dropouts_drop_whole_channels(fn, fmt, shape):
    x = torch.ones(shape)
    with trng.generator_scope(torch.Generator().manual_seed(5)):
        y = getattr(TF, fn)(x, 0.5, data_format=fmt)
    ch = 1 if fmt.startswith("NC") else len(shape) - 1
    per = y.movedim(ch, 1).reshape(shape[0], shape[ch], -1)
    assert set(per.unique().tolist()) <= {0.0, 2.0}
    assert (per.amin(-1) == per.amax(-1)).all()
    assert torch.equal(getattr(TF, fn)(x, 0.5, training=False,
                                       data_format=fmt), x)


def test_alpha_dropout_keeps_values_affine_and_seeded():
    x = torch.from_numpy(_f(50, 40, seed=16))
    runs = []
    for _ in range(2):
        with trng.generator_scope(torch.Generator().manual_seed(9)):
            runs.append(TF.alpha_dropout(x, 0.2))
    assert torch.equal(runs[0], runs[1])
    alpha_p, keep = -1.6732632423543772 * 1.0507009873554805, 0.8
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    dropped = torch.isclose(runs[0], torch.tensor(a * alpha_p + b))
    torch.testing.assert_close(runs[0][~dropped], a * x[~dropped] + b)
    assert 0.1 < dropped.float().mean() < 0.3
    assert torch.equal(TF.alpha_dropout(x, 0.2, training=False), x)


COMMON_LAYERS = [
    ("Identity", (), (2, 3)), ("Flatten", (1, 2), (2, 3, 4, 5)),
    ("Pad1D", ([1, 2], "reflect"), (2, 3, 6)),
    ("Pad2D", ([1, 0, 2, 1], "replicate"), (2, 3, 4, 5)),
    ("Pad3D", ([1, 0, 2, 1, 0, 1], "constant", 0.5), (2, 3, 3, 4, 5)),
    ("ZeroPad2D", ([1, 1, 0, 2],), (2, 3, 4, 5)),
    ("PixelShuffle", (2,), (2, 8, 3, 4)),
    ("PixelUnshuffle", (2,), (2, 3, 4, 6)),
    ("ChannelShuffle", (2,), (2, 6, 3, 4)),
    ("Unfold", ([2, 2], 1, 1), (2, 3, 4, 5)),
    ("Fold", ([4, 5], [2, 2]), (2, 12, 12)),
]


@pytest.mark.parametrize("name,args,shape", COMMON_LAYERS,
                         ids=[c[0] for c in COMMON_LAYERS])
def test_common_layers(name, args, shape):
    _layer_same(name, args, [_f(*shape, seed=17)])


def test_two_input_layers():
    a, b = _f(4, 6, 5, seed=18), _f(4, 6, 5, seed=19)
    _layer_same("CosineSimilarity", (2, 1e-8), [a, b], 2)
    _layer_same("PairwiseDistance", (1.0, 1e-6, False), [a, b], 2)
    _layer_same("Bilinear", (3, 5, 2), [_f(4, 3, seed=20), _f(4, 5, seed=21)],
                2)


def test_channel_dropout_layers_follow_training_mode():
    x = torch.ones(2, 4, 3, 3)
    for cls in (tnn.Dropout2D, tnn.Dropout3D, tnn.AlphaDropout):
        layer = cls(0.5)
        xx = x if cls is not tnn.Dropout3D else x[..., None]
        layer.eval()
        assert torch.equal(layer(xx), xx)
        layer.train()
        assert not torch.equal(layer(xx), xx)


# ------------------------------------------------------------ containers

def test_parameter_list_and_layer_dict_keep_the_reference_names():
    paddle.seed(0)
    jpl = jnn.ParameterList([jnn.Linear(2, 3).weight, jnn.Linear(3, 1).bias])
    tpl = tnn.ParameterList([torch.nn.Parameter(torch.zeros(2, 3)),
                             torch.nn.Parameter(torch.zeros(1))])
    assert list(tpl.state_dict()) == list(jpl.state_dict())
    tpl.append(torch.nn.Parameter(torch.ones(4)))
    assert len(tpl) == 3 and tpl[2].shape == (4,)
    assert [tuple(p.shape) for p in tpl] == [(2, 3), (1,), (4,)]
    jd = jnn.LayerDict({"b": jnn.Linear(2, 3), "a": jnn.ReLU()})
    td = tnn.LayerDict({"b": tnn.Linear(2, 3), "a": tnn.ReLU()})
    td["c"] = tnn.Linear(3, 1)
    jd["c"] = jnn.Linear(3, 1)
    assert list(td.keys()) == list(jd.keys()) == ["b", "a", "c"]
    assert list(td.state_dict()) == list(jd.state_dict())
    assert "a" in td and len(td) == 3
    assert isinstance(td.pop("a"), tnn.ReLU) and list(td) == ["b", "c"]
    td.clear()
    assert len(td) == 0


def test_hook_remove_helper_as_the_reference():
    from paddle_tpu.nn.layer_base import HookRemoveHelper as J
    from paddle_tpu_torch.nn.layer_base import HookRemoveHelper as T
    for cls in (J, T):
        hooks = {1: "a", 2: "b"}
        h = cls(hooks, 1)
        h.remove()
        h.remove()
        assert hooks == {2: "b"}


# ------------------------------------------------------------------ clip

def _grads_pair(seed=22):
    """Two gradients, and port parameters holding them as ``.grad``."""
    rng = np.random.RandomState(seed)
    grads = [rng.randn(3, 4).astype(np.float32) * 3,
             rng.randn(5).astype(np.float32)]
    tps = []
    for g in grads:
        tp = torch.nn.Parameter(torch.zeros(g.shape))
        tp.grad = torch.from_numpy(g.copy())
        tps.append(tp)
    return grads, tps


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_scales_in_place_as_the_reference(norm_type):
    grads, tps = _grads_pair()

    class G:
        def __init__(self, g):
            self.grad = Tensor(jnp.asarray(g))
    jparams = [G(g) for g in grads]
    want = float(unwrap(jclip.clip_grad_norm_(jparams, 2.5, norm_type)))
    got = tclip.clip_grad_norm_(tps, 2.5, norm_type)
    _close(float(got), want)
    for tp, jp in zip(tps, jparams):
        _close(tp.grad.numpy(), np.asarray(unwrap(jp.grad)))


def test_set_gradient_clip_applies_to_optimizers_without_their_own():
    def run(clip_global, clip_own):
        lin = tnn.Linear(4, 3)
        with torch.no_grad():
            lin.weight.copy_(torch.linspace(-1, 1, 12).view(4, 3))
        opt = pt.optimizer.SGD(0.1, parameters=lin.parameters(),
                               grad_clip=clip_own)
        tclip.set_gradient_clip(clip_global)
        try:
            (lin(torch.ones(2, 4)) * 10).sum().backward()
            opt.step()
        finally:
            tclip.set_gradient_clip(None)
        return lin.weight.detach().clone()
    clip = tnn.ClipGradByGlobalNorm(0.5)
    assert torch.equal(run(clip, None), run(None, clip))
    assert not torch.equal(run(clip, None), run(None, None))
    # the optimizer's own clip has priority
    assert torch.equal(run(tnn.ClipGradByGlobalNorm(100.0), clip),
                       run(None, clip))
    with pytest.raises(NotImplementedError):
        tclip.set_gradient_clip(clip, param_list=["w"])


def test_error_clip_by_value_clips_the_gradient():
    x = torch.from_numpy(_f(6, seed=23)).requires_grad_()
    y = tclip.ErrorClipByValue(0.5).apply(x * 1.0)
    (y * torch.linspace(-3, 3, 6)).sum().backward()
    torch.testing.assert_close(x.grad, torch.linspace(-3, 3, 6).clamp(-0.5,
                                                                      0.5))


# ------------------------------------------------------------ nn.utils

@pytest.mark.parametrize("dim", [0, 1, None, -1])
def test_weight_norm_matches_reference(dim):
    paddle.seed(1)
    jl = jutils.weight_norm(jnn.Linear(4, 3), dim=dim)
    tl = tutils.weight_norm(tnn.Linear(4, 3), dim=dim)
    state = {k: np.asarray(v) for k, v in state_arrays(jl).items()}
    assert set(state) == {"bias", "weight_v", "weight_g"}
    assert list(tl.state_dict()) == list(jl.state_dict())
    state = {k: v * 1.3 + 0.1 for k, v in state.items()}
    pt.load_paddle_state(tl, state)
    x = _f(5, 4, seed=24)

    def ref_loss(st):
        out = functional_call(jl, st, Tensor(jnp.asarray(x)))
        return (out * out).sum(), out
    (_, rout), rg = jax.value_and_grad(ref_loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in state.items()})
    out = tl(torch.from_numpy(x))
    (out * out).sum().backward()
    _close(out.detach().numpy(), rout)
    for k, p in tl.named_parameters():
        _close(p.grad.numpy(), rg[k])
    tutils.remove_weight_norm(tl)
    assert set(tl.state_dict()) == {"weight", "bias"}
    _close(tl(torch.from_numpy(x)).detach().numpy(), rout)
    with pytest.raises(ValueError):
        tutils.remove_weight_norm(tl)


def test_spectral_norm_matches_reference():
    paddle.seed(2)
    jl = jutils.spectral_norm(jnn.Linear(6, 4), n_power_iterations=2)
    tl = tutils.spectral_norm(tnn.Linear(6, 4), n_power_iterations=2)
    state = {k: np.asarray(v) for k, v in state_arrays(jl).items()}
    assert set(state) == {"bias", "weight_orig"}
    pt.load_paddle_state(tl, state)
    # u is no state in either: start the port's where the reference's is
    tl.__dict__["_sn_u_weight"] = torch.from_numpy(
        np.asarray(jl.__dict__["_sn_u_weight"]))
    x = _f(3, 6, seed=25)
    for _ in range(2):   # u moves between calls in both
        want = jl(paddle.to_tensor(x)).numpy()
        got = tl(torch.from_numpy(x))
        _close(got.detach().numpy(), want)
    jl2 = jutils.spectral_norm(jnn.Linear(6, 4))
    tl2 = tutils.spectral_norm(tnn.Linear(6, 4))
    st2 = {k: np.asarray(v) for k, v in state_arrays(jl2).items()}
    pt.load_paddle_state(tl2, st2)
    tl2.__dict__["_sn_u_weight"] = torch.from_numpy(
        np.asarray(jl2.__dict__["_sn_u_weight"]))

    # the reference's eager backward (its tape holds u and v constant, as
    # Paddle's; under jax.grad its power iteration would be traced too)
    out = jl2(paddle.to_tensor(x))
    (out * out).sum().backward()
    out = tl2(torch.from_numpy(x))
    (out * out).sum().backward()
    for k, p in tl2.named_parameters():
        _close(p.grad.numpy(), getattr(jl2, k).grad.numpy(), 1e-5)


@pytest.mark.parametrize("maxlen,dtype", [(None, "int64"), (6, "float32"),
                                          (4, "bool"), (5, "int32")])
def test_sequence_mask_as_the_reference(maxlen, dtype):
    """Values equal; the type is the one asked for (the reference's JAX
    runs without 64-bit types, so its "int64" comes out int32)."""
    lens = np.array([[3, 0], [5, 2]], np.int64)
    want = JF.sequence_mask(paddle.to_tensor(lens), maxlen, dtype).numpy()
    got = TF.sequence_mask(torch.from_numpy(lens), maxlen, dtype)
    assert str(got.dtype).replace("torch.", "") == dtype
    assert str(want.dtype) == (dtype if dtype != "int64" else "int32")
    np.testing.assert_array_equal(got.numpy(), want)
