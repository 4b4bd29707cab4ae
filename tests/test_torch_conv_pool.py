"""paddle_tpu_torch's convolutions and pools against the JAX package on the
CPU: conv1d / conv2d / conv3d, the transposed convolutions (groups,
dilation, output_padding, every padding form), every fixed-window and
adaptive pool, ``return_mask`` and the reference's quirks, and the layers
over the same functionals.  Inputs come from numpy seeds; outputs and the
gradients of sum(output * cotangent) with respect to every float input
agree within 1e-5 relative plus 1e-5 of the tensor's largest |value|: the
same sums in another order (a bias gradient sums thousands of terms that
cancel)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor, unwrap

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core.errors import InvalidArgumentError

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _f(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ref(fn, arrays, diff):
    """The reference's output and the gradients of sum(out * cot) for the
    inputs in ``diff``, from one jitted function."""
    def run(*xs):
        full = list(arrays)
        for i, x in zip(diff, xs):
            full[i] = x

        def summed(*ys):
            part = list(full)
            for i, y in zip(diff, ys):
                part[i] = y
            out = unwrap(fn(*[None if a is None else Tensor(jnp.asarray(a))
                              for a in part]))
            cot = jnp.asarray(np.random.RandomState(9).randn(*out.shape),
                              out.dtype)
            return (out * cot).sum(), out
        return jax.value_and_grad(summed, argnums=tuple(range(len(diff))),
                                  has_aux=True)(*xs)
    (_, out), grads = jax.jit(run)(*[jnp.asarray(arrays[i]) for i in diff])
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(fn, arrays, diff):
    ins = [None if a is None else torch.tensor(a, requires_grad=i in diff)
           for i, a in enumerate(arrays)]
    out = fn(*ins)
    cot = torch.from_numpy(np.random.RandomState(9).randn(
        *out.shape).astype(np.float32))
    (out * cot).sum().backward()
    return out.detach().numpy(), [ins[i].grad.numpy() for i in diff]


def _hold(jfn, tfn, arrays):
    diff = [i for i, a in enumerate(arrays) if a is not None]
    want, wgrads = _ref(jfn, arrays, diff)
    got, grads = _port(tfn, arrays, diff)
    assert got.shape == want.shape
    for g, w in zip([got] + grads, [want] + wgrads):
        np.testing.assert_allclose(
            g, w, rtol=1e-5, atol=1e-5 * max(float(np.abs(w).max()), 1.0))


# ------------------------------------------------------------ convolutions

SPATIAL = {1: (9,), 2: (9, 8), 3: (7, 6, 5)}
PADS = {"int": lambda n: 1, "per_axis": lambda n: [1, 2, 0][:n],
        "lo_hi": lambda n: [1, 0, 0, 2, 2, 1][:2 * n],
        "SAME": lambda n: "SAME", "valid": lambda n: "valid"}
CONV_CASES = [(1, 1, 1), (2, 1, 2), (1, 2, 1), (3, 1, 1)]   # stride, dil, g


@pytest.mark.parametrize("sdg", CONV_CASES, ids=lambda c: "s%dd%dg%d" % c)
@pytest.mark.parametrize("pad", list(PADS))
@pytest.mark.parametrize("n", [1, 2, 3])
def test_conv_matches_reference(n, pad, sdg):
    stride, dil, groups = sdg
    x = _f(2, 4, *SPATIAL[n], seed=n)
    w = _f(6, 4 // groups, *(3,) * n, seed=10 + n)
    b = _f(6, seed=20 + n)
    p = PADS[pad](n)
    name = f"conv{n}d"
    _hold(lambda x, w, b: getattr(JF, name)(x, w, b, stride, p, dil, groups),
          lambda x, w, b: getattr(TF, name)(x, w, b, stride, p, dil, groups),
          [x, w, b])


@pytest.mark.parametrize("n,fmt", [(1, "NLC"), (2, "NHWC"), (3, "NDHWC")])
def test_conv_channel_last_formats(n, fmt):
    x = _f(2, *SPATIAL[n], 4, seed=n)
    w, b = _f(5, 4, *(3,) * n, seed=3), _f(5, seed=4)
    name = f"conv{n}d"
    _hold(lambda x, w, b: getattr(JF, name)(x, w, b, 2, [1, 0] * n, 1, 1,
                                            fmt),
          lambda x, w, b: getattr(TF, name)(x, w, b, 2, [1, 0] * n, 1, 1,
                                            fmt), [x, w, b])


T_PADS = {"int": lambda n: 1, "per_axis": lambda n: [0, 2, 1][:n],
          "lo_hi": lambda n: [1, 0, 0, 2, 3, 1][:2 * n]}
T_CASES = [(1, 1, 1, 0), (2, 1, 2, 1), (2, 2, 1, 1), (3, 1, 2, 2)]


@pytest.mark.parametrize("case", T_CASES, ids=lambda c: "s%dd%dg%dop%d" % c)
@pytest.mark.parametrize("pad", list(T_PADS))
@pytest.mark.parametrize("n", [1, 2, 3])
def test_conv_transpose_matches_reference(n, pad, case):
    """Groups hold the reference's (in_c, out_c / groups, *k) interleave;
    a padding past the dilated kernel extent zero-extends the output."""
    stride, dil, groups, opad = case
    x = _f(2, 4, *SPATIAL[n], seed=n)
    w = _f(4, 3, *(3,) * n, seed=30 + n)
    b = _f(3 * groups, seed=40 + n)
    p = T_PADS[pad](n)
    name = f"conv{n}d_transpose"
    _hold(lambda x, w, b: getattr(JF, name)(x, w, b, stride, p, opad,
                                            groups, dil),
          lambda x, w, b: getattr(TF, name)(x, w, b, stride, p, opad,
                                            groups, dil), [x, w, b])


def test_conv_transpose_channel_last_and_output_size():
    x, w, b = _f(2, 5, 6, 4), _f(4, 3, 3, 3, seed=1), _f(3, seed=2)
    jt = [paddle.to_tensor(a) for a in (x, w, b)]
    tt = [torch.from_numpy(a) for a in (x, w, b)]
    want = JF.conv2d_transpose(*jt, 2, 1, 1, data_format="NHWC").numpy()
    got = TF.conv2d_transpose(*tt, 2, 1, 1, output_size=[99, 99],
                              data_format="NHWC").numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("pad", ["SAME", "valid"])
def test_conv_transpose_refuses_a_string_padding_as_the_reference(pad):
    x, w = _f(1, 4, 5, 5), _f(4, 2, 3, 3, seed=1)
    with pytest.raises(ValueError):
        JF.conv2d_transpose(paddle.to_tensor(x), paddle.to_tensor(w), None,
                            2, pad)
    with pytest.raises(InvalidArgumentError):
        TF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w), None,
                            2, pad)


LAYERS = [("Conv1D", (4, 6, 3), dict(stride=2, padding="SAME"), 1),
          ("Conv2D", (4, 6, 3), dict(padding=[1, 0, 0, 1], groups=2), 2),
          ("Conv3D", (4, 6, 3), dict(dilation=2, padding=2), 3),
          ("Conv1DTranspose", (4, 6, 3), dict(stride=2, output_padding=1), 1),
          ("Conv2DTranspose", (4, 6, 3), dict(stride=2, groups=2,
                                              padding=[1, 2]), 2),
          ("Conv3DTranspose", (4, 6, 2), dict(stride=2, padding=1), 3)]


@pytest.mark.parametrize("name,args,kw,n", LAYERS, ids=[c[0] for c in LAYERS])
def test_conv_layers_on_the_reference_weights(name, args, kw, n):
    """The layers' state (names and shapes) is the reference's; on its
    weights the forward equals the reference layer's."""
    paddle.seed(n)
    jl = getattr(jnn, name)(*args, **kw)
    tl = getattr(tnn, name)(*args, **kw, device="cpu")
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in tl.state_dict().items()} == \
        {k: v.shape for k, v in state.items()}
    pt.load_paddle_state(tl, state)
    x = _f(2, 4, *SPATIAL[n], seed=5)
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               jl(paddle.to_tensor(x)).numpy(), **TOL)


# ------------------------------------------------------------------- pools

POOL_PADS = {"zero": lambda n: 0, "int": lambda n: 1,
             "lo_hi": lambda n: [1, 0, 0, 2, 1, 1][:2 * n],
             "SAME": lambda n: "SAME", "VALID": lambda n: "VALID"}
KINDS = ["max", "avg", "avg_inclusive"]


def _pool_fns(kind, n, k, s, p):
    base = "max" if kind == "max" else "avg"
    kw = {} if kind == "max" else dict(exclusive=kind == "avg")
    jf, tf = (getattr(m, f"{base}_pool{n}d") for m in (JF, TF))
    return (lambda x: jf(x, k, s, p, **kw)), (lambda x: tf(x, k, s, p, **kw))


@pytest.mark.parametrize("pad", list(POOL_PADS))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 2, 3])
def test_pool_matches_reference(n, kind, pad):
    """Max pads -inf; an exclusive average over an asymmetric pad counts
    only the unpadded positions; a string padding divides by the whole
    window, exclusive or not (the reference's _pool)."""
    x = _f(2, 3, *SPATIAL[n], seed=50 + n)
    jf, tf = _pool_fns(kind, n, 3, 2, POOL_PADS[pad](n))
    _hold(jf, tf, [x])


@pytest.mark.parametrize("pad", ["zero", "int", "lo_hi", "SAME"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_return_mask_is_the_reference_flat_index(n, pad):
    x = _f(2, 3, *SPATIAL[n], seed=60 + n)
    p = POOL_PADS[pad](n)
    jo, jm = getattr(JF, f"max_pool{n}d")(paddle.to_tensor(x), 3, 2, p,
                                          return_mask=True)
    to, tm = getattr(TF, f"max_pool{n}d")(torch.from_numpy(x), 3, 2, p,
                                          return_mask=True)
    np.testing.assert_allclose(to.numpy(), jo.numpy(), **TOL)
    assert tm.dtype == torch.int32
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm.numpy()))


def test_return_mask_of_an_explicit_nhwc_input_is_the_reference_quirk():
    """The reference's mask is taken over the last two axes of what it is
    given, so for data_format="NHWC" it pools over (W, C) and indexes that
    plane, while the output pools over (H, W); the port returns the same."""
    x = _f(2, 9, 8, 6, seed=7)
    jo, jm = JF.max_pool2d(paddle.to_tensor(x), 2, 2, return_mask=True,
                           data_format="NHWC")
    to, tm = TF.max_pool2d(torch.from_numpy(x), 2, 2, return_mask=True,
                           data_format="NHWC")
    assert to.shape == (2, 4, 4, 6) and tm.shape == (2, 9, 4, 3)
    np.testing.assert_allclose(to.numpy(), jo.numpy(), **TOL)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm.numpy()))


@pytest.mark.parametrize("out", [1, 2, 3, 4, (3, 2, 4)],
                         ids=lambda o: str(o).replace(" ", ""))
@pytest.mark.parametrize("kind", ["avg", "max"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_adaptive_pools_match_reference(n, kind, out):
    """Sizes that do not divide take the general windows [floor(i*in/out),
    ceil((i+1)*in/out))."""
    size = out[:n] if isinstance(out, tuple) else out
    x = _f(2, 3, *SPATIAL[n], seed=70 + n)
    name = f"adaptive_{kind}_pool{n}d"
    _hold(lambda x: getattr(JF, name)(x, size),
          lambda x: getattr(TF, name)(x, size), [x])


def test_adaptive_max_return_mask_returns_the_output_alone():
    x = _f(2, 3, 9, 8, seed=8)
    want = JF.adaptive_max_pool2d(paddle.to_tensor(x), 3, True)
    got = TF.adaptive_max_pool2d(torch.from_numpy(x), 3, True)
    assert not isinstance(want, tuple) and isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    layer = tnn.AdaptiveMaxPool1D(4, return_mask=True)
    assert isinstance(layer(torch.from_numpy(x[:, :, 0])), torch.Tensor)


@pytest.mark.parametrize("fmt,n", [("NHWC", 2), ("NDHWC", 3)])
def test_pools_channel_last(fmt, n):
    x = _f(2, *SPATIAL[n], 3, seed=9)
    for base in ("max", "avg"):
        name = f"{base}_pool{n}d"
        _hold(lambda x: getattr(JF, name)(x, 2, 2, 1, data_format=fmt),
              lambda x: getattr(TF, name)(x, 2, 2, 1, data_format=fmt), [x])
    name = f"adaptive_avg_pool{n}d"
    _hold(lambda x: getattr(JF, name)(x, 3, data_format=fmt),
          lambda x: getattr(TF, name)(x, 3, data_format=fmt), [x])


POOL_LAYERS = [("AvgPool1D", (3, 2, 1), {}, 1),
               ("AvgPool2D", (3, 2, [1, 0, 0, 1]), dict(exclusive=False), 2),
               ("AvgPool3D", (2, 2, "SAME"), {}, 3),
               ("MaxPool1D", (3, 2, 1), dict(return_mask=True), 1),
               ("MaxPool2D", (3, 2, 1), dict(ceil_mode=True), 2),
               ("MaxPool3D", (2, 1, 0), {}, 3),
               ("AdaptiveAvgPool1D", (4,), {}, 1),
               ("AdaptiveAvgPool2D", ((3, 5),), {}, 2),
               ("AdaptiveAvgPool3D", (2,), {}, 3),
               ("AdaptiveMaxPool1D", (5,), {}, 1),
               ("AdaptiveMaxPool2D", (3,), dict(return_mask=True), 2),
               ("AdaptiveMaxPool3D", ((1, 2, 3),), {}, 3)]


@pytest.mark.parametrize("name,args,kw,n", POOL_LAYERS,
                         ids=[c[0] for c in POOL_LAYERS])
def test_pool_layers_match_reference(name, args, kw, n):
    x = _f(2, 3, *SPATIAL[n], seed=11)
    want = getattr(jnn, name)(*args, **kw)(paddle.to_tensor(x))
    got = getattr(tnn, name)(*args, **kw)(torch.from_numpy(x))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()), **TOL)
