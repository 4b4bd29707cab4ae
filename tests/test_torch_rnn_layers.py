"""paddle_tpu_torch's RNN layers (``RNN``, ``BiRNN``, ``SimpleRNN``,
``LSTM``, ``GRU``) against the JAX package on the CPU: 2 layers, forward
and bidirectional, batch- and time-major, with ``sequence_length`` and
initial states in Paddle's (num_layers * num_directions, B, H) layout, on
the reference's weights (``load_paddle_state``).  Outputs, final states
and the gradients of every parameter, the input and the initial states
within 1e-5 (relative, plus 1e-5 of the tensor's largest |value|: sums in
another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import functional_call, state_arrays

import paddle_tpu_torch as pt

torch.set_num_threads(1)

B, T, F, HID = 3, 7, 5, 6
LENS = np.array([7, 4, 1], np.int64)


def _f(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=tol, atol=tol * max(float(np.abs(want).max()), 1.0))


def _flat(out):
    """The leaves of (outputs, states), in order."""
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _flat(o)]
    return [out]


def _wrapped(pkg, inner, fn):
    class Wrap(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.inner = inner

        def forward(self, *xs):
            return fn(self.inner, *xs)
    return Wrap()


def _parity(make, fn, floats, consts, seed=3):
    """``make(pkg)`` in both packages on the reference's weights, run as
    ``fn(layer, *floats, *consts)``: every output leaf and the gradients
    of sum(leaf * cot) over the leaves, for every parameter and every
    float input."""
    paddle.seed(seed)
    jl = _wrapped(paddle, make(paddle), fn)
    tl = _wrapped(pt, make(pt), fn)
    state = {k: np.asarray(v) for k, v in state_arrays(jl).items()}
    pt.load_paddle_state(tl, state)

    def cots(leaves):
        return [np.random.RandomState(50 + i).randn(*x.shape).astype(
            np.float32) for i, x in enumerate(leaves)]

    def ref_loss(st, xs):
        out = _flat(functional_call(jl, st, *[Tensor(x) for x in xs],
                                    *[Tensor(jnp.asarray(c))
                                      for c in consts]))
        return sum((o * jnp.asarray(c)).sum()
                   for o, c in zip(out, cots(out))), out
    (_, rout), (rgs, rgx) = jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in state.items()},
        [jnp.asarray(a) for a in floats])
    ins = [torch.tensor(a, requires_grad=True) for a in floats]
    out = _flat(tl(*ins, *[torch.from_numpy(c) for c in consts]))
    sum((o * torch.from_numpy(c)).sum()
        for o, c in zip(out, cots(out))).backward()
    assert len(out) == len(rout)
    for o, r in zip(out, rout):
        _close(o.detach().numpy(), r)
    params = dict(tl.named_parameters())
    assert set(params) == set(state)
    for k in state:
        _close(params[k].grad.numpy(), rgs[k])
    for t, g in zip(ins, rgx):
        _close(t.grad.numpy(), g)


LAYERS = ["SimpleRNN", "LSTM", "GRU"]


@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("name", LAYERS)
def test_stacked_layers_match_reference(name, direction):
    """2 layers, batch-major, ``sequence_length`` (7, 4, 1) and initial
    states: outputs zero past each length, final states held there."""
    dirs = 2 if direction == "bidirect" else 1
    x = _f(B, T, F, seed=1)
    h0 = _f(2 * dirs, B, HID, seed=2)
    c0 = _f(2 * dirs, B, HID, seed=3)

    def make(pkg):
        return getattr(pkg.nn, name)(F, HID, num_layers=2,
                                     direction=direction)
    if name == "LSTM":
        _parity(make, lambda m, x, h, c, lens: m(x, (h, c), lens),
                [x, h0, c0], [LENS])
    else:
        _parity(make, lambda m, x, h, lens: m(x, h, lens), [x, h0], [LENS])


@pytest.mark.parametrize("name", LAYERS)
def test_time_major_without_lengths_or_states(name):
    """time_major=True, no ``sequence_length``, states from zeros; the
    SimpleRNN with relu."""
    x = _f(T, B, F, seed=4)
    kw = {"activation": "relu"} if name == "SimpleRNN" else {}

    def make(pkg):
        return getattr(pkg.nn, name)(F, HID, num_layers=2, time_major=True,
                                     **kw)
    _parity(make, lambda m, x: m(x), [x], [])


@pytest.mark.parametrize("reverse", [False, True], ids=["fw", "reverse"])
def test_rnn_wrapper_over_a_cell(reverse):
    """``RNN(LSTMCell, is_reverse)``: a reversed pass starts at each row's
    own last element (the padding masked by the original position)."""
    x = _f(B, T, F, seed=5)

    def make(pkg):
        return pkg.nn.RNN(pkg.nn.LSTMCell(F, HID), is_reverse=reverse)
    _parity(make, lambda m, x, lens: m(x, None, lens), [x], [LENS])


def test_birnn_over_gru_cells_with_states():
    x = _f(B, T, F, seed=6)
    h_fw, h_bw = _f(B, HID, seed=7), _f(B, HID, seed=8)

    def make(pkg):
        return pkg.nn.BiRNN(pkg.nn.GRUCell(F, HID), pkg.nn.GRUCell(F, HID))
    _parity(make, lambda m, x, a, b, lens: m(x, (a, b), lens),
            [x, h_fw, h_bw], [LENS])


def test_reversed_pass_equals_the_forward_pass_of_reversed_rows():
    """The reversed pass on padded rows: row b's outputs are the forward
    pass over its own first LENS[b] elements reversed, zeros past it."""
    cell = pt.nn.GRUCell(F, HID)
    x = torch.from_numpy(_f(B, T, F, seed=9))
    out, last = pt.nn.RNN(cell, is_reverse=True)(x, None,
                                                 torch.from_numpy(LENS))
    fw = pt.nn.RNN(cell)
    for b, n in enumerate(LENS):
        want, wlast = fw(x[b:b + 1, :n].flip(1))
        torch.testing.assert_close(out[b, :n], want[0].flip(0))
        torch.testing.assert_close(last[b], wlast[0])
        assert not out[b, n:].any()


def test_dropout_only_between_layers():
    """Training dropout changes a 2-layer LSTM's output and leaves a
    1-layer one's unchanged (nothing lies between layers); eval ignores
    it."""
    x = torch.from_numpy(_f(B, T, F, seed=10))
    for layers, changed in ((1, False), (2, True)):
        torch.manual_seed(0)
        base = pt.nn.LSTM(F, HID, num_layers=layers)
        drop = pt.nn.LSTM(F, HID, num_layers=layers, dropout=0.5)
        drop.set_state_dict(base.state_dict())
        with pt.core.rng.generator_scope(torch.Generator().manual_seed(1)):
            got = drop(x)[0]
        assert (not torch.equal(got, base(x)[0])) == changed
        drop.eval()
        assert torch.equal(drop(x)[0], base(x)[0])


def test_state_names_are_the_references():
    paddle.seed(0)
    for name in LAYERS:
        ref = getattr(paddle.nn, name)(F, HID, num_layers=2,
                                       direction="bidirect")
        port = getattr(pt.nn, name)(F, HID, num_layers=2,
                                    direction="bidirect")
        assert list(port.state_dict()) == list(ref.state_dict())
