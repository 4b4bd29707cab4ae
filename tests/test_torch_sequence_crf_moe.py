"""paddle_tpu_torch's sequence ops, linear-chain CRF, hierarchical
sigmoid loss and mixture of experts against the JAX package on the CPU.

- The ten padded-plus-lengths sequence ops: values, and gradients of the
  float ones, within 1e-6 (relative, plus 1e-6 of the largest |value|).
- ``linear_chain_crf``: the NLL and its gradients within 1e-5 (f32
  log-sum-exp over another summation order); ``crf_decoding``: the
  Viterbi paths exactly.
- ``hsigmoid_loss`` (default tree and a custom one): 1e-5.
- ``moe_ffn`` / ``MoELayer`` with capacity drops: outputs, the auxiliary
  loss and gradients within 1e-5.
The expert-parallel step is a case of the four-rank group of
tests/test_torch_parallel.py.
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
from paddle_tpu.nn.functional import moe as jmoe

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF

torch.set_num_threads(1)

LENS = np.array([5, 0, 3, 7], np.int64)


def _f(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got.astype(np.float64), want.astype(np.float64), rtol=tol,
        atol=tol * max(float(np.abs(want).max()) if want.size else 0, 1.0))


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _same(make, floats, consts=(), tol=1e-6, grads=True, jit=True):
    """``make(F)(*floats, *consts)`` in both packages: every float output
    leaf, and the gradients of sum(leaf * cot) for the float inputs (the
    reference's jitted, unless its extent depends on the data)."""
    jconsts = [Tensor(jnp.asarray(c)) for c in consts]

    def loss(*xs):
        out = _leaves(make(JF)(*[Tensor(x) for x in xs], *jconsts))
        out = [unwrap(o) for o in out]
        tot = sum((o * jnp.asarray(np.random.RandomState(30 + i).randn(
            *o.shape), o.dtype)).sum() for i, o in enumerate(out)
            if jnp.issubdtype(o.dtype, jnp.floating))
        return tot, out
    vg = jax.value_and_grad(loss, argnums=tuple(range(len(floats))),
                            has_aux=True)
    (_, rout), rgrads = (jax.jit(vg) if jit else vg)(
        *[jnp.asarray(a) for a in floats])
    ins = [torch.tensor(a, requires_grad=grads) for a in floats]
    out = _leaves(make(TF)(*ins, *[torch.from_numpy(np.asarray(c))
                                   for c in consts]))
    tot = sum((o * torch.from_numpy(np.random.RandomState(30 + i).randn(
        *o.shape).astype(np.float32))).sum() for i, o in enumerate(out)
        if o.is_floating_point())
    assert len(out) == len(rout)
    for o, r in zip(out, rout):
        _close(o.detach().numpy(), r, tol)
    if grads:
        tot.backward()
        for t, g in zip(ins, rgrads):
            _close(t.grad.numpy(), g, tol)


SEQUENCE = [
    ("pad", lambda F: lambda x, n: F.sequence_pad(x, n, 8, -1.0),
     (15, 3), "packed"),
    ("pad_maxlen_none", lambda F: lambda x, n: F.sequence_pad(x, n),
     (15, 3), "packed"),
    ("unpad", lambda F: F.sequence_unpad, (4, 7, 3), "padded"),
    ("pool_sum", lambda F: lambda x, n: F.sequence_pool(x, n, "sum"),
     (4, 7, 3), "padded"),
    ("pool_average", lambda F: lambda x, n: F.sequence_pool(x, n, "AVERAGE",
                                                            0.5),
     (4, 7, 3), "padded"),
    ("pool_sqrt", lambda F: lambda x, n: F.sequence_pool(x, n, "sqrt"),
     (4, 7, 3), "padded"),
    ("pool_max", lambda F: lambda x, n: F.sequence_pool(x, n, "max"),
     (4, 7, 3), "padded"),
    ("pool_min", lambda F: lambda x, n: F.sequence_pool(x, n, "min"),
     (4, 7), "padded"),
    ("pool_first", lambda F: lambda x, n: F.sequence_pool(x, n, "first"),
     (4, 7, 3), "padded"),
    ("first_step", lambda F: lambda x, n: F.sequence_first_step(x),
     (4, 7, 3), "padded"),
    ("last_step", lambda F: F.sequence_last_step, (4, 7, 3), "padded"),
    ("softmax", lambda F: F.sequence_softmax, (4, 7), "padded"),
    ("reverse", lambda F: F.sequence_reverse, (4, 7, 2), "padded"),
    ("expand_as", lambda F: lambda x, n: F.sequence_expand_as(x, n, 9),
     (4, 3), "padded"),
]


@pytest.mark.parametrize("name,make,shape,kind", SEQUENCE,
                         ids=[c[0] for c in SEQUENCE])
def test_sequence_ops(name, make, shape, kind):
    _same(make, [_f(*shape, seed=1)], [LENS], jit=name != "pad_maxlen_none")


def test_sequence_concat_and_enumerate():
    other = np.array([2, 4, 0, 1], np.int64)
    _same(lambda F: lambda a, b, n, m: F.sequence_concat([a, b], [n, m]),
          [_f(4, 7, 3, seed=2), _f(4, 5, 3, seed=3)], [LENS, other],
          jit=False)
    ids = np.random.RandomState(4).randint(1, 50, (4, 7)).astype(np.int64)
    for lens in (None, LENS):
        want = np.asarray(JF.sequence_enumerate(
            paddle.to_tensor(ids), 3, None if lens is None
            else paddle.to_tensor(lens), pad_value=-1).numpy())
        got = TF.sequence_enumerate(
            torch.from_numpy(ids), 3, None if lens is None
            else torch.from_numpy(lens), pad_value=-1)
        np.testing.assert_array_equal(got.numpy(), want)


def test_sequence_pool_refuses_an_unknown_type():
    from paddle_tpu_torch.core.errors import InvalidArgumentError
    with pytest.raises(InvalidArgumentError):
        TF.sequence_pool(torch.zeros(2, 3), torch.tensor([1, 2]), "median")


# ------------------------------------------------------------------- CRF

N_TAGS, T = 5, 7
CRF_LENS = np.array([7, 3, 1, 5], np.int64)


def _crf_inputs(seed=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(4, T, N_TAGS).astype(np.float32) * 2,
            rng.randn(N_TAGS + 2, N_TAGS).astype(np.float32),
            rng.randint(0, N_TAGS, (4, T)).astype(np.int64))


def test_linear_chain_crf_nll_and_gradients():
    emit, trans, label = _crf_inputs()
    _same(lambda F: lambda e, tr, lab, n: F.linear_chain_crf(e, lab, tr, n),
          [emit, trans], [label, CRF_LENS], tol=1e-5)


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_crf_decoding_paths_exactly(seed):
    emit, trans, _ = _crf_inputs(seed)
    want = np.asarray(JF.crf_decoding(
        paddle.to_tensor(emit), paddle.to_tensor(trans),
        paddle.to_tensor(CRF_LENS)).numpy())
    got = TF.crf_decoding(torch.from_numpy(emit), torch.from_numpy(trans),
                          torch.from_numpy(CRF_LENS))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[1, 3:].any()


def test_crf_decoding_is_the_best_path_by_brute_force():
    """On one short row, the decoded path scores at least every other."""
    import itertools
    emit, trans, _ = _crf_inputs(9)
    e = emit[0, :4]
    got = TF.crf_decoding(torch.from_numpy(emit[:1, :4]),
                          torch.from_numpy(trans),
                          torch.tensor([4]))[0].tolist()

    def score(p):
        s = trans[0, p[0]] + trans[1, p[-1]] + sum(e[i, t]
                                                   for i, t in enumerate(p))
        return s + sum(trans[2 + a, b] for a, b in zip(p, p[1:]))
    best = max(itertools.product(range(N_TAGS), repeat=4), key=score)
    assert tuple(got) == best


@pytest.mark.parametrize("custom", [False, True], ids=["default", "custom"])
def test_hsigmoid_loss_and_gradients(custom):
    k, d = 6, 5
    rng = np.random.RandomState(10)
    x = rng.randn(4, d).astype(np.float32)
    label = np.array([0, 5, 2, 3], np.int64)
    w = rng.randn(k - 1, d).astype(np.float32)
    b = rng.randn(k - 1).astype(np.float32)
    if custom:
        table = np.array([[0, 1, -1], [0, 2, 4], [3, -1, -1], [0, 2, 3]],
                         np.int64)
        code = rng.randint(0, 2, table.shape).astype(np.int64)
        _same(lambda F: lambda x, w, b, lab, pt_, pc: F.hsigmoid_loss(
            x, lab, k, w, b, pt_, pc), [x, w, b], [label, table, code],
            tol=1e-5)
    else:
        _same(lambda F: lambda x, w, b, lab: F.hsigmoid_loss(x, lab, k, w, b),
              [x, w, b], [label], tol=1e-5)
        _same(lambda F: lambda x, w, lab: F.hsigmoid_loss(x, lab, k, w),
              [x, w], [label], tol=1e-5)


# ------------------------------------------------------------------- MoE

def _moe_args(t=24, d=8, f=16, e=4, seed=11):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, t // 2, d).astype(np.float32),
            rng.randn(d, e).astype(np.float32),
            (rng.randn(e, d, f) * 0.3).astype(np.float32),
            (rng.randn(e, f) * 0.1).astype(np.float32),
            (rng.randn(e, f, d) * 0.3).astype(np.float32),
            (rng.randn(e, d) * 0.1).astype(np.float32)]


@pytest.mark.parametrize("top_k,factor,act", [(2, 0.5, "gelu"),
                                              (1, 1.0, "relu"),
                                              (2, 2.0, "silu")])
def test_moe_ffn_outputs_aux_and_gradients(top_k, factor, act):
    """Capacity factor 0.5 drops tokens (the capacity is a quarter of the
    choices); the outputs, the aux loss and every gradient agree."""
    args = _moe_args()
    ref = jmoe._raw_moe_ffn

    def jloss(*a):
        y, aux = ref(*a, top_k=top_k, capacity_factor=factor, activation=act)
        return jnp.sum(y ** 2) + aux, (y, aux)
    (_, (jy, jaux)), jgr = jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True)(
        *[jnp.asarray(a) for a in args])
    ins = [torch.tensor(a, requires_grad=True) for a in args]
    y, aux = TF.moe_ffn(*ins, top_k=top_k, capacity_factor=factor,
                        activation=act)
    ((y ** 2).sum() + aux).backward()
    _close(y.detach().numpy(), jy, 1e-5)
    _close(float(aux), float(jaux), 1e-5)
    assert aux.dtype == torch.float32
    for t, g in zip(ins, jgr):
        _close(t.grad.numpy(), g, 1e-5)
    if factor < 1.0:
        dropped = (y.detach().abs().sum(-1) == 0).sum()
        assert dropped > 0


def test_moe_layer_on_the_reference_weights():
    paddle.seed(12)
    jl = jnn.MoELayer(8, 16, 4, top_k=2, capacity_factor=1.0)
    tl = tnn.MoELayer(8, 16, 4, top_k=2, capacity_factor=1.0)
    state = {k: np.asarray(v) for k, v in state_arrays(jl).items()}
    assert list(tl.state_dict()) == list(state)
    state = {k: v + _f(*v.shape, seed=len(k)) * 0.1 for k, v in state.items()}
    pt.load_paddle_state(tl, state)
    x = _f(3, 5, 8, seed=13)

    def ref_loss(st):
        y = functional_call(jl, st, Tensor(jnp.asarray(x)))
        return (y ** 2).sum(), y
    (_, jy), jg = jax.value_and_grad(ref_loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in state.items()})
    y = tl(torch.from_numpy(x))
    (y ** 2).sum().backward()
    _close(y.detach().numpy(), jy, 1e-5)
    jl.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    jl(paddle.to_tensor(x))
    _close(float(tl.aux_loss), float(jl.aux_loss.numpy()), 1e-5)
    for k, p in tl.named_parameters():
        _close(p.grad.numpy(), jg[k], 1e-5)
