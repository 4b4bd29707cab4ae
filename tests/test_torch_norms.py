"""paddle_tpu_torch's norm layers and functionals against the JAX package
on the CPU: ``BatchNorm`` (the fluid layer, with ``act``), BatchNorm1D /
3D on rank 2, 3 and 5 inputs, ``SyncBatchNorm`` and
``convert_sync_batchnorm``, GroupNorm, InstanceNorm1D / 2D / 3D,
LocalResponseNorm, RMSNorm, SpectralNorm and ``normalize``, each on the
reference's weights (``load_paddle_state``), with the running statistics
a training forward leaves; then the ``PDTPU_FUSED_BN=0`` switch against
the fused path, and ``forward_fused``'s composite branch.

Tolerances: outputs and gradients within 1e-5 relative plus 1e-5 of the
tensor's largest |value| (the statistics are summed in another order);
running statistics within 1e-5 of their largest |value|.  Batches keep at
least 18 rows per channel ("Small-batch BatchNorm", ROADMAP)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor, unwrap
from paddle_tpu.jit import state_arrays

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.ops import fused_bn_act as TK

torch.set_num_threads(1)


def _f(*shape, seed=0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) + shift).astype(
        np.float32)


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-5 * max(float(np.abs(want).max()), 1.0))


def _state(jl):
    return {k: np.asarray(v) for k, v in state_arrays(jl).items()}


def _pair(name, *args, seed=0, **kw):
    """The reference layer and the port's with its state."""
    paddle.seed(seed)
    jl = getattr(jnn, name)(*args, **kw)
    tl = getattr(tnn, name)(*args, **kw)
    state = _state(jl)
    for k, v in state.items():   # non-trivial affine and statistics
        if v.dtype == np.float32 and k.split(".")[-1] in (
                "weight", "bias", "_mean", "_variance"):
            state[k] = v + _f(*v.shape, seed=len(k)) * 0.1
    pt.load_paddle_state(tl, state)
    jl.set_state_dict(state)
    return jl, tl


def _forward_both(jl, tl, x, training):
    jl.train() if training else jl.eval()
    tl.train(training)
    want = jl(paddle.to_tensor(x)).numpy()
    got = tl(torch.from_numpy(x)).detach().numpy()
    _close(got, want)
    if training:   # the running statistics a training forward leaves
        own = tl.state_dict()
        for k, v in _state(jl).items():
            _close(own[k].numpy(), v)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name,args,shape", [
    ("BatchNorm1D", (5,), (24, 5)),
    ("BatchNorm1D", (5,), (6, 5, 4)),
    ("BatchNorm2D", (5,), (2, 5, 3, 4)),
    ("BatchNorm3D", (5,), (2, 5, 3, 2, 3)),
], ids=["bn1d-rank2", "bn1d-rank3", "bn2d", "bn3d-rank5"])
def test_batch_norms_of_every_rank(name, args, shape, training):
    jl, tl = _pair(name, *args)
    _forward_both(jl, tl, _f(*shape, seed=1, shift=0.5), training)


def test_batch_norm_channel_last_rank3():
    jl, tl = _pair("BatchNorm1D", 5, data_format="NLC")
    _forward_both(jl, tl, _f(4, 6, 5, seed=2), True)


@pytest.mark.parametrize("act", [None, "relu", "tanh"])
def test_fluid_batch_norm_with_act(act):
    jl, tl = _pair("BatchNorm", 4, act=act, momentum=0.8)
    x = _f(3, 4, 3, 3, seed=3)
    _forward_both(jl, tl, x, True)
    _forward_both(jl, tl, x, False)


def test_fluid_batch_norm_parameters_in_the_reference_order():
    tl = tnn.BatchNorm(4, "relu", 0.5, 1e-3, None, False, "float32", "NHWC",
                       False, True)
    assert tl._act == "relu" and tl.momentum == 0.5 and tl.epsilon == 1e-3
    assert tl.bias is None and tl.data_format == "NHWC"
    assert tl.use_global_stats is True


def test_sync_batch_norm_is_batch_norm_on_one_process():
    jl, tl = _pair("SyncBatchNorm", 4)
    _forward_both(jl, tl, _f(3, 4, 3, 3, seed=4), True)


def _small_net(mod):
    return mod.Sequential(mod.Conv2D(3, 4, 3, padding=1), mod.BatchNorm2D(4),
                          mod.ReLU(),
                          mod.Sequential(mod.Conv2D(4, 4, 1),
                                         mod.BatchNorm2D(4)))


def test_convert_sync_batchnorm_shares_the_state():
    paddle.seed(5)
    jm = _small_net(jnn)
    tm = _small_net(tnn)
    pt.load_paddle_state(tm, _state(jm))
    params = {k: v for k, v in tm.named_parameters()}
    before = set(tm.state_dict())
    out = tnn.SyncBatchNorm.convert_sync_batchnorm(tm)
    jnn.SyncBatchNorm.convert_sync_batchnorm(jm)
    assert out is tm
    assert isinstance(tm[1], tnn.SyncBatchNorm)
    assert isinstance(tm[3][1], tnn.SyncBatchNorm)
    assert set(tm.state_dict()) == before == set(_state(jm))
    for k, v in tm.named_parameters():
        assert v is params[k], k
    x = _f(2, 3, 6, 6, seed=6)
    _forward_both(jm, tm, x, True)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_group_norm(fmt):
    jl, tl = _pair("GroupNorm", 2, 6, data_format=fmt)
    shape = (2, 6, 4, 3) if fmt == "NCHW" else (2, 4, 3, 6)
    _forward_both(jl, tl, _f(*shape, seed=7, shift=1.0), True)


@pytest.mark.parametrize("name,shape", [
    ("InstanceNorm1D", (3, 4, 7)), ("InstanceNorm2D", (3, 4, 5, 3)),
    ("InstanceNorm3D", (2, 4, 3, 3, 2))])
def test_instance_norms(name, shape):
    jl, tl = _pair(name, 4)
    _forward_both(jl, tl, _f(*shape, seed=8, shift=-0.5), True)
    jn = getattr(jnn, name)(4, weight_attr=False)
    tn = getattr(tnn, name)(4, weight_attr=False)
    assert tn.weight is None and tn.bias is None and not tn.state_dict()
    x = _f(*shape, seed=9)
    _close(tn(torch.from_numpy(x)).numpy(), jn(paddle.to_tensor(x)).numpy())


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_local_response_norm(fmt):
    jl, tl = _pair("LocalResponseNorm", 3, 0.3, 0.6, 1.5, fmt)
    _forward_both(jl, tl, _f(2, 5, 4, 6, seed=10), False)


def test_rms_norm():
    jl, tl = _pair("RMSNorm", 6, 1e-5)
    _forward_both(jl, tl, _f(3, 4, 6, seed=11), True)


def test_spectral_norm_on_the_reference_vectors():
    """The reference's weight_u / weight_v (parameters that take no
    gradient) carried over; power iteration does not write them back."""
    jl, tl = _pair("SpectralNorm", (6, 2, 3), 1, 2)
    assert set(tl.state_dict()) == {"weight_u", "weight_v"}
    assert not tl.weight_u.requires_grad
    w = _f(6, 2, 3, seed=12)
    u0 = tl.weight_u.detach().clone()
    _close(tl(torch.from_numpy(w)).numpy(),
           jl(paddle.to_tensor(w)).numpy())
    assert torch.equal(tl.weight_u, u0)


def _ref_grads(fn, arrays):
    def loss(*xs):
        out = unwrap(fn(*[Tensor(x) for x in xs]))
        cot = jnp.asarray(np.random.RandomState(13).randn(*out.shape),
                          out.dtype)
        return (out * cot).sum(), out
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(arrays))), has_aux=True))(
        *[jnp.asarray(a) for a in arrays])
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_grads(fn, arrays):
    ins = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ins)
    cot = torch.from_numpy(np.random.RandomState(13).randn(
        *out.shape).astype(np.float32))
    (out * cot).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ins]


FUNCTIONALS = [
    ("instance_norm", [(2, 3, 5, 4), (3,), (3,)],
     lambda F: lambda x, w, b: F.instance_norm(x, None, None, w, b)),
    ("group_norm", [(2, 4, 3, 5), (4,), (4,)],
     lambda F: lambda x, w, b: F.group_norm(x, 2, 1e-5, w, b)),
    ("group_norm_nhwc", [(2, 3, 5, 4), (4,), (4,)],
     lambda F: lambda x, w, b: F.group_norm(x, 4, 1e-5, w, b, "NHWC")),
    ("local_response_norm", [(2, 6, 3, 3)],
     lambda F: lambda x: F.local_response_norm(x, 4, 0.2, 0.75, 2.0)),
    ("normalize", [(3, 5, 4)], lambda F: lambda x: F.normalize(x)),
    ("normalize_p1_axis2", [(3, 5, 4)],
     lambda F: lambda x: F.normalize(x, 1.0, 2)),
    ("rms_norm", [(3, 7), (7,)], lambda F: lambda x, w: F.rms_norm(x, w)),
    ("batch_norm_rank5", [(2, 3, 3, 2, 3), (3,), (3,)],
     lambda F: lambda x, w, b: F.batch_norm(
         x, None, None, w, b, training=True, data_format="NCDHW")),
]


@pytest.mark.parametrize("name,shapes,make", FUNCTIONALS,
                         ids=[c[0] for c in FUNCTIONALS])
def test_functionals_and_their_gradients(name, shapes, make):
    arrays = [_f(*s, seed=14 + i, shift=0.3) for i, s in enumerate(shapes)]
    want, wgrads = _ref_grads(make(JF), arrays)
    got, grads = _port_grads(make(TF), arrays)
    _close(got, want)
    for g, w in zip(grads, wgrads):
        _close(g, w)


# --------------------------------------------------- the PDTPU_FUSED_BN switch

def _fused_case(monkeypatch, switch, form):
    """One fused_bn_act / fused_dual_bn_act training call from fresh
    statistics: (output, running mean, running var, gradient of x, the
    kernels' plain calls, the entries' composite calls)."""
    monkeypatch.setenv("PDTPU_FUSED_BN", switch)
    x = torch.tensor(_f(4, 3, 6, 6, seed=15, shift=0.2), requires_grad=True)
    r = torch.tensor(_f(4, 3, 6, 6, seed=16))
    w, b = torch.tensor(_f(3, seed=17)), torch.tensor(_f(3, seed=18))
    rm, rv = torch.zeros(3), torch.ones(3)
    names = ("bn_stats", "bn_apply", "bn_pool_apply")
    entries = (TK.bn_act_train, TK.bn2_act_train, TK.bn_act_pool_train)
    c0 = [getattr(TK, n).calls for n in names]
    k0 = [e.composite_calls for e in entries]
    if form == "dual":
        out = TF.fused_dual_bn_act(x, rm, rv, w, b, r, torch.zeros(3),
                                   torch.ones(3), w, b, activation="relu")
    else:
        out = TF.fused_bn_act(
            x, rm, rv, w, b, activation="relu6",
            residual=r if form == "residual" else None,
            pool=("max", 3, 2, 1) if form == "pool" else None)
    out.sum().backward()
    return (out.detach(), rm, rv, x.grad,
            [getattr(TK, n).calls - c for n, c in zip(names, c0)],
            [e.composite_calls - k for e, k in zip(entries, k0)])


@pytest.mark.parametrize("form", ["plain", "residual", "pool", "dual"])
def test_fused_bn_switch_takes_the_composite(monkeypatch, form):
    """PDTPU_FUSED_BN=0, read at each call: batch_norm plus the composite
    tail (and the pooling functional) reach no fused-BN wrapper, count one
    composite call on their entry, and agree with the fused path."""
    fused = _fused_case(monkeypatch, "1", form)
    comp = _fused_case(monkeypatch, "0", form)
    for a, b in zip(fused[:4], comp[:4]):
        _close(b.numpy(), a.numpy())
    assert fused[4][0] > 0 and fused[5] == [0, 0, 0]
    assert comp[4] == [0, 0, 0]
    want = {"plain": [1, 0, 0], "residual": [1, 0, 0], "pool": [0, 0, 1],
            "dual": [0, 1, 0]}[form]
    assert comp[5] == want


# --------------------------------------------------- forward_fused's composite

class _ActBN(tnn.BatchNorm2D):
    def forward(self, x):
        return super().forward(x) * 2.0


class _JActBN(jnn.BatchNorm2D):
    def forward(self, x):
        return super().forward(x) * 2.0


def test_forward_fused_of_a_subclass_with_its_own_forward():
    """A subclass with its own forward: forward_fused bypasses it for an
    activation the kernels take and runs it, then the composite tail, for
    one they do not (gelu), as the reference's _fused_impl does."""
    paddle.seed(19)
    jl, tl = _JActBN(3), _ActBN(3)
    pt.load_paddle_state(tl, _state(jl))
    x = _f(4, 3, 5, 5, seed=20)
    for act in ("relu", "gelu"):
        want = jl.forward_fused(paddle.to_tensor(x), activation=act).numpy()
        got = tl.forward_fused(torch.from_numpy(x), activation=act)
        _close(got.detach().numpy(), want)
        for k, v in _state(jl).items():
            _close(tl.state_dict()[k].numpy(), v)
