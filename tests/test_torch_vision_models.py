"""paddle_tpu_torch's MobileNetV1 / V2, VGG and LeNet, ResNet's fused
classifier tail and ``fused_pool_linear_cross_entropy`` against the JAX
package on the CPU.  Weights are the reference's (``load_paddle_state``);
inputs are drawn with numpy from a seed.  The fused BatchNorm sites take
their kernels' plain versions here.

Sizes: MobileNetV1 / V2 at scale 0.25, VGG-11-BN's features
(``num_classes=0``) and LeNet; conv nets at 8 x 3 x 64 x 64, whose last
stage normalizes over 2 x 2 x 8 = 32 rows ("Small-batch BatchNorm",
ROADMAP); LeNet at 8 x 1 x 28 x 28.

Tolerances, as ResNet-18's test: train-mode outputs within 1e-4 of the
largest |value| (every BatchNorm's statistics summed in another order),
eval-mode within 1e-5; VGG-11-BN's features and LeNet over 2 f32
Momentum steps: losses within 1e-4 relative, every parameter within 0.01
lr of the reference's, running statistics within 1e-4 of their largest
|value| plus 1e-6 (the batch means after a normalized projection are zero
up to rounding, so some tensors hold only rounding).  The fused tail's losses and gradients within 1e-5 (relative
plus 1e-5 of the largest |value|).  MobileNetV2's classifier dropout is
set to 0 on both sides: the two frameworks draw other masks.

The MobileNets are held over one step, tensor by tensor.  At their
initialization the gradient is discontinuous at the ReLU / ReLU6 kinks:
an activation within rounding of a kink lands on either side, and moves
its tensor's gradient by its share of the tensor's rows.  Measured on
this draw, the port's own f32 gradient against its f64 one, or under a
1e-7 relative change of the input, moves by up to 2.9e-2 (V1) / 8.4e-3
(V2) of a tensor's norm, and by up to 0.3 lr elementwise after a step;
the port against the reference by up to 3.7e-2 / 1.0e-2.  A larger
input or batch does not shrink that (V1 at 128^2 or at B 16: larger).
So after the first step (loss within 1e-4 relative) each parameter's
update lies within UPDATE_TOL of the reference's in norm, every element
within 0.5 lr, and the whole update within cos 0.999; a tensor whose
update is zero by the math (rms under ZERO_TOL lr: a BatchNorm scale
before a depthwise convolution + BatchNorm, a projection's bias before a
convolution + BatchNorm, at init) lies elementwise within ZERO_TOL lr.
Running statistics within 1e-4.  By a second step of lr 0.01 the two
trajectories are apart (V1's second loss 3.0e-2 relative from the
reference's, a tensor's update up to 1.3 of its norm).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor, unwrap
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit import state_arrays
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.fused_ce import \
    fused_pool_linear_cross_entropy as jfused
from paddle_tpu.vision import models as jvm

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.errors import UnimplementedError
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import fused_bn_act as TK
from paddle_tpu_torch.ops.fused_ce import fused_pool_linear_cross_entropy
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as tvm

torch.set_num_threads(1)

LR = 0.01
STEPS = 2
UPDATE_TOL, ZERO_TOL = 0.1, 3e-4   # the MobileNets' step, per tensor
_RUNNING = ("_mean", "_variance")
MODELS = {
    "mobilenet_v1": (dict(scale=0.25, num_classes=10), (8, 3, 64, 64)),
    "mobilenet_v2": (dict(scale=0.25, num_classes=10), (8, 3, 64, 64)),
    "vgg11": (dict(batch_norm=True, num_classes=0), (8, 3, 64, 64)),
    "LeNet": (dict(), (8, 1, 28, 28)),
}


def _np_state(model):
    return {k: np.asarray(v) for k, v in state_arrays(model).items()}


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
                 .max() / max(float(np.abs(b).max()), 1e-30))


def _batch(shape, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randint(0, 10, (shape[0],)).astype(np.int64))


@pytest.fixture(scope="module")
def refs():
    out = {}
    for name, (kw, _) in MODELS.items():
        paddle.seed(0)
        jm = getattr(jvm, name)(**kw)
        out[name] = (jm, _np_state(jm))
    return out


def _port(name, state):
    tm = getattr(tvm, name)(**MODELS[name][0], device="cpu")
    return pt.load_paddle_state(tm, state)


@pytest.mark.parametrize("name", list(MODELS))
def test_state_names_and_forward_match_reference(refs, name):
    jm, state = refs[name]
    tm = _port(name, state)
    assert set(tm.state_dict()) == set(state)
    x, _ = _batch(MODELS[name][1])
    if name == "mobilenet_v2":
        jm.classifier[0].p = tm.classifier[0].p = 0.0
    for training, tol in ((False, 1e-5), (True, 1e-4)):
        jm.train() if training else jm.eval()
        want = jm(paddle.to_tensor(x)).numpy()
        with torch.no_grad():
            got = tm.train(training)(torch.from_numpy(x)).numpy()
        assert _rel(got, want) <= tol, training
    jm.train()
    pt.load_paddle_state(tm, state)


def _loss_fns(name):
    """(reference loss_fn, port loss_fn, uses the fused tail)."""
    if name == "mobilenet_v1":   # model(x, labels): the fused tail
        return (lambda out, y: out.mean()), (lambda out, y: out.mean()), True
    if name == "vgg11":          # the features alone
        return ((lambda out, y: (out * out).mean()),
                (lambda out, y: (out * out).mean()), False)
    return ((lambda lg, y: JF.cross_entropy(lg, y)),
            (lambda lg, y: TF.cross_entropy(lg, y)), False)


@pytest.mark.parametrize("name", list(MODELS))
def test_train_steps_match_reference(name):
    """f32 Momentum TrainSteps from the reference's weights: two for
    VGG-11-BN's features and LeNet, one for the MobileNets (held tensor by
    tensor, see the module's docstring)."""
    paddle.seed(0)
    jm = getattr(jvm, name)(**MODELS[name][0])
    init = _np_state(jm)
    tm = _port(name, init)
    if name == "mobilenet_v2":
        jm.classifier[0].p = 0.0
        tm.classifier[0].p = 0.0
    jloss, tloss, tail = _loss_fns(name)
    jstep = JTrainStep(jm, jloss, paddle.optimizer.Momentum(
        learning_rate=LR, momentum=0.9, parameters=jm.parameters()))
    tstep = TrainStep(tm, tloss, Momentum(learning_rate=LR, momentum=0.9,
                                          parameters=tm.parameters()))
    x, y = _batch(MODELS[name][1], seed=1)
    jb = [paddle.to_tensor(x)] + [paddle.to_tensor(y)] * (2 if tail else 1)
    tb = [torch.from_numpy(x)] + [torch.from_numpy(y)] * (2 if tail else 1)
    steps = 1 if name.startswith("mobilenet") else STEPS
    want = [float(jstep(*jb).numpy()) for _ in range(steps)]
    got = [float(tstep(*tb)) for _ in range(steps)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    own = {k: v.numpy() for k, v in tm.state_dict().items()}
    final = _np_state(jm)
    bound = 0.5 if steps == 1 else 0.01
    for k, v in final.items():
        if k.endswith(_RUNNING):
            np.testing.assert_allclose(
                own[k], v, rtol=0, atol=1e-4 * float(np.abs(v).max()) + 1e-6,
                err_msg=k)
        else:
            assert float(np.abs(own[k] - v).max()) <= bound * LR, k
    keys = [k for k in final if not k.endswith(_RUNNING)]
    if steps == 1:
        for k in keys:
            a, b = own[k] - init[k], final[k] - init[k]
            if np.linalg.norm(b) / np.sqrt(b.size) < ZERO_TOL * LR:
                assert float(np.abs(a - b).max()) <= ZERO_TOL * LR, k
            else:
                rel = np.linalg.norm(a - b) / np.linalg.norm(b)
                assert rel <= UPDATE_TOL, (k, rel)
    got_up = np.concatenate([(own[k] - init[k]).ravel() for k in keys])
    want_up = np.concatenate([(final[k] - init[k]).ravel() for k in keys])
    cos = float(got_up @ want_up / np.linalg.norm(got_up)
                / np.linalg.norm(want_up))
    assert cos >= 0.999, cos


def test_fused_sites_per_step():
    """The models' fused BatchNorm sites, counted on the wrappers over one
    training forward and backward: MobileNetV1 27 single sites;
    MobileNetV2 45 of its 52 BatchNorms, ten of them with the residual
    fused in (the projections of the seven blocks without a shortcut have
    no activation and no residual, so their forward_fused is a plain
    batch_norm, as the reference's forward makes it); VGG-11-BN's 8
    BatchNorms, 5 of them pooled (K9) and 3 not."""
    names = ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx",
             "bn_pool_apply")
    want = {"mobilenet_v1": (27, 27, 27, 27, 0),
            "mobilenet_v2": (45, 45, 45, 45, 0),
            "vgg11": (8, 3, 3, 3, 5)}
    x, _ = _batch((2, 3, 32, 32))
    for name, counts in want.items():
        tm = getattr(tvm, name)(**MODELS[name][0], device="cpu")
        c0 = [getattr(TK, n).calls for n in names]
        out = tm.train()(torch.from_numpy(x))
        out.float().sum().backward()
        got = tuple(getattr(TK, n).calls - c for n, c in zip(names, c0))
        assert got == counts, name


def test_pretrained_is_refused_and_the_aliases_exist():
    for fn in (tvm.mobilenet_v1, tvm.mobilenet_v2, tvm.vgg16):
        with pytest.raises(UnimplementedError):
            fn(pretrained=True, device="cpu")
    assert tvm.mobilenetv1.MobileNetV1 is tvm.MobileNetV1
    assert tvm.mobilenetv2.MobileNetV2 is tvm.MobileNetV2


# ---------------------------------------------------- the fused classifier tail

def test_resnet_labels_need_the_pool_and_the_classifier():
    tm = tvm.resnet18(num_classes=0, device="cpu")
    x = torch.zeros(1, 3, 32, 32)
    with pytest.raises(ValueError):
        tm(x, labels=torch.zeros(1, dtype=torch.int64))
    mm = tvm.MobileNetV1(0.25, 10, with_pool=False, device="cpu")
    with pytest.raises(ValueError):
        mm(x, labels=torch.zeros(1, dtype=torch.int64))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_fused_pool_linear_cross_entropy_and_gradients(fmt, bias):
    rng = np.random.RandomState(3)
    shape = (6, 8, 5, 4) if fmt == "NCHW" else (6, 5, 4, 8)
    feats = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(8, 12) * 0.3).astype(np.float32)
    b = rng.randn(12).astype(np.float32) if bias else None
    y = rng.randint(0, 12, (6,)).astype(np.int64)
    cot = rng.rand(6).astype(np.float32)
    arrays = [feats, w] + ([b] if bias else [])

    def ref(*xs):
        out = unwrap(jfused(Tensor(xs[0]), Tensor(xs[1]),
                            Tensor(jnp.asarray(y)),
                            bias=Tensor(xs[2]) if bias else None,
                            data_format=fmt))
        return (out * cot).sum(), out
    (_, want), wgrads = jax.jit(jax.value_and_grad(
        ref, argnums=tuple(range(len(arrays))), has_aux=True))(
        *[jnp.asarray(a) for a in arrays])
    ins = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = fused_pool_linear_cross_entropy(
        ins[0], ins[1], torch.from_numpy(y), bias=ins[2] if bias else None,
        data_format=fmt)
    (got * torch.from_numpy(cot)).sum().backward()
    for g, r in zip([got.detach()] + [t.grad for t in ins],
                    [want] + list(wgrads)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * max(float(np.abs(r).max()),
                                                   1.0))
