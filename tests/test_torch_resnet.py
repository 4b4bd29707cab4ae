"""paddle_tpu_torch's ResNet training path against the JAX package on the
CPU: the conv-net leg that runs the fused BatchNorm kernels K5-K9 (their
plain versions here).  Weights are carried by ``load_paddle_state``,
velocities by ``load_paddle_opt_state``; inputs are drawn with numpy from
a seed and handed to both.  The reference runs on its own CPU path (its
plain fused-BN references under ``jax.jit``).

Sizes: ResNet-18 with 6 classes; its logits at 4 x 3 x 32 x 32.  The
training steps take 8 x 3 x 64 x 64: at 32 x 32 with batch 4 the last
stage's BatchNorms normalize over 4 rows each, and a step there turns
f32 rounding noise into different updates; at 64 x 64 with batch 8 they
see 32 rows.  ResNet-50's train-mode logits at 2 x 3 x 96 x 96 (18 rows in
the last stage) and eval-mode logits at 2 x 3 x 32 x 32.

Tolerances, with their reasons:
- train-mode logits: within 1e-4 (ResNet-18) and 1e-3 (ResNet-50) of the
  largest |logit|: the statistics of every BatchNorm are summed in
  another order, and a BatchNorm over few rows amplifies that; eval-mode
  logits within 1e-5 of it; running statistics within 1e-5 of each
  tensor's largest |value|.
- f32 steps (Momentum 0.01 / 0.9): losses within 1e-4 relative; after 3
  steps every parameter within 0.01 lr of the reference's, the running
  statistics within 1e-4 of each tensor's largest |value|, every velocity
  within 2e-3 (a parameter moves lr times its velocity).
- one O2 bf16 step: bf16 rounds at other places in the two frameworks
  (the batch statistics of a bf16 activation are summed in another order,
  so a normalized value may round to its bf16 neighbour) and 20 BatchNorm
  layers pass that on; in either framework the O2 step's update points
  within cos 0.95 of its own f32 update.  So: the loss within 1e-2
  relative, every parameter within 0.5 lr of the reference's (the first
  Momentum step moves a parameter by lr * gradient), and the whole update
  within cos 0.9 of the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit import functional_call, state_arrays
from paddle_tpu.nn import functional as JF
from paddle_tpu.vision import models as jvm

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.errors import UnimplementedError
from paddle_tpu_torch.jit import TrainStep, layout_policy
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import fused_bn_act as TK
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as tvm

# tiny shapes gain nothing from intra-op threads, and idle OpenMP threads
# spinning would take cores from the test files running beside this one
torch.set_num_threads(1)

LR = 0.01
CLASSES = 6
STEPS = 3
_RUNNING = ("_mean", "_variance")


def _np_state(model):
    return {k: np.asarray(v) for k, v in state_arrays(model).items()}


def _batch(n, hw, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3, hw, hw).astype(np.float32),
            rng.randint(0, CLASSES, (n,)).astype(np.int64))


def _port18(state):
    tm = tvm.resnet18(num_classes=CLASSES, device="cpu")
    return pt.load_paddle_state(tm, state)


def _ref_logits(jm, state, x, training):
    """The reference's logits (and, training, its running-statistics
    updates) from one jitted forward."""
    def fwd(s, x):
        bufs = {}
        out = functional_call(jm, s, x, training=training,
                              buffer_updates=bufs if training else None)
        return out, bufs
    out, bufs = jax.jit(fwd)({k: jnp.asarray(v) for k, v in state.items()},
                             jnp.asarray(x))
    return np.asarray(out), {k: np.asarray(v) for k, v in bufs.items()}


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
                 .max() / max(float(np.abs(b).max()), 1e-30))


@pytest.fixture(scope="module")
def ref18():
    paddle.seed(0)
    jm = jvm.resnet18(num_classes=CLASSES)
    return jm, _np_state(jm)


def test_state_names_match_the_reference(ref18):
    _, state = ref18
    tm = _port18(state)
    assert set(tm.state_dict()) == set(state)
    assert "layer2.0.downsample.1._variance" in state
    assert not any(k.endswith("conv1.bias") for k in state)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_resnet18_logits_match_reference(ref18, training):
    jm, state = ref18
    x, _ = _batch(4, 32)
    want, bufs = _ref_logits(jm, state, x, training)
    tm = _port18(state).train(training)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= (1e-4 if training else 1e-5)
    if training:   # the running statistics of one training forward
        assert len(bufs) == 2 * 20
        own = tm.state_dict()
        for k, v in bufs.items():
            assert _rel(own[k].numpy(), v) <= 1e-5, k


def _ref_steps(amp, steps):
    paddle.seed(0)
    jm = jvm.resnet18(num_classes=CLASSES)
    init = _np_state(jm)
    opt = paddle.optimizer.Momentum(learning_rate=LR, momentum=0.9,
                                    parameters=jm.parameters())
    step = JTrainStep(jm, lambda lg, y: JF.cross_entropy(lg, y), opt,
                      amp_level=amp)
    x, y = _batch(8, 64)
    losses, mid = [], None
    for i in range(steps):
        losses.append(float(step(paddle.to_tensor(x),
                                 paddle.to_tensor(y)).numpy()))
        if i == steps - 2:
            mid = (_np_state(jm), jax.tree_util.tree_map(
                np.asarray, step._opt_state), opt._step_count)
    opt_state = jax.tree_util.tree_map(np.asarray, step._opt_state)
    return dict(init=init, losses=losses, mid=mid, final=_np_state(jm),
                opt=opt_state)


@pytest.fixture(scope="module")
def ref_f32_run():
    return _ref_steps(None, STEPS)


def _port_step(state, amp=None, guard=False, accum=1):
    tm = _port18(state)
    opt = Momentum(learning_rate=LR, momentum=0.9,
                   parameters=tm.parameters())
    return tm, TrainStep(tm, lambda lg, y: TF.cross_entropy(lg, y), opt,
                         amp_level=amp, guard=guard, accum_steps=accum)


def _run(step, x, y):
    return float(step(torch.from_numpy(x), torch.from_numpy(y)))


def _assert_state(tm, want, param_tol_lr=0.01):
    own = tm.state_dict()
    for k, v in want.items():
        got = own[k].float().numpy()
        if k.endswith(_RUNNING):
            assert _rel(got, v) <= 1e-4, k
        else:
            assert float(np.abs(got - v).max()) <= param_tol_lr * LR, k


def test_trainstep_matches_reference(ref_f32_run):
    run = ref_f32_run
    tm, step = _port_step(run["init"])
    x, y = _batch(8, 64)
    losses = [_run(step, x, y) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-4)
    assert losses[-1] < losses[0]
    _assert_state(tm, run["final"])
    for k, slots in run["opt"].items():
        diff = step._opt_state[k]["velocity"].numpy() - slots["velocity"]
        assert float(np.abs(diff).max()) <= 2e-3, k


def test_resume_from_reference_velocities(ref_f32_run):
    """load_paddle_opt_state carries the reference's velocities: one port
    step from the reference's state after step 2 lands on its state after
    step 3."""
    run = ref_f32_run
    weights, opt_state, count = run["mid"]
    tm, step = _port_step(weights)
    pt.load_paddle_opt_state(step, opt_state, step_count=count)
    assert all(s["velocity"].dtype == torch.float32
               for s in step._opt_state.values())
    x, y = _batch(8, 64)
    np.testing.assert_allclose(_run(step, x, y), run["losses"][-1],
                               rtol=1e-4)
    _assert_state(tm, run["final"])


def test_one_o2_step_matches_reference():
    run = _ref_steps("O2", 1)
    tm, step = _port_step(run["init"], amp="O2")
    x, y = _batch(8, 64)
    loss = _run(step, x, y)
    np.testing.assert_allclose(loss, run["losses"][0], rtol=1e-2)
    own = tm.state_dict()
    keys = [k for k in run["final"] if not k.endswith(_RUNNING)]
    for k in keys:
        assert own[k].dtype == torch.float32, k
        diff = np.abs(own[k].numpy() - run["final"][k]) / LR
        assert diff.max() <= 0.5, (k, diff.max())

    def update(state):
        return np.concatenate([(state[k] - run["init"][k]).ravel()
                               for k in keys])
    got = update({k: v.numpy() for k, v in own.items()})
    want = update(run["final"])
    cos = float(got @ want / np.linalg.norm(got) / np.linalg.norm(want))
    assert cos >= 0.9, cos


def test_guard_keeps_the_state_of_a_poisoned_step(ref18):
    _, state = ref18
    tm, step = _port_step(state, guard=True)
    x, y = _batch(4, 32)
    _run(step, x, y)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    vel = {k: v["velocity"].clone() for k, v in step._opt_state.items()}
    bad = x.copy()
    bad[0, 0, 0, 0] = np.nan
    assert not np.isfinite(_run(step, bad, y))
    assert not bool(step.last_guard[1])
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in step._opt_state.items():
        assert torch.equal(v["velocity"], vel[k]), k
    _run(step, x, y)
    assert bool(step.last_guard[1])
    assert not torch.equal(tm.state_dict()["bn1._mean"], before["bn1._mean"])


def test_accum_steps_compounds_the_running_statistics(ref18):
    """accum_steps=2: the running statistics after one step equal those of
    two eager training forwards over the two micro-batches in turn."""
    _, state = ref18
    tm, step = _port_step(state, accum=2)
    x, y = _batch(8, 32)
    _run(step, x, y)
    eager = _port18(state).train()
    with torch.no_grad():
        for half in np.split(x, 2):
            eager(torch.from_numpy(half))
    want = eager.state_dict()
    for k, v in tm.state_dict().items():
        if k.endswith(_RUNNING):
            assert _rel(v.numpy(), want[k].numpy()) <= 1e-6, k


def test_layout_policy_nhwc_matches_nchw(ref18):
    """layout_policy("NHWC") (channels-last memory, logical NCHW) and a
    model built with data_format="NHWC" on (N, H, W, C) inputs give the
    NCHW model's logits and gradients."""
    _, state = ref18
    x, y = _batch(4, 32)
    out = {}
    for mode in ("nchw", "policy", "nhwc"):
        df = "NHWC" if mode == "nhwc" else "NCHW"
        tm = tvm.resnet18(num_classes=CLASSES, device="cpu", data_format=df)
        pt.load_paddle_state(tm, state)
        xt = torch.from_numpy(x)
        if mode == "nhwc":
            xt = xt.permute(0, 2, 3, 1)
        with layout_policy("NHWC" if mode == "policy" else None):
            logits = tm(xt)
            loss = TF.cross_entropy(logits, torch.from_numpy(y))
            grads = torch.autograd.grad(loss, list(tm.parameters()))
        out[mode] = (logits.detach(), grads)
    for mode in ("policy", "nhwc"):
        assert _rel(out[mode][0].numpy(), out["nchw"][0].numpy()) <= 1e-5
        for g, w in zip(out[mode][1], out["nchw"][1]):
            assert _rel(g.numpy(), w.numpy()) <= 1e-4


def test_labels_path_waits_for_a_later_slice(ref18):
    tm = _port18(ref18[1])
    x, y = _batch(2, 32)
    with pytest.raises(UnimplementedError):
        tm(torch.from_numpy(x), labels=torch.from_numpy(y))


def test_resnet50_logits_and_kernel_calls():
    """ResNet-50's logits against the reference's (train and eval), and
    one training forward and backward through the fused-BN wrappers: 53
    K5, 48 K6 and 1 K9 forward (44 bn_act_train sites, 4 dual, the pooled
    stem), 48 K7 and 48 K8 backward, and no layout copy in the forward
    under layout_policy("NHWC")."""
    paddle.seed(0)
    jm = jvm.resnet50(num_classes=CLASSES)
    state = _np_state(jm)
    tm = tvm.resnet50(num_classes=CLASSES, device="cpu")
    pt.load_paddle_state(tm, state)
    for training, (n, hw), tol in ((False, (2, 32), 1e-5),
                                   (True, (2, 96), 1e-3)):
        x, _ = _batch(n, hw)
        want, _ = _ref_logits(jm, state, x, training)
        with torch.no_grad():
            got = tm.train(training)(torch.from_numpy(x)).numpy()
        assert _rel(got, want) <= tol, training
    names = ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx",
             "bn_pool_apply")
    relayouts = (TK.bn_act_train, TK.bn2_act_train, TK.bn_act_pool_train)
    x, y = _batch(2, 32)
    c0 = {n: getattr(TK, n).calls for n in names}
    r0 = sum(e.relayouts for e in relayouts)
    with layout_policy("NHWC"):
        loss = TF.cross_entropy(tm.train()(torch.from_numpy(x)),
                                torch.from_numpy(y))
        fwd = {n: getattr(TK, n).calls - c0[n] for n in names}
        assert sum(e.relayouts for e in relayouts) == r0
        loss.backward()
    bwd = {n: getattr(TK, n).calls - c0[n] - fwd[n] for n in names}
    assert fwd == {"bn_stats": 53, "bn_apply": 48, "bn_bwd_reduce": 0,
                   "bn_bwd_dx": 0, "bn_pool_apply": 1}
    assert bwd == {"bn_stats": 0, "bn_apply": 0, "bn_bwd_reduce": 48,
                   "bn_bwd_dx": 48, "bn_pool_apply": 0}
