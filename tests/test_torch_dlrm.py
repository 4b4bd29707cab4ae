"""paddle_tpu_torch's DLRM against the JAX package's on the CPU:
``dlrm_tiny_config()`` in the "sparse" and "dense" modes on the
reference's weights (``load_paddle_state``): logits, three ``TrainStep``
steps of Adam and of SGD (losses and the table), the sparse step against
the dense one, and the refused modes.  Inputs come from a numpy seed.

Tolerances: 1e-5 (the same f32 arithmetic; matmuls and the BCE mean sum
in another order); sparse against dense at the first step 1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import dlrm as jdlrm

import paddle_tpu_torch as pt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (DLRM, DLRMConfig, DLRMCriterion,
                                     dlrm_tiny_config)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
B = 8


def _batches(n, seed=0):
    cfg = dlrm_tiny_config()
    r = np.random.RandomState(seed)
    return [(r.randn(B, cfg.dense_dim).astype(np.float32),
             np.stack([r.randint(0, v, B) for v in cfg.vocab_sizes],
                      1).astype(np.int64),
             (r.rand(B, 1) < 0.25).astype(np.float32)) for _ in range(n)]


def _ref(mode, opt="Adam", steps=3):
    paddle.seed(0)
    m = jdlrm.DLRM(jdlrm.dlrm_tiny_config(), embedding=mode)
    init = {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}
    o = getattr(paddle.optimizer, opt)(0.05, parameters=m.parameters())
    step = JTrainStep(m, jdlrm.DLRMCriterion(), o)
    losses = [float(step(*map(paddle.to_tensor, b)))
              for b in _batches(steps)]
    return m, init, losses


def _port(mode, init, opt="Adam"):
    m = DLRM(dlrm_tiny_config(), embedding=mode, device="cpu")
    pt.load_paddle_state(m, init)
    o = getattr(pt.optimizer, opt)(0.05, parameters=m.parameters())
    return m, TrainStep(m, DLRMCriterion(), o)


@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_logits_equal_the_reference(mode):
    paddle.seed(0)
    jm = jdlrm.DLRM(jdlrm.dlrm_tiny_config(), embedding=mode)
    m = DLRM(dlrm_tiny_config(), embedding=mode, device="cpu")
    assert list(m.state_dict()) == list(jm.state_dict())
    pt.load_paddle_state(m, {k: np.asarray(v.numpy())
                             for k, v in jm.state_dict().items()})
    sparse = getattr(m.table.weight, "sparse_grad", False)
    assert sparse == (mode == "sparse")
    x, ids, _ = _batches(1)[0]
    ref = jm(paddle.to_tensor(x), paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(ids)).numpy()
    assert got.shape == (B, 1)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("mode,opt", [("sparse", "Adam"), ("dense", "Adam"),
                                      ("sparse", "SGD"), ("dense", "SGD")])
def test_train_step_equals_the_reference(mode, opt):
    jm, init, ref_losses = _ref(mode, opt)
    m, step = _port(mode, init, opt)
    losses = [float(step(*map(torch.from_numpy, b))) for b in _batches(3)]
    np.testing.assert_allclose(losses, ref_losses, **TOL)
    for k, v in m.state_dict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(
            jm.state_dict()[k].numpy()), err_msg=k, **TOL)
    if mode == "sparse":
        cfg = dlrm_tiny_config()
        seen = {int(i) for _, ids, _ in _batches(3)
                for i in (ids + cfg.offsets[None]).ravel()}
        cold = sorted(set(range(cfg.total_rows)) - seen)
        np.testing.assert_array_equal(m.table.weight.detach().numpy()[cold],
                                      init["table.weight"][cold])


def test_sparse_first_step_equals_dense():
    _, init, _ = _ref("sparse", steps=0)
    out = {}
    for mode in ("sparse", "dense"):
        m, step = _port(mode, init)
        loss = float(step(*map(torch.from_numpy, _batches(1)[0])))
        out[mode] = (loss, {k: v.numpy().copy()
                            for k, v in m.state_dict().items()})
    assert abs(out["sparse"][0] - out["dense"][0]) < 1e-6
    for k, v in out["sparse"][1].items():
        np.testing.assert_allclose(v, out["dense"][1][k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_other_modes_are_refused():
    """"sharded" (one shard without a started group) and "external" (no
    table: the forward takes the gathered rows) are built; an unknown mode
    is still refused."""
    cfg = DLRMConfig()
    assert cfg.num_features == 4 and cfg.total_rows == 256
    np.testing.assert_array_equal(cfg.offsets, [0, 64, 128, 192])
    sharded = DLRM(cfg, embedding="sharded", device="cpu")
    assert tuple(sharded.table.weight.shape) == (256, 8)
    assert sharded.table.weight.sparse_grad
    ext = DLRM(cfg, embedding="external", device="cpu")
    assert ext.table is None and "table.weight" not in ext.state_dict()
    rows = torch.randn(2, 4, 8)
    assert tuple(ext(torch.randn(2, 4), rows).shape) == (2, 1)
    with pytest.raises(ValueError, match="unknown embedding mode"):
        DLRM(cfg, embedding="lazy", device="cpu")
