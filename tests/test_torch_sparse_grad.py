"""Row-sparse gradients of paddle_tpu_torch against the JAX package's on
the CPU: the eager sparse lookup (rows, values, the padding row,
accumulation), ``merge_rows``, the lazy row update of the eager step and
of ``jit.TrainStep`` (with remat, with_outputs, a changed batch shape, the
guard, run_steps), the tied-weight demotion, the ``accum_steps`` refusal,
GradScaler / clip / Lamb with sparse gradients and the typed embedding
errors.  Weights and ids are drawn with numpy from a seed; TrainStep
models carry the reference's weights by ``load_paddle_state``.

Tolerances: eager rows, values and merges are exact (the same f32 sums
in the same order); the lazy Adam trajectory 1e-6 (the same f32 update
on the same rows); TrainStep losses and tables over 3 steps 1e-5 (the
forward and backward sum in another order); untouched rows bit-equal.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.selected_rows import RowSparseGrad as JRowSparseGrad
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.optimizer.sparse import merge_rows as jmerge_rows

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core import selected_rows as sr
from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer.sparse import merge_rows
from paddle_tpu_torch.utils import faults

torch.set_num_threads(1)

V, H = 20, 8
TOL = dict(rtol=1e-5, atol=1e-5)


def _w(seed=1):
    return np.random.RandomState(seed).randn(V, H).astype(np.float32)


def _jparam(w, name="w"):
    return paddle.core.tensor.Parameter(paddle.to_tensor(w)._data, name=name)


def test_eager_rows_and_values_match_the_reference():
    ids = np.random.RandomState(0).randint(0, V, (4, 3)).astype(np.int64)
    jw = _jparam(_w())
    jo = JF.embedding(paddle.to_tensor(ids), jw, sparse=True)
    (jo * jo).sum().backward()
    tw = torch.nn.Parameter(torch.from_numpy(_w()))
    to = TF.embedding(torch.from_numpy(ids), tw, sparse=True)
    (to * to).sum().backward()
    assert isinstance(jw.grad, JRowSparseGrad) and tw.grad.is_sparse
    g = sr.RowSparseGrad.of(tw.grad)
    assert g.dense_shape == jw.grad.dense_shape == (V, H)
    np.testing.assert_array_equal(g.rows.numpy(), np.asarray(jw.grad.rows))
    np.testing.assert_array_equal(g.values.numpy(),
                                  np.asarray(jw.grad.values))
    np.testing.assert_array_equal(g.to_dense().numpy(), jw.grad.numpy())
    np.testing.assert_array_equal(sr.dense_grad(tw.grad).numpy(),
                                  jw.grad.numpy())


def test_padding_row_gets_no_gradient():
    ids = np.array([[0, 3, 3, 5]], np.int64)
    jw = _jparam(_w())
    JF.embedding(paddle.to_tensor(ids), jw, padding_idx=3,
                 sparse=True).sum().backward()
    tw = torch.nn.Parameter(torch.from_numpy(_w()))
    TF.embedding(torch.from_numpy(ids), tw, padding_idx=3,
                 sparse=True).sum().backward()
    g = tw.grad.to_dense().numpy()
    np.testing.assert_array_equal(g, jw.grad.numpy())
    assert np.all(g[3] == 0) and np.all(g[0] == 1) and np.all(g[5] == 1)


def test_gradients_accumulate_by_concatenation():
    tw = torch.nn.Parameter(torch.from_numpy(_w()))
    jw = _jparam(_w())
    for ids in ([[1, 2]], [[2, 3]]):
        ids = np.array(ids, np.int64)
        TF.embedding(torch.from_numpy(ids), tw, sparse=True).sum().backward()
        JF.embedding(paddle.to_tensor(ids), jw, sparse=True).sum() \
            .backward()
    g = sr.RowSparseGrad.of(tw.grad)
    np.testing.assert_array_equal(g.rows.numpy(), [1, 2, 2, 3])
    np.testing.assert_array_equal(g.rows.numpy(), np.asarray(jw.grad.rows))
    np.testing.assert_array_equal(g.to_dense().numpy(), jw.grad.numpy())
    both = g + sr.RowSparseGrad.of(tw.grad)
    assert both.rows.shape == (8,)
    np.testing.assert_array_equal(both.to_dense().numpy(),
                                  2 * jw.grad.numpy())


@pytest.mark.parametrize("n", [1, 5, 37])
def test_merge_rows_equals_the_reference(n):
    r = np.random.RandomState(n)
    rows = r.randint(0, 7, (n,)).astype(np.int64)
    vals = r.randn(n, 3).astype(np.float32)
    ju, js = jmerge_rows(paddle.to_tensor(rows)._data,
                         paddle.to_tensor(vals)._data, V)
    tu, ts = merge_rows(torch.from_numpy(rows), torch.from_numpy(vals), V)
    assert tu.dtype == torch.int32 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)
    k = len(set(rows.tolist()))
    assert (tu.numpy()[k:] == V).all() and (tu.numpy()[:k] < V).all()


def _eager(frame, sparse, steps, opt="Adam", **kw):
    """Eager Embedding training: (weights after ``steps``) of the port or
    the reference."""
    if frame == "ref":
        emb = jnn.Embedding(V, H, sparse=sparse)
        emb.weight._set_data(paddle.to_tensor(_w(3))._data)
        o = getattr(paddle.optimizer, opt)(0.1, parameters=emb.parameters(),
                                           **kw)
        for ids in steps:
            out = emb(paddle.to_tensor(ids))
            (out * out).sum().backward()
            o.step()
            o.clear_grad()
        return np.asarray(emb.weight.numpy())
    emb = tnn.Embedding(V, H, sparse=sparse, device="cpu")
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(_w(3)))
    o = getattr(pt.optimizer, opt)(0.1, parameters=emb.parameters(), **kw)
    for ids in steps:
        out = emb(torch.from_numpy(ids))
        (out * out).sum().backward()
        o.step()
        o.clear_grad()
    return emb.weight.detach().numpy()


STEPS = [np.array([[1, 4, 4, 9]], np.int64),
         np.array([[4, 9, 12, 12]], np.int64),
         np.array([[2, 2, 2, 9]], np.int64)]


def test_lazy_adam_first_step_equals_dense():
    np.testing.assert_allclose(_eager("port", True, STEPS[:1]),
                               _eager("port", False, STEPS[:1]), rtol=1e-6,
                               atol=1e-6)


def test_lazy_adam_trajectory_equals_the_reference():
    got = _eager("port", True, STEPS)
    np.testing.assert_allclose(got, _eager("ref", True, STEPS), rtol=1e-6,
                               atol=1e-6)
    untouched = sorted(set(range(V)) - {1, 2, 4, 9, 12})
    np.testing.assert_array_equal(got[untouched], _w(3)[untouched])
    # row 1, touched at step 1 only, keeps its step-1 value (lazy)
    np.testing.assert_array_equal(got[1],
                                  _eager("port", True, STEPS[:1])[1])
    assert np.abs(_eager("port", False, STEPS)[1] - got[1]).max() > 0


def test_adamw_decay_and_momentum_lazy_rows_equal_the_reference():
    for opt, kw in (("AdamW", dict(weight_decay=0.1)),
                    ("Momentum", dict(momentum=0.9, weight_decay=0.01))):
        np.testing.assert_allclose(_eager("port", True, STEPS, opt, **kw),
                                   _eager("ref", True, STEPS, opt, **kw),
                                   rtol=1e-6, atol=1e-6, err_msg=opt)


def test_grad_scaler_clip_and_lamb_with_sparse_gradients():
    emb = tnn.Embedding(V, H, sparse=True, device="cpu")
    o = pt.optimizer.Adam(0.1, parameters=emb.parameters())
    scaler = pt.amp.GradScaler(init_loss_scaling=8.0)
    out = emb(torch.tensor([[1, 2]]))
    scaler.scale(out.sum()).backward()
    scaler.unscale_(o)
    assert emb.weight.grad.is_sparse
    np.testing.assert_array_equal(emb.weight.grad._values().numpy(), 1.0)
    assert not scaler._found_inf
    emb.weight.grad._values()[0, 0] = float("inf")
    scaler2 = pt.amp.GradScaler(init_loss_scaling=8.0)
    scaler2.unscale_(o)
    assert scaler2._found_inf
    # a grad_clip densifies: the clipped step equals the dense one, and
    # the reference's
    clip = dict(grad_clip=pt.nn.ClipGradByGlobalNorm(0.5))
    jclip = dict(grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5))
    got = _eager("port", True, STEPS, "Adam", **clip)
    np.testing.assert_allclose(got, _eager("port", False, STEPS, "Adam",
                                           **clip), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, _eager("ref", True, STEPS, "Adam",
                                           **jclip), rtol=1e-5, atol=1e-6)
    # Lamb reads whole tensors: densified, equal to dense and reference
    got = _eager("port", True, STEPS[:2], "Lamb")
    np.testing.assert_allclose(got, _eager("port", False, STEPS[:2], "Lamb"),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, _eager("ref", True, STEPS[:2], "Lamb"),
                               rtol=1e-5, atol=1e-6)


class JTinyLM(jnn.Layer):
    def __init__(self, sparse):
        super().__init__()
        self.emb = jnn.Embedding(V, H, sparse=sparse)
        self.fc = jnn.Linear(H, V)

    def forward(self, ids):
        return self.fc(self.emb(ids))


class TinyLM(tnn.Layer):
    def __init__(self, sparse):
        super().__init__()
        self.emb = tnn.Embedding(V, H, sparse=sparse, device="cpu")
        self.fc = tnn.Linear(H, V, device="cpu")

    def forward(self, ids):
        return self.fc(self.emb(ids))


def _jloss(logits, label):
    return JF.cross_entropy(logits.reshape([-1, V]), label.reshape([-1]))


def _tloss(logits, label):
    return TF.cross_entropy(logits.reshape([-1, V]), label.reshape([-1]))


def _batches(shapes, seed=0):
    r = np.random.RandomState(seed)
    return [(r.randint(0, V, s).astype(np.int64),
             r.randint(0, V, s).astype(np.int64)) for s in shapes]


_REF = {}


def _ref_run(variant, shapes, sparse=True):
    """The reference's TrainStep over ``shapes``: (initial state, losses,
    final state), cached per case."""
    key = (variant, tuple(shapes), sparse)
    if key not in _REF:
        paddle.seed(0)
        m = JTinyLM(sparse)
        init = {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}
        o = paddle.optimizer.Adam(0.05, parameters=m.parameters())
        step = JTrainStep(m, _jloss, o, remat=variant == "remat",
                          with_outputs=variant == "with_outputs")
        losses = [float(step(paddle.to_tensor(i), paddle.to_tensor(y)))
                  for i, y in _batches(shapes)]
        _REF[key] = (init, losses, {k: np.asarray(v.numpy())
                                    for k, v in m.state_dict().items()})
    return _REF[key]


def _port(init, sparse=True, **kw):
    m = TinyLM(sparse)
    pt.load_paddle_state(m, init)
    o = pt.optimizer.Adam(0.05, parameters=m.parameters())
    return m, TrainStep(m, _tloss, o, **kw)


@pytest.mark.parametrize("variant,shapes", [
    ("plain", [(4, 6)] * 3), ("remat", [(4, 6)] * 3),
    ("with_outputs", [(4, 6)] * 3), ("shape", [(4, 6), (2, 6), (4, 6)])])
def test_train_step_sparse_equals_the_reference(variant, shapes):
    init, ref_losses, ref_state = _ref_run(variant, shapes)
    m, step = _port(init, remat=variant == "remat",
                    with_outputs=variant == "with_outputs")
    losses = []
    for ids, y in _batches(shapes):
        losses.append(float(step(torch.from_numpy(ids),
                                 torch.from_numpy(y))))
        if variant == "with_outputs":
            (out,) = step.last_outputs
            np.testing.assert_allclose(float(_tloss(out, torch.from_numpy(
                y))), losses[-1], rtol=1e-6)
    np.testing.assert_allclose(losses, ref_losses, **TOL)
    for k, v in m.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref_state[k], err_msg=k, **TOL)
    seen = set(np.concatenate([b[0].ravel() for b in _batches(shapes)]))
    untouched = sorted(set(range(V)) - seen)
    np.testing.assert_array_equal(m.emb.weight.detach().numpy()[untouched],
                                  init["emb.weight"][untouched])
    assert step.compile_counts()["total"] == len(set(shapes))


def test_train_step_sparse_first_step_equals_dense():
    init, _, _ = _ref_run("plain", [(4, 6)] * 3)
    (ids, y), = _batches([(4, 6)])
    out = []
    for sparse in (True, False):
        m, step = _port(init, sparse)
        loss = float(step(torch.from_numpy(ids), torch.from_numpy(y)))
        out.append((loss, {k: v.numpy().copy()
                           for k, v in m.state_dict().items()}))
    assert abs(out[0][0] - out[1][0]) < 1e-6
    for k in out[0][1]:
        np.testing.assert_allclose(out[0][1][k], out[1][1][k], rtol=2e-6,
                                   atol=1e-6, err_msg=k)


def test_guarded_sparse_step_moves_nothing_when_poisoned(monkeypatch):
    init, _, _ = _ref_run("plain", [(4, 6)] * 3)
    faults.reset()
    monkeypatch.setenv("PDTPU_FAULT_NAN_GRADS", "2")
    try:
        m, step = _port(init, guard=True)
        batches = _batches([(4, 6)] * 3)
        step(*map(torch.from_numpy, batches[0]))
        before = {k: v.clone() for k, v in m.state_dict().items()}
        moments = [t.clone() for s in step._opt_state.values()
                   for t in s.values()]
        step(*map(torch.from_numpy, batches[1]))
        assert not bool(step.last_guard[1])
        for k, v in m.state_dict().items():
            assert torch.equal(v, before[k]), k
        now = [t for s in step._opt_state.values() for t in s.values()]
        assert all(torch.equal(a, b) for a, b in zip(now, moments))
        step(*map(torch.from_numpy, batches[2]))
        assert bool(step.last_guard[1])
        assert not torch.equal(m.emb.weight, before["emb.weight"])
    finally:
        faults.reset()


def test_run_steps_equals_per_call_steps():
    init, _, _ = _ref_run("plain", [(4, 6)] * 3)
    batches = _batches([(4, 6)] * 3)
    m1, s1 = _port(init)
    per_call = [float(s1(*map(torch.from_numpy, b))) for b in batches]
    m2, s2 = _port(init)
    multi = s2.run_steps(torch.from_numpy(np.stack([b[0] for b in batches])),
                         torch.from_numpy(np.stack([b[1] for b in batches])))
    np.testing.assert_array_equal(multi.numpy(), np.float32(per_call))
    for k, v in m1.state_dict().items():
        assert torch.equal(m2.state_dict()[k], v), k


class JTiedLM(jnn.Layer):
    def __init__(self, sparse=True):
        super().__init__()
        self.emb = jnn.Embedding(V, H, sparse=sparse)

    def forward(self, ids):
        from paddle_tpu.tensor.linalg import matmul
        return matmul(self.emb(ids), self.emb.weight, transpose_y=True)


class TiedLM(tnn.Layer):
    def __init__(self, sparse=True):
        super().__init__()
        self.emb = tnn.Embedding(V, H, sparse=sparse, device="cpu")

    def forward(self, ids):
        return self.emb(ids) @ self.emb.weight.T


def test_tied_weight_is_demoted_to_a_dense_gradient():
    (ids, y), = _batches([(2, 4)])
    paddle.seed(0)
    jm = JTiedLM(True)
    init = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    js = JTrainStep(jm, _jloss, paddle.optimizer.Adam(
        0.05, parameters=jm.parameters()))
    with pytest.warns(UserWarning, match="dense"):
        ref = [float(js(paddle.to_tensor(ids), paddle.to_tensor(y)))
               for _ in range(3)]
    results = {}
    for sparse in (True, False):
        m = TiedLM(sparse)
        pt.load_paddle_state(m, init)
        step = TrainStep(m, _tloss, pt.optimizer.Adam(
            0.05, parameters=m.parameters()))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            losses = [float(step(torch.from_numpy(ids), torch.from_numpy(y)))
                      for _ in range(3)]
        msgs = [str(w.message) for w in caught
                if issubclass(w.category, UserWarning) and "dense" in
                str(w.message)]
        assert len(msgs) == (1 if sparse else 0)
        if sparse:
            assert "emb.weight" in msgs[0]
        results[sparse] = (losses, m.emb.weight.detach().numpy().copy())
    np.testing.assert_allclose(results[True][0], results[False][0],
                               rtol=1e-6)
    np.testing.assert_allclose(results[True][1], results[False][1],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(results[True][0], ref, **TOL)
    np.testing.assert_allclose(results[True][1],
                               np.asarray(jm.emb.weight.numpy()), **TOL)
    # the hard guard for direct callers
    m = TiedLM(True)
    ids_t = torch.from_numpy(ids)

    def probe(vals):
        ctx = sr.SparseGradContext("apply", zeros={"emb.weight@0": torch.zeros(
            ids.size, H, requires_grad=True)}, names={id(m.emb.weight):
                                                      "emb.weight"})
        with sr.use_ctx(ctx):
            return m(ids_t).sum()
    with pytest.raises(ValueError, match="emb.weight"):
        sr.check_embedding_only_use(probe, {"emb.weight": m.emb.weight})
    assert sr.dense_consumed_keys(
        lambda v: TinyLM(True).emb(ids_t).sum(), {}) == set()


def test_accum_steps_with_a_sparse_weight_is_refused():
    m = TinyLM(True)
    with pytest.raises(NotImplementedError, match="accum_steps"):
        TrainStep(m, _tloss, pt.optimizer.Adam(0.05,
                                               parameters=m.parameters()),
                  accum_steps=2)
    TrainStep(TinyLM(False), _tloss, pt.optimizer.Adam(
        0.05, parameters=m.parameters()), accum_steps=2)


def test_embedding_errors_are_typed():
    w = torch.zeros(V, H)
    with pytest.raises(InvalidArgumentError, match="integer"):
        TF.embedding(torch.zeros(2), w, sparse=True)
    with pytest.raises(InvalidArgumentError, match="2-D"):
        TF.embedding(torch.zeros(2, dtype=torch.long), torch.zeros(V))
