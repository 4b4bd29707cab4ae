"""The reference's signatures for ``amp.auto_cast`` / ``amp.decorate``,
``nn.Embedding`` / ``F.embedding``, ``F.dropout`` / ``nn.Dropout`` and
``F.cross_entropy``, held against the JAX package on the CPU.

Each of these once took the port's own parameters in the reference's
places, so a call written the reference's way computed something else
without a word: a custom op list bound to ``level``, ``padding_idx=0``
read as ``std=0`` (an all-zero table), dropout's ``axis`` read as
``training``, and a class ``weight`` read as ``ignore_index``."""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import amp as jamp

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.core import rng


def _params(fn):
    return list(inspect.signature(fn).parameters)


def _same_signature(pairs):
    for ref, port in pairs:
        assert _params(port) == _params(ref), port


def test_amp_signatures_are_the_reference_ones():
    _same_signature([(jamp.auto_cast.__init__, tamp.auto_cast.__init__),
                     (jamp.decorate, tamp.decorate)])


# ------------------------------------------------------------- amp lists

def test_auto_cast_takes_the_custom_lists():
    """White = WHITE_LIST + custom white; black = (BLACK_LIST + custom
    black) - custom white, as ``paddle_tpu/amp/__init__.py`` builds them:
    the same dtypes come out of both frameworks."""
    xs = np.ones((2, 4), np.float32)
    jl, tl = jnn.Linear(4, 8), tnn.Linear(4, 8, device="cpu")
    jx, tx = paddle.to_tensor(xs), torch.as_tensor(xs)
    cases = [
        # O2 casts everything not black-listed: a black Linear stays f32
        (dict(custom_black_list=["linear"], level="O2"), "linear", "float32"),
        (dict(level="O2"), "linear", "bfloat16"),
        # O1 with a black-listed op made white: softmax runs in bf16
        (dict(custom_white_list=["softmax"]), "softmax", "bfloat16"),
        (dict(), "softmax", "float32"),
        # O1 reads the white list: linear stays white although black too
        (dict(custom_black_list=["linear"]), "linear", "bfloat16"),
    ]
    for kw, op, want in cases:
        with jamp.auto_cast(True, **kw):
            jy = jl(jx) if op == "linear" else JF.softmax(jx)
        with tamp.auto_cast(True, **kw):
            ty = tl(tx) if op == "linear" else TF.softmax(tx)
        assert str(jy.dtype).endswith(want), (kw, jy.dtype)
        assert str(ty.dtype) == f"torch.{want}", (kw, ty.dtype)


def test_auto_cast_binds_a_positional_list_to_the_white_list():
    """``auto_cast(True, ["matmul"])`` binds the list, not the level."""
    with jamp.auto_cast(True, ["softmax"], ["relu"]):
        jstate = (jamp._state.level, set(jamp._state.white),
                  set(jamp._state.black))
    with tamp.auto_cast(True, ["softmax"], ["relu"]):
        tstate = (tamp._state.level, set(tamp._state.white),
                  set(tamp._state.black))
    assert tstate == jstate
    assert tstate[0] == "O1" and "softmax" in tstate[1]
    assert "softmax" not in tstate[2] and "relu" in tstate[2]


def test_decorate_takes_master_weight_and_save_dtype():
    m = tnn.Linear(4, 8, device="cpu")
    out = tamp.decorate(m, None, "O2", "bfloat16", True, "float32")
    assert out is m and m.weight.dtype == torch.bfloat16
    m2, opt = tamp.decorate(models=[tnn.Linear(4, 8, device="cpu")],
                            optimizers="opt", level="O1",
                            master_weight=False, save_dtype="float16")
    assert opt == "opt" and m2[0].weight.dtype == torch.float32


# ------------------------------------------------------------- Embedding

def test_embedding_signature_is_the_reference_one_then_keywords():
    """The port's own extras (``std``, ``device``, ``generator``) come only
    after the reference's parameters, as keywords."""
    _same_signature([(JF.embedding, TF.embedding)])
    ref = _params(jnn.Embedding.__init__)
    port = inspect.signature(tnn.Embedding.__init__).parameters
    assert list(port)[:len(ref)] == ref
    assert all(p.kind is p.KEYWORD_ONLY
               for p in list(port.values())[len(ref):])


def test_embedding_padding_idx_zeroes_that_row_and_its_gradient():
    """``Embedding(10, 4, 0)`` zeroes row 0 only (it once built an
    all-zero table from std 0); a negative index counts from the end; the
    lookup zeroes the pad rows of the output, so no gradient reaches the
    pad row.  Outputs and gradients equal the reference's on its table."""
    ids = np.array([[1, 9, 3], [9, 0, 2]], np.int64)
    for pad, row in ((0, 0), (-1, 9)):
        paddle.seed(3)
        je = jnn.Embedding(10, 4, pad)
        te = tnn.Embedding(10, 4, pad, device="cpu")
        assert te.padding_idx == je.padding_idx == row
        tw = te.weight.detach().numpy()
        assert np.all(tw[row] == 0) and np.all(np.abs(np.delete(tw, row, 0))
                                                .sum(1) > 0)
        with torch.no_grad():
            te.weight.copy_(torch.as_tensor(je.weight.numpy()))
        jo = je(paddle.to_tensor(ids))
        jo.sum().backward()
        to = te(torch.as_tensor(ids))
        to.sum().backward()
        np.testing.assert_array_equal(to.detach().numpy(), jo.numpy())
        np.testing.assert_array_equal(te.weight.grad.numpy(),
                                      je.weight.grad.numpy())
        assert np.all(te.weight.grad.numpy()[row] == 0)
        # the functional form, by position as the reference's
        jf = JF.embedding(paddle.to_tensor(ids), je.weight, row)
        tf = TF.embedding(torch.as_tensor(ids), te.weight, row)
        np.testing.assert_array_equal(tf.detach().numpy(), jf.numpy())


def test_embedding_parts_not_ported_are_refused():
    """Row-sparse gradients are ported: ``Embedding(..., sparse=True)``
    (by position, as the reference's) marks its weight ``sparse_grad``
    and the functional form's gradient is row-sparse.  ``weight_attr`` is
    ported (``ParamAttr``) and sets the table's initializer.  Float ids
    and a weight that is not 2-D are refused with the reference's typed
    ``InvalidArgumentError``."""
    from paddle_tpu.core.errors import InvalidArgumentError as JInvalid
    from paddle_tpu_torch.core.errors import InvalidArgumentError
    te = tnn.Embedding(10, 4, None, True, device="cpu")
    assert te.weight.sparse_grad
    from paddle_tpu_torch import ParamAttr
    te = tnn.Embedding(10, 4, weight_attr=ParamAttr(
        initializer=tnn.initializer.Constant(0.5)), device="cpu")
    assert torch.equal(te.weight.detach(), torch.full((10, 4), 0.5))
    w = torch.zeros(10, 4, requires_grad=True)
    TF.embedding(torch.zeros(2, dtype=torch.long), w, None, True).sum() \
        .backward()
    assert w.grad.is_sparse
    for ids, weight in ((torch.zeros(2), w), (torch.zeros(2, dtype=torch.long),
                                              torch.zeros(10))):
        with pytest.raises(InvalidArgumentError):
            TF.embedding(ids, weight)
        with pytest.raises(JInvalid):
            JF.embedding(paddle.to_tensor(ids.numpy()),
                         paddle.to_tensor(weight.detach().numpy()))


# ------------------------------------------------------- dropout, CE

def test_dropout_and_cross_entropy_signatures_are_the_reference_ones():
    _same_signature([(JF.dropout, TF.dropout),
                     (jnn.Dropout.__init__, tnn.Dropout.__init__),
                     (JF.cross_entropy, TF.cross_entropy)])


def test_dropout_third_argument_is_axis():
    """On 1,000 ones, ``F.dropout(x, 0.5, None)`` trains (axis None) and
    zeroes about half, as the reference; it once read None as
    ``training`` and zeroed none.  Kept values are scaled by 2."""
    x = np.ones(1000, np.float32)
    paddle.seed(0)
    jz = int((JF.dropout(paddle.to_tensor(x), 0.5, None).numpy() == 0)
             .sum())
    with rng.generator_scope(torch.Generator().manual_seed(0)):
        ty = TF.dropout(torch.as_tensor(x), 0.5, None).numpy()
    tz = int((ty == 0).sum())
    # binomial(1000, 0.5): 5 sigma is about 79
    assert 420 < jz < 580 and 420 < tz < 580, (jz, tz)
    assert set(np.unique(ty).tolist()) == {0.0, 2.0}


def test_dropout_axis_and_modes_as_the_reference():
    x = np.arange(1, 25, dtype=np.float32).reshape(4, 6)
    tx = torch.as_tensor(x)
    gen = torch.Generator().manual_seed(1)
    with rng.generator_scope(gen):
        for axis in (1, [1]):
            y = TF.dropout(tx, 0.5, axis).numpy()
            # the mask is drawn over axis 1 and broadcast over axis 0
            cols = (y != 0).all(0)
            assert ((y == 0).all(0) | cols).all()
            np.testing.assert_array_equal(y[:, cols], 2 * x[:, cols])
        y = TF.dropout(tx, 0.5, mode="downscale_in_infer").numpy()
        kept = y != 0
        assert 0 < kept.sum() < x.size
        np.testing.assert_array_equal(y[kept], x[kept])
        layer = tnn.Dropout(0.5, None, "downscale_in_infer")
        assert 0 < (layer(tx).numpy() == 0).sum() < x.size
    # out of training both modes return x unchanged, as the reference
    for mode in ("upscale_in_train", "downscale_in_infer"):
        jy = JF.dropout(paddle.to_tensor(x), 0.5, None, False, mode)
        ty = TF.dropout(tx, 0.5, None, False, mode)
        np.testing.assert_array_equal(ty.numpy(), jy.numpy())
        np.testing.assert_array_equal(ty.numpy(), x)
        assert (tnn.Dropout(0.5, None, mode).eval()(tx) == tx).all()
    with pytest.raises(ValueError):
        TF.dropout(tx, 0.5, mode="upscale")


def test_cross_entropy_never_reads_a_weight_as_ignore_index():
    """``cross_entropy(x, y, w)`` with a class weight: the reference
    weighs the classes; the port once took ``w`` for ``ignore_index``.
    The class-weight path and the other generic paths are ported and
    equal the reference's loss (1e-6); the hard-label path takes the
    reference's keywords and equals the reference's loss."""
    r = np.random.RandomState(0)
    xs = r.randn(6, 5).astype(np.float32)
    ys = r.randint(0, 5, (6,)).astype(np.int64)
    w = np.array([5, 1, 1, 1, 1], np.float32)
    jw = float(JF.cross_entropy(paddle.to_tensor(xs), paddle.to_tensor(ys),
                                paddle.to_tensor(w)).numpy())
    jp = float(JF.cross_entropy(paddle.to_tensor(xs),
                                paddle.to_tensor(ys)).numpy())
    assert np.isfinite(jw) and jw != jp
    tx, ty = torch.as_tensor(xs), torch.as_tensor(ys)
    np.testing.assert_allclose(
        float(TF.cross_entropy(tx, ty, torch.as_tensor(w))), jw, rtol=1e-6)
    for kw in (dict(axis=0), dict(use_softmax=False),
               dict(label_smoothing=0.1)):
        x = np.abs(xs) if "use_softmax" in kw else xs
        y = ys[:5] if "axis" in kw else ys
        x = x[:, :5] if "axis" in kw else x
        ref = JF.cross_entropy(paddle.to_tensor(x), paddle.to_tensor(y),
                               **kw).numpy()
        got = TF.cross_entropy(torch.as_tensor(x), torch.as_tensor(y),
                               **kw).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    for red in ("mean", "sum", "none"):
        ref = JF.cross_entropy(paddle.to_tensor(xs), paddle.to_tensor(ys),
                               None, 2, red, False, -1, True, 0.0).numpy()
        got = TF.cross_entropy(tx, ty, None, 2, red, False, 1, True,
                               0.0).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
