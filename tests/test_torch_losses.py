"""paddle_tpu_torch's loss functions and loss layers against the JAX
package's on the CPU: the 18 public functions of
``nn/functional/loss.py`` (every ``cross_entropy`` path: a class weight,
soft labels, float labels of the logits' shape, another axis,
``use_softmax=False``, label smoothing on hard and soft labels,
``ignore_index`` with a weight) for every reduction, and the 13 layers of
``nn/layer/loss.py``.  Each case holds the value and the gradient of the
summed loss with respect to each float input against the reference's,
with f32 inputs drawn with numpy from a seed; signatures are the
reference's.

Tolerance 1e-5 (relative and absolute): the same f32 formulas, summed in
another order.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
R = np.random.RandomState(0)


def _f(*shape):
    return R.randn(*shape).astype(np.float32)


def _prob(*shape, axis=-1):
    e = np.exp(_f(*shape))
    return (e / e.sum(axis, keepdims=True)).astype(np.float32)


def _int(high, *shape):
    return R.randint(0, high, shape).astype(np.int64)


def _pm1(*shape):
    return np.where(R.rand(*shape) < 0.5, -1.0, 1.0).astype(np.float32)


def _ctc():
    logp = np.log(_prob(6, 2, 5))
    return [logp, np.array([[1, 2, 2], [3, 4, 0]], np.int64),
            np.array([6, 5], np.int64), np.array([3, 2], np.int64)]


RED = ("mean", "sum", "none")
# (function, inputs, keywords, reductions or None); float inputs are
# differentiated
CASES = [
    ("cross_entropy", [_f(5, 7), _int(7, 5)], {}, RED),
    ("cross_entropy", [_f(5, 7), _int(7, 5, 1)], {}, RED),
    ("cross_entropy", [_f(5, 7), _int(7, 5), np.abs(_f(7))], {}, RED),
    ("cross_entropy", [_f(5, 7), _prob(5, 7)], {"soft_label": True}, RED),
    ("cross_entropy", [_f(5, 7), _prob(5, 7)], {}, RED),
    ("cross_entropy", [_f(2, 4, 3), _int(4, 2, 1, 3)], {"axis": 1}, RED),
    ("cross_entropy", [_f(2, 4, 3), _int(4, 2, 3)], {"axis": 1}, RED),
    ("cross_entropy", [_prob(5, 7), _int(7, 5)], {"use_softmax": False},
     RED),
    ("cross_entropy", [_f(5, 7), _int(7, 5)], {"label_smoothing": 0.1},
     RED),
    ("cross_entropy", [_f(5, 7), _prob(5, 7)],
     {"soft_label": True, "label_smoothing": 0.2}, RED),
    ("cross_entropy", [_f(6, 7), np.array([1, -100, 3, 3, -100, 0]),
                       np.abs(_f(7))], {}, RED),
    ("cross_entropy", [_f(6, 7), np.array([1, 4, 3, 3, 4, 0])],
     {"ignore_index": 4}, RED),
    ("softmax_with_cross_entropy", [_f(5, 7), _int(7, 5, 1)], {}, None),
    ("softmax_with_cross_entropy", [_f(5, 7), _prob(5, 7)],
     {"soft_label": True}, None),
    ("nll_loss", [np.log(_prob(5, 7)), _int(7, 5)], {}, RED),
    ("nll_loss", [np.log(_prob(2, 4, 3, axis=1)), _int(4, 2, 3)], {}, RED),
    ("nll_loss", [np.log(_prob(6, 7)), np.array([1, -100, 3, 3, 2, 0]),
                  np.abs(_f(7))], {}, RED),
    ("binary_cross_entropy", [R.uniform(0.05, 0.95, (4, 3)).astype(
        np.float32), (R.rand(4, 3) < 0.5).astype(np.float32)], {}, RED),
    ("binary_cross_entropy", [R.uniform(0.05, 0.95, (4, 3)).astype(
        np.float32), (R.rand(4, 3) < 0.5).astype(np.float32),
        np.abs(_f(4, 3))], {}, RED),
    ("binary_cross_entropy_with_logits", [_f(4, 3), (R.rand(4, 3) < 0.5)
                                          .astype(np.float32)], {}, RED),
    ("binary_cross_entropy_with_logits", [
        _f(4, 3), (R.rand(4, 3) < 0.5).astype(np.float32), np.abs(_f(4, 3))],
     {"pos_weight": np.abs(_f(3)) + 0.5}, RED),
    ("mse_loss", [_f(4, 3), _f(4, 3)], {}, RED),
    ("l1_loss", [_f(4, 3), _f(4, 3)], {}, RED),
    ("smooth_l1_loss", [_f(4, 3), _f(4, 3)], {"delta": 0.5}, RED),
    ("kl_div", [np.log(_prob(4, 5)), _prob(4, 5)], {},
     RED + ("batchmean",)),
    ("kl_div", [np.log(_prob(4, 5)), np.log(_prob(4, 5))],
     {"log_target": True}, RED),
    ("margin_ranking_loss", [_f(6), _f(6), _pm1(6)], {"margin": 0.1}, RED),
    ("hinge_embedding_loss", [_f(6), _pm1(6)], {"margin": 0.5}, RED),
    ("cosine_embedding_loss", [_f(4, 5), _f(4, 5), _pm1(4)],
     {"margin": 0.1}, RED),
    ("triplet_margin_loss", [_f(4, 5), _f(4, 5), _f(4, 5)], {}, RED),
    ("triplet_margin_loss", [_f(4, 5), _f(4, 5), _f(4, 5)],
     {"p": 1.0, "swap": True, "margin": 2.0}, RED),
    ("square_error_cost", [_f(4, 3), _f(4, 3)], {}, None),
    ("log_loss", [R.uniform(0.05, 0.95, (4, 1)).astype(np.float32),
                  (R.rand(4, 1) < 0.5).astype(np.float32)], {}, None),
    ("sigmoid_focal_loss", [_f(4, 3), (R.rand(4, 3) < 0.5).astype(
        np.float32)], {}, RED),
    ("sigmoid_focal_loss", [_f(4, 3), (R.rand(4, 3) < 0.5).astype(
        np.float32), np.array([3.0], np.float32)], {"gamma": 1.5}, RED),
    ("ctc_loss", _ctc(), {}, RED),
    ("ctc_loss", _ctc(), {"blank": 4}, RED),
    ("npair_loss", [_f(4, 5), _f(4, 5), np.array([0, 1, 0, 2])], {}, None),
]


def _grad_inputs(arrays):
    return [i for i, a in enumerate(arrays)
            if a is not None and a.dtype == np.float32]


def _run_ref(fn, arrays, kws, diff):
    """The reference's value and input gradients for each keyword set in
    ``kws``, from one jitted function of value_and_grads (its eager ops
    would each compile on their first use)."""
    from paddle_tpu.core.tensor import Tensor, unwrap

    def run(*xs):
        full = list(arrays)
        for i, x in zip(diff, xs):
            full[i] = x
        out = []
        for kw in kws:
            kw = {k: Tensor(jnp.asarray(v)) if isinstance(v, np.ndarray)
                  else v for k, v in kw.items()}

            def summed(*ys):
                part = list(full)
                for i, y in zip(diff, ys):
                    part[i] = y
                val = unwrap(fn(*[None if a is None
                                  else Tensor(jnp.asarray(a))
                                  for a in part], **kw))
                return val.sum(), val
            out.append(jax.value_and_grad(
                summed, argnums=tuple(range(len(diff))), has_aux=True)(*xs))
        return out
    res = jax.jit(run)(*[jnp.asarray(arrays[i]) for i in diff])
    return [(np.asarray(v), [np.asarray(g) for g in gs])
            for (_, v), gs in res]


def _run_port(fn, arrays, kw, diff):
    kw = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    ins = [None if a is None else torch.tensor(a, requires_grad=i in diff)
           for i, a in enumerate(arrays)]
    out = fn(*ins, **kw)
    out.sum().backward()
    return out.detach().numpy(), [ins[i].grad.numpy() for i in diff]


def _label_free(name, arrays):
    """Inputs differentiated: the predictions, not labels or weights
    (labels of kl_div and the like are differentiated too where they
    are float, as both frameworks allow)."""
    diff = _grad_inputs(arrays)
    if name in ("cross_entropy", "nll_loss", "binary_cross_entropy",
                "binary_cross_entropy_with_logits", "sigmoid_focal_loss",
                "softmax_with_cross_entropy"):
        diff = [0]
    if name == "ctc_loss":
        diff = [0]
    if name in ("margin_ranking_loss", "hinge_embedding_loss",
                "cosine_embedding_loss", "MarginRankingLoss",
                "HingeEmbeddingLoss", "CosineEmbeddingLoss"):
        diff = diff[:-1]   # the +-1 label
    return diff


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_loss_function_equals_the_reference(case):
    name, arrays, kw, reds = CASES[case]
    jfn, tfn = getattr(JF, name), getattr(TF, name)
    assert list(inspect.signature(tfn).parameters) == list(
        inspect.signature(jfn).parameters)
    diff = _label_free(name, arrays)
    kws = [dict(kw, **({} if red is None else {"reduction": red}))
           for red in reds or (None,)]
    for red, kw_r, (rval, rgrads) in zip(reds or (None,), kws,
                                         _run_ref(jfn, arrays, kws, diff)):
        val, grads = _run_port(tfn, arrays, kw_r, diff)
        assert val.shape == rval.shape, (name, red)
        np.testing.assert_allclose(val, rval, err_msg=f"{name} {red}",
                                   **TOL)
        for i, g, rg in zip(diff, grads, rgrads):
            np.testing.assert_allclose(g, rg, err_msg=f"{name} {red} d{i}",
                                       **TOL)


def test_every_reference_loss_function_is_ported():
    from paddle_tpu.nn.functional import loss as jloss
    ref = [n for n, f in inspect.getmembers(jloss, inspect.isfunction)
           if not n.startswith("_") and f.__module__ == jloss.__name__]
    assert sorted(ref) == sorted(TF.loss.__all__)
    assert {c[0] for c in CASES} == set(ref)


LAYERS = [
    ("CrossEntropyLoss", {}, [_f(5, 7), _int(7, 5)]),
    ("CrossEntropyLoss", {"soft_label": True, "label_smoothing": 0.1},
     [_f(5, 7), _prob(5, 7)]),
    ("MSELoss", {"reduction": "sum"}, [_f(4, 3), _f(4, 3)]),
    ("L1Loss", {}, [_f(4, 3), _f(4, 3)]),
    ("NLLLoss", {"ignore_index": 2}, [np.log(_prob(5, 7)), _int(7, 5)]),
    ("BCELoss", {}, [R.uniform(0.05, 0.95, (4, 3)).astype(np.float32),
                     (R.rand(4, 3) < 0.5).astype(np.float32)]),
    ("BCEWithLogitsLoss", {}, [_f(4, 3), (R.rand(4, 3) < 0.5).astype(
        np.float32)]),
    ("KLDivLoss", {"reduction": "batchmean"},
     [np.log(_prob(4, 5)), _prob(4, 5)]),
    ("SmoothL1Loss", {"delta": 2.0}, [_f(4, 3), _f(4, 3)]),
    ("MarginRankingLoss", {"margin": 0.2}, [_f(6), _f(6), _pm1(6)]),
    ("HingeEmbeddingLoss", {}, [_f(6), _pm1(6)]),
    ("CosineEmbeddingLoss", {"margin": 0.1},
     [_f(4, 5), _f(4, 5), _pm1(4)]),
    ("TripletMarginLoss", {"swap": True}, [_f(4, 5), _f(4, 5), _f(4, 5)]),
    ("CTCLoss", {"blank": 0, "reduction": "sum"}, _ctc()),
]


@pytest.mark.parametrize("case", range(len(LAYERS)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LAYERS)])
def test_loss_layer_equals_the_reference(case):
    name, kw, arrays = LAYERS[case]
    jcls, tcls = getattr(jnn, name), getattr(tnn, name)
    for attr in ("__init__", "forward"):
        assert list(inspect.signature(getattr(tcls, attr)).parameters) == \
            list(inspect.signature(getattr(jcls, attr)).parameters), attr
    diff = [0] if name in ("CrossEntropyLoss", "NLLLoss", "BCELoss",
                           "BCEWithLogitsLoss", "CTCLoss") \
        else _label_free(name, arrays)
    val, grads = _run_port(tcls(**kw), arrays, {}, diff)
    ((rval, rgrads),) = _run_ref(jcls(**kw), arrays, [{}], diff)
    np.testing.assert_allclose(val, rval, err_msg=name, **TOL)
    for g, rg in zip(grads, rgrads):
        np.testing.assert_allclose(g, rg, err_msg=name, **TOL)


def test_every_reference_loss_layer_is_ported():
    from paddle_tpu.nn.layer import loss as jloss
    ref = [n for n, c in inspect.getmembers(jloss, inspect.isclass)
           if c.__module__ == jloss.__name__]
    assert sorted(ref) == sorted(tnn.loss.__all__)
    assert {c[0] for c in LAYERS} == set(ref)
