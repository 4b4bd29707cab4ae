"""The reference's signatures for ``amp.auto_cast`` / ``amp.decorate``,
``nn.Embedding`` / ``F.embedding``, ``F.dropout`` / ``nn.Dropout`` and
``F.cross_entropy``, held against the JAX package on the CPU.

Each of these once took the port's own parameters in the reference's
places, so a call written the reference's way computed something else
without a word: a custom op list bound to ``level``, ``padding_idx=0``
read as ``std=0`` (an all-zero table), dropout's ``axis`` read as
``training``, and a class ``weight`` read as ``ignore_index``."""
import importlib
import importlib.util
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


# ----------------------------------------------- conv and pool paddings

PAD_FORMS = [1, [1, 2], [1, 0, 1, 0], [0, 2, 1, 1], "SAME", "same", "VALID"]


def _pad_ids(p):
    return str(p).replace(" ", "")


def _np_rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("padding", PAD_FORMS, ids=_pad_ids)
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_takes_every_reference_padding(padding, stride):
    """The reference's string and 2n-list paddings (lax's "SAME" for any
    stride), held at 1e-5; on an 8x8 input with a 3x3 kernel "SAME"
    gives 8x8, "VALID" 6x6 and [1, 0, 1, 0] 7x7 at stride 1."""
    x, w = _np_rand((2, 3, 8, 8), 0), _np_rand((4, 3, 3, 3), 1)
    b = _np_rand((4,), 2)
    ref = JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w),
                    paddle.to_tensor(b), stride, padding).numpy()
    got = TF.conv2d(torch.as_tensor(x), torch.as_tensor(w),
                    torch.as_tensor(b), stride, padding).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if stride == 1:
        want = {"SAME": 8, "same": 8, "VALID": 6}.get(str(padding))
        if padding == [1, 0, 1, 0]:
            want = 7
        assert want is None or got.shape[-2:] == (want, want)
    layer = tnn.Conv2D(3, 4, 3, stride, padding)
    layer.weight.data.copy_(torch.as_tensor(w))
    layer.bias.data.copy_(torch.as_tensor(b))
    np.testing.assert_allclose(layer(torch.as_tensor(x)).detach().numpy(),
                               ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("padding", PAD_FORMS, ids=_pad_ids)
@pytest.mark.parametrize("kind", ["max", "avg", "avg_inclusive"])
def test_pool2d_takes_every_reference_padding(padding, kind):
    """Max pools pad -inf; an exclusive average's divisor counts only the
    unpadded positions of an asymmetric window; with a string padding the
    reference divides by the whole window, as the port does."""
    x = _np_rand((2, 3, 9, 8), 3)
    kw = {}
    if kind == "max":
        jf, tf = JF.max_pool2d, TF.max_pool2d
    else:
        jf, tf = JF.avg_pool2d, TF.avg_pool2d
        kw = dict(exclusive=kind == "avg")
    ref = jf(paddle.to_tensor(x), 3, 2, padding, **kw).numpy()
    got = tf(torch.as_tensor(x), 3, 2, padding, **kw).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if kind == "max":
        layer = tnn.MaxPool2D(3, 2, padding)
        np.testing.assert_allclose(layer(torch.as_tensor(x)).numpy(), ref,
                                   rtol=1e-5, atol=1e-5)


def test_nested_paddings_are_refused_as_the_reference_does():
    x, w = _np_rand((1, 2, 6, 6), 4), _np_rand((2, 2, 3, 3), 5)
    nested = [[0, 0], [0, 0], [1, 1], [1, 1]]   # length 2n: refused
    with pytest.raises(TypeError):
        JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w), padding=nested)
    with pytest.raises(TypeError):
        TF.conv2d(torch.as_tensor(x), torch.as_tensor(w), padding=nested)
    with pytest.raises(TypeError):
        TF.max_pool2d(torch.as_tensor(x), 2, 2, [[1, 1], [1, 1]])


@pytest.mark.parametrize("kind", ["max", "avg"])
def test_ceil_mode_changes_nothing_as_in_the_reference(kind):
    """8x8, kernel 3, stride 2, padding 1: 4x4 in the reference with or
    without ceil_mode (its _pool never reads the flag), so in the port."""
    x = _np_rand((2, 3, 8, 8), 6)
    jf = JF.max_pool2d if kind == "max" else JF.avg_pool2d
    tf = TF.max_pool2d if kind == "max" else TF.avg_pool2d
    ref = jf(paddle.to_tensor(x), 3, 2, 1, ceil_mode=True).numpy()
    got = tf(torch.as_tensor(x), 3, 2, 1, ceil_mode=True).numpy()
    assert ref.shape[-2:] == got.shape[-2:] == (4, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if kind == "max":
        layer = tnn.MaxPool2D(3, 2, 1, ceil_mode=True)
        np.testing.assert_allclose(layer(torch.as_tensor(x)).numpy(), ref,
                                   rtol=1e-5, atol=1e-5)


# ------------------------------------------- conv / pool / norm signatures

def _ref_params(fn):
    """The reference's parameters in order; a pool layer's ``**kw`` (the
    functional's keywords, passed through) is what the port spells out."""
    return [n for n, p in inspect.signature(fn).parameters.items()
            if p.kind is not p.VAR_KEYWORD]


def _port_modules():
    """Every module of the port whose counterpart in the JAX package
    exists (by the same dotted path)."""
    import pkgutil
    import paddle_tpu_torch
    out = []
    for info in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                      "paddle_tpu_torch."):
        rel = info.name[len("paddle_tpu_torch."):]
        if importlib.util.find_spec("paddle_tpu." + rel) is not None:
            out.append(rel)
    return sorted(out)


def _public(module):
    return [n for n, o in vars(module).items() if not n.startswith("_")
            and (inspect.isfunction(o) or inspect.isclass(o))
            and o.__module__ == module.__name__]


SIGNATURES = [(m, n) for m in _port_modules()
              for n in _public(importlib.import_module("paddle_tpu." + m))]

# The reference's names that the port's module of the same path does not
# have yet, each with the ROADMAP item that ports it.  A name missing from
# the port fails its case unless it is here; a name here that the port has
# fails too, so the list shrinks as the items land.
_NOT_PORTED = {
    "amp": ("item 9b", "amp_guard is_amp_enabled"),
    "core.device": ("item 9b", "Place CPUPlace TPUPlace CUDAPlace XPUPlace "
                    "CUDAPinnedPlace set_device get_device current_jax_device "
                    "device_count is_compiled_with_cuda is_compiled_with_tpu "
                    "is_compiled_with_xpu get_cudnn_version"),
    "core.layout": ("item 9b", "enabled tag_of tag tag_tree to_nchw to_nhwc "
                    "ensure_nhwc dispatch_prepare"),
    "core.rng": ("item 9b", "Generator register_seed_listener "
                 "default_generator next_key example_key get_rng_state "
                 "set_rng_state key_ctx"),
    "nn.clip": ("item 9a", "clip_grad_norm_ set_gradient_clip "
                "ErrorClipByValue"),
    "nn.functional": ("item 9d", "yolo_box yolov3_loss prior_box "
                      "anchor_generator box_coder box_clip multiclass_nms "
                      "distribute_fpn_proposals roi_align roi_pool "
                      "generate_proposals deformable_conv gather_tree "
                      "image_resize resize_bilinear resize_nearest "
                      "resize_trilinear pool2d pool3d fc pad2d smooth_l1 "
                      "dice_loss bpr_loss soft_relu space_to_depth "
                      "shuffle_channel add_position_encoding "
                      "pad_constant_like fsp_matrix "
                      "teacher_student_sigmoid_loss ssd_loss"),
    "nn.functional.activation": (
        "item 9a", "sigmoid silu swish mish softsign tanhshrink hardswish "
        "hardsigmoid log_sigmoid leaky_relu elu selu celu prelu rrelu "
        "hardtanh hardshrink softshrink softplus thresholded_relu "
        "log_softmax gumbel_softmax maxout glu softmax_ tanh_ relu_"),
    "nn.functional.attention": ("item 9a",
                                "set_flash_attention sequence_mask"),
    "nn.functional.common": (
        "item 9a", "dropout2d dropout3d alpha_dropout one_hot label_smooth "
        "pad zeropad2d cosine_similarity pairwise_distance pixel_shuffle "
        "pixel_unshuffle channel_shuffle bilinear unfold fold"),
    "nn.layer.activation": (
        "item 9a", "ReLU6 GELU Sigmoid LeakyReLU ELU CELU SELU Silu Swish "
        "Mish Hardswish Hardsigmoid Hardtanh Hardshrink Softshrink Softplus "
        "Softsign Tanhshrink ThresholdedReLU LogSigmoid Softmax LogSoftmax "
        "Maxout PReLU RReLU GLU"),
    "nn.layer.common": (
        "item 9a", "Identity Dropout2D Dropout3D AlphaDropout Flatten Pad1D "
        "Pad2D Pad3D ZeroPad2D CosineSimilarity PairwiseDistance Bilinear "
        "PixelShuffle PixelUnshuffle ChannelShuffle Unfold Fold"),
    "nn.layer.container": ("item 9a", "ParameterList LayerDict"),
    "nn.layer.rnn": ("item 9a", "RNN BiRNN SimpleRNN LSTM GRU"),
    "nn.layer_base": ("item 9a", "HookRemoveHelper"),
    "observability.programs": ("item 9d", "peak_live_bytes trace_peak_live"),
    "tensor.linalg": (
        "item 9b", "mm bmm mv norm vector_norm matrix_norm dist cond solve "
        "triangular_solve cholesky cholesky_solve lu qr svd svdvals pinv "
        "eig eigvals eigh eigvalsh matrix_power matrix_rank det slogdet "
        "multi_dot histogram bincount corrcoef cov householder_product "
        "lstsq"),
    "tensor.manipulation": (
        "item 9b", "cast reshape reshape_ transpose moveaxis swapaxes "
        "transpose_ t unsqueeze squeeze concat stack unstack split chunk "
        "tensor_split tile expand expand_as broadcast_to broadcast_tensors "
        "broadcast_shape slice strided_slice gather gather_nd "
        "take_along_axis put_along_axis scatter scatter_ scatter_nd "
        "scatter_nd_add index_select index_sample index_add index_put "
        "masked_select masked_fill masked_scatter roll flip rot90 "
        "repeat_interleave unique unique_consecutive as_complex as_real "
        "view view_as atleast_1d atleast_2d atleast_3d diagonal diag_embed "
        "unfold flatten_ shard_index reverse crop"),
    "utils": ("item 9d", "dump_config try_import deprecated run_check "
              "download"),
    "utils.faults": ("§1 Fault hooks (items 8 and 9c)",
                     "worker_crash_config maybe_crash_worker "
                     "prefetch_stall_config maybe_stall_prefetch "
                     "row_corrupt_fetch backend_down"),
    "version": ("item 9d", "show"),
}

# Internal helpers whose parameters are the port's by design: the
# reference's carry JAX state or versions (a functional state dict and a
# PRNG key, the jax version, a row-sharded table's spec, a jitted
# function).  Each case pins the port's own parameters.
_DESIGN = {
    ("jit", "forward_loss"): ["model", "loss_fn", "batch", "generator",
                              "amp_level", "amp_dtype", "return_outputs"],
    ("optimizer.functional", "apply_updates"): [
        "optimizer", "params", "grads", "opt_state", "lr", "step_no",
        "decay", "lr_mults", "regs"],
    ("programs.program_set", "LoadedProgram"): ["self", "name", "record"],
    ("programs.store", "cache_fingerprint"): [
        "port_version", "op_versions", "torch_version", "cuda_version",
        "nvcc_flags"],
}


def _case_id(where, name):
    parts = where.split(".")
    return ".".join(parts[-2:] + [name])


@pytest.mark.parametrize("where,name", SIGNATURES,
                         ids=[_case_id(w, n) for w, n in SIGNATURES])
def test_conv_pool_norm_signatures_start_with_the_reference(where, name):
    """Every public function and layer of every module of the port that
    has a counterpart in the JAX package takes the reference's parameters
    in the reference's order (``name=`` and ``avg_pool2d``'s
    ``divisor_override`` in seventh place included); the port's extras
    are keywords after them.  The few internal helpers of ``_DESIGN``
    keep the port's own parameters; a name on ``_NOT_PORTED`` must still
    be missing from the port."""
    ref = getattr(importlib.import_module("paddle_tpu." + where), name)
    module = importlib.import_module("paddle_tpu_torch." + where)
    item, missing = _NOT_PORTED.get(where, ("", ""))
    if name in missing.split():
        assert not hasattr(module, name), \
            f"{where}.{name} is ported: take it off _NOT_PORTED"
        return
    assert hasattr(module, name), \
        f"{where}.{name} is not in the port and not on _NOT_PORTED"
    port = getattr(module, name)
    if inspect.isclass(ref):
        ref, port = ref.__init__, port.__init__
    got = inspect.signature(port).parameters
    if (where, name) in _DESIGN:
        assert list(got) == _DESIGN[(where, name)]
        return
    want = _ref_params(ref)
    assert list(got)[:len(want)] == want
    if any(p.kind is p.VAR_KEYWORD
           for p in inspect.signature(ref).parameters.values()):
        return   # the rest are the functional's, which **kw passes on
    assert all(p.kind is p.KEYWORD_ONLY
               for p in list(got.values())[len(want):])


def test_softmax_casts_to_dtype_first_as_the_reference():
    """``F.softmax(x, axis, dtype)`` casts before the softmax: bf16 logits
    with ``dtype="float32"`` give the f32 softmax of the bf16 values."""
    import ml_dtypes
    x = _np_rand((4, 33), 21).astype(ml_dtypes.bfloat16)
    ref = JF.softmax(paddle.to_tensor(x), -1, "float32").numpy()
    got = TF.softmax(torch.from_numpy(x.view(np.int16)).view(
        torch.bfloat16), -1, "float32", name="sm")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn", ["relu", "relu6", "tanh", "gelu"])
def test_activations_take_name(fn):
    x = _np_rand((3, 5), 22)
    ref = getattr(JF, fn)(paddle.to_tensor(x), name="a").numpy()
    got = getattr(TF, fn)(torch.from_numpy(x), name="a").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_clip_by_global_norm_keeps_group_name():
    jc = jnn.ClipGradByGlobalNorm(1.0, "g")
    tc = tnn.ClipGradByGlobalNorm(1.0, "g")
    assert tc.group_name == jc.group_name == "g"
    assert tnn.ClipGradByGlobalNorm(2.0).group_name == "default_group"


def test_train_step_takes_mesh_and_batch_sharding_and_reads_neither():
    """``TrainStep(mesh=, batch_sharding=)``: accepted, and a step with
    them equals a step without them, as in the reference (whose step
    reads neither)."""
    from paddle_tpu_torch import jit as tjit
    rng = np.random.RandomState(23)
    x = torch.from_numpy(rng.randn(8, 4).astype(np.float32))
    y = torch.from_numpy(rng.randn(8, 2).astype(np.float32))
    losses = []
    for kw in ({}, {"mesh": object(), "batch_sharding": object()}):
        torch.manual_seed(0)
        lin = tnn.Linear(4, 2, device="cpu")
        with torch.no_grad():
            lin.weight.copy_(torch.linspace(-1, 1, 8).view(4, 2))
        opt = __import__("paddle_tpu_torch").optimizer.SGD(
            0.1, parameters=lin.parameters())
        step = tjit.TrainStep(lin, lambda o, t: ((o - t) ** 2).mean(), opt,
                              **kw)
        losses.append([float(step(x, y)) for _ in range(2)]
                      + [lin.weight.detach().clone()])
    assert losses[0][:2] == losses[1][:2]
    assert torch.equal(losses[0][2], losses[1][2])


def test_avg_pool2d_positional_call_written_for_the_reference():
    x = _np_rand((1, 2, 6, 6), 7)
    args = (2, 2, 0, False, True, None, "NCHW", "pool")
    ref = JF.avg_pool2d(paddle.to_tensor(x), *args).numpy()
    got = TF.avg_pool2d(torch.as_tensor(x), *args).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    m, v = np.zeros(2, np.float32), np.ones(2, np.float32)
    t = [torch.as_tensor(a) for a in (x, m, v)]
    TF.batch_norm(*t, name="bn")
    TF.fused_bn_act(*t, name="bn")
    TF.adaptive_avg_pool2d(t[0], 1, name="gap")
    tnn.AdaptiveAvgPool2D(1, name="gap")
