"""Exported training programs of paddle_tpu_torch against the JAX
package's on the CPU: a tiny GPT (f32, no dropout, head_dim 64 and S 128:
the flash route, K1 / K2's plain versions; the reference with its Pallas
kernels in interpret mode) and the tiny sparse DLRM are saved by
``save_train_program``, loaded by ``TrainSession`` and stepped 3 times.
Both models carry the reference's weights (``load_paddle_state``); the
batches come from a numpy seed.

Held: the losses equal the port's ``TrainStep`` on the same weights
(1e-6: the same program, differentiated by autograd) and the reference's
``TrainSession`` (1e-5: the forward and backward sum in another order);
the state after 3 steps equals the port's TrainStep (1e-6), and for the
DLRM the reference's (1e-5; the GPT's AdamW update, sign-like where a
gradient is tiny, moves a few elements of the reference's state by more
in either order); the npz's ``s{i}`` / ``o{i}`` arrays
equal the reference's for the same weights; a reference artifact is
refused with ``ArtifactFormatError``.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.jit import train_export as jexport
from paddle_tpu.ops import flash_attention as jfa

import paddle_tpu_torch as pt
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.jit import (ArtifactFormatError, TrainSession,
                                  TrainStep, save_train_program)
from paddle_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

GPT = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
           num_attention_heads=2, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0, max_position_embeddings=128)
SPECS = {"gpt": [((2, 128), "int64"), ((2, 128), "int64")],
         "dlrm": [((8, 4), "float32"), ((8, 4), "int64"), ((8, 1),
                                                          "float32")]}


def _batches(kind, n=3):
    r = np.random.RandomState(1)
    if kind == "gpt":
        return [(r.randint(0, 256, (2, 128)), r.randint(0, 256, (2, 128)))
                for _ in range(n)]
    return [(r.randn(8, 4).astype(np.float32),
             r.randint(0, 64, (8, 4)).astype(np.int64),
             (r.rand(8, 1) < 0.25).astype(np.float32)) for _ in range(n)]


def _jmodel(kind):
    paddle.seed(0)
    if kind == "gpt":
        crit = jmodels.GPTPretrainingCriterion()
        return (jmodels.GPTForPretraining(jmodels.GPTConfig(**GPT)),
                lambda lg, y: crit(lg, y))
    from paddle_tpu.models import dlrm
    return (dlrm.DLRM(dlrm.dlrm_tiny_config(), embedding="sparse"),
            dlrm.DLRMCriterion())


def _tmodel(kind, init):
    if kind == "gpt":
        m = tmodels.GPTForPretraining(tmodels.GPTConfig(**GPT),
                                      device="cpu")
        crit = tmodels.GPTPretrainingCriterion()
        fn = lambda lg, y: crit(lg, y)  # noqa: E731
    else:
        m = tmodels.DLRM(tmodels.dlrm_tiny_config(), device="cpu")
        fn = tmodels.DLRMCriterion()
    pt.load_paddle_state(m, init)
    return m, fn


@pytest.fixture(scope="module", params=["gpt", "dlrm"])
def ref(request, tmp_path_factory):
    """The reference's artifact and its session's 3 losses and state."""
    kind = request.param
    path = str(tmp_path_factory.mktemp(kind) / "ref")
    mp = pytest.MonkeyPatch()
    mp.setattr(jfa, "_INTERPRET", True)
    mp.setenv("PDTPU_OBS_PROGRAMS", "0")   # jax.export takes a bare jit
    try:
        m, fn = _jmodel(kind)
        init = {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}
        jexport.save_train_program(m, fn, paddle.optimizer.AdamW(
            1e-3, parameters=m.parameters()), path, SPECS[kind])
        sess = jexport.TrainSession(path)
        losses = [sess.step(*b) for b in _batches(kind)]
        state = sess.state_dict()
    finally:
        mp.undo()
    return kind, path, init, losses, state


def test_session_steps_equal_train_step_and_the_reference(ref, tmp_path):
    kind, ref_path, init, ref_losses, ref_state = ref
    m, fn = _tmodel(kind, init)
    path = str(tmp_path / "port")
    save_train_program(m, fn, pt.optimizer.AdamW(
        1e-3, parameters=m.parameters()), path, SPECS[kind])
    calls = []
    plain_bwd = tfa._plain_bwd

    def counted(*a, **k):
        calls.append(1)
        return plain_bwd(*a, **k)
    sess = TrainSession(path, device="cpu")
    assert sess.batch_specs == [(s, d) for s, d in SPECS[kind]]
    m2, fn2 = _tmodel(kind, init)
    step = TrainStep(m2, fn2, pt.optimizer.AdamW(
        1e-3, parameters=m2.parameters()))
    got, want = [], []
    tfa._plain_bwd = counted
    try:
        for b in _batches(kind):
            n0 = len(calls)
            got.append(sess.step(*b))
            n1 = len(calls)
            want.append(float(step(*map(torch.from_numpy, b))))
            if kind == "gpt":   # K2 (its plain version) per layer, both
                assert n1 - n0 == len(calls) - n1 == 2
    finally:
        tfa._plain_bwd = plain_bwd
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, ref_losses, rtol=1e-5, atol=1e-5)
    state = sess.state_dict()
    for k, v in m2.state_dict().items():
        np.testing.assert_allclose(state[k], v.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    if kind == "dlrm":
        for k in ref_state:
            np.testing.assert_allclose(state[k], ref_state[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        meta = json.load(open(path + ".pdtrainmeta"))
        assert list(meta["sparse"]) == ["table.weight@0"]
        seen = {int(i) for b in _batches(kind)
                for i in (b[1] + np.array([0, 64, 128, 192])).ravel()}
        cold = sorted(set(range(256)) - seen)
        np.testing.assert_array_equal(state["table.weight"][cold],
                                      init["table.weight"][cold])


def test_npz_leaves_equal_the_reference(ref, tmp_path):
    kind, ref_path, init, _, _ = ref
    m, fn = _tmodel(kind, init)
    path = str(tmp_path / "port")
    save_train_program(m, fn, pt.optimizer.AdamW(
        1e-3, parameters=m.parameters()), path, SPECS[kind])
    with np.load(path + ".pdstate.npz") as got, \
            np.load(ref_path + ".pdstate.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_a_reference_artifact_is_refused(ref, tmp_path):
    _, ref_path, _, _, _ = ref
    with pytest.raises(ArtifactFormatError):
        TrainSession(ref_path, device="cpu")
    # a port program beside the reference's pickled metadata
    import shutil
    m, fn = _tmodel("dlrm", _jdlrm_init())
    save_train_program(m, fn, pt.optimizer.SGD(
        0.1, parameters=m.parameters()), str(tmp_path / "p"), SPECS["dlrm"])
    shutil.copy(ref_path + ".pdtrainmeta", str(tmp_path / "p.pdtrainmeta"))
    with pytest.raises(ArtifactFormatError):
        TrainSession(str(tmp_path / "p"), device="cpu")


def _jdlrm_init():
    m, _ = _jmodel("dlrm")
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def test_remat_session_equals_plain(tmp_path):
    init = _jdlrm_init()
    losses = {}
    for remat in (False, True):
        m, fn = _tmodel("dlrm", init)
        path = str(tmp_path / f"r{remat}")
        save_train_program(m, fn, pt.optimizer.Adam(
            0.05, parameters=m.parameters()), path, SPECS["dlrm"],
            remat=remat)
        sess = TrainSession(path, device="cpu")
        losses[remat] = [sess.step(*b) for b in _batches("dlrm")]
    assert losses[True] == losses[False]
