"""paddle_tpu_torch's TrainStep checkpoints against the JAX package's
on-disk format, both ways.

- Reference to port: the reference's ``TrainStep.save_checkpoint`` after
  3 steps of a tiny BERT (naive attention route, dropout 0, AdamW under
  ``LinearWarmup(PolynomialDecay)``); the port's ``restore_checkpoint``
  resumes it with the step count and the scheduler, and its next 2 losses
  are within 1e-5 of the reference's own continued run.
- Port to reference: the reference's ``restore_sharded`` reads what the
  port wrote, parameters and optimizer state equal, and the reference's
  ``TrainStep.restore_checkpoint`` continues from it within 1e-5 of the
  port's next loss.
- The port resuming itself with dropout on (flash route, padding bias,
  attention dropout in K1's plain version): bit-equal losses, and a
  restore into a step whose program exists makes no new program and
  writes every state tensor in place.
- The layout: bf16 arrays as the reference's bytes, shards assembled,
  ``latest`` and its fallback, ``CheckpointManager`` retention, and a
  mesh that is no ``parallel.Mesh`` refused.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu.jit import TrainStep as JTrainStep, state_arrays
from paddle_tpu.optimizer import lr as jlr

import paddle_tpu_torch as pt
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.distributed import checkpoint as tck
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import lr as tlr

torch.set_num_threads(1)

CFG = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=64,
           max_position_embeddings=16, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)
SAVE_AT, MORE = 3, 2


def _schedule(m):
    return m.LinearWarmup(m.PolynomialDecay(4e-3, decay_steps=6),
                          warmup_steps=2, start_lr=1e-4, end_lr=4e-3)


def _decay(n):
    return "bias" not in n and "norm" not in n


def _batches(n=SAVE_AT + MORE):
    rng = np.random.RandomState(21)
    return [(rng.randint(0, 64, (2, 16)).astype(np.int32),
             rng.randint(0, 64, (2, 16)).astype(np.int32)) for _ in range(n)]


def _port_step(init):
    tm = tmodels.BertForPretraining(tmodels.BertConfig(**CFG), device="cpu")
    pt.load_paddle_state(tm, init)
    crit = tmodels.BertPretrainingCriterion()
    sched = _schedule(tlr)
    opt = pt.optimizer.AdamW(learning_rate=sched, parameters=tm.parameters(),
                             apply_decay_param_fun=_decay)
    return tm, sched, TrainStep(tm, lambda lg, nsp, y: crit(lg, nsp, y), opt)


def _tstep(step, sched, batch):
    loss = float(step(*[torch.from_numpy(a).long() for a in batch]))
    sched.step()
    return loss


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's run: 3 steps, its checkpoint, 2 more steps."""
    paddle.seed(9)
    jm = jmodels.BertForPretraining(jmodels.BertConfig(**CFG))
    init = {k: np.asarray(v) for k, v in state_arrays(jm).items()}
    crit = jmodels.BertPretrainingCriterion()
    sched = _schedule(jlr)
    step = JTrainStep(jm, lambda lg, nsp, y: crit(lg, nsp, y),
                      paddle.optimizer.AdamW(learning_rate=sched,
                                             parameters=jm.parameters(),
                                             apply_decay_param_fun=_decay))
    ckpt = str(tmp_path_factory.mktemp("ref_ckpt"))
    losses = []
    for i, batch in enumerate(_batches()):
        losses.append(float(step(*[paddle.to_tensor(a)
                                   for a in batch]).numpy()))
        sched.step()
        if i + 1 == SAVE_AT:
            step.save_checkpoint(ckpt, extra_meta={"run": "ref"},
                                 data_cursor={"epoch": 0, "batch": SAVE_AT})
    return dict(init=init, losses=losses, ckpt=ckpt, step=step, sched=sched,
                model=jm)


def test_port_resumes_a_reference_checkpoint(reference):
    ref = reference
    with open(os.path.join(ref["ckpt"], "step-000000003",
                           "manifest.json")) as f:
        assert "__rng__" in json.load(f)["extra"]  # the reference's key
    paddle.seed(1)   # another init: the restore must overwrite it
    other = {k: np.asarray(v) for k, v in state_arrays(
        jmodels.BertForPretraining(jmodels.BertConfig(**CFG))).items()}
    tm, sched, step = _port_step(other)
    meta = step.restore_checkpoint(ref["ckpt"])
    assert meta["step"] == SAVE_AT and meta["run"] == "ref"
    assert meta["data_cursor"] == {"epoch": 0, "batch": SAVE_AT}
    assert "__rng__" not in meta
    assert step.optimizer._step_count == SAVE_AT
    assert sched.last_epoch == SAVE_AT      # the schedule resumed too
    got = [_tstep(step, sched, b) for b in _batches()[SAVE_AT:]]
    np.testing.assert_allclose(got, ref["losses"][SAVE_AT:], rtol=1e-5,
                               atol=1e-5)


def test_reference_reads_a_port_checkpoint(reference, tmp_path):
    ref = reference
    tm, sched, step = _port_step(ref["init"])
    batches = _batches()
    for b in batches[:SAVE_AT - 1]:
        _tstep(step, sched, b)
    path = step.save_checkpoint(str(tmp_path))
    assert os.path.basename(path) == f"step-{SAVE_AT - 1:09d}"
    tree, at, extra = jck.restore_sharded(str(tmp_path))
    assert at == SAVE_AT - 1
    assert extra["__lr_sched__"] == sched.state_dict()
    assert set(tree["params"]) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(np.asarray(tree["params"][k]),
                                      v.numpy())
    assert set(tree["opt"]) == set(step._opt_state)
    for k, slots in step._opt_state.items():
        for s, t in slots.items():
            np.testing.assert_array_equal(np.asarray(tree["opt"][k][s]),
                                          t.numpy())
    # the reference's own TrainStep continues from the port's checkpoint
    jmeta = ref["step"].restore_checkpoint(str(tmp_path))
    assert jmeta["step"] == SAVE_AT - 1
    want = _tstep(step, sched, batches[SAVE_AT - 1])
    jloss = float(ref["step"](*[paddle.to_tensor(a) for a in
                                batches[SAVE_AT - 1]]).numpy())
    np.testing.assert_allclose(jloss, want, rtol=1e-5, atol=1e-5)


FLASH = dict(CFG, hidden_size=128, intermediate_size=256,
             max_position_embeddings=128, hidden_dropout_prob=0.1,
             attention_probs_dropout_prob=0.1)


def _dropout_run(seed=0):
    pt.seed(seed)
    tm = tmodels.BertForPretraining(tmodels.BertConfig(**FLASH),
                                    device="cpu", seed=5)
    crit = tmodels.BertPretrainingCriterion()
    sched = _schedule(tlr)
    opt = pt.optimizer.AdamW(learning_rate=sched, parameters=tm.parameters())
    return tm, sched, TrainStep(tm, lambda lg, nsp, y: crit(lg, nsp, y), opt)


def test_port_resumes_itself_bit_equal_with_dropout(tmp_path):
    rng = np.random.RandomState(22)
    ids = rng.randint(0, 64, (2, 128))
    mask = np.ones((2, 128), np.int64)
    mask[0, 90:] = 0
    lab = np.where(rng.rand(2, 128) < 0.2, ids, -100)
    batch = (ids, np.zeros_like(ids), np.broadcast_to(np.arange(128),
                                                      (2, 128)), mask, lab)
    batch = tuple(np.ascontiguousarray(a) for a in batch)
    tm, sched, step = _dropout_run()
    full = []
    for i in range(5):
        full.append(_tstep(step, sched, batch))
        if i == 2:
            step.save_checkpoint(str(tmp_path))
    # a step that already made its program (and drew other masks): the
    # restore overwrites it in place and makes no new program
    tm2, sched2, step2 = _dropout_run(seed=3)
    _tstep(step2, sched2, batch)
    made = step2.compile_counts()["total"]
    ptrs = [t.data_ptr() for t in step2._state_tensors()]
    step2.restore_checkpoint(str(tmp_path))
    got = [_tstep(step2, sched2, batch) for _ in range(2)]
    assert got == full[3:]
    assert step2.compile_counts()["total"] == made
    assert [t.data_ptr() for t in step2._state_tensors()] == ptrs


def test_bf16_arrays_cross_as_the_reference_writes_them(tmp_path):
    x = np.random.RandomState(23).randn(3, 5).astype(np.float32)
    jck.save_sharded({"w": jnp.asarray(x).astype(jnp.bfloat16)},
                     str(tmp_path / "ref"))
    tree, _, _ = tck.restore_sharded(str(tmp_path / "ref"))
    want = torch.from_numpy(x).bfloat16()
    assert tree["w"].dtype == torch.bfloat16
    assert torch.equal(tree["w"], want)
    tck.save_sharded({"w": want}, str(tmp_path / "port"))
    files = [np.load(os.path.join(str(tmp_path / d), "step-000000000",
                                  "shards-p00000.npz"))
             for d in ("ref", "port")]
    assert files[0].files == files[1].files == ["w@0,0"]
    assert files[0]["w@0,0"].dtype == files[1]["w@0,0"].dtype
    assert files[0]["w@0,0"].tobytes() == files[1]["w@0,0"].tobytes()
    for d in ("ref", "port"):
        with open(os.path.join(str(tmp_path / d), "step-000000000",
                               "manifest.json")) as f:
            assert json.load(f)["arrays"]["w"]["dtype"] == "bfloat16"
    assert files[1]["w@0,0"].view(ml_dtypes.bfloat16).astype(
        np.float32).tolist() == want.float().tolist()


def test_sharded_reference_arrays_are_assembled(tmp_path):
    """A reference array saved sharded over 4 of its virtual CPU devices
    (one shard per row block) comes back whole, and a 0-dim one too; the
    port's save of the array reads back equal in the reference."""
    mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    arr = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("dp")))
    jck.save_sharded({"a": {"w": arr, "n": jnp.asarray(7, jnp.int32)}},
                     str(tmp_path / "ref"), step=4)
    tree, at, _ = tck.restore_sharded(str(tmp_path / "ref"))
    assert at == 4 and tree["a"]["n"].item() == 7
    assert torch.equal(tree["a"]["w"], torch.from_numpy(x))
    # (the reference's reader takes no 0-dim array: its "name@" key has
    # no start to parse)
    tck.save_sharded({"a": {"w": tree["a"]["w"]}}, str(tmp_path / "port"),
                     step=4)
    back, _, _ = jck.restore_sharded(str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(back["a"]["w"]), x)


def test_latest_step_dir_and_manager_retention(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step-000000099.tmp-p00000"))
    mgr = tck.CheckpointManager(d, max_to_keep=2, save_interval_steps=2,
                                keep_every_k_steps=4)
    assert not any(".tmp-p" in e for e in os.listdir(d))   # debris gone
    state = {"w": torch.arange(4.0)}
    saved = [s for s in range(1, 8) if mgr.maybe_save(state, s)]
    assert saved == [2, 4, 6]
    assert mgr.all_steps() == [4, 6]          # 2 pruned; 4 also a milestone
    mgr.save(state, 8)
    assert mgr.all_steps() == [4, 6, 8]       # 4 kept as a milestone
    assert tck.latest_step_dir(d).endswith("step-000000008")
    # `latest` names a directory without a manifest: the newest valid one
    os.remove(os.path.join(d, "step-000000008", "manifest.json"))
    assert tck.latest_step_dir(d).endswith("step-000000006")
    os.remove(os.path.join(d, "latest"))
    assert tck.latest_step_dir(d).endswith("step-000000006")
    assert mgr.restore_latest()[1] == 6
    assert jck.latest_step_dir(d) == tck.latest_step_dir(d)
    assert tck.CheckpointManager(d, save_interval_seconds=0).should_save(1)
    assert not tck.CheckpointManager(
        d, save_interval_seconds=3600).should_save(10 ** 6)
    assert tck.latest_step_dir(str(tmp_path / "none")) is None
    assert tck.restore_sharded(str(tmp_path / "none")) is None


def _port_state():
    tm = tmodels.BertForPretraining(tmodels.BertConfig(**CFG), device="cpu")
    return {k: v.numpy() for k, v in tm.state_dict().items()}


def test_the_parts_not_ported_are_refused(tmp_path):
    """Restoring onto a mesh is ported (tests/test_torch_distributed.py
    holds it against the reference); what is not a ``parallel.Mesh`` is
    refused.  A checkpoint's ``scaler=``, once refused, is ported
    (test_torch_grad_scaler.py holds it against the reference)."""
    tm, sched, step = _port_step(_port_state())
    scaler = pt.amp.GradScaler(init_loss_scaling=64.0)
    step.save_checkpoint(str(tmp_path), scaler=scaler)
    back = pt.amp.GradScaler()
    assert step.restore_checkpoint(str(tmp_path), scaler=back) is not None
    assert back.state_dict() == scaler.state_dict()
    with pytest.raises(InvalidArgumentError):
        tck.restore_sharded(str(tmp_path), mesh=object())
    with pytest.raises(InvalidArgumentError):
        tck.CheckpointManager(str(tmp_path)).restore_latest(mesh=object())
    assert not hasattr(step, "load_checkpoint")
    assert step.restore_checkpoint(str(tmp_path / "empty")) is None


def test_accum_steps_is_recorded_in_the_meta(tmp_path):
    tm = tmodels.BertForPretraining(tmodels.BertConfig(**CFG), device="cpu")
    crit = tmodels.BertPretrainingCriterion()
    step = TrainStep(tm, lambda lg, nsp, y: crit(lg, nsp, y),
                     pt.optimizer.AdamW(1e-3, parameters=tm.parameters()),
                     accum_steps=2)
    ids = torch.from_numpy(_batches(1)[0][0]).long()
    step(ids, ids)
    step.save_checkpoint(str(tmp_path), extra_meta={"k": 1})
    meta = step.restore_checkpoint(str(tmp_path))
    assert meta["accum_steps"] == 2 and meta["k"] == 1 and meta["step"] == 1
