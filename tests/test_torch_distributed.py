"""paddle_tpu_torch.distributed on two gloo ranks against the JAX package
on the CPU: the environment, DataParallel's eager reducer, SyncBatchNorm,
ResNet-18 in ShardedTrainStep with the BatchNorm over the global batch,
LocalSGD, fp16_allreduce, checkpoints across the frameworks and
topologies, the fleet facade, spawn and launch.

One module fixture writes the reference's weights and data, spawns one
group of two CPU ranks (``tests/torch_ranks.py``) and runs every
scenario in it; each test reads its results and holds them against the
reference (tests/test_parallel.py, test_averaging.py and
test_dist_checkpoint.py are the reference's own cases).

Tolerances, with their reasons:
- DataParallel and LocalSGD against single-device SGD: the reference's
  own (2e-5; 1e-4 relative and 1e-5 absolute): the gradients averaged
  over two ranks are summed in another order;
- SyncBatchNorm against the reference's BatchNorm on the whole batch:
  1e-5 of each tensor's largest |value| (the statistics are summed per
  rank, then over the ranks, in f64);
- ResNet-18 (20 rows in the last stage): the first loss within 1e-4
  relative of the reference's training-mode forward on the whole batch
  (its train-mode logits test's bound); against the port's own
  single-device step, losses within 1e-5 and every parameter within 0.01
  lr after 2 steps;
- fp16_allreduce against exact: the reference's 2e-2 (bf16 on the wire);
- checkpoints exactly.
"""
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu import parallel as jpar
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu.jit import functional_call, state_arrays
from paddle_tpu.nn import functional as JF
from paddle_tpu.vision import models as jvm

import torch_ranks as R
from paddle_tpu_torch import distributed as TD
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import parallel as tpar
from paddle_tpu_torch.distributed import launch as tlaunch
from paddle_tpu_torch.optimizer import SGD

torch.set_num_threads(1)

SCENARIOS = ("env", "ddp", "syncbn", "resnet", "localsgd", "localsgd_ckpt",
             "fp16", "ckpt_port", "ckpt_ref", "fleet")
RESNET_B = 20   # rows of the last stage at 32 x 32


def _np_state(model):
    return {k: np.asarray(v) for k, v in state_arrays(model).items()}


def _jmlp(seed, out):
    paddle.seed(seed)
    return paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(),
                                paddle.nn.Linear(16, out))


def _bn_data():
    rng = np.random.RandomState(5)
    return {"x": (rng.randn(8, 3, 4, 4) * 2 + 1).astype("float32"),
            "gamma": rng.rand(3).astype("float32") + 0.5,
            "beta": rng.randn(3).astype("float32"),
            "w": rng.randn(8, 3, 4, 4).astype("float32")}


def _resnet_batch():
    rng = np.random.RandomState(0)
    return (rng.randn(RESNET_B, 3, 32, 32).astype(np.float32),
            rng.randint(0, 6, (RESNET_B,)).astype(np.int64))


@pytest.fixture(scope="module")
def jresnet():
    paddle.seed(0)
    jm = jvm.resnet18(num_classes=6)
    return jm, _np_state(jm)


@pytest.fixture(scope="module")
def group(tmp_path_factory, jresnet):
    out = tmp_path_factory.mktemp("ranks2")
    np.savez(out / "ddp.npz", **_np_state(_jmlp(7, 4)))
    np.savez(out / "avg.npz", **_np_state(_jmlp(0, 1)))
    np.savez(out / "bn.npz", **_bn_data())
    np.savez(out / "resnet.npz", **jresnet[1])
    x, y = _resnet_batch()
    np.savez(out / "resnet_batch.npz", x=x, y=y)
    paddle.seed(123)
    gpt = jmodels.GPTForPretraining(jmodels.GPTConfig(**R.TINY_GPT))
    np.savez(out / "gpt2.npz", **_np_state(gpt))
    # the reference's checkpoint from its 4-device mesh
    mesh = jpar.create_mesh({"dp": 4})
    w = jax.device_put(jnp.arange(32, dtype=jnp.float32).reshape(8, 4),
                       JNamedSharding(mesh, JP("dp", None)))
    jck.save_sharded({"params": {"w": w, "b": jnp.arange(6.0) + 0.5}},
                     str(out / "ref_ckpt"), step=5)
    R.run_group(2, SCENARIOS, out, limit=240.0)
    return out


def test_env_sees_the_group(group):
    for rank in range(2):
        got = R.result(group, "env", rank)
        assert (int(got["rank"]), int(got["world"]), int(got["nranks"])) \
            == (rank, 2, 2)
        np.testing.assert_array_equal(got["get"], [rank, 2])
        assert bool(got["init"]) and int(got["dev"]) == 0


def test_env_world_of_one_without_a_group():
    env = TD.init_parallel_env()
    assert (env.rank, env.world_size) == (0, 1) and TD.is_initialized()
    assert TD.prepare_context("s") == "s"


def test_data_parallel_eager_reducer_parity(group):
    """Each rank runs its 8 rows; the averaged gradients give the
    reference's single-device trajectory on all 16."""
    ref = _jmlp(7, 4)
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=ref.parameters())
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(3):
        x = rng.randn(16, 8).astype("float32")
        y = rng.randn(16, 4).astype("float32")
        loss = paddle.mean((ref(paddle.to_tensor(x))
                            - paddle.to_tensor(y)) ** 2)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    final = _np_state(ref)
    for rank in range(2):
        got = R.result(group, "ddp", rank)
        assert int(got["out_rows"]) == 8   # the rank's rows (deviation)
        np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
        for k, v in final.items():
            np.testing.assert_allclose(got["p:" + k], v, atol=2e-5)


def _ref_bn(form):
    d = _bn_data()
    bn = paddle.nn.BatchNorm2D(3)
    bn.weight._set_data(jnp.asarray(d["gamma"]))
    bn.bias._set_data(jnp.asarray(d["beta"]))
    x = paddle.to_tensor(d["x"], stop_gradient=False)
    y = bn(x) if form == "plain" else bn.forward_fused(x, activation="relu")
    (y * paddle.to_tensor(d["w"])).sum().backward()
    return {"y": y.numpy(), "dx": x.grad.numpy(),
            "dgamma": bn.weight.grad.numpy(), "dbeta": bn.bias.grad.numpy(),
            "mean": bn._mean.numpy()}


@pytest.mark.parametrize("form", ["plain", "fused"])
def test_sync_batch_norm_is_the_whole_batch_norm(group, form):
    """SyncBatchNorm on two ranks of 4 rows each: outputs, input and
    affine gradients and running mean equal the reference's BatchNorm2D
    over all 8 rows, forward and backward (the fused entry's plain
    versions of K5-K8 reduce over the ranks as the kernels do)."""
    want = _ref_bn(form)
    for rank in range(2):
        got = R.result(group, "syncbn", rank)
        for k, v in want.items():
            g = got[f"{form}_{k}"]
            if k in ("y", "dx"):
                v = v[rank * 4:(rank + 1) * 4]
            scale = max(float(np.abs(v).max()), 1e-30)
            assert float(np.abs(g - v).max()) <= 1e-5 * scale, k


def test_sync_batch_norm_alone_is_batch_norm():
    bn = tnn.SyncBatchNorm(3, device="cpu")
    x = torch.from_numpy(_bn_data()["x"])
    ref = tnn.BatchNorm2D(3, device="cpu")
    torch.testing.assert_close(bn(x), ref(x), rtol=0, atol=0)


def test_resnet18_sharded_step_takes_the_global_batch_norm(group, jresnet):
    """ResNet-18 (NHWC, the fused sites) in ShardedTrainStep on two ranks
    of 10 rows: the first loss equals the reference's training-mode loss
    on all 20 rows; two steps equal the port's single-device step on the
    whole batch; each step all-reduces the statistics of every fused
    site twice (forward, backward)."""
    jm, state = jresnet
    x, y = _resnet_batch()

    def loss_of(s, x, y):
        out = functional_call(jm, s, x, training=True, buffer_updates={})
        return JF.cross_entropy(paddle.Tensor(out), paddle.Tensor(y))._data
    ref = float(jax.jit(loss_of)({k: jnp.asarray(v) for k, v in state.items()},
                                 jnp.asarray(x), jnp.asarray(y)))
    for rank in range(2):
        got = R.result(group, "resnet", rank)
        np.testing.assert_allclose(got["sharded_losses"][0], ref, rtol=1e-4)
        np.testing.assert_allclose(got["sharded_losses"],
                                   got["single_losses"], rtol=1e-5)
        for k in state:
            if k.endswith(("_mean", "_variance")):   # frozen when sharded
                np.testing.assert_array_equal(got["sharded:" + k], state[k])
                continue
            d = np.abs(got["sharded:" + k] - got["single:" + k]).max()
            assert float(d) <= 1e-2 * 0.01, k
        sites = 17   # the stem, and two per BasicBlock (dual with a shortcut)
        assert list(got["sharded_reduces"]) == [2 * sites] * 2
        assert list(got["single_reduces"]) == [0, 0]


def _single_sgd(n):
    m = _jmlp(0, 1)
    o = paddle.optimizer.SGD(0.1, parameters=m.parameters())
    x, y = R.mlp_data(64)
    losses = []
    for _ in range(n):
        loss = ((m(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()
        loss.backward()
        o.step()
        o.clear_grad()
        losses.append(float(loss))
    return losses, _np_state(m)


def test_localsgd_k1_matches_sync_sgd(group):
    """With SGD and k = 1, averaging after each local step is the
    reference's single-device full-batch SGD; with k = 3 the replicas
    learn apart and agree after the sync at step 9."""
    losses, final = _single_sgd(4)
    got = [R.result(group, "localsgd", r) for r in range(2)]
    for g in got:
        np.testing.assert_allclose(g["k1_losses"], losses, rtol=1e-4,
                                   atol=1e-5)
        for k, v in final.items():
            np.testing.assert_allclose(g["k1:" + k], v, rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        assert g["k3_losses"][-1] < g["k3_losses"][0]
    for k in final:
        np.testing.assert_array_equal(got[0]["k3:" + k], got[1]["k3:" + k])


def test_localsgd_checkpoint_roundtrip(group):
    for rank in range(2):
        got = R.result(group, "localsgd_ckpt", rank)
        assert int(got["step"]) == 3 and bool(got["same"])
        assert abs(got["next"][0] - got["next"][1]) < 1e-6


def test_fp16_allreduce_trains_close_to_exact(group):
    got = R.result(group, "fp16")
    a, b = got["True"], got["False"]
    np.testing.assert_allclose(a, b, rtol=2e-2, atol=1e-3)
    assert a[-1] < a[0]


def test_fp16_allreduce_refusals():
    m = tnn.Linear(8, 1, device="cpu")
    for kw in ({"sharding": True}, {"tensor_parallel": True},
               {"sequence_parallel": True}, {"pipeline": True}):
        st = tpar.DistributedStrategy(fp16_allreduce=True, **kw)
        st.sharding_configs.stage = 3
        with pytest.raises(ValueError, match="fp16_allreduce"):
            tpar.ShardedTrainStep(m, R._mse, SGD(0.1,
                                                 parameters=m.parameters()),
                                  strategy=st)


def test_port_checkpoint_from_two_ranks_restores_in_the_reference(group):
    """A stage-3 step on two ranks writes its blocks (shards-p00000 and
    -p00001); the reference reads the whole arrays; a fresh port step
    restores its blocks exactly, and the port reads it back whole."""
    d = str(group / "port_ckpt")
    files = sorted(f for f in os.listdir(jck.latest_step_dir(d))
                   if f.startswith("shards-p"))
    assert files == ["shards-p00000.npz", "shards-p00001.npz"]
    tree, step, _ = jck.restore_sharded(d)
    got = R.result(group, "ckpt_port")
    assert int(got["step"]) == step == 1
    n = 0
    for key, v in got.items():
        if key.startswith("whole:"):
            name = key[len("whole:"):]
            np.testing.assert_array_equal(np.asarray(tree["params"][name]), v)
            np.testing.assert_array_equal(
                np.asarray(tree["opt"][name]["moment1"]), got["m1:" + name])
            n += 1
    assert n > 10
    assert bool(got["restored_equal"]) and bool(got["whole_equal"])


def test_reference_checkpoint_from_four_devices_restores_onto_two_ranks(
        group):
    w = np.arange(32, dtype=np.float32).reshape(8, 4)
    for rank in range(2):
        got = R.result(group, "ckpt_ref", rank)
        np.testing.assert_array_equal(got["w"], w[4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(got["b"], np.arange(6.0) + 0.5)
        assert int(got["step"]) == 5


def test_fleet_facade(group):
    for rank in range(2):
        got = R.result(group, "fleet", rank)
        assert int(got["tp"]) == 2 and int(got["num"]) == 2
        assert bool(got["first"]) == (rank == 0)
        assert np.isfinite(float(got["loss"]))
        assert str(got["kind"]) == "ShardedTrainStep"
        np.testing.assert_array_equal(got["sum"], [3.0])
        assert list(got["shard"]) == (["a", "b"] if rank == 0 else ["c"])


def test_fleet_localsgd_rejects_conflicting_flags():
    from paddle_tpu_torch.distributed import fleet
    st = tpar.DistributedStrategy(localsgd=True, sharding=True)
    m = tnn.Linear(8, 1, device="cpu")
    with pytest.raises(ValueError, match="localsgd"):
        fleet.distributed_train_step(m, R._mse,
                                     SGD(0.1, parameters=m.parameters()),
                                     strategy=st)
    tpar.set_mesh(None)


def test_spawn_sets_the_variables_and_reports_failures():
    TD.spawn(R.spawn_worker, args=(2,), nprocs=2, port=29786)
    with pytest.raises(RuntimeError, match="rank 1 exited with code 3"):
        TD.spawn(R.spawn_failing_worker, nprocs=2, port=29790, timeout=60)


def test_launch_starts_a_trainer_per_rank_and_reports_failures(tmp_path):
    ok = tmp_path / "ok.py"
    ok.write_text("import os\n"
                  "assert os.environ['PADDLE_TRAINERS_NUM'] == '2'\n"
                  "open(os.environ['OUT'] + os.environ['PADDLE_TRAINER_ID'],"
                  " 'w').write(os.environ['PADDLE_LOCAL_RANK'])\n")
    bad = tmp_path / "bad.py"
    bad.write_text("import os, sys\n"
                   "sys.exit(3 if os.environ['PADDLE_TRAINER_ID'] == '1'"
                   " else 0)\n")
    env = dict(os.environ, OUT=str(tmp_path / "r"))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2"]
    r = subprocess.run(cmd + [str(ok)], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert [(tmp_path / f"r{i}").read_text() for i in (0, 1)] == ["0", "1"]
    r = subprocess.run(cmd + [str(bad)], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 3
    assert "worker 1 FAILED (exit 3)" in r.stderr
    args = tlaunch._parse_args(["--ips", "a,b", "x.py", "--lr", "1"])
    assert (args.ips, args.training_script_args) == ("a,b", ["--lr", "1"])


@pytest.mark.parametrize("limit", ["exit_grace", "timeout"])
def test_launch_joins_are_bounded(tmp_path, limit):
    """A rank that hangs (past another's clean exit, or from the start)
    is torn down when the launcher's limit passes, and the launcher exits
    ``TIMED_OUT``.  The ranks write to ``--log_dir``, so no sleeper holds
    this test's pipes."""
    hang = tmp_path / "hang.py"
    hang.write_text("import os, time\n"
                    "if os.environ['PADDLE_TRAINER_ID'] == '1' or "
                    "os.environ['HANG_ALL'] == '1':\n"
                    "    time.sleep(600)\n")
    env = dict(os.environ, HANG_ALL=str(int(limit == "timeout")))
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m",
                        "paddle_tpu_torch.distributed.launch",
                        "--nproc_per_node", "2", f"--{limit}", "2",
                        "--log_dir", str(tmp_path / "logs"), str(hang)],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == tlaunch.TIMED_OUT, r.stderr
    assert "still running past the launcher's limit" in r.stderr
    assert time.monotonic() - t0 < 60
