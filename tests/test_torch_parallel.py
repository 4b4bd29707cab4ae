"""paddle_tpu_torch.parallel on four gloo ranks against the JAX package's
parallel tests (tests/test_parallel.py) on the CPU.

One module fixture writes the reference's initial weights, spawns one
group of four CPU ranks (``tests/torch_ranks.py``: a file store, a hard
join limit) and runs every scenario in it; each test reads its
scenario's results and holds them against the reference, which runs its
own mesh shapes on the 8-virtual-device CPU mesh in this process.

Tolerances, with their reasons:
- sharded steps, gradient merge, recompute and the pipelines against the
  reference's single-device trajectory (tiny GPT, Adam 1e-2): losses
  within 1e-5 relative and every parameter within 0.01 lr of the
  reference's.  The two frameworks sum the same f32 products in other
  orders (gradients averaged over ranks add one more order), and Adam
  divides a gradient by the root of its second moment, so the rounding
  of a gradient near zero moves its parameter by a share of lr;
- the collectives exactly (small integers), ``PROD`` at 1e-6 (it goes
  through exp / log in both);
- ring attention at the reference's own 2e-4 (output) and 2e-3
  (gradients).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as JP

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu import parallel as jpar
from paddle_tpu.jit import state_arrays

import torch_ranks as R
from paddle_tpu_torch import parallel as tpar

torch.set_num_threads(1)

SCENARIOS = ("dp4", "tp", "zero2", "fsdp", "merge", "recompute",
             "collectives", "gpipe", "1f1b", "pipe_mem", "pipe_frozen",
             "ring")


def _jgpt(layers):
    paddle.seed(123)
    cfg = jmodels.GPTConfig(**dict(R.TINY_GPT, num_hidden_layers=layers))
    return jmodels.GPTForPretraining(cfg), jmodels.GPTPretrainingCriterion()


def _np_state(model):
    return {k: np.asarray(v) for k, v in state_arrays(model).items()}


def _ref_run(layers, n, batches=None):
    """The reference's single-device eager trajectory: (initial state,
    losses, final state)."""
    model, crit = _jgpt(layers)
    init = _np_state(model)
    opt = paddle.optimizer.Adam(learning_rate=R.LR,
                                parameters=model.parameters())
    losses = []
    for ids, labels in (batches or R.gpt_batches(n)):
        loss = crit(model(paddle.to_tensor(ids.astype("int32"))),
                    paddle.to_tensor(labels.astype("int32")))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return init, np.asarray(losses), _np_state(model)


@pytest.fixture(scope="module")
def refs():
    return {"gpt2": _ref_run(2, 3), "gpt2_2": _ref_run(2, 2),
            "gpt4": _ref_run(4, 1)}


@pytest.fixture(scope="module")
def group(refs, tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks4")
    for layers in (2, 4):
        np.savez(out / f"gpt{layers}.npz", **refs[f"gpt{layers}"][0])
    R.run_group(4, SCENARIOS, out, limit=240.0)
    return out


def _close_state(got, want, tol=1e-2 * R.LR):
    for k, v in want.items():
        assert float(np.abs(got["whole:" + k] - v).max()) <= tol, k


@pytest.mark.parametrize("name", ["dp4", "tp", "zero2", "fsdp"])
def test_sharded_step_matches_single_device(group, refs, name):
    """{"dp": 4}, {"dp": 2, "tp": 2}, ZeRO-2 and FSDP (stage 3): every
    rank's losses and whole parameters equal the reference's
    single-device trajectory over 3 steps."""
    _, losses, final = refs["gpt2"]
    for rank in range(4):
        got = R.result(group, name, rank)
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        _close_state(got, final)


def test_fsdp_params_actually_sharded(group):
    """Stage 3 holds every divisible parameter as its dp block between
    steps; ZeRO-2 holds the moments so; tp holds the Megatron blocks."""
    got = R.result(group, "fsdp")
    assert tuple(got["shape:gpt.blocks.0.qkv.weight"]) == (32, 24)
    assert tuple(got["shape:gpt.word_embeddings.weight"]) == (16, 32)
    z = R.result(group, "zero2")
    assert tuple(z["moment:gpt.blocks.0.qkv.weight"]) == (32, 24)
    assert not any(k.startswith("shape:") for k in z)
    t = R.result(group, "tp")
    assert tuple(t["shape:gpt.blocks.0.qkv.weight"]) == (32, 48)
    assert tuple(t["shape:gpt.blocks.0.proj.weight"]) == (16, 32)


def test_gradient_merge_matches_large_batch(group, refs):
    """k_steps=2 micro-batches on {"dp": 2, "tp": 2}: the same update as
    one step on the whole batch."""
    _, losses, final = refs["gpt2_2"]
    got = R.result(group, "merge")
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    _close_state(got, final)


def test_recompute_matches(group, refs):
    _, losses, final = refs["gpt2_2"]
    got = R.result(group, "recompute", 3)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    _close_state(got, final)


def _jcollectives():
    """The reference's collectives under one shard_map on a {"dp": 4}
    mesh, each rank with the inputs the port's ranks take: a dict of
    per-rank results."""
    from paddle_tpu.distributed import collective as C
    mesh = jpar.create_mesh({"dp": 4})
    x = np.stack([np.arange(4, dtype=np.float32) + 10 * r
                  for r in range(4)])
    rs_in = np.stack([np.arange(8, dtype=np.float32) + r for r in range(4)])
    signs = np.asarray([[-2.0], [3.0], [-1.0], [2.0]], np.float32)
    zeros = np.asarray([[-2.0], [3.0], [0.0], [2.0]], np.float32)
    names = ("sum", "max", "min", "avg", "bcast", "shift", "p2p", "gather",
             "rs", "prod", "prod_zero")

    def body(xs, rss, ss, zs):
        def t(a):
            return paddle.Tensor(a[0])
        parts = []
        C.all_gather(parts, t(xs))
        outs = [C.all_reduce(t(xs), op=op)._data
                for op in ("sum", "max", "min", "avg")]
        outs += [C.broadcast(t(xs), src=3)._data,
                 C.ppermute(t(xs), shift=1)._data,
                 C.p2p(t(xs), pairs=[(1, 3)])._data,
                 jnp.concatenate([p._data for p in parts]),
                 C.reduce_scatter(None, t(rss))._data,
                 C.all_reduce(t(ss), op=C.ReduceOp.PROD)._data,
                 C.all_reduce(t(zs), op=C.ReduceOp.PROD)._data]
        return tuple(o[None] for o in outs)
    out = shard_map(body, mesh=mesh, in_specs=(JP("dp"),) * 4,
                    out_specs=(JP("dp"),) * len(names))(x, rs_in, signs,
                                                        zeros)
    return {n: np.asarray(o) for n, o in zip(names, out)}


@pytest.fixture(scope="module")
def jcollectives():
    return _jcollectives()


def test_collectives_match_the_reference(group, jcollectives):
    """Each rank's all_reduce (sum, max, min, avg), all_gather,
    broadcast, ppermute, reduce_scatter and p2p against the reference's
    under shard_map on a {"dp": 4} mesh with the same per-rank inputs."""
    for rank in range(4):
        got = R.result(group, "collectives", rank)
        for k in ("sum", "max", "min", "avg", "bcast", "shift", "p2p",
                  "gather", "rs"):
            np.testing.assert_array_equal(got[k], jcollectives[k][rank],
                                          err_msg=k)
        assert int(got["n_parts"]) == 4
        np.testing.assert_array_equal(got["scatter"], np.full(4, rank))
        np.testing.assert_array_equal(got["a2a"][:, 0],
                                      [10 * r + rank for r in range(4)])
        np.testing.assert_array_equal(got["spmd"], [rank, 4])
    np.testing.assert_array_equal(R.result(group, "collectives", 1)["recv"],
                                  np.arange(4) + 100.0)


def test_allreduce_prod_signs_and_zeros(group, jcollectives):
    """PROD's sign parity and zero handling with the reference's test
    values spread over the ranks: (-2)*3*(-1)*2 = 12, and 0 where any
    rank holds a zero."""
    for rank in range(4):
        got = R.result(group, "collectives", rank)
        for key in ("prod", "prod_zero"):
            np.testing.assert_allclose(got[key], jcollectives[key][rank],
                                       rtol=1e-6)
    assert float(R.result(group, "collectives")["prod"][0]) == \
        pytest.approx(12.0, rel=1e-6)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_matches_single_device(group, refs, schedule):
    """GPipe and 1F1B over {"pp": 2, "dp": 2} with 2 micro-batches track
    the reference's single-device trajectory; the blocks synced back to
    every rank give finite logits."""
    _, losses, final = refs["gpt2"]
    for rank in range(4):
        got = R.result(group, schedule, rank)
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        assert bool(got["finite"])
        for i in (0, 1):
            want = final[f"gpt.blocks.{i}.qkv.weight"]
            assert float(np.abs(got[f"qkv{i}"] - want).max()) <= \
                1e-2 * R.LR


def test_pipeline_1f1b_saves_less_than_gpipe(group):
    """4 layers, 4 micro-batches: the last stage's peak bytes saved for
    backward are lower under 1F1B (the reference measures XLA's temp
    allocation; the port counts saved tensors)."""
    last = R.result(group, "pipe_mem", 1)
    assert 0 < int(last["1f1b"]) < int(last["gpipe"])


def test_pipeline_respects_frozen_params(group, refs):
    init = refs["gpt2"][0]
    for rank in range(4):
        got = R.result(group, "pipe_frozen", rank)
        for i in (0, 1):   # the per-suffix rule freezes the whole stack
            np.testing.assert_array_equal(
                got[f"qkv{i}"], init[f"gpt.blocks.{i}.qkv.weight"])


def _naive(q, k, v, causal):
    d = q.shape[-1]
    s = q.shape[1]
    qt, kt, vt = (jnp.swapaxes(t, 1, 2) for t in (q, k, v))
    sc = jnp.einsum("bhqd,bhkd->bhqk", qt, kt) / np.sqrt(d)
    if causal:
        sc = jnp.where(jnp.tril(jnp.ones((s, s), bool)), sc, -1e30)
    return jnp.swapaxes(jnp.einsum("bhqk,bhkd->bhqd",
                                   jax.nn.softmax(sc, -1), vt), 1, 2)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_the_reference(group, causal):
    """{"dp": 2, "sp": 2}: output and gradients of ``.sum()`` on every
    rank against the naive softmax of the reference's own ring test, at
    its 2e-4 / 2e-3."""
    rng = np.random.RandomState(3)
    q, k, v = (jnp.asarray(rng.randn(2, 32, 4, 8).astype("float32"))
               for _ in range(3))
    out = np.asarray(_naive(q, k, v, causal))
    grads = jax.grad(lambda q, k, v: _naive(q, k, v, causal).sum(),
                     argnums=(0, 1, 2))(q, k, v)
    tag = "causal" if causal else "full"
    for rank in range(4):
        got = R.result(group, "ring", rank)
        np.testing.assert_allclose(got[tag], out, rtol=2e-4, atol=2e-4)
        for n, g in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(got[f"{tag}_{n}"], np.asarray(g),
                                       rtol=2e-3, atol=2e-3)


def _port_shapes(model):
    return {k: tuple(v.shape) for k, v in state_arrays(model).items()}


@pytest.mark.parametrize("which", ["gpt", "bert", "ernie"])
@pytest.mark.parametrize("axes,flags", [
    ({"dp": 8}, {}), ({"dp": 2, "tp": 4}, {"tensor_parallel": True}),
    ({"dp": 4, "tp": 2}, {"tensor_parallel": True, "fsdp": True}),
    ({"dp": 8}, {"fsdp": True})], ids=["dp", "tp", "tp_fsdp", "fsdp"])
def test_param_specs_match_the_reference_for_every_state_name(which, axes,
                                                               flags):
    """``param_specs`` of every state name of the tiny GPT, BERT and
    ERNIE, on a mesh of the same shape, equals the reference's."""
    paddle.seed(0)
    if which == "gpt":
        model = jmodels.GPTForPretraining(jmodels.GPTConfig(**R.TINY_GPT))
    else:
        kw = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=64,
                  max_position_embeddings=32)
        model = (jmodels.BertForPretraining(jmodels.BertConfig(**kw))
                 if which == "bert" else
                 jmodels.ErnieForPretraining(jmodels.ErnieConfig(**kw)))
    shapes = _port_shapes(model)
    want = jpar.param_specs(shapes, jpar.create_mesh(axes), **flags)
    got = tpar.param_specs(shapes, _FakeMesh(axes), **flags)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k]) == tuple(want[k]), k


class _FakeMesh:
    """The axis sizes of a mesh of ``axes``, without ranks: the rules read
    only ``mesh.shape``."""

    def __init__(self, axes):
        self.shape = {a: axes.get(a, 1) for a in tpar.AXES}


def test_create_mesh_axes_and_refusals():
    mesh = tpar.create_mesh({"dp": 1})
    assert mesh.shape == {"dp": 1, "pp": 1, "ep": 1, "tp": 1, "sp": 1}
    assert mesh.group("dp") is None   # nothing started: the identity
    with pytest.raises(ValueError):
        tpar.create_mesh({"bogus": 2})
    with pytest.raises(ValueError):
        tpar.create_mesh({"dp": 64})
    st = tpar.DistributedStrategy(tensor_parallel=True)
    st.hybrid_configs.mp_degree = 4
    assert st.mesh_axes(8) == {"dp": 2, "pp": 1, "ep": 1, "tp": 4, "sp": 1}
    # parallel.sharding is the rules' module, as in the reference's package
    assert tpar.mesh.sharding(mesh, "dp", None).spec == tpar.P("dp", None)
    assert tpar.replicated(mesh).is_fully_replicated
