"""paddle_tpu_torch.embedding against the JAX package's embedding tests
(tests/test_embedding_shard.py) on the CPU.

One group of 4 gloo ranks (``tests/torch_ranks.py``) runs the row-sharded
scenario; the host-table, predictor and refusal tests run in this process
on the tiny DLRM.  Tolerances: inside the port, everything the contract
calls bit-identical is compared exactly (the sharded step against the
sparse oracle, async against sync, a resumed run against an unbroken
one); against the reference's tp=8 step (other kernels, other summation
orders) the losses at 1e-5 relative and the table at 1e-6.
"""
import tempfile

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import jit as pjit
from paddle_tpu.jit import state_arrays
from paddle_tpu.models import DLRM as JDLRM
from paddle_tpu.models import DLRMCriterion as JCriterion
from paddle_tpu.parallel.mesh import create_mesh as jmesh

import torch_ranks as R
import paddle_tpu_torch as pt
from paddle_tpu_torch.embedding import (HostEmbeddingTable,
                                        HostPrefetchPipeline,
                                        HostTableTrainStep, RecsysPredictor,
                                        ShardedEmbedding, dedup_gather,
                                        dedup_ids)
from paddle_tpu_torch.models import DLRM, DLRMCriterion, dlrm_tiny_config
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.utils import faults

torch.set_num_threads(1)

CFG = dlrm_tiny_config()
B, F = 16, CFG.num_features
_batch = R.dlrm_batch


@pytest.fixture(scope="module")
def reference():
    """The reference's tp=8 sharded step over 2 batches: (initial state,
    losses, final table)."""
    paddle.seed(0)
    oracle = JDLRM(CFG, embedding="sparse")
    init = {k: np.asarray(v) for k, v in state_arrays(oracle).items()}
    import jax
    import jax.numpy as jnp
    paddle.seed(0)
    sharded = JDLRM(CFG, embedding="sharded", mesh=jmesh({"tp": 8}))
    sd = sharded.state_dict()
    for k, v in init.items():
        sd[k]._set_data(jax.device_put(jnp.asarray(v), sd[k]._data.sharding)
                        if k == "table.weight" else jnp.asarray(v))
    opt = paddle.optimizer.Adam(0.01, parameters=sharded.parameters())
    step = pjit.TrainStep(sharded, JCriterion(), opt)
    losses = [float(np.asarray(step(*map(paddle.to_tensor, _batch(i)))
                               ._data)) for i in range(2)]
    table = np.asarray(sharded.state_dict()["table.weight"]._data)
    return init, losses, table


@pytest.fixture(scope="module")
def group(reference, tmp_path_factory):
    out = tmp_path_factory.mktemp("emb4")
    np.savez(out / "dlrm.npz", **reference[0])
    R.run_group(4, ["emb_sharded"], out, limit=180.0)
    return out


# -- dedup units --------------------------------------------------------------

def test_dedup_ids_matches_numpy_unique():
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 50, (257,)).astype(np.int64)
    uids, inv, nu = dedup_ids(torch.from_numpy(ids), 50)
    uids, inv, nu = uids.numpy(), inv.numpy(), int(nu)
    ref_u, ref_inv = np.unique(ids, return_inverse=True)
    assert nu == len(ref_u)
    np.testing.assert_array_equal(uids[:nu], ref_u)
    assert np.all(uids[nu:] == 50)
    np.testing.assert_array_equal(uids[inv], ids)
    np.testing.assert_array_equal(inv, ref_inv)


def test_dedup_gather_is_exact():
    rng = np.random.RandomState(4)
    w = torch.from_numpy(rng.randn(40, 6).astype("float32"))
    ids = torch.from_numpy(rng.randint(0, 40, (123,)))
    out, _, _ = dedup_gather(w, ids)
    assert torch.equal(out, w[ids])


# -- the row-sharded table ----------------------------------------------------

def test_sharded_train_step_bit_identical_to_sparse_oracle(group,
                                                           reference):
    """DLRM with its table's rows over tp=4 trains bit-identically (losses
    and whole table) to the port's single-device sparse oracle on every
    rank; rows never looked up and their moments are untouched (exactly
    zero moments); each rank holds a quarter of the rows; and the run is
    the reference's tp=8 step within the stated tolerance."""
    init, ref_losses, ref_table = reference
    live = np.unique(np.concatenate(
        [_batch(i)[1] + CFG.offsets.reshape(1, -1) for i in range(2)]))
    untouched = np.setdiff1d(np.arange(CFG.total_rows), live)
    for rank in range(4):
        got = R.result(group, "emb_sharded", rank)
        assert list(got["block_shape"]) == [CFG.total_rows // 4, 8]
        assert np.array_equal(got["sharded_losses"], got["sparse_losses"])
        assert np.array_equal(got["sharded_table"], got["sparse_table"])
        assert np.array_equal(got["sharded_top"], got["sparse_top"])
        w = got["sharded_table"]
        assert np.array_equal(w[untouched], init["table.weight"][untouched])
        assert not np.array_equal(w[live], init["table.weight"][live])
        assert np.all(got["sharded_m1"][untouched] == 0)
        assert np.any(got["sharded_m1"][live] != 0)
        np.testing.assert_allclose(got["sharded_losses"], ref_losses,
                                   rtol=1e-5)
        np.testing.assert_allclose(w, ref_table, atol=1e-6)


def test_sharded_embedding_eager_lazy_update_per_shard(group):
    """Eager lookup: the exact rows, a sparse COO gradient of the rank's
    rows, and Adam moves exactly the looked-up rows of each block."""
    ids = np.array([3, 3, 9, 20, 63])
    for rank in range(4):
        got = R.result(group, "emb_sharded", rank)
        assert bool(got["eager_sparse"])
        assert np.array_equal(got["eager_out"], got["eager_w0"][ids])
        moved = np.flatnonzero(got["eager_moved"]) + rank * 16
        want = sorted(i for i in set(ids) if rank * 16 <= i < rank * 16 + 16)
        assert moved.tolist() == want


def test_sharded_embedding_rejects_undivisible_vocab(group):
    got = R.result(group, "emb_sharded")
    assert "divide evenly" in str(got["undivisible"])


def test_sharded_one_rank_matches_sparse():
    """Without a started group the table is one shard: DLRM("sharded")
    steps exactly as DLRM("sparse") on the same weights."""
    out = {}
    for mode in ("sparse", "sharded"):
        m = DLRM(CFG, embedding=mode, device="cpu", seed=0)
        if mode == "sharded":
            m.load_state_dict(out["state"])
        else:
            out["state"] = {k: v.clone() for k, v in m.state_dict().items()}
        step = pt.jit.TrainStep(m, DLRMCriterion(),
                                Adam(0.01, parameters=m.parameters()))
        out[mode] = ([float(step(*map(torch.from_numpy, _batch(i))))
                      for i in range(2)], m.state_dict()["table.weight"])
    assert out["sparse"][0] == out["sharded"][0]
    assert torch.equal(out["sparse"][1], out["sharded"][1])


# -- the host-resident table --------------------------------------------------

def _run_host(steps=6, async_prefetch=True, save_dir=None, save_at=None,
              start=0):
    model = DLRM(CFG, embedding="external", device="cpu", seed=0)
    opt = Adam(0.01, parameters=model.parameters())
    table = HostEmbeddingTable(CFG.total_rows, CFG.embedding_dim, seed=7)
    step = HostTableTrainStep(model, DLRMCriterion(), opt, table)
    if save_dir is not None and start > 0:
        meta = step.restore_checkpoint(save_dir)
        start = meta["data_cursor"]["batch_index"]
    pipe = HostPrefetchPipeline(table, _batch, steps, optimizer=opt,
                                offsets=CFG.offsets,
                                async_prefetch=async_prefetch, bucket=64,
                                start_index=start, device="cpu")
    losses = []
    while True:
        prep = pipe.next_prepared()
        if prep is None:
            break
        loss, new_slab, new_states = step.run(prep, (B, F))
        pipe.complete(prep, new_slab, new_states)
        losses.append(float(loss))
        if save_dir is not None and save_at is not None \
                and prep.index + 1 == save_at:
            step.save_checkpoint(save_dir, pipeline=pipe)
    pipe.close()
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return losses, table, params, pipe.metrics()


_CLEAN = {}


def _clean_host_run():
    if not _CLEAN:
        losses, table, params, _ = _run_host(async_prefetch=False)
        _CLEAN.update(losses=losses, rows=table.rows.copy(),
                      moments={k: v.copy() for k, v in
                               table.opt_slabs.items()},
                      params=params)
    return _CLEAN


def test_host_pipeline_async_bit_identical_to_sync():
    clean = _clean_host_run()
    losses, table, params, metrics = _run_host(async_prefetch=True)
    assert losses == clean["losses"]
    assert np.array_equal(table.rows, clean["rows"])
    for k, v in clean["moments"].items():
        assert np.array_equal(table.opt_slabs[k], v)
    for k, v in clean["params"].items():
        assert torch.equal(params[k], v)
    assert metrics["hits"] >= 1
    assert 0 < metrics["peak_device_table_bytes"] < table.nbytes


def test_prefetch_stall_fault_degrades_to_synchronous():
    """prefetch_stall: the consumer waits and misses climb, with every
    result unchanged."""
    clean = _clean_host_run()
    faults.enable("prefetch_stall", "30")
    try:
        losses, table, _, metrics = _run_host(async_prefetch=True)
    finally:
        faults.reset()
    assert losses == clean["losses"]
    assert np.array_equal(table.rows, clean["rows"])
    assert metrics["misses"] > metrics["hits"]
    assert metrics["wait_seconds"] > 0.05


def test_row_corrupt_fault_detected_and_refetched():
    """row_corrupt poisons one fetched copy: found, fetched again, and
    training stays bit-identical."""
    clean = _clean_host_run()
    faults.enable("row_corrupt", "3")
    try:
        losses, table, _, metrics = _run_host(async_prefetch=True)
    finally:
        faults.reset()
    assert metrics["corrupt_refetches"] == 1
    assert losses == clean["losses"]
    assert np.array_equal(table.rows, clean["rows"])
    assert np.isfinite(table.rows).all()


def test_host_table_checkpoint_resume_bit_exact():
    """A checkpoint after batch 3 (rows, moments, dense state, cursor),
    then a cold restart from it: the rest of the run is bit-exact."""
    clean = _clean_host_run()
    with tempfile.TemporaryDirectory() as ck:
        _run_host(steps=6, save_dir=ck, save_at=3)
        losses, table, params, _ = _run_host(steps=6, save_dir=ck, start=1)
        assert losses == clean["losses"][3:]
        assert np.array_equal(table.rows, clean["rows"])
        for k, v in clean["moments"].items():
            assert np.array_equal(table.opt_slabs[k], v)
        for k, v in clean["params"].items():
            assert torch.equal(params[k], v)


def test_observability_embedding_section():
    _clean_host_run()
    from paddle_tpu_torch import observability
    rep = observability.report()["embedding"]
    assert rep["rows_gathered"] > 0
    assert rep["rows_unique"] > 0
    assert rep["dedup_ratio"] >= 1.0
    assert rep["host_to_device_bytes"] > 0
    assert "prefetch_wait_seconds" in rep


def test_accum_sparse_typed_error_names_params():
    """accum_steps > 1 with a row-sparse table: the typed error names the
    parameter and the sparse=False remedy, for "sparse" and "sharded"."""
    for mode in ("sparse", "sharded"):
        m = DLRM(CFG, embedding=mode, device="cpu")
        with pytest.raises(NotImplementedError) as e:
            pt.jit.TrainStep(m, DLRMCriterion(),
                             Adam(0.01, parameters=m.parameters()),
                             accum_steps=2)
        assert "accum_steps=2" in str(e.value)
        assert "table.weight" in str(e.value)
        assert "sparse=False" in str(e.value)


# -- serving ------------------------------------------------------------------

def test_recsys_predictor_batched_dedup_scoring_parity():
    """Config.enable_recsys_serving builds a RecsysPredictor; merged
    requests score as a direct forward on the gathered rows."""
    import paddle_tpu_torch.inference as infer
    model = DLRM(CFG, embedding="external", device="cpu", seed=0)
    table = HostEmbeddingTable(CFG.total_rows, CFG.embedding_dim, seed=7)
    cfg = infer.Config()
    cfg.disable_gpu()
    cfg.enable_recsys_serving(model=model, table=table,
                              offsets=CFG.offsets, window_ms=5.0)
    assert cfg.recsys_enabled()
    pred = infer.create_predictor(cfg)
    assert isinstance(pred, RecsysPredictor)
    try:
        dense, ids, _ = _batch(0, b=24)
        resps = [pred.submit(dense[k:k + 8], ids[k:k + 8])
                 for k in range(0, 24, 8)]
        got = np.concatenate([r.result(30) for r in resps], axis=0)
        gids = (ids + CFG.offsets.reshape(1, -1)).reshape(-1)
        emb = torch.from_numpy(table.rows[gids].reshape(24, F, 8))
        with torch.no_grad():
            ref = model.eval()(torch.from_numpy(dense), emb).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        assert pred.metrics()["batches"] <= len(resps)
    finally:
        pred.close()


def test_recsys_predictor_queue_full_rejects_terminally():
    model = DLRM(CFG, embedding="external", device="cpu", seed=0)
    table = HostEmbeddingTable(CFG.total_rows, CFG.embedding_dim, seed=7)
    pred = RecsysPredictor(model, table, offsets=CFG.offsets, max_queue=1,
                           start=False)
    try:
        dense, ids, _ = _batch(0, b=4)
        ok = pred.submit(dense, ids)
        shed = pred.submit(dense, ids)
        assert not ok.done
        assert shed.done and shed.failed
        assert "shed" in shed.error
        with pytest.raises(RuntimeError, match="shed"):
            shed.result(0.1)
    finally:
        pred.close()
