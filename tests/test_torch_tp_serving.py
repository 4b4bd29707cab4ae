"""Tensor-parallel serving (``ServingEngine(mesh=)``) on gloo ranks
against the port's single-device engine and the JAX package's tp engine
(tests/test_dist_serving.py's tp tests) on the CPU.

One group of 2 ranks and one of 4 (``tests/torch_ranks.py``: a file
store, a hard join limit) each run the scenarios ``tp_serve`` and
``tp_more``; the reference's tp=8 engine runs on the 8-virtual-device CPU
mesh in this process.  Streams are held equal token for token (the
weights of ``tp_gpt`` keep every argmax well apart; a split at a near tie
would show as a failure here, not be waived); one prompt's logits
through the rank-local forward within 1e-5 of the whole model's (the
row-parallel all-reduces sum the products in another order).
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu import parallel as jpar
from paddle_tpu.jit import state_arrays
from paddle_tpu.serving import ServingEngine as JEngine

import torch_ranks as R
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining

torch.set_num_threads(1)

SCENARIOS = ("tp_serve", "tp_more")


def _jtp_gpt():
    paddle.seed(7)
    m = jmodels.GPTForPretraining(jmodels.GPTConfig(**R.TP_GPT))
    m.eval()
    return m


@pytest.fixture(scope="module")
def ref_streams():
    """The reference's tp=8 engine on the cases' prompts."""
    m = _jtp_gpt()
    eng = JEngine(m, max_slots=2, max_len=32, prefill_buckets=(8,),
                  decode_chunk=4, mesh=jpar.create_mesh({"tp": 8}))
    out = []
    for p, kw in zip(R.tp_prompts(), R.TP_CASES):
        r = eng.submit(p, **kw)
        eng.run_until_drained(timeout=240)
        out.append(r.tokens(timeout=5))
    return m, out


def _save(path, model):
    np.savez(path, **{k: v.detach().numpy()
                      for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def groups(ref_streams, tmp_path_factory):
    m, _ = ref_streams
    out = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"tp{world}")
        np.savez(d / "tp_gpt.npz", **{k: np.asarray(v) for k, v in
                                      state_arrays(m).items()})
        _save(d / "tp_draft.npz", GPTForPretraining(GPTConfig(**dict(
            R.TP_GPT, num_hidden_layers=1, num_attention_heads=4)),
            device="cpu", seed=5))
        _save(d / "tp_other.npz", GPTForPretraining(
            GPTConfig(**R.TP_GPT), device="cpu", seed=9))
        R.run_group(world, SCENARIOS, d, limit=240.0)
        out[world] = d
    return out


def _j(got, key):
    return json.loads(str(got[key]))


@pytest.mark.parametrize("world", [2, 4])
def test_tp_engine_shardings_asserted(groups, world):
    """The reference's layout on every rank: column-parallel qkv (the
    rank's heads) and ffn_in, row-parallel proj / ffn_out, vocabulary-
    sharded embeddings, norms and the row layers' biases replicated; the
    KV pool holds heads / tp; metrics()["mesh"] as the reference's."""
    for rank in range(world):
        got = R.result(groups[world], "tp_serve", rank)
        spec = {k[5:]: str(v) for k, v in got.items()
                if k.startswith("spec:")}
        assert spec["gpt.blocks.0.qkv.weight"] == "(None, 'tp')"
        assert spec["gpt.blocks.0.qkv.bias"] == "('tp',)"
        assert spec["gpt.blocks.0.proj.weight"] == "('tp', None)"
        assert spec["gpt.word_embeddings.weight"] == "('tp', None)"
        assert spec["gpt.ln_f.weight"] == "()"
        assert spec["gpt.blocks.0.proj.bias"] == "()"
        shape = {k[6:]: tuple(v) for k, v in got.items()
                 if k.startswith("shape:")}
        assert shape["gpt.blocks.0.qkv.weight"] == (32, 96 // world)
        assert shape["gpt.blocks.0.proj.weight"] == (32 // world, 32)
        assert shape["gpt.blocks.0.ffn_out.weight"] == (128 // world, 32)
        assert shape["gpt.word_embeddings.weight"] == (64 // world, 32)
        assert shape["gpt.ln_f.weight"] == (32,)
        assert tuple(got["pool"]) == (2, 32, 8 // world, 4)
        assert list(got["mesh"]) == [world, world]


def test_tp_qkv_block_is_the_ranks_heads(groups, ref_streams):
    """A rank's fused-qkv block holds its heads of q, k and v."""
    m, _ = ref_streams
    whole = np.asarray(state_arrays(m)["gpt.blocks.0.qkv.weight"])
    t = whole.reshape(32, 3, 8, 4)
    for rank in range(4):
        got = R.result(groups[4], "tp_serve", rank)["qkv_block"]
        want = t[:, :, rank * 2:(rank + 1) * 2].reshape(32, 24)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("world", [2, 4])
def test_tp_engine_bit_identical_streams(groups, ref_streams, world):
    """Greedy and sampled streams from the tp engine equal the port's
    single-device engine's and the reference's tp=8 engine's, with the
    compile count at its bound and one prompt's logits within 1e-5."""
    _, want = ref_streams
    got = R.result(groups[world], "tp_serve")
    assert _j(got, "tp") == _j(got, "sd") == want
    total, bound = got["compiles"]
    assert total <= bound
    assert float(got["logit_err"]) <= 1e-5


@pytest.mark.parametrize("world", [2, 4])
def test_tp_fixed_restore_keeps_pool_sharded(groups, world):
    """Preempt / restore writes the rank's own pool in place: it keeps
    its heads, nothing is captured again, and the stream equals the
    single-device engine's."""
    got = R.result(groups[world], "tp_serve")
    assert bool(got["restored"])
    assert tuple(got["pool_after"]) == (2, 32, 8 // world, 4)
    assert list(got["restore_tokens"]) == list(got["restore_want"])
    assert int(got["restore_compiles"]) == 0


@pytest.mark.parametrize("world", [2, 4])
def test_tp_paged_engine_matches_single_device(groups, world):
    got = R.result(groups[world], "tp_serve")
    assert np.array_equal(got["paged"], got["paged_want"])
    assert tuple(got["paged_pool"])[2] == 8 // world
    assert int(got["paged_used"]) == 0


def test_tp_rejects_fully_replicated_kv_pool(groups):
    """2 heads over tp=4: the target is refused, and a 2-head draft
    behind a 8-head target is refused as the draft pool."""
    got = R.result(groups[4], "tp_more")
    target, draft = (str(s) for s in got["refusals"])
    assert "replicated" in target and "draft" not in target
    assert "draft KV pool" in draft


@pytest.mark.parametrize("world", [2, 4])
def test_tp_int8_keeps_the_reference_layout(groups, world):
    """An int8 weight-only model: ``tp_spec`` matches ``.weight`` only, so
    ``w_int8`` / ``w_scale`` stay whole (K4 runs on whole weights) while
    the biases, the embeddings and the KV pool's heads are sharded; its
    streams equal the single-device int8 engine's."""
    got = R.result(groups[world], "tp_more")
    spec = {k[10:]: str(v) for k, v in got.items()
            if k.startswith("int8_spec:")}
    shape = {k[11:]: tuple(v) for k, v in got.items()
             if k.startswith("int8_shape:")}
    assert spec["gpt.blocks.0.qkv.w_int8"] == "()"
    assert shape["gpt.blocks.0.qkv.w_int8"] == (32, 96)
    assert shape["gpt.blocks.0.qkv.w_scale"] == (1, 96)
    assert spec["gpt.blocks.0.qkv.bias"] == "('tp',)"
    assert shape["gpt.blocks.0.ffn_in.bias"] == (128 // world,)
    assert shape["gpt.word_embeddings.weight"] == (64 // world, 32)
    assert tuple(got["int8_pool"])[2] == 8 // world
    assert _j(got, "int8") == _j(got, "int8_want")


@pytest.mark.parametrize("world", [2, 4])
def test_tp_speculative_and_swap(groups, world):
    """A speculative tp engine (the draft and its pool sharded too)
    streams as the single-device speculative engine; after
    ``swap_weights`` (whole tensors, cut to the layout) as a
    single-device engine swapped alike."""
    got = R.result(groups[world], "tp_more")
    assert tuple(got["draft_pool"])[2] == 4 // world
    assert _j(got, "spec") == _j(got, "spec_want")
    assert _j(got, "swap") == _j(got, "swap_want")


@pytest.mark.parametrize("world", [2, 4])
def test_tp_requests_while_the_loops_run(groups, world):
    """Requests submitted on the leader from another thread while every
    rank's loop runs (start / close): every rank stays in step and the
    streams equal the single-device engine's."""
    got = R.result(groups[world], "tp_more")
    assert _j(got, "live") == _j(got, "live_want")
    for rank in range(1, world):
        R.result(groups[world], "tp_more", rank)
